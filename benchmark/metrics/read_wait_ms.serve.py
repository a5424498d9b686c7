"""ms a served frame that the host waits in the program's host reads: the
host time inside its `host_read` spans of its last traced window (the
profiled one), over its `frame` spans."""


def read(record):
    try:
        from fastposecnn_tpu_torch.utils.timer import last_window
    except ImportError:  # a program without the tracer
        return None
    window = last_window()
    units = window.units("frame") if window is not None else 0
    return window.total_host_ms("host_read") / units if units else None
