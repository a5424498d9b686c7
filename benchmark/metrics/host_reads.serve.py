"""Host reads a served frame: the program's `host_read/<site>` counts of
its last traced window (the profiled one), over its `frame` spans."""


def read(record):
    try:
        from fastposecnn_tpu_torch.utils.timer import last_window
    except ImportError:  # a program without the tracer
        return None
    window = last_window()
    units = window.units("frame") if window is not None else 0
    return window.counted("host_read/") / units if units else None
