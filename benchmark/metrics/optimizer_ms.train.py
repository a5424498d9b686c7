"""ms a train step of the program's `optimizer` spans (CUDA event pairs: the
gradients' norm, their finite test and read, the update) in its last
traced window (the profiled one), over its `step` spans."""


def read(record):
    try:
        from fastposecnn_tpu_torch.utils.timer import last_window
    except ImportError:  # a program without the tracer
        return None
    window = last_window()
    units = window.units("step") if window is not None else 0
    return window.total_ms("optimizer") / units if units else None
