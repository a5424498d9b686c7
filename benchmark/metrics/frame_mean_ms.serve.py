"""Mean ms of a served frame: the traced run's window without the profiler
over the frames it completed (its wall time, on the host's clock)."""


def read(record):
    if record.span_window_s <= 0 or record.units <= 0:
        return None
    return 1e3 * record.span_window_s / record.units
