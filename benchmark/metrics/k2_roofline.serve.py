"""K2's least time (FP32 operations of the valid cells, or bytes) over its device time, %."""

import readers


def read(record):
    return readers.roofline_pct(record, record.k2_bound_s, readers.K2_KERNELS)
