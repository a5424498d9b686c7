"""K1's least time (bytes at HBM rate) over its device time, %."""

import readers


def read(record):
    return readers.roofline_pct(record, record.k1_bound_s, readers.K1_KERNELS)
