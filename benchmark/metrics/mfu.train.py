"""The network's convolution operations over the traced window, against the compute dtype's dense peak, %."""

import readers


def read(record):
    return readers.mfu_pct(record)
