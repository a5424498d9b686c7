"""Median ms of the served network's forward (CUDA events around it)."""

import readers


def read(record):
    return readers.span_median_ms(record, "network")
