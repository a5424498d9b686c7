"""Median ms of a frame's post-network stages (events around run_pipeline)."""

import readers


def read(record):
    return readers.span_median_ms(record, "post_network")
