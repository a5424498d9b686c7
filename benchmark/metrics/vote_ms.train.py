"""Median ms of a step's hough-voting stage (events around stage_hough_voting)."""

import readers


def read(record):
    return readers.span_median_ms(record, "vote")
