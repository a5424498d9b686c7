"""Share of the traced window with no device operation running, %."""

import readers


def read(record):
    return readers.idle_pct(record)
