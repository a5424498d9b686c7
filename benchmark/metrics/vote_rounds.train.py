"""Mean adaptive vote rounds a step (the step logs' pose/vote_rounds)."""

import readers


def read(record):
    return readers.counter(record, "vote_rounds")
