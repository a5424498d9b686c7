"""The arithmetic of the per-layer metrics, over a traced window's record
(`harness.TraceRecord`). Each returns None where the window has nothing to
read, so the metric is left out of the result line."""

from __future__ import annotations

import statistics
from typing import Optional

K1_KERNELS = ("cc_tile", "cc_border", "cc_flatten")
K2_KERNELS = ("vote_count_kernel",)


def span_median_ms(record, name: str) -> Optional[float]:
    ms = record.spans.ms.get(name) if record.spans is not None else None
    return statistics.median(ms) if ms else None


def counter(record, name: str) -> Optional[float]:
    return record.spans.counters.get(name) if record.spans is not None else None


def roofline_pct(record, bound_s: float, kernels) -> Optional[float]:
    """The kernel's least time on these inputs over its device time (the
    device time of every trace event whose name holds one of `kernels`)."""
    spent = record.kernel_time(kernels)
    if spent <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / spent


def idle_pct(record) -> Optional[float]:
    """The share of a frame or step in which no device operation runs: one
    minus the device's busy seconds (the profiled window's) over the wall
    seconds (the window without the profiler, whose own host work would
    count as idle), each per frame or step."""
    if record.busy_s <= 0 or record.span_window_s <= 0:
        return None
    return 100.0 * (1.0 - record.busy_s / record.span_window_s)


def mfu_pct(record) -> Optional[float]:
    """The network's convolution operations over the window without the
    profiler, against the dense peak of the network's compute dtype."""
    if record.busy_s <= 0 or record.span_window_s <= 0 or record.peak_flops <= 0:
        return None
    return 100.0 * record.flops / record.span_window_s / record.peak_flops
