"""The port's tracer, the CLIs' per-stage timing with the reference's ms /
fps report (counterpart of the JAX package's `utils/timer.py`), and timing
helpers.

**The tracer** holds the program's spans and counters.

- `span(name)` marks a stretch of the program: `frame` (a served frame)
  and `step` (a train step) are units; `feed`, `network`, `backward`,
  `stages`, `class_compress`, `aggregate`, `vote`, `vote_round`, `rt`,
  `losses` and `optimizer` nest inside them; `host_read` is the host
  waiting in `host_read`. The evaluate CLI adds `matching` and `errors`.
- `count(name, n)` adds to a counter: `launch/<kernel>` (the hand-written
  kernels' launches, `kernels.count_launch`), `host_read/<site>` (device
  to host reads that block the host) and `vote_rounds`. Counters always
  add to lifetime totals (`totals`).
- `host_read(site, read, *args)` is the one way the frame and step paths
  read a device value on the host (`read(*args)`), counted and spanned.

The tracer is off by default, and a span then costs one flag check and
does no device work. It is on inside `tracing()` and while a
`torch.profiler` records. Switching it on starts a new window record
(`Window`, `last_window()`) and drops the last one: the tracer sees the
switch at the first span or count after it was last found off (by a span,
a count or `enabled()`), and entering `tracing()` while off is one. While
on, every span is kept in the window with its parent, its unit's id, and
its host start and end (`perf_counter_ns`). While CUDA is in use, every
span but the ones that come many a unit (`HOST_SPANS`) also holds a CUDA
event pair, recorded on the current stream and read after the window, so
timing adds no host sync inside a frame or a step. The window also keeps
the counts taken while on. While a profiler records, each span is also
the profiler range `fpc/<name>` (`fpc/host_read/<site>` for a read): a
host-side op (`_RecordFunctionFast`), with no device-side mirror, so the
spans sit in the trace on the profiler's clock. Under
`torch.compiler.is_compiling()` (`torch.export`) a span is a no-op.

The inference and evaluate CLIs read their per-stage report from a
`tracing()` window (`stage_ms`, `report_runtime`).

`event_ms`, `median_ms`, `loop_ms`, `kernel_trace` and `device_us_by_kernel`
time work on a CUDA device, for `chip_smoke.py` and the probes, against the
card's published peaks below.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple, TypeVar

import torch
import torch.autograd.profiler as _profiler

T = TypeVar("T")

# Published H100 SXM peaks (NVIDIA data sheet), at the full 700 W power
# limit: HBM bytes/s; FP32 outside the tensor cores, 67 TFLOP/s counting a
# fused multiply-add as two operations, so 33.5 T/s for the unfused adds and
# multiplies of kernels built with -fmad=false; TF32 on the tensor cores,
# 495 TFLOP/s dense.
HBM_BYTES_PER_S = 3.35e12
FP32_UNFUSED_OPS_PER_S = 67e12 / 2
TF32_TENSOR_OPS_PER_S = 495e12


def _mark() -> torch.cuda.Event:
    """A timing event recorded on the current CUDA stream."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _elapsed_ms(start: torch.cuda.Event, end: torch.cuda.Event) -> float:
    """ms between two recorded events (waits for the second)."""
    end.synchronize()
    return start.elapsed_time(end)


# -----------------------------------------------------------------------------
# The tracer

UNITS = ("frame", "step")
# The spans that come many a frame or step (a round, a read), which hold
# the host's clock alone: an event pair costs tens of microseconds of the
# host's time.
HOST_SPANS = frozenset(("host_read", "vote_round"))


class SpanRecord:
    """One span of a window: `parent` is the index of the enclosing span in
    `Window.spans` (-1 for none), `unit` the id of its frame or step (their
    order in the window; -1 outside any)."""
    __slots__ = ("name", "site", "parent", "unit", "start_ns", "end_ns", "events")

    def __init__(self, name: str, site: Optional[str], parent: int, unit: int):
        self.name, self.site, self.parent, self.unit = name, site, parent, unit
        self.start_ns = self.end_ns = 0
        self.events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    @property
    def ms(self) -> float:
        """The CUDA event pair's ms where it has one, else the host's."""
        return _elapsed_ms(*self.events) if self.events is not None else self.host_ms


class Window:
    """What the tracer kept while on: every span in the order it started,
    and the counts taken."""

    def __init__(self):
        self.spans: List[SpanRecord] = []
        self.counts: Dict[str, int] = {}
        self.open: List[int] = []  # indices of the spans not yet ended
        self.last_unit = -1

    def named(self, name: str) -> List[SpanRecord]:
        return [r for r in self.spans if r.name == name]

    def units(self, name: str) -> int:
        """How many spans `name` (a unit: "frame" or "step") the window holds."""
        return len(self.named(name))

    def total_ms(self, name: str) -> float:
        return sum(r.ms for r in self.named(name))

    def total_host_ms(self, name: str) -> float:
        return sum(r.host_ms for r in self.named(name))

    def counted(self, prefix: str) -> int:
        """The window's counts of every counter whose name starts with
        `prefix`, summed."""
        return sum(v for k, v in self.counts.items() if k.startswith(prefix))


_explicit = 0  # depth of `tracing()` blocks
_live = False  # whether `_window` still takes spans and counts
_window: Optional[Window] = None
_totals: Dict[str, int] = {}


def enabled() -> bool:
    """Whether the tracer is on. Finding it off (here, or in a span or a
    count) ends the window, so the next span or count while on starts a
    new one."""
    global _live
    if _explicit or _profiler._is_profiler_enabled:
        return True
    _live = False
    return False


def _current() -> Window:
    global _window, _live
    if not _live:
        _window, _live = Window(), True
    return _window


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "site", "window", "index", "range", "start")

    def __init__(self, name: str, site: Optional[str]):
        self.name, self.site = name, site

    def __enter__(self) -> SpanRecord:
        win = self.window = _current()
        parent = win.open[-1] if win.open else -1
        if self.name in UNITS:
            win.last_unit += 1
            unit = win.last_unit
        else:
            unit = win.spans[parent].unit if parent >= 0 else -1
        rec = SpanRecord(self.name, self.site, parent, unit)
        self.index = len(win.spans)
        win.spans.append(rec)
        win.open.append(self.index)
        self.range = self.start = None
        if _profiler._is_profiler_enabled:
            self.range = torch._C._profiler._RecordFunctionFast(
                f"fpc/{self.name}" if self.site is None else f"fpc/{self.name}/{self.site}")
            self.range.__enter__()
        if self.name not in HOST_SPANS and torch.cuda.is_initialized():
            self.start = _mark()
        rec.start_ns = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc) -> bool:
        rec = self.window.spans[self.index]
        rec.end_ns = time.perf_counter_ns()
        if self.start is not None:
            rec.events = (self.start, _mark())
        if self.range is not None:
            self.range.__exit__(None, None, None)
        self.window.open.remove(self.index)
        return False


def span(name: str, site: Optional[str] = None):
    """A span of the program (a context manager): nothing while the tracer
    is off or a trace compiles, else kept in the window (with a CUDA event
    pair, but for `HOST_SPANS`, while CUDA is in use)."""
    if not enabled() or torch.compiler.is_compiling():
        return _OFF
    return _Span(name, site)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` (and to the window's while on)."""
    _totals[name] = _totals.get(name, 0) + n
    if enabled():
        counts = _current().counts
        counts[name] = counts.get(name, 0) + n


def host_read(site: str, read: Callable[..., T], *args) -> T:
    """`read(*args)`, a read that waits for the device (`t.item`, ...),
    counted as `host_read/<site>` and spanned as `host_read` at `site`."""
    count("host_read/" + site)
    with span("host_read", site=site):
        return read(*args)


def totals() -> Dict[str, int]:
    """Every counter's lifetime total."""
    return dict(_totals)


def reset_totals(prefix: str) -> None:
    """Zero the lifetime totals of the counters whose names start with
    `prefix`."""
    for k in _totals:
        if k.startswith(prefix):
            _totals[k] = 0


@contextlib.contextmanager
def tracing() -> Iterator[Window]:
    """The tracer on for the block; a new window starts unless it was on
    already. Yields the window."""
    global _explicit
    enabled()  # finding the tracer off ends the last window
    win = _current()
    _explicit += 1
    try:
        yield win
    finally:
        _explicit -= 1
        enabled()


def last_window() -> Optional[Window]:
    """The window of the tracer's last stretch on (None if it never was)."""
    return _window


def stage_ms(window: Window, stages: Dict[str, str]) -> Dict[str, float]:
    """Mean ms a call of each stage ({key: span name}) that ran in `window`:
    its spans that no other span encloses, the first (warm-up) call left
    out when there are more."""
    out = {}
    for key, name in stages.items():
        times = [r.ms for r in window.spans if r.name == name and r.parent < 0]
        if times:
            times = times[1:] if len(times) > 1 else times
            out[key] = sum(times) / len(times)
    return out


def report_runtime(ms: Dict[str, float]) -> str:
    """The reference's report, one `<stage>: <ms> ms - <fps> fps` line a
    stage."""
    return "\n".join(f"{name}: {avg:.3f} ms - {1000.0 / avg if avg > 0 else float('inf'):.1f} fps"
                     for name, avg in ms.items())


def event_ms(fn: Callable, iters: int = 20, warmup: int = 3) -> List[float]:
    """`iters` CUDA-event timings of fn() in ms, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def median_ms(fn: Callable, iters: int = 20, warmup: int = 3) -> float:
    """Median of `iters` CUDA-event timings of fn(), after `warmup` calls."""
    return statistics.median(event_ms(fn, iters, warmup))


def loop_ms(fn: Callable, launches: int = 50, repeats: int = 5) -> float:
    """Device time per call of a launch-only fn (no host syncs inside): CUDA
    events around `launches` back-to-back calls, median of `repeats`."""
    return median_ms(lambda: [fn() for _ in range(launches)],
                     iters=repeats, warmup=1) / launches


def kernel_trace(fn: Callable, calls: int = 20) -> Tuple[Dict[str, float], float]:
    """Device microseconds per call of each kernel, copy or set that fn()
    runs on the card, and how many of them it runs per call, from a
    torch.profiler trace of `calls` calls (an empty dict and 0 if the trace
    holds no device event)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return ({e.key: e.self_device_time_total / calls for e in kernels},
            sum(e.count for e in kernels) / calls)


def device_us_by_kernel(fn: Callable, calls: int = 20) -> Dict[str, float]:
    """Device microseconds per call of each CUDA kernel that fn() launches
    (`kernel_trace`'s first result)."""
    return kernel_trace(fn, calls)[0]
