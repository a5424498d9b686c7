"""Per-stage timing with the reference's ms / fps report (counterpart of the
JAX package's `utils/timer.py`).

On a CUDA device `StageTimer.measure()` records one pair of CUDA events
around each call of its stage and reads them in `flush()`, after the batch,
so timing adds no sync inside the batch. On the CPU it reads the host
clock.

`median_ms`, `loop_ms` and `device_us_by_kernel` time work on a CUDA
device, for `chip_smoke.py` and the probes, against the card's published
peaks below.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Callable, Dict, List

import torch

# Published H100 SXM peaks (NVIDIA data sheet), at the full 700 W power
# limit: HBM bytes/s; FP32 outside the tensor cores, 67 TFLOP/s counting a
# fused multiply-add as two operations, so 33.5 T/s for the unfused adds and
# multiplies of kernels built with -fmad=false; TF32 on the tensor cores,
# 495 TFLOP/s dense.
HBM_BYTES_PER_S = 3.35e12
FP32_UNFUSED_OPS_PER_S = 67e12 / 2
TF32_TENSOR_OPS_PER_S = 495e12


class StageTimer:
    def __init__(self, name: str, device: torch.device):
        self.name = name
        self.cuda = torch.device(device).type == "cuda"
        self.times_ms: List[float] = []
        self._pending: List[tuple] = []

    @contextlib.contextmanager
    def measure(self):
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self._pending.append((start, end))
        else:
            t0 = time.perf_counter()
            yield
            self.times_ms.append((time.perf_counter() - t0) * 1000.0)

    def flush(self) -> None:
        """Read the recorded event pairs (waits for the last one)."""
        for start, end in self._pending:
            end.synchronize()
            self.times_ms.append(start.elapsed_time(end))
        self._pending.clear()

    @property
    def average(self) -> float:
        """Mean ms per call, the first (warm-up) call left out when there
        are more."""
        self.flush()
        samples = self.times_ms[1:] if len(self.times_ms) > 1 else self.times_ms
        return sum(samples) / max(len(samples), 1)

    @property
    def fps(self) -> float:
        avg = self.average
        return 1000.0 / avg if avg > 0 else float("inf")

    def report(self) -> str:
        return f"{self.name}: {self.average:.3f} ms - {self.fps:.1f} fps"


def report_runtime(timers: Dict[str, StageTimer]) -> str:
    """Print one line per stage that ran."""
    for t in timers.values():
        t.flush()
    text = "\n".join(t.report() for t in timers.values() if t.times_ms)
    print(text)
    return text


def median_ms(fn: Callable, iters: int = 20, warmup: int = 3) -> float:
    """Median of `iters` CUDA-event timings of fn(), after `warmup` calls."""
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
    return statistics.median(times)


def loop_ms(fn: Callable, launches: int = 50, repeats: int = 5) -> float:
    """Device time per call of a launch-only fn (no host syncs inside): CUDA
    events around `launches` back-to-back calls, median of `repeats`."""
    return median_ms(lambda: [fn() for _ in range(launches)],
                     iters=repeats, warmup=1) / launches


def device_us_by_kernel(fn: Callable, calls: int = 20) -> Dict[str, float]:
    """Device microseconds per call of each CUDA kernel that fn() launches,
    from a torch.profiler trace of `calls` calls (an empty dict if the
    trace holds no device time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / calls for e in prof.key_averages()
            if e.self_device_time_total > 0}
