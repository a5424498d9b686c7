"""Per-stage timing with the reference's ms / fps report (counterpart of the
JAX package's `utils/timer.py`).

On a CUDA device `StageTimer.measure()` records one pair of CUDA events
around each call of its stage and reads them in `flush()`, after the batch,
so timing adds no sync inside the batch. On the CPU it reads the host
clock.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch


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
