"""The harness's shared parts: finding a cell's files by name, spans and
counters taken from the benchmark's side of the program's calls, the
profiler trace and its reduction, and the result line.

A cell (`workloads` in BENCHMARK.json) names a configuration, whose sizes
are `configs/<config>.json`, and a traffic mix, `traffic/<traffic>.json`,
which names its driver, `drivers/<driver>.py`, and holds the mix's
parameters and the limits of its correctness check. A per-layer metric
`<name>` is read by `metrics/<name>.py`, whose `read(record)` returns a
number or None (nothing to read in this run).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import pathlib
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fastposecnn_tpu")
# The reading of a number whose comparison could not be made (a shape the
# reference refuses): above every limit.
UNREADABLE = 1e30


class Refused(Exception):
    """A run that cannot give a result (no card, a missing file)."""


def load_json(path: pathlib.Path) -> Dict:
    if not path.is_file():
        raise Refused(f"missing {path}")
    return json.loads(path.read_text())


@dataclasses.dataclass
class Cell:
    bench: Dict
    workload: Dict
    config: Dict
    traffic: Dict
    root: pathlib.Path  # the benchmark's folder

    @property
    def name(self) -> str:
        return self.workload["name"]

    def end_to_end(self) -> List[Dict]:
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[Dict]:
        own = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m else m["moves"] in own)]


def find_cell(name: str, bench_path: Optional[pathlib.Path] = None,
              root: pathlib.Path = HERE) -> Cell:
    bench = load_json(bench_path or root.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    return Cell(bench, w, load_json(root / "configs" / f"{w['config']}.json"),
                load_json(root / "traffic" / f"{w['traffic']}.json"), root)


def load_driver(cell: Cell):
    path = cell.root / "drivers" / f"{cell.traffic['driver']}.py"
    return _load_module(f"drivers_{cell.traffic['driver']}", path)


def load_metric(root: pathlib.Path, name: str):
    return _load_module(f"metric_{name.replace('.', '_')}", root / "metrics" / f"{name}.py")


def _load_module(modname: str, path: pathlib.Path):
    if not path.is_file():
        raise Refused(f"missing {path}")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: `fastposecnn_tpu_torch` is not
    `fastposecnn_tpu`)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def check_network(cfg: Dict, net: torch.nn.Module, side: str) -> None:
    """Refuse the run when `net` lacks a size the configuration states."""
    from reference.nets import config_mismatches

    bad = config_mismatches(cfg, net)
    if bad:
        raise Refused(f"the {side}'s network is not the configuration's: " + "; ".join(bad))


def check_fixed(traffic: Dict, fixed: Dict[str, Any], driver: str) -> None:
    """Refuse a traffic mix that asks the driver for what it does not do."""
    bad = [f"{k} {traffic.get(k)!r} (the driver runs {v!r})" for k, v in fixed.items()
           if traffic.get(k) != v]
    if bad:
        raise Refused(f"the {driver} driver cannot run this traffic: " + "; ".join(bad))


# -----------------------------------------------------------------------------
# Timing


def log(what: str, t0: float) -> None:
    """One line on standard error: seconds since the process started."""
    print(f"benchmark: {what} at {time.perf_counter() - t0:.3f} s", file=sys.stderr, flush=True)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Named spans timed with CUDA events on the card (read after the
    window, so they add no host sync), with the host clock on the CPU; and
    named counters."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.on = False  # spans are taken only while on
        self._pending: Dict[str, List[Tuple[Any, Any]]] = {}
        self.ms: Dict[str, List[float]] = {}
        self.counters: Dict[str, float] = {}

    def start(self):
        if not self.on:
            return None
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def stop(self, name: str, began) -> None:
        if began is None:
            return
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._pending.setdefault(name, []).append((began, ev))
        else:
            self.ms.setdefault(name, []).append((time.perf_counter() - began) * 1e3)

    @contextlib.contextmanager
    def span(self, name: str):
        began = self.start()
        try:
            yield
        finally:
            self.stop(name, began)

    def flush(self) -> None:
        for name, pairs in self._pending.items():
            for a, b in pairs:
                b.synchronize()
                self.ms.setdefault(name, []).append(a.elapsed_time(b))
        self._pending.clear()


@contextlib.contextmanager
def patched(module, name: str, wrap: Callable[[Callable], Callable]):
    """Replace `module.name` by `wrap(original)` inside the block."""
    original = getattr(module, name)
    setattr(module, name, wrap(original))
    try:
        yield original
    finally:
        setattr(module, name, original)


def percentile(values: List[float], p: float) -> float:
    """The p-th percentile (linear interpolation between order statistics)."""
    xs = sorted(values)
    if not xs:
        return float("nan")
    k = (len(xs) - 1) * p / 100.0
    lo = int(k)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


# -----------------------------------------------------------------------------
# The profiler trace


@dataclasses.dataclass
class TraceRecord:
    """What a traced run gives the per-layer metrics' readers. It runs the
    same frames or steps twice after set-up: once with spans (CUDA events)
    and without the profiler (`span_window_s`), once under the profiler
    (`window_s`, with the device's busy seconds and the kernels' bounds)."""
    window_s: float
    units: int  # frames or steps in each window
    images: int
    span_window_s: float = 0.0
    busy_s: float = 0.0
    kernel_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    idle_gaps: List[Tuple[str, float]] = dataclasses.field(default_factory=list)
    spans: Optional[Spans] = None
    flops: float = 0.0  # the network's convolutions in the window
    peak_flops: float = 0.0
    k1_bound_s: float = 0.0
    k2_bound_s: float = 0.0

    def kernel_time(self, names: Tuple[str, ...]) -> float:
        return sum(s for k, s in self.kernel_s.items() if any(n in k for n in names))


@contextlib.contextmanager
def profiled(device: torch.device):
    """torch.profiler over the block on the card; yields a holder whose
    `prof` is the finished profile (None on the CPU)."""
    holder = type("Holder", (), {"prof": None})()
    if device.type != "cuda":
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield holder
        torch.cuda.synchronize(device)
    holder.prof = prof


def reduce_trace(prof, record: TraceRecord, top: int = 10) -> None:
    """Device busy seconds (the union of the device events' intervals),
    seconds by kernel name, and the longest idle gaps labelled with the
    innermost host operation running at the gap's start."""
    if prof is None:
        return
    from torch.autograd import DeviceType

    events = prof.events()
    dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                 if e.device_type == DeviceType.CUDA)
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == DeviceType.CPU]
    busy, gaps, cur_s, cur_e = 0.0, [], None, None
    by_name: Dict[str, float] = {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    record.busy_s = busy * 1e-6
    record.kernel_s = by_name
    labelled = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        inner = [h for h in host if h[0] <= g0 < h[1]]
        label = max(inner)[2] if inner else "no host operation"
        labelled.append((label, (g1 - g0) * 1e-6))
    record.idle_gaps = labelled


def breakdown(record: TraceRecord, top: int = 10) -> Dict[str, List]:
    ops = sorted(record.kernel_s.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in record.idle_gaps[:top]]}


# -----------------------------------------------------------------------------
# Correctness numbers


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want| (0 for two all-zero tensors)."""
    got, want = got.double(), want.double()
    scale = want.abs().max().item() if want.numel() else 0.0
    diff = (got - want).abs().max().item() if want.numel() else 0.0
    return diff / scale if scale > 0 else diff


def mismatches(got: torch.Tensor, want: torch.Tensor) -> int:
    return int((got != want).sum().item())


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              moved: Optional[Dict[str, bool]] = None) -> Dict[str, float]:
    """Each leaf's gap of norms: | |got_l| - |want_l| | over the larger of
    |want_l| and the median leaf's |want|, over the leaves in `moved` (all
    when None)."""
    names = [n for n in want if moved is None or moved.get(n)]
    norms = {n: want[n].double().norm().item() for n in names}
    med = sorted(norms.values())[len(norms) // 2] if norms else 0.0
    return {n: abs(got[n].double().norm().item() - norms[n]) / max(norms[n], med, 1e-300)
            for n in names}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """Every number within its limit (an exact comparison's limit is 0). A
    number the traffic gives no limit is read and not compared: it goes to
    standard error only."""
    checks, ok = {}, True
    for name, value in numbers.items():
        if name not in limits:
            print(f"benchmark: {name} {value!r} (not compared)", file=sys.stderr)
            continue
        limit = limits[name]
        checks[name] = {"value": value, "limit": limit}
        ok = ok and value <= limit
    return ok, checks


def device_info(device: torch.device, chips: int) -> Dict[str, Any]:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"
