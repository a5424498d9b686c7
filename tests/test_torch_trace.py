"""The port's tracer (`utils/timer.py`) on the CPU at 32x32 (where the
plain CC labelling of a random network's mask is quick): off it keeps
nothing; under `torch.profiler` a served frame and a HEAD step leave their
span tree, each span a host-side `fpc/` range; the adaptive vote's
confidence reads; the kernels' launch counters; the CLIs' stage report from
a window; and the benchmark's readers of the tracer's window
(`benchmark/metrics/`)."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fastposecnn_tpu_torch import config as C
from fastposecnn_tpu_torch import kernels
from fastposecnn_tpu_torch.data.synthetic import SceneConfig, make_batch
from fastposecnn_tpu_torch.models import PoseRegressorNet
from fastposecnn_tpu_torch.models.weights import init_random_
from fastposecnn_tpu_torch.ops import voting
from fastposecnn_tpu_torch.serve import InferenceServer
from fastposecnn_tpu_torch.train import task
from fastposecnn_tpu_torch.utils import timer

REPO = pathlib.Path(__file__).resolve().parents[1]
SIZES = dict(IMAGE_HEIGHT=32, IMAGE_WIDTH=32, SELECTED_CLASSES=("bg", "bottle", "bowl"),
             MAX_INSTANCES=4, MAX_VOTE_POINTS=128)


@pytest.fixture(scope="module")
def frame():
    """One served frame (single-shot vote; no flag to read on the CPU)."""
    server = InferenceServer(device="cpu", seed=1, HV_NUM_OF_HYPOTHESES=256, **SIZES)
    image = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 3, 32, 32))
                             .astype(np.float32))
    return lambda: server(image)


@pytest.fixture(scope="module")
def step():
    """One HEAD step (adaptive vote) of batch 2."""
    hp = C.head_training(HV_NUM_OF_HYPOTHESES=32, HV_ADAPTIVE=True, BATCH_SIZE=2, **SIZES)
    net = init_random_(PoseRegressorNet(hp.num_classes), 0)
    opt = task.make_optimizer(hp, net)
    state = [task.create_train_state(net, opt)]
    intr = np.array([[60.0, 0, 16], [0, 60.0, 16], [0, 0, 1]])
    train_step = task.make_train_step(net, opt, hp, C.pipeline_config_from(hp),
                                      np.linalg.inv(intr), "cpu")
    batch = make_batch(np.random.default_rng(0), SceneConfig(
        height=32, width=32, num_classes=3, max_instances=4, max_scene_instances=2,
        box_half_extent=(4, 9)), 2)

    def run():
        state[0], logs = train_step(state[0], batch)
        return logs
    return run


def path(window, rec) -> str:
    names = []
    while True:
        names.append(rec.name)
        if rec.parent < 0:
            return "/".join(reversed(names))
        rec = window.spans[rec.parent]


STAGES = {"stages", "stages/class_compress", "stages/aggregate", "stages/vote", "stages/rt"}
TREES = {
    "frame": {"frame", "frame/network"} | {"frame/" + s for s in STAGES},
    "step": ({"step", "step/feed", "step/network", "step/losses", "step/backward",
              "step/optimizer", "step/optimizer/host_read", "step/stages/vote/host_read",
              "step/stages/vote/vote_round"} | {"step/" + s for s in STAGES}),
}


def test_off_keeps_nothing(frame, step, monkeypatch):
    """Off, a frame and a step add nothing to the last window, and only the
    lifetime totals count; while a trace compiles a span is a no-op."""
    with timer.tracing() as window:
        pass
    before = timer.totals().get("vote_rounds", 0)
    frame()
    rounds = int(step()["pose/vote_rounds"])
    assert timer.last_window() is window
    assert window.spans == [] and window.counts == {}
    assert timer.totals()["vote_rounds"] == before + 1 + rounds
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    with timer.tracing() as window:
        with timer.span("frame"):
            pass
    assert window.spans == []


@pytest.mark.parametrize("unit", ["frame", "step"])
def test_span_tree_under_the_profiler(unit, frame, step):
    """The profiler switches the tracer on: a new window holds the unit's
    span tree, and each span is a host-side range `fpc/<name>` (not a user
    annotation, which would have a device-side mirror in a CUDA trace)."""
    assert not timer.enabled()  # and the last window has ended
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = frame() if unit == "frame" else step()
    window = timer.last_window()
    want = TREES[unit]
    if unit == "step":
        rounds = int(out["pose/vote_rounds"])
        assert len(window.named("vote_round")) == rounds
        assert window.counts["host_read/vote_confident"] in (rounds, rounds + 1)
        assert window.counts["host_read/finite"] == 1
        want = want if rounds else want - {"step/stages/vote/vote_round"}
    assert {path(window, r) for r in window.spans} == want
    assert window.units(unit) == 1 and {r.unit for r in window.spans} == {0}
    ranges = [e for e in prof.events() if e.name.startswith("fpc/")]
    assert sorted(e.name for e in ranges) == sorted(
        f"fpc/{r.name}" + (f"/{r.site}" if r.site else "") for r in window.spans)
    assert not any(e.is_user_annotation for e in ranges)


@pytest.mark.parametrize("confidence, max_iter", [(0.99, 20), (1.0, 3)])
def test_vote_confident_reads(confidence, max_iter):
    """Given pairs, the adaptive loop reads its flag before every round and
    once more when it stops on confidence (every point's direction passes
    through its slot's centre, so the first round is confident); at
    `max_iter` it stops without the last read."""
    m, p, h = 2, 32, 16
    gen = torch.Generator().manual_seed(0)
    pts = torch.rand((m, p, 2), generator=gen) * 60
    centre = torch.tensor([[20.0, 30.0], [40.0, 10.0]])[:, None]
    dirs = torch.nn.functional.normalize(centre - pts, dim=-1)
    pairs = torch.stack([torch.randperm(p, generator=gen)[:2 * h].reshape(h, 2)
                         for _ in range(max_iter * m)]).reshape(max_iter, m, h, 2)
    with timer.tracing() as window:
        _, ratio, _, rounds = voting.ransac_vote_centers_adaptive(
            pts, dirs, torch.full((m,), p), torch.ones(m, dtype=torch.bool),
            torch.ones((m, p), dtype=torch.bool), h, confidence=confidence,
            max_iter=max_iter, pairs=pairs)
    assert bool((ratio == 1.0).all())
    assert rounds == (1 if confidence < 1 else max_iter)
    assert window.counts == {"host_read/vote_confident": rounds + (rounds < max_iter)}
    assert len(window.named("vote_round")) == rounds


def test_launch_counters():
    """`kernels.count_launch` counts into the tracer's `launch/<kernel>`:
    lifetime totals that `reset_launch_counts` zeroes, and the window's
    counts while on."""
    kernels.reset_launch_counts()
    kernels.count_launch("cc_label")
    with timer.tracing() as window:
        kernels.count_launch("vote_count")
        kernels.count_launch("vote_count")
    assert kernels.launch_counts() == {"cc_label": 1, "vote_count": 2,
                                       "vote_expanded_mm": 0, "vote_expanded_bcast": 0,
                                       "optim_stats": 0, "optim_update": 0}
    assert window.counts == {"launch/vote_count": 2}
    kernels.reset_launch_counts()
    assert set(kernels.launch_counts().values()) == {0}
    with pytest.raises(KeyError):
        kernels.count_launch("not_a_kernel")


def synthetic_window() -> timer.Window:
    """Two frames and four steps, with host-clock spans of whole ms."""
    window = timer.Window()

    def add(name, ms, site=None):
        rec = timer.SpanRecord(name, site, -1, -1)
        rec.end_ns = int(ms * 1e6)
        window.spans.append(rec)

    for _ in range(2):
        add("frame", 10)
    for _ in range(4):
        add("step", 100)
        add("backward", 4)
    for ms in (3, 5):
        add("losses", ms)
    for ms in (2, 6):
        add("optimizer", ms)
    for site in ("finite", "vote_confident", "cc_flag"):
        add("host_read", 1, site)
    window.counts = {"host_read/finite": 2, "host_read/vote_confident": 5,
                     "launch/cc_label": 2, "vote_rounds": 9}
    return window


def test_stage_report():
    """The CLIs' stage report reads the spans that no other span encloses,
    leaves out the first (warm-up) call when there are more, and names only
    the stages that ran."""
    window = timer.Window()
    for ms, parent in ((50, -1), (10, -1), (30, 1), (20, -1), (5, -1)):
        rec = timer.SpanRecord("network" if ms != 5 else "rt", None, parent, -1)
        rec.end_ns = int(ms * 1e6)
        window.spans.append(rec)
    ms = timer.stage_ms(window, {"model": "network", "rt_calculation": "rt", "errors": "errors"})
    assert ms == pytest.approx({"model": 15.0, "rt_calculation": 5.0})
    assert timer.report_runtime(ms).splitlines() == [
        "model: 15.000 ms - 66.7 fps", "rt_calculation: 5.000 ms - 200.0 fps"]


@pytest.mark.parametrize("name, value", [
    ("host_reads.serve", 3.5), ("host_reads.train", 1.75),
    ("read_wait_ms.serve", 1.5), ("read_wait_ms.train", 0.75),
    ("losses_ms.train", 2.0), ("optimizer_ms.train", 2.0), ("backward_ms.train", 4.0)])
def test_benchmark_readers(name, value, monkeypatch):
    """Each reader of the tracer's last window: None with no window or no
    unit, else its total over the window's frames or steps."""
    spec = importlib.util.spec_from_file_location(
        f"metric_{name.replace('.', '_')}", REPO / "benchmark" / "metrics" / f"{name}.py")
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    monkeypatch.setattr(timer, "_window", None)
    assert reader.read(None) is None
    monkeypatch.setattr(timer, "_window", timer.Window())
    assert reader.read(None) is None
    monkeypatch.setattr(timer, "_window", synthetic_window())
    assert reader.read(None) == pytest.approx(value)
