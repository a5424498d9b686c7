"""The benchmark's tests: on the CPU at a small size, with the port's plain
kernel versions; `cuda`-marked tests skip without a card (decided inside
the `cuda_device` fixture)."""

from __future__ import annotations

import json
import pathlib
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
REPO = BENCH.parent
for p in (str(BENCH), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

SCENES = {"min_instances": 1, "max_scene_instances": 3, "box_half_extent": [4, 12]}
# 3 classes: the heads' channels and the parameter counts that follow.
CLASSES = {"classes": ["bg", "bottle", "bowl"],
           "head_channels": {"mask": 3, "rotation": 8, "translation": 6, "scales": 6}}
PARAMETERS = {"r18-serve": 18661847, "r18-train-head": 18661847, "r50-train-mask": 33942487}
# Small sizes per driver: 3 classes, 64x64 or 64x96, a few slots and points.
SMALL = {
    "serve": {"config": {"image_height": 64, "image_width": 96, **CLASSES},
              "traffic": {"pool": 3, "max_instances": 4, "max_points": 128,
                          "hypotheses": 256, "warmup_passes": 1, "trace_frames": 2,
                          "scenes": SCENES}},
    "train": {"config": {"image_height": 64, "image_width": 64, **CLASSES},
              "traffic": {"pool": 12, "batch": 2, "max_instances": 4, "max_points": 128,
                          "hypotheses": 32, "trace_steps": 2, "scenes": SCENES}},
}
DRIVER = {"r18-serve": "serve", "r18-train-head": "train", "r50-train-mask": "train"}


def small_run(workload: str, seed: int = 5, device: str = "cpu", *extra: str) -> dict:
    """One run of `workload` at the small size; returns the result line."""
    import run

    args = run.parse(["--workload", workload, "--seed", str(seed), "--seconds", "0.5",
                      "--trace", "0", "--device", device,
                      "--small", json.dumps(small(workload)), *extra])
    return run.run_cell(args, 0.0)


def small(workload: str) -> dict:
    """The `--small` overrides of `workload`."""
    sizes = SMALL[DRIVER[workload]]
    return {"config": dict(sizes["config"], parameters=PARAMETERS[workload]),
            "traffic": sizes["traffic"]}


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
