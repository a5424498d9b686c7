"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (into
fastposecnn_tpu_torch/_build/, reused by a later run), holds each kernel
against its plain PyTorch version, runs a crafted scene through the
INFERENCE pipeline, runs the EVALUATING preset (adaptive RANSAC, matching,
float64 errors) on perfect logits of synthetic scenes through the kernels
and through their plain versions, holds the vote-variant probe's kernels
(P1 on the tensor cores, P2 on the CUDA cores) against their plain versions
and the rounding band, serves a few full-width requests through
`InferenceServer`, evaluates a few synthetic scenes through the evaluate
CLI, runs the probe (`probes/vote_variants.py`) and the held-out recipe
of BASELINE.md with the trained FULL_c5 checkpoint, and trains at full
width: 8 MASK_TRAINING and 6 HEAD_TRAINING steps (the paths: the kernels'
launch counters are reset just before each and read just after), holds a
HEAD_TRAINING step through the kernels against one through their plain
versions and a reduced-size step on the card against the CPU, runs the
train CLI for 2 full-width HEAD_TRAINING epochs on augmented synthetic
scenes written as NOCS folders (checkpoints, a full resume and a
weights-only resume, the native augmentation against numpy on the card's
host), runs its device-resident staged trainer for 3 full-width epochs
that restage onto fresh scene banks of a rotating pool (verified uploads,
checkpoint flushes, a batch gathered on the card against the host
collate, the PNG decode native and numpy), measures what TF32
would change in the network (and checks that the entry points' float32
does not reuse a convolution algorithm that cuDNN's heuristics chose
outside them), checks that a served frame enqueues with
no host sync until it reads the CC kernel's error flag at its end, serves
the same requests with the resnet34 and resnet50 encoders (K1 and K2 once
a frame; each network's logits on the card against the CPU's) and with
soft voting (K1 once a frame, K2 never; oracle centres within 1.5 px; the
soft vote on the card against the CPU), holds vanishing-point voting on
the card against the CPU, trains resnet50 at full width (HEAD_TRAINING
steps, a step through the kernels against their plain versions, one
epoch of the train CLI with `--ENCODER resnet50`), trains data-parallel
(two ranks that share the card over gloo, each a process with its rows of
a global batch of 4, held against the same 3 full-width HEAD_TRAINING
steps in one process; one NCCL rank held against one step), trains
tensor-parallel (four ranks laid out dp 2 x tp 2 that share the card over
gloo, the 59 wide convolutions' output channels and their optimizer state
split over each tp pair, held against the same single-process steps,
every rank's replicated tensors bit-equal), exports the
served pipeline with `torch.export` (K1 and K2 as the custom ops
`fastposecnn::cc_label` and `fastposecnn::vote_count`) and answers the
served requests from the `.pt2` loaded in a fresh process, against
`InferenceServer` on the same draws (and the adaptive vote loop exported
as one `while_loop`), prepares a raw NOCS tree of rendered frames with
known poses through the `create_meta` CLI, records which of cv2,
matplotlib, pandas and PIL the machine has and holds the figures' and
tables' refusals or output, traces the inference CLI (`--trace`), serves
the requests with a bfloat16 network (`InferenceServer(compute_dtype=
"bfloat16")`: its logits held against the CPU's bf16 network stage by
stage, its frames beside the float32 server's), trains with the bfloat16
network the train loop builds on the card (MASK and HEAD steps beside
float32 ones, a reduced-size step against the CPU's bf16 step, one epoch
of the train CLI with the default COMPUTE_DTYPE), and
times the kernels at the served and the evaluated shapes (K1 beside its
floor: its launches with empty kernels), their plain versions, the
adaptive loop's host syncs, 30 served frames, and what a host sync right
after K1 cost the frame, the train steps of each preset with the
share of a HEAD_TRAINING step spent voting, the served frame of each
encoder and of soft voting (with the share spent in its
`hypothesis_weights`) and resnet50's train step, with CUDA events. Everything runs
in full float32 (TF32 off), as the port's entry points compute, but for
the network's TF32 timing, which sets the flags around a direct call, and
the two bfloat16 phases; the phases that go through the trainers pass
`--COMPUTE_DTYPE float32`.

Every phase prints one flushed JSON line before the next begins. Any failure
prints a traceback to stderr and exits non-zero; only a run in which every
phase passed ends with the line
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
A watchdog dumps every thread's stack and exits non-zero after 900 s.

    python3 chip_smoke.py --tp-algorithms

runs only `train_tp`'s steps, with cuDNN's algorithms chosen by each rank's
timing and with the port's deterministic heuristics, each against one
process (`tp_algorithms_check`).
"""

import contextlib
import dataclasses
import faulthandler
import io
import json
import math
import pathlib
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import warnings

import numpy as np
import torch

from fastposecnn_tpu_torch.utils.timer import (
    FP32_UNFUSED_OPS_PER_S,
    HBM_BYTES_PER_S,
    event_ms,
    kernel_trace,
    loop_ms,
    median_ms,
)

WATCHDOG_S = 900
H, W = 480, 640
# FP32 arithmetic per (m, h, p) cell of the vote count: 2 sub, 6 mul, 3 add.
VOTE_FLOPS_PER_CELL = 11
# The kernels the served frame and the evaluated batch run.
PATH_KERNELS = ("cc_label", "vote_count")
# The held-out recipe (BASELINE.md:22-29) through the port on the CPU, in
# float32: 261 matched instances, pooled geodesic mean in degrees
# (`python -m fastposecnn_tpu_torch.cli.evaluate --device cpu` with the
# arguments of `phase_held_out`). The card's float32 mean lies a few 1e-6
# degrees from it, its TF32 mean about 4e-3 away (PERF.md): the tolerance
# lies between, so that a network run in TF32 fails the phase.
HELD_OUT_CKPT = "evidence/rot_demo/ckpt_FULL_c5.npz"
HELD_OUT_CPU_INSTANCES = 261
HELD_OUT_CPU_MEAN_DEG = 22.201571812990487
HELD_OUT_TOL_DEG = 2e-4


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def set_tf32(matmul, cudnn):
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn


def paired_ms(fn_a, fn_b, pairs=10):
    """CUDA-event times of fn_a and fn_b in `pairs` interleaved pairs, the
    order alternating (a b, b a, ...), so that a drift of the host's speed
    falls on both. Returns the two lists of ms."""
    fn_a(), fn_b()
    torch.cuda.synchronize()
    times = ([], [])
    for i in range(pairs):
        order = (0, 1) if i % 2 == 0 else (1, 0)
        for k in order:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            (fn_a, fn_b)[k]()
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end))
    return times


# -----------------------------------------------------------------------------
# Inputs


def cc_masks(dev):
    """Masks for the CC kernel. At 480x640: filled ellipses, a thick and a
    thin serpentine with many U-turns, >1000 small components, random noise,
    a comb of one-pixel teeth, empty and all-foreground, and the masks that
    cross the kernel's 32x32 tile edges (`tests/cc_masks.py`, which the CPU
    tests hold against JAX: a one-pixel spiral, squares touching diagonally
    at tile corners, a lattice on the tile edges, lines in the first and
    last column, one pixel a tile); two batches of 2, the evaluated shape
    (3x480x640) and the held-out shape (8x224x320, the tile-edge masks,
    noise, full and empty)."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "tests"))
    from cc_masks import tile_edge_masks

    ys, xs = np.mgrid[0:H, 0:W]
    ellipses = np.zeros((H, W), bool)
    for cx, cy, ax, ay in [(120, 100, 90, 50), (400, 120, 60, 80),
                           (300, 330, 150, 70), (560, 400, 50, 50)]:
        ellipses |= ((xs - cx) / ax) ** 2 + ((ys - cy) / ay) ** 2 <= 1.0

    def serpentine(thick):
        m = np.zeros((H, W), bool)
        period = 2 * thick
        for i, r in enumerate(range(0, H - thick + 1, period)):
            m[r:r + thick, :] = True
            if r + period < H:
                col = slice(W - thick, W) if i % 2 == 0 else slice(0, thick)
                m[r + thick:r + period, col] = True
        return m

    dots = np.zeros((H, W), bool)
    dots[1::4, 1::4] = True
    dots[2::4, 1::4] = True  # 19200 components of 2 pixels
    noise = np.random.default_rng(0).random((H, W)) > 0.55
    comb = np.zeros((H, W), bool)
    comb[:, ::2] = True  # 320 one-pixel teeth joined by the bottom row
    comb[-1] = True
    masks = {
        "ellipses": ellipses,
        "serpentine_thick": serpentine(8),
        "serpentine_thin": serpentine(1),
        "small_components": dots,
        "noise": noise,
        "comb": comb,
        "empty": np.zeros((H, W), bool),
        "full": np.ones((H, W), bool),
        **tile_edge_masks(H, W),
    }
    batches = {f"{k}_b1": v[None] for k, v in masks.items()}
    batches["ellipses+serpentine_b2"] = np.stack([ellipses, serpentine(1)])
    batches["dots+full_b2"] = np.stack([dots, np.ones((H, W), bool)])
    batches["spiral+lattice+noise_b3"] = np.stack(
        [masks["spiral"], masks["edge_lattice"], noise])
    h, w = 224, 320
    batches["held_out_shape_b8"] = np.stack(
        [*tile_edge_masks(h, w).values(), np.random.default_rng(1).random((h, w)) > 0.55,
         np.ones((h, w), bool), np.zeros((h, w), bool)])
    return {k: torch.from_numpy(v).to(dev) for k, v in batches.items()}


def vote_inputs(dev, m, h, p, n_active, seed, active=None):
    """Points around a centre per slot with noisy directions at it, and
    hypotheses scattered near the centre (so counts are large and tie).
    The first `n_active` slots are active, or those of the bool `active`."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform([50, 50], [W - 50, H - 50], size=(m, 1, 2))
    pts = np.floor(centre + rng.uniform(-80, 80, size=(m, p, 2)))
    d = centre - pts + rng.normal(scale=3.0, size=(m, p, 2))
    dirs = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-6)
    hyps = centre + np.round(rng.normal(scale=4.0, size=(m, h, 2)) * 2) / 2
    if active is None:
        active = np.arange(m) < n_active
    pvalid = (rng.random((m, p)) > 0.2) & active[:, None]
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)  # noqa: E731
    return (f(hyps), f(pts), f(dirs), f(pvalid),
            torch.from_numpy(active).to(dev))


def known_scene(dev, num_classes=7):
    """Crafted NCHW logits: 6 objects (discs and ellipses) of classes 1..6,
    each with its quaternion, a noisy xy field pointing at a known centre, a
    constant log-depth and constant scales. Returns (logits, objects)."""
    cm1 = num_classes - 1
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    mask = np.full((num_classes, H, W), -10.0, np.float32)
    mask[0] = 10.0
    quat = np.zeros((4 * cm1, H, W), np.float32)
    xy = np.zeros((2 * cm1, H, W), np.float32)
    z = np.zeros((cm1, H, W), np.float32)
    scales = np.zeros((3 * cm1, H, W), np.float32)
    rng = np.random.default_rng(1)
    objects = []
    specs = [(1, 110.5, 100.25, 60, 60), (2, 330.25, 110.5, 90, 50),
             (3, 540.5, 120.5, 55, 75), (4, 120.25, 350.5, 70, 45),
             (5, 330.5, 360.25, 50, 50), (6, 530.25, 350.5, 80, 60)]
    for cls, cx, cy, ax, ay in specs:
        inside = ((xs - cx) / ax) ** 2 + ((ys - cy) / ay) ** 2 <= 1.0
        k = cls - 1
        mask[0][inside] = -10.0
        mask[cls][inside] = 10.0
        q = rng.normal(size=4).astype(np.float32)
        q /= np.linalg.norm(q)
        quat[4 * k:4 * k + 4, inside] = q[:, None]
        dx, dy = cx - xs, cy - ys
        nrm = np.sqrt(dx * dx + dy * dy)
        noise = rng.normal(scale=0.05, size=(2, H, W)).astype(np.float32)
        xy[2 * k][inside] = (dx / nrm + noise[0])[inside]
        xy[2 * k + 1][inside] = (dy / nrm + noise[1])[inside]
        z_mm = 700.0 + 150.0 * k
        z[k][inside] = np.log(z_mm)
        scales[3 * k:3 * k + 3, inside] = 0.1 * cls
        root = int(np.flatnonzero(inside.reshape(-1))[0])
        objects.append(dict(cls=cls, centre=(cx, cy), z=z_mm, root=root))
    logits = {"mask": mask, "quaternion": quat, "xy": xy, "z": z,
              "scales": scales}
    logits = {k: torch.from_numpy(v)[None].to(dev) for k, v in logits.items()}
    return logits, sorted(objects, key=lambda o: o["root"])


# -----------------------------------------------------------------------------
# Phases


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    return kind, smi


def phase_build():
    from fastposecnn_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.load_library()
    info = build.build_info
    emit("build", seconds=time.perf_counter() - t0, reused=info["reused"],
         library=info["library"], nvcc=info["nvcc_version"])
    # `nvcc -Xptxas -v`: each kernel's registers, shared memory and spills.
    emit("ptxas", kernels=info["ptxas"])


def phase_cc_kernel(dev):
    from fastposecnn_tpu_torch.ops.connected_components import (
        label_components_cuda,
        label_components_reference,
    )

    results, max_err = {}, 0.0
    for name, fg in cc_masks(dev).items():
        got = label_components_cuda(fg)
        want = label_components_reference(fg)
        torch.cuda.synchronize()
        max_err = max(max_err, float((got.long() - want.long()).abs().max()))
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"cc_label differs from its plain version on "
                                 f"'{name}' at {bad} pixels")
        hw = want.shape[1] * want.shape[2]
        n_comp = int((want.reshape(want.shape[0], -1)
                      == torch.arange(hw, device=dev)).sum())
        results[name] = n_comp
    if results["small_components_b1"] <= 1000:
        raise AssertionError("the small-components mask has too few components")
    emit("cc_kernel", tolerance="exact", max_abs_err=max_err, components=results)
    return max_err


def scattered_slots(m, n_active, seed):
    """A bool [m] mask of `n_active` slots drawn at random: evaluated slots
    need not be a prefix (active = valid & npts >= 5)."""
    active = np.zeros(m, bool)
    active[np.random.default_rng(seed).choice(m, n_active, replace=False)] = True
    return active


def phase_vote_kernel(dev):
    """K2 against its plain version at the main-path shapes and at the edges
    of its partition (hypotheses in blocks, points split over warps and
    staged in 1024-point tiles): H and P below one warp split, H one past a
    block, P beyond one or two tiles, one hypothesis and one point, no
    active slot and active slots that are not a prefix."""
    from fastposecnn_tpu_torch.ops.voting import (
        vote_counts_cuda,
        vote_counts_reference,
    )

    # name: (M, H, P, active slots: a count of leading slots or a mask,
    # whether some count must be nonzero)
    shapes = {
        "main": (16, 4096, 1024, 8, True),
        "padding": (5, 1000, 777, 4, True),
        "eval_scattered": (64, 1000, 1024, scattered_slots(64, 15, seed=64), True),
        "one_by_one": (3, 1, 1, 2, False),
        "below_warp_split": (2, 33, 31, 2, True),
        "past_block_and_tile": (7, 129, 2048, 5, True),
        "past_block_and_tile_wide": (9, 1921, 2100, 7, True),
        "none_active": (4, 256, 512, 0, False),
    }
    out, max_err = {}, 0.0
    for name, (m, h, p, act_spec, votes) in shapes.items():
        if isinstance(act_spec, np.ndarray):
            inputs = vote_inputs(dev, m, h, p, 0, seed=m, active=act_spec)
        else:
            inputs = vote_inputs(dev, m, h, p, act_spec, seed=m)
        hyps, pts, dirs, pv, act = inputs
        got = vote_counts_cuda(hyps, pts, dirs, pv, 0.999, active=act)
        want = vote_counts_reference(hyps, pts, dirs, pv, 0.999, active=act)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            raise AssertionError(f"vote_count differs from its plain version at "
                                 f"{name} {m}x{h}x{p}: max abs err {err}")
        if (votes and float(got.max()) <= 0) or got[~act].any():
            raise AssertionError(f"vote_count {name}: no votes, or votes in "
                                 "an inactive slot")
        out[name] = dict(shape=[m, h, p], active=int(act.sum()),
                         max_count=float(got.max()))
    emit("vote_kernel", tolerance="exact", max_abs_err=max_err, shapes=out)
    return max_err


def phase_vote_variants(dev):
    """The vote-variant probe's kernels against their plain versions on the
    TPU script's inputs (`make_inputs`, seed 0) at its shape, at K2's
    evaluated shape and at the edges of their tiles (`EDGE_CASES`: H not a
    multiple of 64, M = 1, a slot with no valid point, valid counts that are
    no multiple of a tile): P2 exactly equal, P1 inside the rounding band
    derived for 3xTF32. At the two full shapes P2 and the plain P1 also lie
    inside the float32 band, and P1's counts that differ from its plain
    version's are counted. Returns each kernel's largest difference from its
    plain version."""
    from fastposecnn_tpu_torch.probes import vote_variants as V

    full = ("script", "eval")
    out, errs = {}, {"vote_expanded_mm": 0.0, "vote_expanded_bcast": 0.0}
    for name, (m, h, p) in V.EDGE_CASES.items():
        args = [torch.from_numpy(a).to(dev) for a in V.edge_inputs(name)]
        p1 = V.vote_counts_expanded_mm_cuda(*args)
        p2 = V.vote_counts_expanded_bcast_cuda(*args)
        plain1 = V.vote_counts_expanded_mm_reference(*args)
        plain2 = V.vote_counts_expanded_bcast_reference(*args)
        lo, hi = V.expanded_vote_band(*args, c=V.BAND_C_3XTF32)
        torch.cuda.synchronize()
        p1_err = float((p1 - plain1).abs().max())
        errs["vote_expanded_mm"] = max(errs["vote_expanded_mm"], p1_err)
        if not torch.equal(p2, plain2):
            raise AssertionError(f"vote_expanded_bcast differs from its plain version "
                                 f"at {name} {m}x{h}x{p}")
        if not bool(((lo <= p1) & (p1 <= hi)).all()):
            raise AssertionError(f"vote_expanded_mm leaves the 3xTF32 band at {name}")
        line = dict(shape=[m, h, p], valid_points=int((args[3] != 0).sum()),
                    max_count=float(plain2.max()),
                    p1_vs_plain_max_abs=p1_err,
                    p1_vs_plain_cells=int((p1 != plain1).sum()),
                    band_3xtf32_width_mean=float((hi - lo).mean()))
        if name in full:
            lo8, hi8 = V.expanded_vote_band(*args, c=V.BAND_C_FP32)
            in8 = {k: bool(((lo8 <= x) & (x <= hi8)).all())
                   for k, x in (("p1", p1), ("p2", p2), ("plain_p1", plain1))}
            if not (in8["p2"] and in8["plain_p1"]):
                raise AssertionError(f"float32 counts leave the float32 band at {name}: {in8}")
            line.update(in_fp32_band=in8, band_fp32_width_mean=float((hi8 - lo8).mean()))
        out[name] = line
    emit("vote_variants", tolerance=dict(vote_expanded_bcast="exact",
                                         vote_expanded_mm="inside expanded_vote_band, c = 32"),
         max_abs_err=errs, shapes=out)
    return errs


def phase_known_scene(dev):
    from fastposecnn_tpu_torch import config as C
    from fastposecnn_tpu_torch import constants, kernels
    from fastposecnn_tpu_torch.pipeline import run_pipeline

    logits, objects = known_scene(dev)
    cfg = C.pipeline_config_from(C.inference())
    inv_K = torch.tensor(np.linalg.inv(constants.scaled_intrinsics("CAMERA", H, W)),
                         dtype=torch.float32, device=dev)

    def run(impl):
        gen = torch.Generator(dev).manual_seed(5)
        cpu_gen = torch.Generator().manual_seed(5)
        with torch.inference_mode():
            return run_pipeline(logits, dataclasses.replace(cfg, impl=impl),
                                inv_K, generator=gen, cpu_generator=cpu_gen)

    kernels.reset_launch_counts()
    out = run(None)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    agg = out["aggregated"]
    n = len(objects)
    want_ids = [o["cls"] for o in objects] + [0] * (cfg.max_instances - n)
    got_ids = agg["class_ids"][0].tolist()
    if got_ids != want_ids:
        raise AssertionError(f"class ids {got_ids} != {want_ids}")
    centres = agg["xy"][0, :n].cpu().numpy()
    want_c = np.array([o["centre"] for o in objects])
    centre_err = np.linalg.norm(centres - want_c, axis=-1)
    if not (centre_err < 1.0).all():
        raise AssertionError(f"voted centres off by {centre_err.tolist()} px")
    z_err = np.abs(agg["z"][0, :n].cpu().numpy() / [o["z"] for o in objects] - 1)
    if not torch.isfinite(agg["RT"]).all() or z_err.max() > 1e-4:
        raise AssertionError("RT not finite or z wrong")
    if min(launches[k] for k in PATH_KERNELS) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    if float(agg["win_ratio"].max()) <= 0:
        raise AssertionError("no votes on the known scene")

    ref = run("reference")
    torch.cuda.synchronize()
    ra = ref["aggregated"]
    exact = {
        "mask": (out["categorical"]["mask"], ref["categorical"]["mask"]),
        "cc_labels": (agg["cc_labels"], ra["cc_labels"]),
        "hypothesis": (agg["hypothesis"], ra["hypothesis"]),
        "win_ratio": (agg["win_ratio"], ra["win_ratio"]),
        "class_ids": (agg["class_ids"], ra["class_ids"]),
    }
    for key, (a, b) in exact.items():
        if not torch.equal(a, b):
            raise AssertionError(f"known scene: '{key}' differs between the "
                                 "kernels and the plain versions")
    close_err = {}
    for key in ("xy", "z", "RT"):
        torch.testing.assert_close(agg[key], ra[key], atol=2e-4, rtol=1e-4)
        close_err[key] = float((agg[key] - ra[key]).abs().max())
    emit("known_scene", objects=n, class_ids=got_ids[:n],
         centre_err_px=centre_err.tolist(), max_win_ratio=float(agg["win_ratio"].max()),
         launches=launches, vs_reference=dict(exact=list(exact), max_abs_err=close_err,
                                              atol=2e-4, rtol=1e-4))


def served_images(dev, requests):
    """The serve phase's seeded random 480x640 requests."""
    gen = torch.Generator(dev).manual_seed(123)
    return [torch.randn((1, 3, H, W), generator=gen, device=dev) for _ in range(requests)]


def check_answers(answers):
    for mask, class_ids, xy, z, RT in answers:
        shapes = [tuple(t.shape) for t in (mask, class_ids, xy, z, RT)]
        if shapes != [(1, H, W), (1, 16), (1, 16, 2), (1, 16), (1, 16, 4, 4)]:
            raise AssertionError(f"served shapes {shapes}")
        if not all(bool(torch.isfinite(t).all()) for t in (xy, z, RT)):
            raise AssertionError("served outputs are not finite")


def phase_serve(dev, requests=5):
    """The main path: `InferenceServer` at full width answers `requests`
    seeded random 480x640 images with seeded random weights. The caller
    leaves both TF32 flags on, and the network must run with both off."""
    from fastposecnn_tpu_torch import kernels
    from fastposecnn_tpu_torch.serve import InferenceServer

    server = InferenceServer(device="cuda", seed=0)
    images = served_images(dev, requests)
    seen = []  # the TF32 and cuDNN flags at each call of the network
    hook = server.net.register_forward_pre_hook(lambda *_: seen.append(
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic)))
    torch.cuda.synchronize()
    set_tf32(True, True)
    kernels.reset_launch_counts()
    answers = [server(img) for img in images]
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    set_tf32(False, False)
    hook.remove()
    if seen != [(False, False, True, True)] * requests:
        raise AssertionError(f"the served frames ran the network with flags {seen}")
    check_answers(answers)
    if min(launches[k] for k in PATH_KERNELS) < requests:
        raise AssertionError(f"the main path skipped a kernel: {launches}")
    emit("serve", requests=requests, launches=launches,
         valid_instances=[int((a[1] > 0).sum()) for a in answers],
         tf32_of_caller=dict(matmul=True, cudnn=True),
         in_network=dict(tf32_matmul=False, tf32_cudnn=False, cudnn_benchmark=True,
                         cudnn_deterministic=True))
    return server, images[0], launches


def phase_sync_check(server, image):
    """The served frame enqueues without a host sync until its final flag
    read: `InferenceServer.enqueue` (every stage of `__call__` but that
    read) on a device-resident image under
    `torch.cuda.set_sync_debug_mode("error")`. If anything syncs, the same
    call in "warn" mode names every place that did, and the phase fails."""
    from fastposecnn_tpu_torch.ops.connected_components import raise_on_error_flag

    torch.cuda.synchronize()
    failure = None
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, cc_error = server.enqueue(image)
    except RuntimeError as e:
        failure = f"{e} at {traceback.extract_tb(e.__traceback__)[-1]}"
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if failure is not None:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                server.enqueue(image)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        sites = sorted({f"{w.filename}:{w.lineno}" for w in caught})
        raise AssertionError(f"the served frame syncs before its flag read: {failure}; "
                             f"every sync: {sites}")
    raise_on_error_flag(cc_error)
    emit("sync_check", mode="error", synced=False, stages="InferenceServer.enqueue",
         image_on=str(image.device))


def oracle_batch(dev, scenes=4):
    """`scenes` synthetic 480x640 scenes (up to 6 boxes each, 16 instance
    slots) with perfect logits, as the JAX oracle test builds them
    (tests/test_pipeline.py): NCHW logits, the GT instances and inv(K)."""
    from fastposecnn_tpu_torch.data.synthetic import (
        SceneConfig,
        generate_scene,
        perfect_logits,
        to_nchw,
    )

    cfg = SceneConfig(height=H, width=W, max_instances=16, max_scene_instances=6)
    rng = np.random.default_rng(7)
    t0 = time.perf_counter()
    batch = [generate_scene(rng, cfg) for _ in range(scenes)]
    seconds = time.perf_counter() - t0
    logits = [to_nchw(perfect_logits(sc, cfg.num_classes)) for sc in batch]
    logits = {k: torch.from_numpy(np.concatenate([lg[k] for lg in logits])).to(dev)
              for k in logits[0]}
    gts = {k: torch.from_numpy(np.stack([sc["agg"][k] for sc in batch])).to(dev)
           for k in batch[0]["agg"]}
    inv_K = torch.tensor(np.linalg.inv(batch[0]["intrinsics"]), dtype=torch.float32,
                         device=dev)
    return logits, gts, inv_K, seconds


def eval_draws(dev, b, n, p, h, max_iter, seed):
    """One fixed set of draws for the bbox sampler and every adaptive round."""
    from fastposecnn_tpu_torch.ops.voting import VoteDraws

    gen = torch.Generator(dev).manual_seed(seed)
    return VoteDraws(
        ux=torch.rand((b, n, p), generator=gen, device=dev),
        uy=torch.rand((b, n, p), generator=gen, device=dev),
        pairs=torch.randint(0, p, (max_iter, b * n, h, 2), generator=gen, device=dev))


def raw_errors(matched):
    """Float64 errors of the matched GT slots, as phase A of the evaluate
    CLI computes them."""
    from fastposecnn_tpu_torch.cli.evaluate import instance_errors

    m = {k: v.cpu().numpy() for k, v in matched.items()}
    return {k: v[m["valid"]] for k, v in instance_errors(m).items()}


def phase_eval_oracle(dev):
    """The EVALUATING preset at full width (480x640, 7 classes, 16 slots,
    1024 points, 1000 hypotheses, adaptive to confidence 0.99 within 20
    rounds) on perfect logits of 4 synthetic scenes: post-network stages,
    matching and the float64 errors, once through the kernels and once
    through their plain versions on the same draws. Everything must be
    exactly equal, and meet the JAX oracle test's thresholds."""
    from fastposecnn_tpu_torch import config as C
    from fastposecnn_tpu_torch import kernels
    from fastposecnn_tpu_torch.ops.matching import gather_matched, match_instances
    from fastposecnn_tpu_torch.ops.voting import slot_confident
    from fastposecnn_tpu_torch.pipeline import run_pipeline

    logits, gts, inv_K, scene_s = oracle_batch(dev)
    emit("eval_oracle_scenes", scenes=int(gts["valid"].shape[0]), seconds=scene_s)
    hp = C.evaluating()
    cfg = C.pipeline_config_from(hp)
    b, n = gts["valid"].shape[0], cfg.max_instances
    draws = eval_draws(dev, b, n, cfg.max_points, cfg.hv_num_hypotheses,
                       cfg.hv_max_iter, seed=11)
    gts["instance_masks"] = gts["instance_masks"].float()

    def run(impl):
        with torch.inference_mode():
            t0 = time.perf_counter()
            out = run_pipeline(logits, dataclasses.replace(cfg, impl=impl), inv_K,
                               draws=draws)
            agg = out["aggregated"]
            match = match_instances(agg, gts)
            matched = gather_matched(agg, gts, match)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        return out, match, matched, raw_errors(matched), seconds

    kernels.reset_launch_counts()
    out, match, matched, errs, k_s = run(None)
    launches = kernels.launch_counts()
    ref, r_match, _, r_errs, r_s = run("reference")
    agg, ra = out["aggregated"], ref["aggregated"]

    rounds = agg["vote_rounds"]
    if rounds != ra["vote_rounds"]:
        raise AssertionError(f"rounds {rounds} (kernels) != {ra['vote_rounds']} (plain)")
    if launches["cc_label"] != 1 or launches["vote_count"] != rounds:
        raise AssertionError(f"launches {launches}, rounds {rounds}")
    for key, a, r in (("win_ratio", agg["win_ratio"], ra["win_ratio"]),
                      ("hypothesis", agg["hypothesis"], ra["hypothesis"]),
                      ("cc_labels", agg["cc_labels"], ra["cc_labels"]),
                      ("pred_idx", match["pred_idx"], r_match["pred_idx"]),
                      ("match_valid", match["valid"], r_match["valid"])):
        if not torch.equal(a, r):
            raise AssertionError(f"eval_oracle: '{key}' differs between the kernels "
                                 "and the plain versions")
    for key in errs:
        if not np.array_equal(errs[key], r_errs[key]):
            raise AssertionError(f"eval_oracle: raw '{key}' errors differ")

    n_gt = int(gts["valid"].sum())
    iou = match["iou"][gts["valid"]]
    deg5_ap = 100.0 * float((errs["degree_error"] < 5.0).mean())
    checks = {
        "every_gt_matched": int(matched["valid"].sum()) == n_gt,
        "mask_iou_1": bool(torch.allclose(iou, torch.ones_like(iou), atol=1e-6)),
        "rotation_ap_5deg_100": deg5_ap == 100.0,
        "offset_below_0.1cm": bool((errs["offset_error"] < 0.1).all()),
    }
    if not all(checks.values()):
        raise AssertionError(f"eval_oracle thresholds: {checks}, errors "
                             f"{ {k: v.tolist() for k, v in errs.items()} }")

    # The exit test on the card against the CPU on every win ratio a vote of
    # at most 1024 points can reach (the CPU tests hold the CPU against JAX).
    d = torch.cat([torch.full((k + 1,), k) for k in range(1, 1025)]).float()
    c = torch.cat([torch.arange(k + 1) for k in range(1, 1025)]).float()
    ratios = torch.unique(c / d)
    exit_diff = 0
    for r in range(cfg.hv_max_iter + 1):
        for h in (cfg.hv_num_hypotheses, 128):
            on_gpu = slot_confident(ratios.to(dev), r, h, cfg.hv_confidence).cpu()
            exit_diff += int((on_gpu != slot_confident(ratios, r, h,
                                                       cfg.hv_confidence)).sum())
    if exit_diff:
        raise AssertionError(f"the exit test decides differently on the card "
                             f"for {exit_diff} (ratio, rounds, H)")
    emit("eval_oracle", preset=dict(hw=[H, W], classes=hp.num_classes,
                                    max_instances=n, points=cfg.max_points,
                                    hypotheses=cfg.hv_num_hypotheses,
                                    confidence=cfg.hv_confidence,
                                    max_iter=cfg.hv_max_iter),
         batch=b, gt_instances=n_gt, active_slots=int(agg["valid"].sum()),
         launches=launches, rounds=rounds, thresholds=checks,
         worst_errors={k: float(v.min() if k == "3d_iou" else v.max())
                       for k, v in errs.items()},
         exact_vs_plain=["rounds", "win_ratio", "hypothesis", "cc_labels",
                         "pred_idx", "match_valid"] + sorted(errs),
         exit_test_ratios_checked=int(ratios.numel()),
         seconds=dict(kernels=k_s, plain=r_s))
    return dict(out=out, draws=draws, launches=launches, rounds=rounds)


def phase_evaluate(dev, scenes=9):
    """The port's evaluate CLI (`cli.evaluate.main`) on `scenes` in-memory
    480x640 synthetic scenes with seeded random weights, into a temporary
    directory; the kernels' launch counts of its phase A."""
    import contextlib
    import io
    import tempfile

    from fastposecnn_tpu_torch import kernels
    from fastposecnn_tpu_torch.cli import evaluate

    with tempfile.TemporaryDirectory(prefix="fpcnn_eval_") as out_dir:
        argv = ["--synthetic", str(scenes), "--output", out_dir, "--device", "cuda",
                "--synthetic_seed", "5", "--vote_seed", "0"]
        printed = io.StringIO()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with contextlib.redirect_stdout(printed):
            summary = evaluate.main(argv)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
    if min(launches[k] for k in PATH_KERNELS) < 1:
        raise AssertionError(f"phase A skipped a kernel: {launches}")
    if summary["frames"] != scenes:
        raise AssertionError(f"evaluated {summary['frames']} of {scenes} scenes")
    lines = printed.getvalue().splitlines()
    emit("evaluate_scenes", scenes=scenes, seconds=summary["scene_seconds"])
    emit("evaluate", frames=summary["frames"], batches=summary["batches"],
         seconds=summary["seconds"],
         frames_per_s=summary["frames_per_s"],
         frames_per_s_after_first_batch=summary["frames_per_s_after_first_batch"],
         vote_rounds=summary["vote_rounds"],
         stage_ms=summary["stage_ms"], launches=launches,
         summary_lines=[ln for ln in lines if ln.startswith(("phase", "3D-IoU", "rotation"))])
    return summary, launches


def vote_bound(pv, act32, h, tensors):
    """K2's least time: unfused FP32 operations on the cells of the active
    slots' valid points (a point with pv = 0 adds nothing, and the kernel
    skips it), or the bytes of its inputs and output, whichever is larger."""
    cells = int(((pv != 0) & (act32 != 0)[:, None]).sum()) * h
    op_s = cells * VOTE_FLOPS_PER_CELL / FP32_UNFUSED_OPS_PER_S
    byte_s = sum(t.numel() * t.element_size() for t in tensors) / HBM_BYTES_PER_S
    return max(op_s, byte_s) * 1e3, "operations" if op_s >= byte_s else "bytes"


def time_vote(dev, lib, smi, name, hyps, pts, dirs, pv, act32):
    """K2 through its C entry point on these inputs: ms per launch (CUDA
    events around 50 back-to-back launches), the plain version's ms, the
    bound and the device time per CUDA kernel. Emits one `timing` line and
    returns its fields."""
    from fastposecnn_tpu_torch.kernels.build import check
    from fastposecnn_tpu_torch.ops.voting import vote_counts_reference

    mm, hh = hyps.shape[:2]
    pp = pts.shape[1]
    counts = torch.empty((mm, hh), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    t2 = float(np.float32(0.999 ** 2))

    def call():
        check(lib.fpcnn_vote_count(
            hyps.data_ptr(), pts.data_ptr(), dirs.data_ptr(), pv.data_ptr(),
            act32.data_ptr(), counts.data_ptr(), mm, hh, pp, t2, stream), "vote_count")

    ms = loop_ms(call)
    plain = median_ms(lambda: vote_counts_reference(
        hyps, pts, dirs, pv, 0.999, active=act32.bool()), iters=5)
    n_act = int(act32.sum())
    bound, by = vote_bound(pv, act32, hh, (hyps, pts, dirs, pv, act32, counts))
    line = dict(kernel="vote_count", shape=[mm, hh, pp], active=n_act, ms=ms,
                plain_ms=plain, bound_ms=bound, bound_by=by,
                device_us_by_kernel=whole_trace(call)[0][0])
    emit("timing", what=name, card=smi, **line)
    return line


def whole_trace(fn, calls=20, whole=True, tries=4):
    """`kernel_trace(fn, calls)` and the number of traces taken. Every `fn`
    traced here runs work on the card, so a trace that holds no device event
    lost it all (a trace of 20 calls of K1 on the card once came back empty),
    and with `whole` a trace whose device events are not a whole number per
    call lost some (one once held 59 of its 60 launches): either is taken
    again, up to `tries` times; the caller's check sees the last."""
    for n in range(1, tries + 1):
        result = kernel_trace(fn, calls)
        if result[1] > 0 and (not whole or result[1] == int(result[1])):
            break
    return result, n


def time_cc(lib, smi, fg, **what):
    """K1 through its C entry point on the bool mask `fg` [B, H, W]: ms per
    call (CUDA events around 50 back-to-back calls), the plain version's
    ms, the byte bound (read the mask once, write the labels once), the
    device time per CUDA kernel, the launches a call makes (counted in the
    same profiler trace), and the floor: the bound plus the same launches
    of an empty kernel, timed alike. Emits
    one `timing` line and returns its fields."""
    from fastposecnn_tpu_torch.kernels.build import check
    from fastposecnn_tpu_torch.ops.connected_components import label_components_reference

    b, h, w = fg.shape
    fg8 = fg.contiguous().view(torch.uint8)
    labels = torch.empty(fg.shape, dtype=torch.int32, device=fg.device)
    err = torch.zeros(1, dtype=torch.int32, device=fg.device)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        check(lib.fpcnn_cc_label(fg8.data_ptr(), labels.data_ptr(), err.data_ptr(),
                                 b, h, w, stream), "cc_label")

    def empty():
        check(lib.fpcnn_cc_label_empty(b, h, w, stream), "cc_label_empty")

    ms = loop_ms(call)
    if int(err.item()) != 0:
        raise AssertionError(f"cc_label passed its step bound on {what}")
    bound = fg.numel() * (1 + 4) / HBM_BYTES_PER_S * 1e3
    empty_ms = loop_ms(empty)
    (us_by_kernel, launches), traces = whole_trace(call)
    (empty_us_by_kernel, empty_launches), empty_traces = whole_trace(empty)
    if launches != empty_launches or launches != int(launches) or launches < 1:
        raise AssertionError(f"cc_label launches {launches} kernels a call, its empty "
                             f"version {empty_launches}, on {what}")
    line = dict(kernel="cc_label", shape=list(fg.shape), foreground=int(fg.sum()), ms=ms,
                plain_ms=median_ms(lambda: label_components_reference(fg), iters=5),
                bound_ms=bound, bound_by="bytes", launches_per_call=int(launches),
                empty_launches_ms=empty_ms, floor_ms=bound + empty_ms,
                device_us_by_kernel=us_by_kernel,
                empty_launches_device_us=sum(empty_us_by_kernel.values()),
                traces=[traces, empty_traces])
    emit("timing", **what, card=smi, **line)
    return line


def phase_eval_timing(dev, oracle, smi):
    """K2 at the evaluation shapes (the oracle batch's first round, 64 x 1000
    x 1024, and the held-out recipe's 64 x 128 x 1024), K1 at B=4 on the
    oracle batch, and the adaptive loop's host syncs: 20 rounds with the
    per-round flag read against the same rounds without it."""
    from fastposecnn_tpu_torch.kernels.build import load_library
    from fastposecnn_tpu_torch.ops import voting as V

    lib = load_library()
    agg, draws = oracle["out"]["aggregated"], oracle["draws"]
    b, n = agg["valid"].shape
    m = b * n
    with torch.inference_mode():
        pts, dirs, npts, pt_valid = V.sample_mask_points_bbox(
            draws.ux, draws.uy, agg["instance_masks"], agg["xy_dense"],
            agg["cc_labels"], agg["cc_roots"])
        p = pts.shape[2]
        pts, dirs = pts.reshape(m, p, 2).contiguous(), dirs.reshape(m, p, 2).contiguous()
        active = agg["valid"].reshape(m) & (npts.reshape(m) >= 5)
        pv = (pt_valid.reshape(m, p) & active[:, None]).float()
        hyps = V.generate_hypotheses(pts, dirs, draws.pairs[0]).contiguous()
    act32 = active.to(torch.int32)
    out = {}
    for name, args in (
            ("vote_count_eval_oracle_round1", (hyps, pts, dirs, pv, act32)),
            ("vote_count_held_out_shape", vote_inputs(dev, 64, 128, 1024, 16, seed=9))):
        out[name] = time_vote(dev, lib, smi, name, *args[:4], args[4].to(torch.int32))

    out["cc_label_eval_oracle_b4"] = time_cc(
        lib, smi, oracle["out"]["categorical"]["mask"] != 0, what="cc_label_eval_oracle_b4")

    # The adaptive loop: 20 rounds (confidence 1.0 is never reached) with
    # the flag read before each round, against the same rounds, exit test
    # included, replayed without reading the flag.
    rounds = 20
    h = hyps.shape[1]
    slots = (pts, dirs, npts.reshape(m), agg["valid"].reshape(m), pt_valid.reshape(m, p))

    def with_syncs():
        V.ransac_vote_centers_adaptive(*slots, h, confidence=1.0, max_iter=rounds,
                                       pairs=draws.pairs)

    def without_syncs():
        count_denom = pv.sum(-1).clamp_min(1.0)
        best_pts = torch.zeros((m, 2), device=dev)
        best_ratio = torch.zeros((m,), device=dev)
        for r in range(rounds):
            torch.where(active, V.slot_confident(best_ratio, r, h, 1.0), True).all()
            hy = V.generate_hypotheses(pts, dirs, draws.pairs[r])
            win_pts, win = V._pick_winners(hy, V.vote_counts(hy, pts, dirs, pv, 0.999,
                                                             active=active))
            ratio = win / count_denom
            best_pts = torch.where((ratio > best_ratio)[:, None], win_pts, best_pts)
            best_ratio = torch.maximum(best_ratio, ratio)

    with torch.inference_mode():
        t_sync, t_free = paired_ms(with_syncs, without_syncs, pairs=10)
    diff = np.subtract(t_sync, t_free) / rounds
    out["round_loop"] = dict(
        rounds=rounds, shape=[m, h, p], pairs=len(t_sync),
        ms_with_flag_reads=statistics.median(t_sync),
        ms_without=statistics.median(t_free),
        sync_cost_ms_per_round=float(np.median(diff)),
        sync_cost_quartiles=[float(q) for q in np.percentile(diff, [25, 75])])
    emit("timing", what="adaptive_round_loop", card=smi, **out["round_loop"])
    return out


def phase_timing(dev, server, image, launches, errs, smi):
    from fastposecnn_tpu_torch import pipeline as P
    from fastposecnn_tpu_torch.device import full_float32
    from fastposecnn_tpu_torch.kernels.build import load_library
    from fastposecnn_tpu_torch.ops import aggregation
    from fastposecnn_tpu_torch.ops.connected_components import (
        label_components,
        label_components_deferred,
    )

    lib = load_library()
    card = dict(card=smi)

    # K1, B=1, 480x640, on the served frame's own foreground (the main
    # path's input: the kernels line), on the known scene's and on an
    # all-foreground mask.
    logits, _ = known_scene(dev)
    with torch.inference_mode(), full_float32():
        served_fg = P.stage_class_compress(server.net(image))["mask"] != 0
    cc_masks_timed = {
        "known_scene": logits["mask"].argmax(1) != 0,
        "served_frame": served_fg,
        "all_foreground": torch.ones((1, H, W), dtype=torch.bool, device=dev),
    }
    cc_times = {name: time_cc(lib, smi, fg, mask=name) for name, fg in cc_masks_timed.items()}
    cc = cc_times["served_frame"]

    # K2 at the main-path shape with every slot active (its best case).
    hyps, pts, dirs, pv, act = vote_inputs(dev, 16, 4096, 1024, 16, seed=3)
    vote = time_vote(dev, lib, smi, "vote_count_served_shape", hyps, pts, dirs, pv,
                     act.to(torch.int32))

    # The served frame: CUDA events around 30 frames; then the card's busy
    # time a frame (the summed device time of every kernel, copy and set of
    # 10 frames in a profiler trace, one stream) against that median.
    frames = event_ms(lambda: server(image), iters=30)
    frame_ms = statistics.median(frames)
    (busy_us, device_ops), traces = whole_trace(lambda: server(image), calls=10, whole=False)
    busy_ms = sum(busy_us.values()) / 1e3
    emit("timing", what="served_frame", shape=[1, 3, H, W], frames=len(frames),
         ms=frame_ms, quartiles_ms=[float(q) for q in np.percentile(frames, [25, 75])],
         fps=1e3 / frame_ms, device_busy_ms=busy_ms, idle_share=1 - busy_ms / frame_ms,
         device_ops_per_frame=device_ops, traces=traces, **card)

    # What K1's flag read cost the frame before the entry points deferred
    # it: the served frame as it runs against the same stages with K1's
    # wrapper reading its flag at once (a host sync right after K1, as the
    # parent of this change did), in 20 interleaved pairs.
    def k1_reads_at_once(fg, impl=None):
        return label_components(fg, impl=impl), None

    def frame_with_k1_sync():
        aggregation.label_components_deferred = k1_reads_at_once
        try:
            server(image)
        finally:
            aggregation.label_components_deferred = label_components_deferred

    t_deferred, t_sync = paired_ms(lambda: server(image), frame_with_k1_sync, pairs=20)
    diff = np.subtract(t_sync, t_deferred)
    emit("timing", what="served_frame_k1_sync", pairs=len(diff),
         ms_deferred=statistics.median(t_deferred), ms_k1_sync=statistics.median(t_sync),
         sync_cost_ms_per_frame=float(np.median(diff)),
         sync_cost_quartiles=[float(q) for q in np.percentile(diff, [25, 75])], **card)

    # The served frame by stage, each timed alone on the previous stage's
    # output, in full float32 as the server runs them; and the post-network
    # stages on the 6-object known scene.
    cfg, gens = server.config, dict(generator=server.generator,
                                    cpu_generator=server.cpu_generator)
    with torch.inference_mode(), full_float32():
        out = server.net(image)
        cat = P.stage_class_compress(out)
        agg = P.stage_aggregate(cat, cfg)
        voted = P.stage_hough_voting(agg, cfg, **gens)
        stages = {
            "network": lambda: server.net(image),
            "class_compress": lambda: P.stage_class_compress(out),
            "aggregate": lambda: P.stage_aggregate(cat, cfg),
            "hough_vote": lambda: P.stage_hough_voting(agg, cfg, **gens),
            "rt": lambda: P.stage_rt_calculation(voted, server.inv_K),
            "pipeline_known_scene": lambda: P.run_pipeline(
                logits, cfg, server.inv_K, **gens),
        }
        stage_ms = {k: median_ms(fn, iters=10) for k, fn in stages.items()}
    emit("timing", what="served_frame_stages", ms=stage_ms,
         valid_instances=int(agg["valid"].sum()), **card)

    return [
        dict(name="cc_label", route="cuda",
             source="fastposecnn_tpu_torch/kernels/cc_label.cu",
             replaces="fastposecnn_tpu/ops/connected_components.py:85",
             launches=launches["cc_label"], max_abs_err=errs["cc_label"], ms=cc["ms"],
             plain_ms=cc["plain_ms"], bound_ms=cc["bound_ms"], bound_by="bytes",
             library_ms=None, launches_per_call=cc["launches_per_call"],
             floor_ms=cc["floor_ms"]),
        dict(name="vote_count", route="cuda",
             source="fastposecnn_tpu_torch/kernels/vote_count.cu",
             replaces="fastposecnn_tpu/ops/voting.py:282",
             launches=launches["vote_count"], max_abs_err=errs["vote_count"],
             ms=vote["ms"], plain_ms=vote["plain_ms"], bound_ms=vote["bound_ms"],
             bound_by=vote["bound_by"], library_ms=None),
    ]


def phase_vote_scan(dev, smi):
    """K2 with few active slots, after the served frame is timed (so that
    line runs after the same work as before these lines were added): the
    main-path shape with 4 of 16 slots active, as a scene with a handful of
    objects gives it, the train path's shape (a HEAD_TRAINING round at batch
    3: 48 slots, 128 hypotheses, 1024 points) with all 48 active, and the
    evaluation shape with the first 0, 1, 4, 15, 32 and 64 of 64 slots active
    (its fixed costs against the cells' work)."""
    from fastposecnn_tpu_torch.kernels.build import load_library

    lib = load_library()
    out = {}
    for name, (m, h, n_active) in (
            ("vote_count_served_shape_4_active", (16, 4096, 4)),
            ("vote_count_train_shape_48_active", (48, 128, 48)),
            *((f"vote_count_eval_shape_{n}_active", (64, 1000, n))
              for n in (0, 1, 4, 15, 32, 64))):
        hyps, pts, dirs, pv, act = vote_inputs(dev, m, h, 1024, n_active,
                                               seed=3 if m == 16 else 9)
        out[name] = time_vote(dev, lib, smi, name, hyps, pts, dirs, pv,
                              act.to(torch.int32))
    return out


def phase_probe(dev):
    """The probe path: `probes.vote_variants.main` (K2, P1 and P2 at the
    script's 16x4096x1024 and at 64x1000x1024, each wrapper called once a
    shape, the timed launches uncounted), with the launch counters reset
    just before and read just after. Its own JSON lines are printed as it
    runs."""
    from fastposecnn_tpu_torch import kernels
    from fastposecnn_tpu_torch.probes import vote_variants as V

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    lines = V.main([])
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    n = len(V.SHAPES)
    want = {"cc_label": 0, "vote_count": n, "vote_expanded_mm": n, "vote_expanded_bcast": n}
    if launches != want:
        raise AssertionError(f"probe launches {launches}, expected {want}")
    for ln in lines:
        if not ln["in_band"]:
            raise AssertionError(f"probe: {ln['kernel']} at {ln['shape']} leaves the band")
        if not all(isinstance(ln[f], float) and math.isfinite(ln[f])
                   for f in ("us", "plain_us", "bound_us")):
            raise AssertionError(f"probe: no time for {ln['kernel']} at {ln['shape']}")
    emit("probe", launches=launches, lines=len(lines))
    return lines, launches


def phase_held_out(dev):
    """The held-out recipe of BASELINE.md:22-29 (128 seed-99 pose-cue scenes
    at 224x320, the trained FULL_c5 checkpoint, 128 hypotheses a round)
    through the evaluate CLI on the card, in float32: as many matched
    instances as on the CPU, and a pooled geodesic mean within
    HELD_OUT_TOL_DEG of the CPU's (the rotation does not pass through the
    vote, so the vote's draws do not matter). Then the same run with the
    network in TF32, as the CLI ran before it computed in float32 (its
    float32 context swapped for one that turns TF32 on), which must land
    outside that tolerance: the check can tell the two apart."""
    from fastposecnn_tpu_torch import kernels
    from fastposecnn_tpu_torch.cli import evaluate

    ckpt = pathlib.Path(__file__).resolve().parent / HELD_OUT_CKPT
    if not ckpt.is_file():
        raise FileNotFoundError(f"{ckpt}: the held-out phase needs the trained checkpoint")

    def run():
        with tempfile.TemporaryDirectory(prefix="fpcnn_held_out_") as out_dir:
            argv = ["--synthetic", "128", "--synthetic_seed", "99", "--synthetic_pose_cues",
                    "--IMAGE_HEIGHT", "224", "--IMAGE_WIDTH", "320", "--BATCH_SIZE", "8",
                    "--TRAIN_SIZE", "1024", "--VALID_SIZE", "128", "--MAX_INSTANCES", "8",
                    "--MAX_VOTE_POINTS", "1024", "--HV_NUM_OF_HYPOTHESES", "128",
                    "--CHECKPOINT", str(ckpt), "--output", out_dir, "--vote_seed", "0"]
            with contextlib.redirect_stdout(io.StringIO()):
                return evaluate.main(argv)

    @contextlib.contextmanager
    def tf32_on():
        set_tf32(True, True)
        try:
            yield
        finally:
            set_tf32(False, False)

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    summary = run()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    float32_context, evaluate.full_float32 = evaluate.full_float32, tf32_on
    try:
        tf32 = run()
    finally:
        evaluate.full_float32 = float32_context
    if min(launches[k] for k in PATH_KERNELS) < 1:
        raise AssertionError(f"held-out: a kernel was not launched: {launches}")
    diff = summary["geodesic_mean_deg"] - HELD_OUT_CPU_MEAN_DEG
    if summary["instances"] != HELD_OUT_CPU_INSTANCES or not abs(diff) < HELD_OUT_TOL_DEG:
        raise AssertionError(
            f"held-out: {summary['instances']} instances, geodesic mean "
            f"{summary['geodesic_mean_deg']!r} deg; the CPU gives {HELD_OUT_CPU_INSTANCES} "
            f"and {HELD_OUT_CPU_MEAN_DEG!r} (tolerance {HELD_OUT_TOL_DEG})")
    tf32_diff = tf32["geodesic_mean_deg"] - HELD_OUT_CPU_MEAN_DEG
    if abs(tf32_diff) < HELD_OUT_TOL_DEG:
        raise AssertionError(
            f"held-out: the TF32 run lands {tf32_diff!r} deg from the CPU, inside the "
            f"tolerance {HELD_OUT_TOL_DEG}: the phase cannot tell TF32 from float32")
    emit("held_out", checkpoint=HELD_OUT_CKPT, frames=summary["frames"],
         instances=summary["instances"], geodesic_mean_deg=summary["geodesic_mean_deg"],
         cpu_geodesic_mean_deg=HELD_OUT_CPU_MEAN_DEG, diff_deg=diff,
         tolerance_deg=HELD_OUT_TOL_DEG, chord_mean_deg=summary["chord_mean_deg"],
         table_aps_mean=summary["table_aps_mean"], vote_rounds=summary["vote_rounds"],
         seconds=seconds, launches=launches,
         with_tf32=dict(instances=tf32["instances"],
                        geodesic_mean_deg=tf32["geodesic_mean_deg"],
                        diff_from_cpu_deg=tf32_diff,
                        table_aps_mean=tf32["table_aps_mean"]))


# -----------------------------------------------------------------------------
# Training


def train_setup(dev, preset, seed, h=H, w=W, classes=7, batch=3, network=None, **overrides):
    """A port train step at `preset`, with seeded random weights (or the
    network `network(hp)` builds) and a batch of seeded synthetic scenes on
    `dev`."""
    from fastposecnn_tpu_torch import config as C
    from fastposecnn_tpu_torch.constants import CAMERA_CLASSES, scaled_intrinsics
    from fastposecnn_tpu_torch.data.synthetic import SceneConfig, make_batch
    from fastposecnn_tpu_torch.models import PoseRegressorNet
    from fastposecnn_tpu_torch.models.weights import init_random_
    from fastposecnn_tpu_torch.train import task as T

    hp = preset(IMAGE_HEIGHT=h, IMAGE_WIDTH=w, SELECTED_CLASSES=CAMERA_CLASSES[:classes],
                BATCH_SIZE=batch, **overrides)
    net = (init_random_(PoseRegressorNet(hp.num_classes, encoder_name=hp.ENCODER), seed)
           if network is None else network(hp)).to(dev)
    opt = T.make_optimizer(hp, net)
    scenes = SceneConfig(height=h, width=w, num_classes=classes,
                         max_instances=hp.MAX_INSTANCES, max_scene_instances=6)
    data = T.upcast_batch(make_batch(np.random.default_rng(seed), scenes, batch), dev)
    inv_k = np.linalg.inv(scaled_intrinsics("CAMERA", h, w))
    pcfg = C.pipeline_config_from(hp)
    return dict(hp=hp, opt=opt, pcfg=pcfg, inv_k=inv_k, batch=data,
                state=T.create_train_state(net, opt),
                step=T.make_train_step(net, opt, hp, pcfg, inv_k, dev))


def timed_steps(run, n, seed=0, dropout_keep=None):
    """`n` steps of run["step"] from run["state"] (updated), each timed with
    CUDA events, and the time of its hough-voting stage (events around
    `pipeline.stage_hough_voting`); every step with the decoders' keep masks
    `dropout_keep` when given. Returns (logs, step ms, voting ms)."""
    from fastposecnn_tpu_torch import pipeline as P

    original, spans = P.stage_hough_voting, []

    def timed_vote(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = original(*args, **kwargs)
        end.record()
        spans.append((start, end))
        return out

    logs, ms, vote_ms = [], [], []
    P.stage_hough_voting = timed_vote
    try:
        for _ in range(n):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run["state"], step_logs = run["step"](run["state"], run["batch"], seed=seed,
                                                  dropout_keep=dropout_keep)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            vote_ms.append(sum(s.elapsed_time(e) for s, e in spans))
            spans.clear()
            logs.append({k: float(v) for k, v in step_logs.items()})
    finally:
        P.stage_hough_voting = original
    return logs, ms, vote_ms


def phase_train(dev, smi):
    """The training path at full width (480x640, 7 classes, ResNet18 and four
    FPN decoders, batch 3, seeded random weights, in-memory synthetic
    scenes): 8 MASK_TRAINING steps at LEARNING_RATE 3e-3 (the loss falls,
    the frozen heads stay bit-equal, the mask head moves, no kernel runs)
    and 6 HEAD_TRAINING steps with the preset's defaults (16 instance slots,
    1024 vote points, 128 hypotheses a round, adaptive): finite losses and
    gradients, no skipped update, one Lookahead sync, K1 once a step and K2
    once a RANSAC round. Times each step with CUDA events (the first step
    of each preset, with cuDNN's autotuning, is left out of the medians),
    the share of a HEAD step spent in hough voting, and from a profiler
    trace of 3 more steps the device's busy time a step (its kernels' sum),
    the idle share against the median step and the costliest kernels.
    Launch counts are read before the traced steps."""
    from fastposecnn_tpu_torch import config as C
    from fastposecnn_tpu_torch import kernels
    from fastposecnn_tpu_torch.train.optim import frozen_modules

    mask = train_setup(dev, C.mask_training, seed=11, LEARNING_RATE=3e-3)
    net = mask["state"].net
    frozen = {n: p.detach().clone() for n, p in net.named_parameters()
              if n.split(".")[0] in frozen_modules(mask["hp"])}
    head0 = [p.detach().clone() for p in net.segmentation_head.parameters()]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    mask_logs, mask_ms, _ = timed_steps(mask, 8)
    mask_launches = kernels.launch_counts()
    losses = [lg["pose/total_loss"] for lg in mask_logs]
    if not losses[-1] < losses[0] or not all(map(math.isfinite, losses)):
        raise AssertionError(f"MASK_TRAINING loss did not fall: {losses}")
    if any(not torch.equal(p, frozen[n]) for n, p in net.named_parameters() if n in frozen):
        raise AssertionError("a frozen module moved under MASK_TRAINING")
    if all(torch.equal(a, b) for a, b in zip(head0, net.segmentation_head.parameters())):
        raise AssertionError("the mask head did not move under MASK_TRAINING")
    if any(mask_launches.values()) or mask["state"].skipped_updates:
        raise AssertionError(f"MASK_TRAINING launched {mask_launches} or skipped "
                             f"{mask['state'].skipped_updates} updates")

    head = train_setup(dev, C.head_training, seed=12)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    head_logs, head_ms, vote_ms = timed_steps(head, 6)
    head_launches = kernels.launch_counts()
    st = head["state"]
    rounds = [int(lg["pose/vote_rounds"]) for lg in head_logs]
    if not all(math.isfinite(v) for lg in head_logs for v in lg.values()):
        raise AssertionError(f"non-finite HEAD_TRAINING logs: {head_logs}")
    if any(lg["grad/finite"] != 1.0 for lg in head_logs) or st.skipped_updates:
        raise AssertionError(f"HEAD_TRAINING skipped {st.skipped_updates} updates")
    if (st.step, st.opt_state.count, st.opt_state.lookahead_step) != (6, 6, 6):
        raise AssertionError(f"HEAD_TRAINING state counts {st}")
    if head_launches["cc_label"] != 6 or head_launches["vote_count"] != sum(rounds):
        raise AssertionError(f"HEAD_TRAINING launches {head_launches}, rounds {rounds}")
    med_mask, med_head = statistics.median(mask_ms[1:]), statistics.median(head_ms[1:])
    share = [v / t for v, t in zip(vote_ms[1:], head_ms[1:])]
    busy = {}
    for name, run, med in (("mask_training", mask, med_mask), ("head_training", head, med_head)):
        def one_step(run=run):
            run["state"], _ = run["step"](run["state"], run["batch"], seed=1)
        (by_kernel, launches), traces = whole_trace(one_step, calls=3, whole=False)
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
        busy[name] = dict(device_busy_ms=sum(by_kernel.values()) / 1e3,
                          idle_share=1 - sum(by_kernel.values()) / 1e3 / med,
                          device_ops_per_step=launches, traces=traces,
                          top_kernels_us=[[k[:80], v] for k, v in top])
    emit("train", card=smi, hw=[H, W], batch=3, classes=7,
         mask_training=dict(steps=8, ms_per_step_median=med_mask, ms_per_step=mask_ms,
                            images_per_s=3e3 / med_mask, total_loss=losses,
                            launches=mask_launches, **busy["mask_training"]),
         head_training=dict(steps=6, ms_per_step_median=med_head, ms_per_step=head_ms,
                            images_per_s=3e3 / med_head,
                            voting_ms=vote_ms, voting_share_median=statistics.median(share),
                            vote_rounds=rounds, launches=head_launches,
                            launches_per_step={k: v / 6 for k, v in head_launches.items()},
                            total_loss=[lg["pose/total_loss"] for lg in head_logs],
                            grad_global_norm=[lg["grad/global_norm"] for lg in head_logs],
                            lookahead_step=st.opt_state.lookahead_step,
                            **busy["head_training"]))
    return {k: mask_launches[k] + head_launches[k] for k in head_launches}


def recorded(module, name, sink):
    """Replace `module.name` by a wrapper that appends each result to
    `sink`; returns the original."""
    original = getattr(module, name)

    def wrapper(*args, **kwargs):
        out = original(*args, **kwargs)
        sink.append((out[0] if isinstance(out, tuple) else out).detach().clone())
        return out

    setattr(module, name, wrapper)
    return original


@contextlib.contextmanager
def calls_recorded(module, name):
    """Within the block `module.name` records each call: a list of (args,
    kwargs, result), tensors cloned."""
    original, calls = getattr(module, name), []

    def clone(x):
        if isinstance(x, tuple):
            return tuple(clone(v) for v in x)
        return x.detach().clone() if isinstance(x, torch.Tensor) else x

    def wrapper(*args, **kwargs):
        out = original(*args, **kwargs)
        calls.append(([clone(a) for a in args], {k: clone(v) for k, v in kwargs.items()},
                      clone(out)))
        return out

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, original)


@contextlib.contextmanager
def kernel_calls_recorded():
    """Within the block every call of K1 (`aggregation.
    label_components_deferred`) and of K2 (`voting.vote_counts`) is
    recorded: {"cc_label": calls, "vote_count": calls}."""
    from fastposecnn_tpu_torch.ops import aggregation, voting

    with calls_recorded(aggregation, "label_components_deferred") as cc, \
            calls_recorded(voting, "vote_counts") as vote:
        yield {"cc_label": cc, "vote_count": vote}


def hold_kernels_plain(calls, what):
    """K1's labels and K2's counts of each call `kernel_calls_recorded`
    kept equal their plain versions' on the same inputs; returns the
    number of calls of each."""
    from fastposecnn_tpu_torch.ops import voting
    from fastposecnn_tpu_torch.ops.connected_components import label_components_reference

    counts = {k: len(v) for k, v in calls.items()}
    if not all(counts.values()):
        raise AssertionError(f"{what}: K1 or K2 did not run ({counts})")
    for args, _, (labels, _) in calls["cc_label"]:
        if not torch.equal(labels, label_components_reference(*args)):
            raise AssertionError(f"{what}: K1's labels differ from its plain version's")
    for args, kwargs, inliers in calls["vote_count"]:
        plain = voting.vote_counts(*args, **{**kwargs, "impl": "reference"})
        if not torch.equal(inliers, plain):
            raise AssertionError(f"{what}: K2's counts differ from its plain version's")
    return counts


def phase_train_kernels(dev, phase="train_kernels", seed=13, grads_l2=None, **overrides):
    """One full-width HEAD_TRAINING step from one state through the kernels
    and through their plain versions (`impl="reference"`): the CC labels,
    every round's vote counts and the rounds exactly equal; the logs,
    gradients, updated parameters and BatchNorm statistics at the golden
    tolerance (atol 2e-4, rtol 1e-4), or, with `grads_l2`, the gradients
    in L2 per tensor within that share of the plain run's norm. `overrides`
    go to the preset (the `train_encoders` phase passes its ENCODER)."""
    import copy

    from fastposecnn_tpu_torch import config as C
    from fastposecnn_tpu_torch.ops import aggregation, voting
    from fastposecnn_tpu_torch.train import task as T

    run = train_setup(dev, C.head_training, seed=seed, **overrides)
    ref_net = copy.deepcopy(run["state"].net)
    ref = dict(run, state=T.TrainState(ref_net, copy.deepcopy(run["state"].opt_state)),
               step=T.make_train_step(ref_net, run["opt"], run["hp"],
                                      dataclasses.replace(run["pcfg"], impl="reference"),
                                      run["inv_k"], dev))
    seen = {}
    for name, r in (("kernels", run), ("reference", ref)):
        labels, counts = [], []
        orig_cc = recorded(aggregation, "label_components_deferred", labels)
        orig_vote = recorded(voting, "vote_counts", counts)
        try:
            r["state"], logs = r["step"](r["state"], r["batch"], seed=3)
        finally:
            aggregation.label_components_deferred, voting.vote_counts = orig_cc, orig_vote
        seen[name] = dict(labels=labels, counts=counts, logs=logs)
    a, b = seen["kernels"], seen["reference"]
    if len(a["counts"]) != len(b["counts"]) or int(a["logs"]["pose/vote_rounds"]) != len(b["counts"]):
        raise AssertionError(f"rounds differ: {len(a['counts'])} vs {len(b['counts'])}")
    for x, y in zip(a["labels"] + a["counts"], b["labels"] + b["counts"]):
        if not torch.equal(x, y):
            raise AssertionError("a kernel's output inside the train step differs from its "
                                 "plain version")
    worst = {}

    def hold(what, got, want):
        if got is None or want is None:  # a parameter no loss reaches
            if (got is None) != (want is None):
                raise AssertionError(f"{what}: a gradient only one side has")
            return
        err = float((got - want).abs().max()) if got.numel() else 0.0
        worst[what] = max(worst.get(what, 0.0), err)
        if not torch.allclose(got, want, atol=2e-4, rtol=1e-4):
            raise AssertionError(f"{what}: kernels and plain versions differ by {err}")

    for k in b["logs"]:
        hold("logs", a["logs"][k], b["logs"][k])
    params = dict(ref["state"].net.named_parameters())
    grad_rel = 0.0
    for n, p in run["state"].net.named_parameters():
        want = params[n].grad
        if grads_l2 is None or p.grad is None or want is None or not want.any():
            hold("grads", p.grad, want)
            continue
        rel = float((p.grad - want).norm() / want.norm())
        grad_rel = max(grad_rel, rel)
        worst["grads"] = max(worst.get("grads", 0.0), float((p.grad - want).abs().max()))
        if not rel <= grads_l2:
            raise AssertionError(f"grad {n}: kernels and plain versions differ by {rel} in L2")
    ref_sd = ref["state"].net.state_dict()
    for n, t in run["state"].net.state_dict().items():
        hold("params_and_batch_stats", t.float(), ref_sd[n].float())
    tolerance = dict(cc_labels="exact", vote_counts="exact", rounds="exact",
                     logs_grads_params=dict(atol=2e-4, rtol=1e-4))
    if grads_l2 is not None:
        tolerance.update(logs_params=tolerance.pop("logs_grads_params"),
                         grads_relative_l2=grads_l2)
    emit(phase, hw=[H, W], batch=3, encoder=run["hp"].ENCODER, tolerance=tolerance,
         rounds=len(b["counts"]), max_abs_diff=worst, max_grad_relative_l2=grad_rel)


def phase_train_cpu(dev, h=96, w=128):
    """One HEAD_TRAINING step at a reduced size (96x128, 7 classes, batch 2,
    8 slots, 256 points, 64 hypotheses) from one seeded state, on the card
    and through the port on the CPU, with the same dropout masks and vote
    draws. Exact: the rounds and the matched count. The logs, updated
    parameters and BatchNorm statistics at the golden tolerance, but the
    matched xy loss within 0.1 (the voted centres may move by up to 0.05 px
    where the card's compiler contracts the hypotheses' multiply-adds, as
    compiled JAX does: ROADMAP.md C4). The gradients in L2 per tensor,
    within 2e-3 of the CPU's norm: a pre-activation at a ReLU's kink can
    fall on the other side on the other device (tests/torch_train_helpers.py)."""
    from fastposecnn_tpu_torch import config as C
    from fastposecnn_tpu_torch.ops.voting import VoteDraws

    kw = dict(h=h, w=w, batch=2, MAX_INSTANCES=8, MAX_VOTE_POINTS=256, HV_NUM_OF_HYPOTHESES=64)
    card, cpu = (train_setup(d, C.head_training, seed=14, **kw)
                 for d in (dev, torch.device("cpu")))
    hp, gen = cpu["hp"], torch.Generator().manual_seed(5)
    keep = cpu["state"].net.draw_dropout_keep(2, "cpu", gen)
    b, n, p = 2, hp.MAX_INSTANCES, hp.MAX_VOTE_POINTS
    draws = VoteDraws(ux=torch.rand((b, n, p), generator=gen),
                      uy=torch.rand((b, n, p), generator=gen),
                      pairs=torch.randint(0, p, (20, b * n, hp.HV_NUM_OF_HYPOTHESES, 2),
                                          generator=gen))
    out = {}
    for name, r, d in (("card", card, dev), ("cpu", cpu, torch.device("cpu"))):
        r_draws = VoteDraws(ux=draws.ux.to(d), uy=draws.uy.to(d), pairs=draws.pairs.to(d))
        r["state"], logs = r["step"](r["state"], r["batch"], seed=0,
                                     dropout_keep={k: v.to(d) for k, v in keep.items()},
                                     draws=r_draws)
        out[name] = {k: float(v) for k, v in logs.items()}
    a, want = out["card"], out["cpu"]
    for k in ("pose/vote_rounds", "pose/num_matched"):
        if a[k] != want[k]:
            raise AssertionError(f"{k}: card {a[k]}, CPU {want[k]}")
    log_err = {}
    for k, v in want.items():
        tol = 0.1 if k == "xy/loss_xy" else 2e-4 + 1e-4 * abs(v)
        log_err[k] = abs(a[k] - v)
        if not log_err[k] <= tol:
            raise AssertionError(f"log {k}: card {a[k]}, CPU {v}")
    grad_rel = 0.0
    cpu_params = dict(cpu["state"].net.named_parameters())
    for name, q in card["state"].net.named_parameters():
        g, gc = q.grad, cpu_params[name].grad
        if gc is None or not gc.any():
            if g is not None and g.any():
                raise AssertionError(f"grad {name}: the CPU gives none")
            continue
        rel = float((g.cpu() - gc).norm() / gc.norm())
        grad_rel = max(grad_rel, rel)
        if not rel <= 2e-3:
            raise AssertionError(f"grad {name}: relative L2 difference {rel}")
    cpu_sd = cpu["state"].net.state_dict()
    param_err = 0.0
    for name, t in card["state"].net.state_dict().items():
        t, tc = t.cpu().float(), cpu_sd[name].float()
        param_err = max(param_err, float((t - tc).abs().max()))
        if not torch.allclose(t, tc, atol=2e-4, rtol=1e-4):
            raise AssertionError(f"{name}: card and CPU differ")
    emit("train_cpu", hw=[h, w], batch=2, rounds=int(want["pose/vote_rounds"]),
         num_matched=want["pose/num_matched"], tolerance=dict(
             logs=dict(atol=2e-4, rtol=1e-4, xy_loss_atol=0.1), grads_relative_l2=2e-3,
             params_and_batch_stats=dict(atol=2e-4, rtol=1e-4)),
         max_log_diff=log_err, max_grad_relative_l2=grad_rel, max_param_diff=param_err)


# -----------------------------------------------------------------------------
# The train CLI


class SyncCounter:
    """Counts the host syncs made on the calling thread while it is entered
    (a read of a device value, a copy that waits for the card): it turns on
    `torch.cuda.set_sync_debug_mode("warn")` and counts PyTorch's warning
    for each. Another thread's syncs (a checkpoint flush) are not counted."""

    MESSAGE = r".*synchronizing CUDA operation.*"

    def __init__(self):
        self.count, self.thread = 0, threading.get_ident()

    def __enter__(self):
        self.catch = warnings.catch_warnings()
        self.catch.__enter__()
        warnings.filterwarnings("always", message=self.MESSAGE)
        show = warnings.showwarning

        def counting(message, category, filename, lineno, file=None, line=None):
            if "synchronizing CUDA operation" not in str(message):
                return show(message, category, filename, lineno, file, line)
            if threading.get_ident() == self.thread:
                self.count += 1
            return None

        warnings.showwarning = counting
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        self.catch.__exit__(*exc)


class CliProbe:
    """Instruments the train CLI's path while it runs: the metrics handed to
    the run logger, each train step's CUDA-event time, and the train state
    at the first step of the run (what a resume loaded). `trainer` is the
    module whose step makers it wraps (`train.loop`, or `train.staged`);
    with `syncs` (a `SyncCounter`) it also counts each step's host syncs."""

    def __init__(self, trainer=None, syncs=None):
        from fastposecnn_tpu_torch.train import loop
        from fastposecnn_tpu_torch.utils import tb

        self.loop, self.tb, self.syncs = trainer or loop, tb, syncs
        self.logged, self.step_ms, self.eval_steps, self.first_state = [], [], 0, None
        # with `syncs`: the count at each train step's start, and the syncs
        # inside each train and each eval step
        self.step_starts, self.step_syncs, self.eval_syncs = [], [], []
        self.eval_rounds = []  # vote rounds of each eval step

    def __enter__(self):
        loop, probe = self.loop, self
        self.originals = (loop.make_train_step, loop.make_eval_step,
                          self.tb.RunLogger.log_metrics)

        def make_train_step(*args):
            step = probe.originals[0](*args)

            def timed(state, batch, seed=0):
                if probe.first_state is None:
                    probe.first_state = snapshot_state(state)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                before = probe.syncs.count if probe.syncs else 0
                probe.step_starts.append(before)
                start.record()
                out = step(state, batch, seed=seed)
                end.record()
                if probe.syncs:
                    probe.step_syncs.append(probe.syncs.count - before)
                end.synchronize()
                probe.step_ms.append(start.elapsed_time(end))
                return out
            return timed

        def make_eval_step(*args):
            step = probe.originals[1](*args)

            def counted(*a, **kw):
                probe.eval_steps += 1
                before = probe.syncs.count if probe.syncs else 0
                out = step(*a, **kw)
                if probe.syncs:
                    probe.eval_syncs.append(probe.syncs.count - before)
                agg = out[2]["aggregated"] if out[2] is not None else None
                if agg is not None and "vote_rounds" in agg:
                    probe.eval_rounds.append(int(agg["vote_rounds"]))
                return out
            return counted

        def log_metrics(logger, mode, metrics, step, accumulate=True):
            probe.logged.append((mode, {k: float(v) for k, v in metrics.items()}, step))
            return probe.originals[2](logger, mode, metrics, step, accumulate)

        loop.make_train_step, loop.make_eval_step = make_train_step, make_eval_step
        self.tb.RunLogger.log_metrics = log_metrics
        return self

    def __exit__(self, *exc):
        (self.loop.make_train_step, self.loop.make_eval_step,
         self.tb.RunLogger.log_metrics) = self.originals


def snapshot_state(state):
    """A host copy of a TrainState: state_dict, OptState fields, counts."""
    o = state.opt_state
    cpu = lambda d: {k: v.detach().cpu().clone() for k, v in d.items()}  # noqa: E731
    return dict(state_dict=cpu(state.net.state_dict()), mu=cpu(o.mu), nu=cpu(o.nu),
                slow=cpu(o.slow), params=cpu(dict(state.net.named_parameters())),
                scalars=(o.count, o.lookahead_step, o.lr_scale, o.hyper_count),
                step=state.step, skipped=state.skipped_updates)


def run_train_cli(argv, trainer=None, syncs=None, compute_dtype="float32"):
    """`cli.train.main(argv)` with its printed lines kept off the smoke's
    output (run.log holds them); returns (state, run dir, probe). The
    network computes in `--COMPUTE_DTYPE compute_dtype` (float32, the
    precision every phase but `train_bf16` was set for), or in the
    hparams' default with `compute_dtype` None."""
    from fastposecnn_tpu_torch.cli import train as train_cli

    if compute_dtype is not None:
        argv = [*argv, "--COMPUTE_DTYPE", compute_dtype]
    with CliProbe(trainer, syncs) as probe, contextlib.redirect_stdout(io.StringIO()):
        state, run_dir = train_cli.main(argv)
    torch.cuda.synchronize()
    return state, run_dir, probe


def phase_train_cli(dev, smi, scenes=12, epochs=2):
    """The train CLI (`cli.train.main`, called as a function) on the card at
    full width: HEAD_TRAINING, 480x640, 7 CAMERA classes, batch 3,
    `--synthetic 12` (train: 12 scenes with the train augmentation through
    the native operators; valid: 3 scenes; written as NOCS folders under a
    temporary `--bank_pool_dir` and read back), 4 loader threads, 2 epochs, no
    TensorBoard, seeded random weights. Requires: the run dir with
    HPARAM.json, 2 epoch lines, checkpoints/{best,periodic,last}; every
    logged loss finite, no skipped update; K1 once a train or eval step and
    K2 once a vote round (launch counters reset just before this run and
    read just after). Then a third epoch from checkpoints/last, whose state
    right after the load is bit-equal to the saved file and whose step count
    goes on; and a weights-only resume from an npz snapshot the port wrote
    (slow weights equal to the loaded parameters, RAdam's count 0). Checks
    that `augment_sample` through the native operators is bit-equal to its
    numpy path on 480x640 samples of the card's host, and prints, without
    gating: ms a sample on each path, images/s of each epoch, the loader
    alone in batches/s, the median train step and whether
    torch.utils.tensorboard imports."""
    import copy
    import os
    import re

    from fastposecnn_tpu_torch import config as C
    from fastposecnn_tpu_torch import constants, kernels
    from fastposecnn_tpu_torch.cli import train as train_cli
    from fastposecnn_tpu_torch.data import augment as A
    from fastposecnn_tpu_torch.data.loader import PrefetchLoader
    from fastposecnn_tpu_torch.data.nocs import SyntheticNOCSSource
    from fastposecnn_tpu_torch.data.synthetic import SceneConfig
    from fastposecnn_tpu_torch.native import augment_lib
    from fastposecnn_tpu_torch.ops import aggregation, voting
    from fastposecnn_tpu_torch.train import checkpoint as ckpt

    phase_t0 = t0 = time.perf_counter()
    augment_lib.load_library()
    native_build_s = time.perf_counter() - t0

    # ---- the native augmentation against numpy, on this host ----
    sample = SyntheticNOCSSource(1, 5, SceneConfig(height=H, width=W, num_classes=7,
                                                   max_instances=16))[0]
    K = constants.scaled_intrinsics("CAMERA", H, W)
    aug_ms = {"native": [], "numpy": []}
    warped = 0
    for seed in range(6):
        out = {}
        for path in ("numpy", "native"):
            s = copy.deepcopy(sample)
            t0 = time.perf_counter()
            out[path] = A.augment_sample(s, np.random.default_rng(seed), intrinsics=K,
                                         native=path == "native")
            aug_ms[path].append((time.perf_counter() - t0) * 1e3)
        a, b = out["native"], out["numpy"]
        fields = [("image", a["image"], b["image"]), ("mask", a["mask"], b["mask"]),
                  ("depth", a["depth"], b["depth"])] + [
            (f"agg/{k}", a["agg"][k], b["agg"][k]) for k in b["agg"]]
        for name, x, y in fields:
            if x.dtype != y.dtype or not np.array_equal(x, y):
                raise AssertionError(f"native augmentation differs from numpy: {name}, "
                                     f"seed {seed}")
        warped += not np.array_equal(b["mask"], sample["mask"])
    if not 0 < warped < 6:
        raise AssertionError(f"{warped} of 6 seeds took the perspective warp")

    try:
        import torch.utils.tensorboard  # noqa: F401
        tensorboard = "imports"
    except ImportError as e:
        tensorboard = f"does not import: {e}"

    with tempfile.TemporaryDirectory(prefix="fpcnn_train_cli_") as tmp:
        common = ["--preset", "HEAD_TRAINING", "--synthetic", str(scenes),
                  "--IMAGE_HEIGHT", str(H), "--IMAGE_WIDTH", str(W), "--BATCH_SIZE", "3",
                  "--SELECTED_CLASSES", *C.HParams().SELECTED_CLASSES, "--NUM_WORKERS", "4",
                  "--bank_pool_dir", f"{tmp}/banks", "--no_tb", "--device", dev.type]
        old_logs = os.environ.get("LOGS")
        os.environ["LOGS"] = tmp
        try:
            # ---- the loader alone, one epoch of augmented batches (the banks'
            # render is reused by the runs below) ----
            args = train_cli.build_parser().parse_args(common)
            hp = C.apply_cli_overrides(C.head_training(), args)
            t0 = time.perf_counter()
            _, train_dir, valid_dir = train_cli.synthetic_banks(hp, args)
            render_s = time.perf_counter() - t0
            train_ds, _ = train_cli.datasets(hp, args, train_dir, valid_dir)
            loader = PrefetchLoader(train_ds, hp.BATCH_SIZE, num_workers=hp.NUM_WORKERS)
            t0 = time.perf_counter()
            n_batches = sum(1 for b in loader if b is not None)
            loader_s = time.perf_counter() - t0

            # ---- the main path: 2 epochs ----
            labels, counts = [], []
            orig_cc = recorded(aggregation, "label_components_deferred", labels)
            orig_vote = recorded(voting, "vote_counts", counts)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            try:
                state, run_dir, probe = run_train_cli(
                    ["-e", "SMOKE", "--epochs", str(epochs), *common])
            finally:
                aggregation.label_components_deferred, voting.vote_counts = orig_cc, orig_vote
            launches = kernels.launch_counts()
            run_log = (run_dir / "run.log").read_text()
            epoch_lines = re.findall(r"epoch \d+: val_loss=.*", run_log)
            steps = len(probe.step_ms)
            if not (run_dir / "HPARAM.json").is_file() or len(epoch_lines) != epochs:
                raise AssertionError(f"run dir {run_dir}: HPARAM.json or the {epochs} epoch "
                                     f"lines missing: {epoch_lines}")
            kinds = {k: ckpt.latest_step(run_dir / "checkpoints" / k)
                     for k in ("best", "periodic", "last")}
            if None in kinds.values() or kinds["last"] != state.step:
                raise AssertionError(f"checkpoints {kinds}, step {state.step}")
            losses = [v for _, m, _ in probe.logged for k, v in m.items() if "loss" in k]
            if not losses or not all(map(math.isfinite, losses)):
                raise AssertionError(f"a logged loss is not finite: {losses}")
            if state.skipped_updates or any("skipped=0 " not in ln for ln in epoch_lines):
                raise AssertionError(f"skipped updates: {epoch_lines}")
            if steps != epochs * -(-scenes // 3) or state.step != steps:
                raise AssertionError(f"{steps} train steps, state step {state.step}")
            if (launches["cc_label"] != len(labels) or len(labels) != steps + probe.eval_steps
                    or launches["vote_count"] != len(counts) or len(counts) < steps
                    or launches["vote_expanded_mm"] or launches["vote_expanded_bcast"]):
                raise AssertionError(f"launches {launches}: {len(labels)} CC calls, "
                                     f"{len(counts)} vote rounds, {steps} train and "
                                     f"{probe.eval_steps} eval steps")
            del labels, counts
            throughput = [m["throughput/images_per_s"] for _, m, _ in probe.logged
                          if "throughput/images_per_s" in m]

            # ---- full resume: a third epoch from checkpoints/last ----
            last = run_dir / "checkpoints" / "last"
            saved = torch.load(last / f"step_{kinds['last']:08d}.pt", map_location="cpu",
                               weights_only=True)
            resumed, run2, probe2 = run_train_cli(
                ["-e", "SMOKE_RESUME", "--epochs", "1", "--resume", str(last), *common])
            got = probe2.first_state
            o = saved["opt_state"]
            same = (all(torch.equal(got["state_dict"][k], v)
                        for k, v in saved["state_dict"].items())
                    and sorted(got["state_dict"]) == sorted(saved["state_dict"])
                    and all(torch.equal(got[f][k], v) for f in ("mu", "nu", "slow")
                            for k, v in o[f].items())
                    and got["scalars"] == (o["count"], o["lookahead_step"], o["lr_scale"],
                                           o["hyper_count"])
                    and (got["step"], got["skipped"]) == (saved["step"],
                                                          saved["skipped_updates"]))
            if not same or resumed.step != saved["step"] + len(probe2.step_ms):
                raise AssertionError(f"full resume: state after the load equal {same}, "
                                     f"steps {saved['step']} -> {resumed.step}")

            # ---- weights-only resume from an npz the port wrote ----
            snap = pathlib.Path(tmp) / "snapshot.npz"
            ckpt.save_npz_snapshot(snap, resumed, C.HParams.load(run2 / "HPARAM.json"))
            want = {n: p.detach().cpu().half().float()
                    for n, p in resumed.net.named_parameters()}
            _, _, probe3 = run_train_cli(
                ["-e", "SMOKE_NPZ", "--epochs", "1", "--TRAIN_SIZE", "3",
                 "--resume", str(snap), *common])
            got = probe3.first_state
            weights_only = dict(
                params_equal_snapshot=all(torch.equal(got["params"][n], v)
                                          for n, v in want.items()),
                slow_equal_params=all(torch.equal(got["slow"][n], p)
                                      for n, p in got["params"].items()),
                radam_count=got["scalars"][0], step=got["step"])
            if not (weights_only["params_equal_snapshot"] and weights_only["slow_equal_params"]
                    and weights_only["radam_count"] == 0 and weights_only["step"] == 0):
                raise AssertionError(f"weights-only resume: {weights_only}")
        finally:
            if old_logs is None:
                os.environ.pop("LOGS", None)
            else:
                os.environ["LOGS"] = old_logs

    emit("train_cli", card=smi, hw=[H, W], batch=3, classes=7, scenes=scenes,
         epochs=epochs, train_steps=steps, eval_steps=probe.eval_steps,
         epoch_lines=epoch_lines, checkpoints=kinds, launches=launches,
         launches_per_step=dict(cc_label=launches["cc_label"] / (steps + probe.eval_steps),
                                vote_count=launches["vote_count"] / (steps + probe.eval_steps)),
         images_per_s_by_epoch=throughput,
         step_ms_median=statistics.median(probe.step_ms[1:]), step_ms=probe.step_ms,
         loader_alone=dict(batches=n_batches, seconds=loader_s,
                           batches_per_s=n_batches / loader_s, workers=4, backend="thread"),
         render_banks_s=render_s,
         native_augment=dict(build_s=native_build_s, bit_equal=True, seeds=6, warped=warped,
                             ms_per_sample_native=statistics.median(aug_ms["native"]),
                             ms_per_sample_numpy=statistics.median(aug_ms["numpy"])),
         full_resume=dict(from_step=saved["step"], to_step=resumed.step,
                          state_bit_equal_after_load=same),
         weights_only_resume=weights_only, tensorboard=tensorboard,
         seconds=time.perf_counter() - phase_t0)
    return launches


def phase_train_staged(dev, smi, scenes=24, epochs=3):
    """The staged trainer through the train CLI (`cli.train.main`, called as
    a function) on the card at full width: HEAD_TRAINING, 480x640, 7 CAMERA
    classes, batch 3, 16 GT slots, 1024 points and 128 hypotheses a round
    (adaptive), seeded random weights, no TensorBoard, `--synthetic 24
    --stage_on_device --restage_every 1 --epochs 3 --bank_pool_dir <tmp>
    --snapshot_npz <tmp>/snap.npz`, 4 staging workers. `bank_2` is rendered
    into the pool first by the writer's command line, so the first restage
    moves onto a bank the run did not start from. Requires: the staged
    trainer's line in run.log; every upload verified with no retry; restage
    lines at epochs 1 and 2, one of them read from bank_2; a pending best
    flushed before a restage; checkpoints/{best,periodic,last} and the npz snapshot,
    which loads; every logged loss finite; K1 once a train or eval step and
    K2 once a vote round (counters reset just before the run and read just
    after, K2's against the rounds the train and eval steps report); no
    renderer or staging process left. Then one batch gathered
    on the card (and upcast there) bit-equal to the host collate of the same
    samples (upcast on the card). Prints, without gating: the staged bytes,
    the staging and restage seconds, images/s an epoch, the median step,
    host syncs in each train and eval step and those of an epoch outside
    its steps (from one epoch's first train step to the next's: the gather,
    the fetch, the checkpoint clones, the restage upload), ms to decode a
    480x640 PNG of the bank (filter 0 rows) and to unfilter 480x640 RGB
    Paeth rows, each with the native and the numpy unfilter."""
    import logging
    import multiprocessing
    import os
    import re

    from fastposecnn_tpu_torch import config as C
    from fastposecnn_tpu_torch import kernels
    from fastposecnn_tpu_torch.data import bank_pool, png
    from fastposecnn_tpu_torch.data.loader import upcast_batch
    from fastposecnn_tpu_torch.data.nocs import NOCSDataset, collate
    from fastposecnn_tpu_torch.models import PoseRegressorNet
    from fastposecnn_tpu_torch.ops import aggregation, voting
    from fastposecnn_tpu_torch.train import checkpoint as ckpt
    from fastposecnn_tpu_torch.train import staged

    phase_t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="fpcnn_train_staged_") as tmp:
        pool_dir, snap = pathlib.Path(tmp) / "pool", pathlib.Path(tmp) / "snap.npz"
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "fastposecnn_tpu_torch.data.nocs_writer",
                        "--out", str(pool_dir / "bank_2"), "--num", str(scenes), "--seed", "2",
                        "--height", str(H), "--width", str(W), "--num_classes", "7",
                        "--max_instances", "16"],
                       check=True, timeout=300, cwd=pathlib.Path(__file__).resolve().parent,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        writer_cli_s = time.perf_counter() - t0

        # ---- PNG decode of a 480x640 color file, native and numpy ----
        color = sorted((pool_dir / "bank_2").rglob("*_color.png"))[0]
        decode_ms = {}
        for native in (True, False):
            times = []
            for _ in range(5 if native else 2):
                t0 = time.perf_counter()
                img = png.decode_png(color, native=native, rgb=True)
                times.append((time.perf_counter() - t0) * 1e3)
            decode_ms["native" if native else "numpy"] = statistics.median(times)
        if img.shape != (H, W, 3) or not np.array_equal(
                img, png.decode_png(color, native=True, rgb=True)):
            raise AssertionError("native and numpy PNG decode differ")
        # The writer's rows are all filter 0; files from other encoders carry
        # Paeth rows, where the unfilter is sequential: time it alone there.
        raw = np.random.default_rng(0).integers(0, 256, (H, W * 3 + 1), dtype=np.uint8)
        raw[:, 0] = 4
        raw = raw.reshape(-1)
        unfilter_ms = {}
        for name, fn in (("native", png.unfilter_native), ("numpy", png.unfilter_numpy)):
            t0 = time.perf_counter()
            rows = fn(raw, H, W * 3, 3)
            unfilter_ms[name] = (time.perf_counter() - t0) * 1e3
            if name == "native":
                paeth_native = rows
        if not np.array_equal(rows, paeth_native):
            raise AssertionError("native and numpy unfilter differ on Paeth rows")

        # ---- the main path ----
        rotations, renders, uploads, stagings = [], [], [], []
        originals = (bank_pool.BankPool.rotate, bank_pool.BankPool.launch,
                     staged.verified_device_put, staged.stage_dataset)

        def rotate(pool):
            rotations.append(originals[0](pool))
            return rotations[-1]

        def launch(pool):
            originals[1](pool)
            renders.append(pool.proc)

        def put(host_tree, what, *a, **kw):
            t = time.perf_counter()
            out = originals[2](host_tree, what, *a, **kw)
            uploads.append((what, staged.tree_nbytes(host_tree),
                            host_tree["image"].shape[0], time.perf_counter() - t))
            return out

        def stage(ds, *a, **kw):
            t = time.perf_counter()
            out = originals[3](ds, *a, **kw)
            stagings.append(time.perf_counter() - t)
            return out

        calls = {"label_components_deferred": 0, "vote_counts": 0}

        def counting(module, name):
            original = getattr(module, name)

            def wrapper(*args, **kwargs):
                calls[name] += 1
                return original(*args, **kwargs)
            setattr(module, name, wrapper)
            return original

        bank_pool.BankPool.rotate, bank_pool.BankPool.launch = rotate, launch
        staged.verified_device_put, staged.stage_dataset = put, stage
        orig_cc = counting(aggregation, "label_components_deferred")
        orig_vote = counting(voting, "vote_counts")
        old_logs = os.environ.get("LOGS")
        os.environ["LOGS"] = tmp
        try:
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            with SyncCounter() as syncs:
                state, run_dir, probe = run_train_cli(
                    ["-e", "SMOKE_STAGED", "--preset", "HEAD_TRAINING",
                     "--synthetic", str(scenes), "--IMAGE_HEIGHT", str(H),
                     "--IMAGE_WIDTH", str(W), "--BATCH_SIZE", "3",
                     "--SELECTED_CLASSES", *C.HParams().SELECTED_CLASSES,
                     "--NUM_WORKERS", "4", "--no_tb", "--device", dev.type,
                     "--stage_on_device", "--restage_every", "1", "--epochs", str(epochs),
                     "--bank_pool_dir", str(pool_dir), "--snapshot_npz", str(snap)],
                    trainer=staged, syncs=syncs)
            launches = kernels.launch_counts()
        finally:
            (bank_pool.BankPool.rotate, bank_pool.BankPool.launch,
             staged.verified_device_put, staged.stage_dataset) = originals
            aggregation.label_components_deferred, voting.vote_counts = orig_cc, orig_vote
            if old_logs is None:
                os.environ.pop("LOGS", None)
            else:
                os.environ["LOGS"] = old_logs

        run_log = (run_dir / "run.log").read_text()
        epoch_lines = re.findall(r"epoch \d+: val_loss=.*", run_log)
        restaged = [int(e) for e in re.findall(r"restaged \d+ train samples \(\d+ generated\) "
                                               r"at epoch (\d+)", run_log)]
        flushed = [int(e) for e in re.findall(
            r"flushed best checkpoint before restage at epoch (\d+)", run_log)]
        verified = len(re.findall(r"staged (?:train|valid) upload verified: ", run_log))
        if "staged (device-resident) trainer" not in run_log or len(epoch_lines) != epochs:
            raise AssertionError(f"run.log of {run_dir}: {epoch_lines}")
        if (verified != len(uploads) or "FAILED checksum" in run_log
                or "verified on retry" in run_log):
            raise AssertionError(f"{verified} verified uploads of {len(uploads)}")
        if restaged != list(range(1, epochs)) or pool_dir / "bank_2" not in rotations:
            raise AssertionError(f"restaged at {restaged}, banks read {rotations}")
        if not flushed:
            raise AssertionError("no flush before a restage")
        kinds = {k: ckpt.latest_step(run_dir / "checkpoints" / k)
                 for k in ("best", "periodic", "last")}
        if None in kinds.values() or kinds["last"] != state.step:
            raise AssertionError(f"checkpoints {kinds}, step {state.step}")
        hp = ckpt.merge_arch_from_any(snap, C.head_training())
        net = PoseRegressorNet(hp.num_classes)
        ckpt.load_weights(net, snap, hp)
        if not all(torch.isfinite(v).all() for v in net.state_dict().values()
                   if v.is_floating_point()):
            raise AssertionError("the npz snapshot holds a non-finite weight")
        losses = [v for _, m, _ in probe.logged for k, v in m.items() if "loss" in k]
        if not losses or not all(map(math.isfinite, losses)):
            raise AssertionError(f"a logged loss is not finite: {losses}")
        steps = len(probe.step_ms)
        if steps != epochs * (scenes // 3) or state.step != steps:
            raise AssertionError(f"{steps} train steps, state step {state.step}")
        rounds = [int(m["pose/vote_rounds"]) for mode, m, _ in probe.logged
                  if mode == "train" and "pose/vote_rounds" in m]
        if (launches["cc_label"] != calls["label_components_deferred"]
                or calls["label_components_deferred"] != steps + probe.eval_steps
                or launches["vote_count"] != calls["vote_counts"]
                or calls["vote_counts"] != sum(rounds) + sum(probe.eval_rounds)
                or len(rounds) != steps or len(probe.eval_rounds) != probe.eval_steps
                or launches["vote_expanded_mm"] or launches["vote_expanded_bcast"]):
            raise AssertionError(f"launches {launches}: calls {calls}, train rounds {rounds}, "
                                 f"eval rounds {probe.eval_rounds}, {steps} train and "
                                 f"{probe.eval_steps} eval steps")
        left = [p.pid for p in renders if p.poll() is None]
        left += [p.pid for p in multiprocessing.active_children()]
        if left:
            raise AssertionError(f"processes left after the run: {left}")

        # ---- a batch gathered on the card against the host collate ----
        ds = NOCSDataset(pool_dir / "bank_2", max_instances=16, augmentation="train")
        ds.epoch = 1
        host = staged.stage_dataset(ds)
        dev_tree = staged.verified_device_put(host, "check", logging.getLogger("chip_smoke"),
                                              dev)
        n = host["image"].shape[0]
        idx = np.array([n - 1, 0, n // 2], np.int64)
        ones = torch.ones((3,), dtype=torch.float32, device=dev)
        gathered = staged._gather_batch(dev_tree, torch.from_numpy(idx).to(dev), ones)
        want = collate([ds[int(i)] for i in idx])
        want["sample_valid"] = np.ones((3,), np.float32)
        pairs = [("image", gathered["image"], want["image"]),
                 ("mask", gathered["mask"], want["mask"])] + [
            (f"agg/{k}", gathered["agg"][k], want["agg"][k]) for k in want["agg"]]
        up_got, up_want = upcast_batch(gathered, dev), upcast_batch(want, dev)
        pairs += [("upcast image", up_got["image"], up_want["image"]),
                  ("upcast mask", up_got["mask"], up_want["mask"]),
                  ("upcast instance_masks", up_got["agg"]["instance_masks"],
                   up_want["agg"]["instance_masks"])]
        for name, got, ref in pairs:
            ref = torch.as_tensor(np.asarray(ref)) if not isinstance(ref, torch.Tensor) else ref
            if got.dtype != ref.dtype or not torch.equal(got.cpu(), ref.cpu()):
                raise AssertionError(f"gathered batch differs from the host collate: {name}")

    throughput = [m["throughput/images_per_s"] for _, m, _ in probe.logged
                  if "throughput/images_per_s" in m]
    train_uploads = [u for u in uploads if u[0] == "train"]
    per_epoch = steps // epochs
    evals_per_epoch = probe.eval_steps // epochs
    between = [probe.step_starts[(e + 1) * per_epoch] - probe.step_starts[e * per_epoch]
               - sum(probe.step_syncs[e * per_epoch:(e + 1) * per_epoch])
               - sum(probe.eval_syncs[e * evals_per_epoch:(e + 1) * evals_per_epoch])
               for e in range(epochs - 1)]
    emit("train_staged", card=smi, hw=[H, W], batch=3, classes=7, scenes=scenes,
         epochs=epochs, train_steps=steps, eval_steps=probe.eval_steps,
         epoch_lines=[ln[:120] for ln in epoch_lines], restaged_at=restaged,
         flushed_before_restage_at=flushed, checkpoints=kinds,
         banks_read=[p.name for p in rotations], renders_started=len(renders),
         launches=launches, vote_rounds_train=rounds, vote_rounds_eval=probe.eval_rounds,
         launches_per_step=dict(cc_label=launches["cc_label"] / (steps + probe.eval_steps),
                                vote_count=launches["vote_count"] / (steps + probe.eval_steps)),
         staged_bytes=dict(train=train_uploads[0][1],
                           per_sample=train_uploads[0][1] / train_uploads[0][2],
                           valid=sum(u[1] for u in uploads if u[0] == "valid")),
         staging_s=stagings, upload_verified_s=[u[3] for u in uploads],
         images_per_s_by_epoch=throughput,
         step_ms_median=statistics.median(probe.step_ms[1:]), step_ms=probe.step_ms,
         host_syncs=dict(in_train_steps=probe.step_syncs,
                         per_train_step_median=statistics.median(probe.step_syncs),
                         in_eval_steps=probe.eval_syncs,
                         epoch_outside_steps=between, whole_run=syncs.count),
         png_decode_ms_480x640=decode_ms, png_unfilter_ms_480x640_paeth=unfilter_ms,
         writer_cli_s=writer_cli_s,
         gathered_batch_bit_equal=True, seconds=time.perf_counter() - phase_t0)
    return launches


def phase_network_precision(dev, server, smi, pairs=10):
    """What computing in float32 costs and buys in the network alone at
    480x640: the served network (seeded random weights, random images) and
    the trained FULL_c5 network (pose-cue synthetic scenes), at batch 1 (a
    served frame) and 3 (an evaluated batch), timed in `full_float32()`, as
    the entry points run it, and with TF32 on and cuDNN's heuristics
    (torch's defaults, as the entry points ran before), in interleaved
    pairs, with the largest absolute difference of each head's outputs
    between the two. Then the order check at batch 2, a shape no other
    phase runs: one call in float32 with cuDNN's heuristics (torch's
    defaults but TF32 off), which leaves the algorithms they chose (a slow
    FFT one among them) in PyTorch's cache, and after it the same network
    in `full_float32()`, which must not reuse them: at most 1.5 times its
    float32 time at batch 3. The same order for a caller that already
    computes in float32 with deterministic algorithms (TF32 off,
    `cudnn.deterministic` on, `cudnn.benchmark` off, flags a train loop may
    set for reproducibility) runs in a fresh process
    (`deterministic_caller_order_check`), as PyTorch's algorithm cache is
    one per process."""
    from fastposecnn_tpu_torch.data.loader import upcast_image
    from fastposecnn_tpu_torch.data.synthetic import SceneConfig, generate_scene
    from fastposecnn_tpu_torch.device import full_float32
    from fastposecnn_tpu_torch.serve import InferenceServer

    rng = np.random.default_rng(99)
    cfg = SceneConfig(height=H, width=W, max_instances=16, max_scene_instances=6,
                      render_pose_cues=True)
    color = np.stack([(np.clip(generate_scene(rng, cfg)["image"], 0, 1) * 255)
                      .astype(np.uint8) for _ in range(3)])
    trained = InferenceServer(
        weights=pathlib.Path(__file__).resolve().parent / HELD_OUT_CKPT, device="cuda")
    gen = torch.Generator(dev).manual_seed(321)
    nets = {"random_weights": (server.net, torch.randn((3, 3, H, W), generator=gen,
                                                        device=dev)),
            "FULL_c5": (trained.net, upcast_image(torch.from_numpy(color).to(dev)))}

    @contextlib.contextmanager
    def heuristics(tf32):
        benchmark = torch.backends.cudnn.benchmark
        set_tf32(tf32, tf32)
        torch.backends.cudnn.benchmark = False
        try:
            yield
        finally:
            set_tf32(False, False)
            torch.backends.cudnn.benchmark = benchmark

    out = {}
    with torch.inference_mode():
        for name, (net, images) in nets.items():
            for b in (1, 3):
                x = images[:b]

                def tf32(net=net, x=x):
                    with heuristics(True):
                        return net(x)

                def float32(net=net, x=x):
                    with full_float32():
                        return net(x)

                on, off = tf32(), float32()
                t_on, t_off = paired_ms(tf32, float32, pairs=pairs)
                out[f"{name}_b{b}"] = dict(
                    ms_tf32=statistics.median(t_on), ms_float32=statistics.median(t_off),
                    max_abs_diff={k: float((on[k] - off[k]).abs().max()) for k in off},
                    max_abs_float32={k: float(off[k].abs().max()) for k in off},
                    mask_argmax_pixels_differing=int(
                        (on["mask"].argmax(1) != off["mask"].argmax(1)).sum()))
        net, images = nets["random_weights"]
        x = images[:2]
        limit_ms = 1.5 * out["random_weights_b3"]["ms_float32"]

        def float32_b2():
            with full_float32():
                net(x)

        with heuristics(False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            net(x)
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
        after_ms = median_ms(float32_b2, iters=5, warmup=1)
        out["order_check_b2"] = dict(float32_heuristics_first_call_ms=first_ms,
                                     full_float32_after_ms=after_ms, limit_ms=limit_ms)
        if not after_ms <= limit_ms:
            raise AssertionError(
                f"full_float32() at batch 2 takes {after_ms} ms after a float32 call "
                f"under cuDNN's heuristics ({first_ms} ms), over {limit_ms} ms: it "
                f"reused the heuristics' algorithms")
    proc = subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()),
                           "--deterministic-caller-order-check"],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"the deterministic caller's order check failed:\n{proc.stderr}")
    det = json.loads(proc.stdout.strip().splitlines()[-1])
    det["limit_ms"] = limit_ms
    out["order_check_b2_deterministic_caller"] = det
    if not det["full_float32_after_ms"] <= limit_ms:
        raise AssertionError(
            f"full_float32() at batch 2 takes {det['full_float32_after_ms']} ms after a "
            f"float32 call with deterministic algorithms under cuDNN's heuristics "
            f"({det['caller_first_call_ms']} ms), over {limit_ms} ms: it reused that "
            "caller's algorithms")
    emit("network_precision", hw=[H, W], pairs=pairs, card=smi, **out)
    return out


# -----------------------------------------------------------------------------
# Every network and voting configuration


def drive_server(server, images):
    """The main path of a served configuration: every count set to 0 just
    before the requests and read just after. Returns (answers, counts)."""
    from fastposecnn_tpu_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    answers = [server(img) for img in images]
    torch.cuda.synchronize()
    return answers, kernels.launch_counts()


def logits_card_vs_cpu(dev, encoder, seed, h=96, w=128):
    """The network of `encoder` with seeded random weights at a reduced size
    (7 classes, batch 1, eval mode): its logits on the card in full float32
    against the CPU's, at the golden tolerance. Returns the largest
    difference per head."""
    from fastposecnn_tpu_torch.device import full_float32
    from fastposecnn_tpu_torch.models import PoseRegressorNet
    from fastposecnn_tpu_torch.models.weights import init_random_

    net = init_random_(PoseRegressorNet(7, encoder_name=encoder), seed).eval()
    x = torch.randn((1, 3, h, w), generator=torch.Generator().manual_seed(seed))
    with torch.inference_mode():
        want = net(x)
        with full_float32():
            got = net.to(dev)(x.to(dev))
    diff = {}
    for k, v in want.items():
        g = got[k].cpu()
        diff[k] = float((g - v).abs().max())
        if not torch.allclose(g, v, atol=2e-4, rtol=1e-4):
            raise AssertionError(f"{encoder} logits '{k}': card and CPU differ by {diff[k]}")
    return diff


def phase_serve_encoders(dev, smi, resnet18_server, requests=4):
    """`InferenceServer` with ENCODER resnet34 and resnet50 (the INFERENCE
    preset: 4096 hypotheses, 1024 points, 16 slots; seeded random weights)
    answers the serve phase's requests: K1 and K2 once a frame, finite
    answers of the served shapes. Each network's logits on the card match
    the CPU's at 96x128 at the golden tolerance. Then the median served
    frame of resnet18 (the serve phase's server), resnet34 and resnet50,
    with CUDA events, in this call."""
    from fastposecnn_tpu_torch.models.resnet import RESNET_SPECS
    from fastposecnn_tpu_torch.serve import InferenceServer

    images = served_images(dev, requests)
    launches, logit_diff, servers = {}, {}, {"resnet18": resnet18_server}
    for i, name in enumerate(("resnet34", "resnet50")):
        server = InferenceServer(device=dev, seed=0, ENCODER=name)
        enc = server.net.encoder
        if (enc.out_channels != RESNET_SPECS[name].out_channels
                or [len(getattr(enc, f"layer{j}")) for j in range(1, 5)] != [3, 4, 6, 3]):
            raise AssertionError(f"the server built {enc.encoder_name} for {name}")
        answers, launches[name] = drive_server(server, images)
        check_answers(answers)
        if launches[name]["cc_label"] != requests or launches[name]["vote_count"] != requests:
            raise AssertionError(f"{name}: launches {launches[name]} for {requests} frames")
        logit_diff[name] = logits_card_vs_cpu(dev, name, seed=20 + i)
        servers[name] = server
    frame_ms = {name: median_ms(lambda srv=srv: srv(images[0]), iters=20)
                for name, srv in servers.items()}
    emit("serve_encoders", card=smi, requests=requests, launches=launches,
         launches_per_frame={n: {k: v / requests for k, v in c.items()}
                             for n, c in launches.items()},
         logits_card_vs_cpu=dict(hw=[96, 128], tolerance=dict(atol=2e-4, rtol=1e-4),
                                 max_abs_diff=logit_diff),
         served_frame_ms_median=frame_ms)
    return {k: sum(c[k] for c in launches.values()) for k in launches["resnet34"]}


def phase_serve_soft(dev, smi, requests=4):
    """Soft voting (`HV_IMPLEMENTATION="soft"`, resnet18, the INFERENCE
    preset's 4096 hypotheses and 1024 points, iqr pruning). On perfect
    logits of the oracle scenes every GT centre has a voted centre within
    1.5 px (the JAX test's bound). The same aggregated inputs and draws on
    the card and on the CPU give the same hypotheses and centres at the
    golden tolerance. `InferenceServer` answers the serve phase's requests
    with K1 once a frame and K2 never. Prints the median served frame and
    the share of it in `hypothesis_weights` (CUDA events around each call in
    20 frames), and `hypothesis_weights` alone at the served shape."""
    from fastposecnn_tpu_torch import config as C
    from fastposecnn_tpu_torch import pipeline as P
    from fastposecnn_tpu_torch.device import full_float32
    from fastposecnn_tpu_torch.ops import voting_soft
    from fastposecnn_tpu_torch.ops.voting import VoteDraws
    from fastposecnn_tpu_torch.serve import InferenceServer

    hp = C.inference(HV_IMPLEMENTATION="soft")
    pcfg = C.pipeline_config_from(hp)
    logits, gts, inv_K, _ = oracle_batch(dev, scenes=4)
    gen = torch.Generator(dev).manual_seed(31)
    with torch.inference_mode(), full_float32():
        agg = P.run_pipeline(logits, pcfg, inv_K, generator=gen)["aggregated"]
    worst = 0.0
    for b in range(gts["valid"].shape[0]):
        pred = agg["xy"][b][agg["valid"][b]]
        for g in gts["xy"][b][gts["valid"][b]]:
            d = float((pred - g).norm(dim=-1).min()) if len(pred) else math.inf
            worst = max(worst, d)
    if not worst < 1.5:
        raise AssertionError(f"a GT centre has no soft-voted centre within 1.5 px: {worst}")

    # card against CPU: the same aggregated inputs (2 scenes) and draws
    with torch.inference_mode(), full_float32():
        cat = P.stage_class_compress({k: v[:2] for k, v in logits.items()})
        agg2 = P.stage_aggregate(cat, pcfg)
    b, n, p, h = 2, hp.MAX_INSTANCES, hp.MAX_VOTE_POINTS, hp.HV_NUM_OF_HYPOTHESES
    draws = VoteDraws(u=torch.rand((b, n, p), generator=gen, device=dev),
                      pairs=torch.randint(0, p, (1, b * n, h, 2), generator=gen, device=dev))
    inputs = {k: agg2[k] for k in ("valid", "instance_masks", "xy_dense")}
    kw = dict(max_points=p, num_hypotheses=h, prun_method=pcfg.prun_method,
              in_mask_multiplier=pcfg.hv_in_mask_multiplier)
    with torch.inference_mode():
        on_card = voting_soft.soft_hough_vote(inputs, draws=draws, **kw)
        on_cpu = voting_soft.soft_hough_vote(
            {k: v.cpu() for k, v in inputs.items()},
            draws=VoteDraws(u=draws.u.cpu(), pairs=draws.pairs.cpu()), **kw)
    vs_cpu = {}
    for k in ("xy", "hypothesis", "pruned_hypothesis"):
        a, want = on_card[k].cpu(), on_cpu[k]
        vs_cpu[k] = float((a - want).abs().max())
        if not torch.allclose(a, want, atol=2e-4, rtol=1e-4):
            raise AssertionError(f"soft voting '{k}': card and CPU differ by {vs_cpu[k]}")

    # the served frames
    server = InferenceServer(device=dev, seed=0, HV_IMPLEMENTATION="soft")
    images = served_images(dev, requests)
    answers, launches = drive_server(server, images)
    check_answers(answers)
    if launches["cc_label"] != requests or any(
            v for k, v in launches.items() if k != "cc_label"):
        raise AssertionError(f"soft serving launched {launches} for {requests} frames")
    original, spans = voting_soft.hypothesis_weights, []

    def timed_weights(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = original(*args, **kwargs)
        end.record()
        spans.append((start, end))
        return out

    server(images[0])
    frames, shares = [], []
    voting_soft.hypothesis_weights = timed_weights
    try:
        for _ in range(20):
            spans.clear()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            server(images[0])
            end.record()
            end.synchronize()
            frames.append(start.elapsed_time(end))
            shares.append(sum(a.elapsed_time(z) for a, z in spans) / frames[-1])
    finally:
        voting_soft.hypothesis_weights = original
    hyps, pts, dirs, pv, _ = vote_inputs(dev, n, h, p, n, seed=32)
    weights_ms = median_ms(lambda: voting_soft.hypothesis_weights(hyps, pts, dirs, pv),
                           iters=10)
    emit("serve_soft", card=smi, requests=requests, launches=launches,
         oracle=dict(scenes=4, worst_gt_centre_px=worst, bound_px=1.5),
         card_vs_cpu=dict(scenes=2, tolerance=dict(atol=2e-4, rtol=1e-4), max_abs_diff=vs_cpu),
         served_frame_ms_median=statistics.median(frames),
         hypothesis_weights_share_median=statistics.median(shares),
         hypothesis_weights_ms_served_shape=dict(shape=[n, h, p], ms=weights_ms))
    return launches


def phase_voting_vp(dev, smi, m=16, h=256, p=1024):
    """`ransac_vanishing_points` on the card against the CPU with the same
    point pairs (16 slots, 12 active, 1024 points, 256 hypotheses): the
    winners' counts exactly equal, the unit points within 1e-3 (as
    scripts/chip_check.py:264 allows). Launches no kernel."""
    from fastposecnn_tpu_torch import kernels
    from fastposecnn_tpu_torch.ops.voting_vp import ransac_vanishing_points

    _, pts, dirs, pv, act = vote_inputs(dev, m, 1, p, 12, seed=33)
    pairs = torch.randint(0, p, (m, h, 2), generator=torch.Generator().manual_seed(34))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with torch.inference_mode():
        best, counts = ransac_vanishing_points(pts, dirs, act, pairs.to(dev), pt_valid=pv > 0)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    with torch.inference_mode():
        want_best, want_counts = ransac_vanishing_points(pts.cpu(), dirs.cpu(), act.cpu(),
                                                         pairs, pt_valid=pv.cpu() > 0)
    if not torch.equal(counts.cpu(), want_counts):
        raise AssertionError(f"vanishing-point counts differ: {counts.cpu()} vs {want_counts}")
    err = float((best.cpu() - want_best).abs().max())
    if not err <= 1e-3 or not bool(want_counts[act.cpu()].min() > 0) or any(launches.values()):
        raise AssertionError(f"vanishing points differ by {err}, a count is 0 or a kernel "
                             f"launched: {launches}")
    ms = median_ms(lambda: ransac_vanishing_points(pts, dirs, act, pairs.to(dev),
                                                   pt_valid=pv > 0), iters=10)
    emit("voting_vp", card=smi, shape=[m, h, p], counts_equal=True, max_abs_diff_unit=err,
         tolerance_unit=1e-3, winner_counts=[float(c) for c in want_counts], ms=ms,
         launches=launches)
    return launches


def phase_train_encoders(dev, smi, steps=5):
    """ResNet50 trains at full width: `steps` HEAD_TRAINING steps (480x640,
    7 classes, batch 3, the preset's defaults) through the port's train
    step, each with the same seeded dropout masks (the frozen mask decoder's
    dropout would otherwise move the loss more than a step does), with every
    loss finite and the dense xy loss falling (the loss HEAD_TRAINING's
    gradients carry; the matched losses follow each step's vote draws and
    instances, and the frozen mask loss does not fall), K1 once a step
    and K2 once a RANSAC round, and the median ms a step (the first, with
    cuDNN's autotuning, left out); one step through the kernels against one
    through their plain versions (as `train_kernels`, the gradients in L2);
    then the train CLI
    for one epoch with `--ENCODER resnet50` on 3 synthetic scenes, whose
    network must be a resnet50."""
    import os

    from fastposecnn_tpu_torch import config as C
    from fastposecnn_tpu_torch import kernels
    from fastposecnn_tpu_torch.models.resnet import BottleneckBlock

    run = train_setup(dev, C.head_training, seed=16, ENCODER="resnet50")
    net = run["state"].net
    if not isinstance(net.encoder.layer3[0], BottleneckBlock):
        raise AssertionError("train_setup did not build resnet50")
    keep = net.draw_dropout_keep(3, dev, torch.Generator(dev).manual_seed(3))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    logs, step_ms, vote_ms = timed_steps(run, steps, dropout_keep=keep)
    launches = kernels.launch_counts()
    losses = [lg["pose/total_loss"] for lg in logs]
    dense = [lg["xy/loss_dense"] for lg in logs]
    rounds = [int(lg["pose/vote_rounds"]) for lg in logs]
    if not all(math.isfinite(v) for lg in logs for v in lg.values()) or not dense[-1] < dense[0]:
        raise AssertionError(f"resnet50 HEAD_TRAINING losses {losses}, dense xy {dense}")
    if run["state"].skipped_updates or launches["cc_label"] != steps or (
            launches["vote_count"] != sum(rounds)):
        raise AssertionError(f"resnet50 launches {launches}, rounds {rounds}, skipped "
                             f"{run['state'].skipped_updates}")
    del run, net, keep
    # Two runs of one step differ in the gradients' last bits on the card (the
    # bilinear upsampling's backward adds with atomics), which resnet50's
    # train-mode backward amplifies past atol 2e-4 (2.2e-4 and 2.4e-4 on an
    # H100 in runs whose kernel outputs were equal): the gradients are held
    # in L2 per tensor, as `train_cpu` holds the card against the CPU.
    phase_train_kernels(dev, phase="train_encoders_kernels", seed=17, grads_l2=2e-3,
                        ENCODER="resnet50")

    with tempfile.TemporaryDirectory(prefix="fpcnn_train_r50_") as tmp:
        old_logs = os.environ.get("LOGS")
        os.environ["LOGS"] = tmp
        try:
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            state, run_dir, probe = run_train_cli(
                ["-e", "SMOKE_R50", "--preset", "HEAD_TRAINING", "--synthetic", "3",
                 "--IMAGE_HEIGHT", str(H), "--IMAGE_WIDTH", str(W), "--BATCH_SIZE", "3",
                 "--SELECTED_CLASSES", *C.HParams().SELECTED_CLASSES, "--NUM_WORKERS", "2",
                 "--epochs", "1", "--ENCODER", "resnet50",
                 "--bank_pool_dir", f"{tmp}/banks", "--no_tb", "--device", dev.type])
            cli_launches = kernels.launch_counts()
            encoder = state.net.encoder
            hp = json.loads((run_dir / "HPARAM.json").read_text())
        finally:
            if old_logs is None:
                os.environ.pop("LOGS", None)
            else:
                os.environ["LOGS"] = old_logs
    if (hp["ENCODER"] != "resnet50" or len(encoder.layer3) != 6
            or not isinstance(encoder.layer3[0], BottleneckBlock)):
        raise AssertionError(f"the train CLI built {encoder.encoder_name}")
    cli_losses = [v for _, m, _ in probe.logged for k, v in m.items() if "loss" in k]
    if (state.step != 1 or not cli_losses or not all(map(math.isfinite, cli_losses))
            or cli_launches["cc_label"] != 1 + probe.eval_steps):
        raise AssertionError(f"train CLI: step {state.step}, launches {cli_launches}, "
                             f"losses {cli_losses}")
    emit("train_encoders", card=smi, encoder="resnet50", hw=[H, W], batch=3, steps=steps,
         total_loss=losses, dense_xy_loss=dense, vote_rounds=rounds, launches=launches,
         launches_per_step={k: v / steps for k, v in launches.items()},
         ms_per_step_median=statistics.median(step_ms[1:]), ms_per_step=step_ms,
         voting_ms=vote_ms, images_per_s=3e3 / statistics.median(step_ms[1:]),
         train_cli=dict(epochs=1, train_steps=state.step, eval_steps=probe.eval_steps,
                        launches=cli_launches, encoder=encoder.encoder_name))
    return {k: launches[k] + cli_launches[k] for k in launches}


DP_RANKS = 2
DP_STEPS = 3
DP_DEADLINE_S = 360.0
# The matched xy loss (a mean |dx| plus a mean |dy|; logged only, voting
# passes no gradient) is held within 0.1 px plus the golden rtol 1e-4 of
# its value: the voted centres may move by up to 0.05 px (ROADMAP.md C4),
# and with random weights the dense refinement's least squares over an
# untrained field puts the centres thousands of px off, ill-conditioned.
# One process and the ranks normalize with one BatchNorm formula (flax's
# E[x^2] - E[x]^2, ROADMAP.md C11).
XY_BAND_LOSS, XY_RTOL_LOSS = 0.1, 1e-4


def dp_setup(batch, seed):
    """The `train_dp` phase's inputs, made on the host from `seed`: the
    HEAD_TRAINING preset at full width (480x640, 7 classes, 16 slots, 1024
    points, 128 hypotheses a round, adaptive) with a global batch of
    `batch`, the global batch of synthetic scenes (numpy), the inverse
    intrinsics, and each step's dropout masks and vote draws for the whole
    batch."""
    from fastposecnn_tpu_torch import config as C
    from fastposecnn_tpu_torch.constants import CAMERA_CLASSES, scaled_intrinsics
    from fastposecnn_tpu_torch.data.synthetic import SceneConfig, make_batch
    from fastposecnn_tpu_torch.models import PoseRegressorNet
    from fastposecnn_tpu_torch.ops.voting import VoteDraws

    hp = C.head_training(IMAGE_HEIGHT=H, IMAGE_WIDTH=W, SELECTED_CLASSES=CAMERA_CLASSES[:7],
                         BATCH_SIZE=batch)
    scenes = SceneConfig(height=H, width=W, num_classes=7, max_instances=hp.MAX_INSTANCES,
                         max_scene_instances=6)
    data = make_batch(np.random.default_rng(seed), scenes, batch)
    gen = torch.Generator().manual_seed(seed)
    net = PoseRegressorNet(hp.num_classes)
    n, p, h = hp.MAX_INSTANCES, hp.MAX_VOTE_POINTS, hp.HV_NUM_OF_HYPOTHESES
    rounds = C.pipeline_config_from(hp).hv_max_iter
    draws = [dict(keep=net.draw_dropout_keep(batch, "cpu", gen),
                  draws=VoteDraws(ux=torch.rand((batch, n, p), generator=gen),
                                  uy=torch.rand((batch, n, p), generator=gen),
                                  pairs=torch.randint(0, p, (rounds, batch * n, h, 2),
                                                      generator=gen)))
             for _ in range(DP_STEPS)]
    return hp, data, np.linalg.inv(scaled_intrinsics("CAMERA", H, W)), draws


def dp_steps(hp, data, inv_k, draws, dev, seed, steps=DP_STEPS):
    """`steps` train steps on `dev` from the weights of `seed` (inside a
    process group: this rank's rows of `data`; ranks other than 0 start
    from other weights and `shard_state_tp` over the group's layout makes
    them rank 0's, tp-sharded when the layout's tp is above 1), each with
    its injected draws of the global batch. Returns (state, logs, host ms a
    step, the collectives' ms, count and longest ms a step, launches, and
    the all-reduces' and all-gathers' ms a step apart)."""
    import torch.distributed as dist

    from fastposecnn_tpu_torch import config as C
    from fastposecnn_tpu_torch import kernels
    from fastposecnn_tpu_torch.models import PoseRegressorNet
    from fastposecnn_tpu_torch.models.weights import init_random_
    from fastposecnn_tpu_torch.ops.voting import VoteDraws
    from fastposecnn_tpu_torch.parallel import mesh
    from fastposecnn_tpu_torch.train import task as T

    net = init_random_(PoseRegressorNet(hp.num_classes), seed + mesh.rank()).to(dev)
    opt = T.make_optimizer(hp, net)
    state = mesh.shard_state_tp(T.create_train_state(net, opt), mesh.layout())
    step = T.make_train_step(state.net, opt, hp, C.pipeline_config_from(hp), inv_k, dev)
    batch = T.upcast_batch(mesh.shard_batch(data), dev)
    spans = []
    originals = {"all_reduce": dist.all_reduce, "all_gather": dist.all_gather}

    def timed(kind):
        def collective(*args, **kwargs):  # the collective alone, the card idle
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = originals[kind](*args, **kwargs)
            torch.cuda.synchronize()
            spans.append((kind, time.perf_counter() - t0))
            return out
        return collective

    logs, step_ms, coll_ms, coll_n, coll_max = [], [], [], [], []
    by_kind = {kind: [] for kind in originals}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for kind in originals:
        setattr(dist, kind, timed(kind))
    try:
        for d in draws[:steps]:
            dr = d["draws"]
            on_dev = VoteDraws(ux=dr.ux.to(dev), uy=dr.uy.to(dev), pairs=dr.pairs.to(dev))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, lg = step(state, batch, seed=0,
                             dropout_keep={k: v.to(dev) for k, v in d["keep"].items()},
                             draws=on_dev)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            coll_ms.append(sum(s for _, s in spans) * 1e3)
            coll_n.append(len(spans))
            coll_max.append(max((s for _, s in spans), default=0.0) * 1e3)
            for kind, got in by_kind.items():
                got.append(dict(n=sum(k == kind for k, _ in spans),
                                ms=sum(s for k, s in spans if k == kind) * 1e3))
            spans.clear()
            logs.append({k: float(v) for k, v in lg.items()})
    finally:
        for kind, fn in originals.items():
            setattr(dist, kind, fn)
    return (state, logs, step_ms, (coll_ms, coll_n, coll_max), kernels.launch_counts(),
            by_kind)


def replicated_digest(state) -> str:
    """A digest of every tensor of `state` that is not a tp shard (the
    network's other parameters and buffers and their optimizer tensors):
    the part every rank holds whole, equal on every rank."""
    import hashlib

    from fastposecnn_tpu_torch.parallel.tp import sharded_names

    sharded = sharded_names(state.net)
    h = hashlib.sha256()
    o = state.opt_state
    for k, t in sorted(state.net.state_dict().items()):
        if k not in sharded:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    for d in (o.mu, o.nu, o.slow):
        for k in sorted(d):
            if k not in sharded:
                h.update(d[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def state_digest(state) -> str:
    import hashlib

    h = hashlib.sha256()
    o = state.opt_state
    for t in [*state.net.state_dict().values(),
              *(d[k] for d in (o.mu, o.nu, o.slow) for k in sorted(d))]:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def train_dp_rank(hp, data, inv_k, draws, seed, device, steps):
    """One rank of `train_dp` (a spawned process): gloo's all-reduce of a
    CUDA tensor checked, then `dp_steps` on `device`. Rank 0 returns its
    parameters and BatchNorm statistics on the host."""
    from fastposecnn_tpu_torch.kernels.build import build_info, load_library
    from fastposecnn_tpu_torch.parallel import mesh
    from fastposecnn_tpu_torch.train import task as T

    dev = mesh.use_rank_device(device)
    probe = torch.full((2,), float(mesh.rank() + 1), device=dev)
    summed = mesh.global_sum(probe, over="world")
    want = float(sum(range(1, mesh.world_size() + 1)))
    if summed.device != dev or summed.tolist() != [want, want]:
        raise AssertionError(f"{mesh.backend()} all-reduce of a CUDA tensor gave {summed}")
    if mesh.tp_size() > 1:  # and an all-gather over the tp group
        from fastposecnn_tpu_torch.parallel.tp import gather

        group = mesh.layout().tp_groups()[mesh.dp_rank()]
        got = gather(probe[:1])
        if got.device != dev or got.tolist() != [float(r + 1) for r in group]:
            raise AssertionError(f"{mesh.backend()} all-gather of a CUDA tensor gave {got}")
    load_library()
    # The TF32 flags are the process's own: the step must enter full float32
    # in this rank.
    inside, original = [], T.full_float32

    @contextlib.contextmanager
    def recorded_float32():
        with original():
            inside.append((torch.backends.cuda.matmul.allow_tf32,
                           torch.backends.cudnn.allow_tf32))
            yield

    T.full_float32 = recorded_float32
    try:
        state, logs, step_ms, (coll_ms, coll_n, coll_max), launches, by_kind = dp_steps(
            hp, data, inv_k, draws, dev, seed, steps)
    finally:
        T.full_float32 = original
    out = dict(rank=mesh.rank(), coords=(mesh.dp_rank(), mesh.tp_rank()),
               backend=mesh.backend(), device=str(dev),
               library_reused=build_info.get("reused"), logs=logs, step_ms=step_ms,
               collective_ms=coll_ms, collectives=coll_n, longest_collective_ms=coll_max,
               collectives_by_kind=by_kind, launches=launches,
               digest=state_digest(state), replicated_digest=replicated_digest(state),
               tf32_inside_steps=inside,
               **tp_shards(state))
    whole = mesh.gather_state_tp(state)  # every rank of a tp group takes part
    if mesh.rank() == 0:
        out["state_dict"] = {k: v.detach().cpu() for k, v in whole.net.state_dict().items()}
        out["opt"] = host_opt(whole)
    return out


def host_opt(state):
    """RAdam's moments and Lookahead's slow weights on the host."""
    o = state.opt_state
    return {part: {k: v.detach().cpu() for k, v in getattr(o, part).items()}
            for part in ("mu", "nu", "slow")}


def state_bytes(state):
    """(parameter bytes, optimizer bytes: RAdam's moments and Lookahead's
    slow weights) that `state` holds."""
    o = state.opt_state
    params = sum(p.numel() * p.element_size() for p in state.net.parameters())
    opt = sum(t.numel() * t.element_size() for part in (o.mu, o.nu, o.slow)
              for t in part.values())
    return params, opt


def tp_shards(state):
    """This rank's tensor-parallel cut: the sharded convolutions, those
    whose weight holds exactly cout / tp output channels, and the bytes it
    holds."""
    from fastposecnn_tpu_torch.parallel.tp import TPConv2d

    convs = [m for m in state.net.modules() if isinstance(m, TPConv2d)]
    params, opt = state_bytes(state)
    return dict(tp_convs=len(convs),
                tp_convs_at_cout_over_tp=sum(m.weight.shape[0] * m.tp == m.out_channels
                                             for m in convs),
                param_bytes=params, opt_bytes=opt)


def hold_run(worst, what, got, want, band=0.0, rtol=1e-4):
    """`got` against `want` at the golden tolerance (atol 2e-4, rtol 1e-4;
    a float within `band` more and `rtol`); the worst difference of each
    quantity kept in `worst`."""
    if isinstance(got, float):
        err, ok = abs(got - want), abs(got - want) <= band + 2e-4 + rtol * abs(want)
    else:
        err = float((got - want).abs().max())
        ok = torch.allclose(got, want, atol=2e-4, rtol=1e-4)
    key = what.split(" ")[-1]
    worst[key] = max(worst.get(key, 0.0), err)
    if not ok:
        raise AssertionError(f"{what}: {got if isinstance(got, float) else err} "
                             f"against {want if isinstance(want, float) else ''}")


def hold_run_logs(worst, who, got_logs, want_logs):
    """A run's logs step by step: the rounds exactly, every log at the
    golden tolerance, the matched xy loss within `XY_BAND_LOSS`."""
    for got, want in zip(got_logs, want_logs, strict=True):
        if got["pose/vote_rounds"] != want["pose/vote_rounds"]:
            raise AssertionError(f"{who}: rounds {got['pose/vote_rounds']} against "
                                 f"{want['pose/vote_rounds']}")
        for k, v in want.items():
            if k == "xy/loss_xy":
                hold_run(worst, f"{who} {k}", got[k], v, XY_BAND_LOSS, XY_RTOL_LOSS)
            else:
                hold_run(worst, f"{who} {k}", got[k], v)


def hold_run_state(worst, what, got, want):
    for k, v in want.items():
        hold_run(worst, f"{k} {what}", got[k].float(), v.float())


def phase_train_dp(dev, smi):
    """Data-parallel training on the card: two ranks share it over gloo
    (NCCL refuses two ranks of one communicator on one device), with CUDA
    tensors, each a spawned process that takes its rows of a global batch
    of 4 at full width (HEAD_TRAINING, 480x640, 7 classes, 16 slots, 1024
    points, 128 hypotheses a round, adaptive), for 3 steps with injected
    dropout masks and vote draws of the global batch; then the same 3 steps
    in this process on the global batch. Held: each rank's logs (the global
    batch's) against this process's, and rank 0's parameters and BatchNorm
    statistics after the steps, at the golden tolerance (atol 2e-4, rtol
    1e-4; the matched xy loss, logged only, within 0.1 px and 1e-3 of its
    value: `XY_BAND_LOSS`), as `train_kernels` holds the card's runs; the rounds of every step equal; the ranks'
    states bit-equal; K1 once a step and K2 once a round on each rank
    (their CUDA builds, built once by `phase_build`). One NCCL rank then
    takes the first two steps through the same collective path and is held
    against this process's first two. Prints each rank's ms a step, this
    process's in the same call, and the collectives' ms a step (each timed
    alone, the card synchronised around it). The two ranks share one card:
    their times are not a scaling result. Returns the launches of both
    ranks, and this process's run (inputs, logs, state on the host, bytes)
    for `phase_train_tp`."""
    from fastposecnn_tpu_torch.parallel import mesh

    hp, data, inv_k, draws = dp_setup(batch=4, seed=21)
    seed = 22
    phase_t0 = time.perf_counter()
    ranks = mesh.launch(train_dp_rank, DP_RANKS, (hp, data, inv_k, draws, seed, "cuda:0",
                                                 DP_STEPS),
                        backend="gloo", deadline_s=DP_DEADLINE_S)
    dp_seconds = time.perf_counter() - phase_t0
    state, logs, step_ms, _, launches, _ = dp_steps(hp, data, inv_k, draws, dev, seed)
    single_sd = {k: v.detach().cpu() for k, v in state.net.state_dict().items()}
    single = dict(inputs=(hp, data, inv_k, draws, seed), logs=logs, state_dict=single_sd,
                  opt=host_opt(state), bytes=state_bytes(state), ms_per_step=step_ms)
    del state
    t0 = time.perf_counter()
    (nccl,) = mesh.launch(train_dp_rank, 1, (hp, data, inv_k, draws, seed, "cuda:0", 2),
                          backend="nccl", deadline_s=DP_DEADLINE_S)
    nccl_seconds = time.perf_counter() - t0
    state2, first_logs, first_ms, _, _, _ = dp_steps(hp, data, inv_k, draws, dev, seed,
                                                     steps=2)
    first_sd = {k: v.detach().cpu() for k, v in state2.net.state_dict().items()}
    del state2

    worst = {}
    rounds = [int(lg["pose/vote_rounds"]) for lg in logs]
    for r in ranks:
        hold_run_logs(worst, f"rank {r['rank']}", r["logs"], logs)
        if (r["launches"]["cc_label"] != DP_STEPS
                or r["launches"]["vote_count"] != sum(rounds)):
            raise AssertionError(f"rank {r['rank']} launches {r['launches']}, rounds {rounds}")
        if (r["backend"] != "gloo" or not r["library_reused"]
                or r["tf32_inside_steps"] != [(False, False)] * DP_STEPS):
            raise AssertionError(f"rank {r['rank']}: {r['backend']}, reused "
                                 f"{r['library_reused']}, TF32 in its steps "
                                 f"{r['tf32_inside_steps']}")
    if len({r["digest"] for r in ranks}) != 1:
        raise AssertionError("the ranks' states differ after the steps")
    hold_run_state(worst, "params_and_batch_stats", ranks[0]["state_dict"], single_sd)
    hold_run_logs(worst, "nccl", nccl["logs"], first_logs)
    hold_run_state(worst, "nccl_params_and_batch_stats", nccl["state_dict"], first_sd)
    if nccl["backend"] != "nccl" or nccl["launches"]["cc_label"] != 2:
        raise AssertionError(f"NCCL rank: {nccl['backend']}, launches {nccl['launches']}")
    both = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    emit("train_dp", card=smi, ranks=DP_RANKS, backend="gloo", shared_card=True,
         gloo_all_reduces_cuda_tensors=True,
         hw=[H, W], global_batch=4, batch_per_rank=2, steps=DP_STEPS, classes=7,
         tolerance=dict(logs_params_batch_stats=dict(atol=2e-4, rtol=1e-4),
                        xy_loss=dict(atol=2e-4 + XY_BAND_LOSS, rtol=XY_RTOL_LOSS),
                        rounds="exact", ranks_states="bit-equal"),
         max_abs_diff=worst, vote_rounds=rounds,
         launches_per_rank={r["rank"]: r["launches"] for r in ranks},
         ms_per_step_per_rank={r["rank"]: r["step_ms"] for r in ranks},
         collective_ms_per_step_per_rank={r["rank"]: r["collective_ms"] for r in ranks},
         longest_collective_ms_per_step_per_rank={r["rank"]: r["longest_collective_ms"]
                                                  for r in ranks},
         collectives_per_step=ranks[0]["collectives"],
         single_process=dict(batch=4, ms_per_step=step_ms, launches=launches),
         total_loss=[lg["pose/total_loss"] for lg in logs],
         launch_seconds=dp_seconds,
         nccl=dict(ranks=1, steps=2, seconds=nccl_seconds, ms_per_step=nccl["step_ms"],
                   collective_ms=nccl["collective_ms"], collectives=nccl["collectives"],
                   longest_collective_ms=nccl["longest_collective_ms"],
                   launches=nccl["launches"], single_process_ms=first_ms))
    return both, single


TP_LAYOUT = (2, 2)  # (dp, tp)
TP_SHARDED_CONVS = 59  # resnet18's layer2-4 and the four FPNs' 256/128-channel convs


def phase_train_tp(single):
    """Tensor-parallel training on the card: four ranks laid out (dp 2, tp
    2) share it over gloo, with CUDA tensors (NCCL refuses two ranks of one
    communicator on one device), each a spawned process; the state is
    `shard_state_tp`'d (the 59 wide convolutions' output channels split over
    each tp group, with their moments and slow weights), the two ranks of a
    tp group take the same rows of the global batch of 4 at full width
    (HEAD_TRAINING, 480x640, 7 classes, 16 slots, 1024 points, 128
    hypotheses a round, adaptive), for the same `DP_STEPS` steps, inputs
    and injected draws as `train_dp`. Held against `train_dp`'s
    single-process steps (`single`, not run again): every rank's logs at the
    golden tolerance (the matched xy loss within `XY_BAND_LOSS`), the rounds
    exactly; rank 0's parameters, BatchNorm statistics, moments and slow
    weights, gathered over its tp group, at the golden tolerance; the two
    ranks of each tp index bit-equal; every rank's replicated tensors (all
    but the tp shards, with their optimizer tensors) bit-equal, which needs
    the same cuDNN algorithms on each rank of a tp group (`full_float32()`
    takes the deterministic heuristics there); each rank's 59 sharded weights at
    cout / 2 channels; K1 `DP_STEPS` times and K2 once a round on every
    rank; TF32 off inside every rank's steps. Prints each rank's parameter
    and optimizer bytes against one process's (about 0.505 expected), its
    ms a step and the all-gathers' and all-reduces' ms a step (each timed
    alone). Four ranks sharing one card over gloo are no scaling figure.
    Returns the launches of every rank."""
    from fastposecnn_tpu_torch.parallel import mesh

    hp, data, inv_k, draws, seed = single["inputs"]
    layout = mesh.make_mesh(TP_LAYOUT[0] * TP_LAYOUT[1], tp=TP_LAYOUT[1])
    torch.cuda.empty_cache()  # four more processes on the card
    t0 = time.perf_counter()
    ranks = mesh.launch(train_dp_rank, layout.size,
                        (hp, data, inv_k, draws, seed, "cuda:0", DP_STEPS),
                        backend="gloo", deadline_s=DP_DEADLINE_S, layout=layout)
    seconds = time.perf_counter() - t0
    worst = {}
    logs = single["logs"]
    rounds = [int(lg["pose/vote_rounds"]) for lg in logs]
    for r in ranks:
        hold_run_logs(worst, f"rank {r['rank']}", r["logs"], logs)
        if (r["launches"]["cc_label"] != DP_STEPS
                or r["launches"]["vote_count"] != sum(rounds)):
            raise AssertionError(f"rank {r['rank']} launches {r['launches']}, rounds {rounds}")
        if (r["backend"] != "gloo" or not r["library_reused"]
                or r["tf32_inside_steps"] != [(False, False)] * DP_STEPS):
            raise AssertionError(f"rank {r['rank']}: {r['backend']}, reused "
                                 f"{r['library_reused']}, TF32 in its steps "
                                 f"{r['tf32_inside_steps']}")
        if not r["tp_convs"] == r["tp_convs_at_cout_over_tp"] == TP_SHARDED_CONVS:
            raise AssertionError(f"rank {r['rank']}: {r['tp_convs']} sharded convolutions, "
                                 f"{r['tp_convs_at_cout_over_tp']} at cout / tp")
    if [r["coords"] for r in ranks] != [layout.coords(i) for i in range(layout.size)]:
        raise AssertionError(f"coordinates {[r['coords'] for r in ranks]}")
    for t in range(layout.tp):
        if len({r["digest"] for r in ranks if r["coords"][1] == t}) != 1:
            raise AssertionError(f"the ranks of tp index {t} differ after the steps")
    if len({r["replicated_digest"] for r in ranks}) != 1:
        raise AssertionError("the ranks' replicated tensors differ after the steps")
    hold_run_state(worst, "params_and_batch_stats", ranks[0]["state_dict"],
                   single["state_dict"])
    for part in ("mu", "nu", "slow"):
        hold_run_state(worst, part, ranks[0]["opt"][part], single["opt"][part])
    one_params, one_opt = single["bytes"]
    bytes_share = {r["rank"]: (r["param_bytes"] + r["opt_bytes"]) / (one_params + one_opt)
                   for r in ranks}
    emit("train_tp", card=nvidia_smi(), ranks=layout.size, mesh=layout.shape,
         backend="gloo", shared_card=True, no_scaling_figure=True, hw=[H, W], global_batch=4,
         batch_per_rank=4 // layout.dp, steps=DP_STEPS, classes=7,
         tp_sharded_convs=TP_SHARDED_CONVS,
         tolerance=dict(logs_params_batch_stats_moments_slow=dict(atol=2e-4, rtol=1e-4),
                        xy_loss=dict(atol=2e-4 + XY_BAND_LOSS, rtol=XY_RTOL_LOSS),
                        rounds="exact", ranks_of_a_tp_index="bit-equal",
                        replicated_tensors_of_every_rank="bit-equal"),
         max_abs_diff=worst, vote_rounds=rounds,
         bytes_per_rank={r["rank"]: dict(params=r["param_bytes"], optimizer=r["opt_bytes"])
                         for r in ranks},
         bytes_one_process=dict(params=one_params, optimizer=one_opt),
         bytes_share_of_one_process=bytes_share,
         launches_per_rank={r["rank"]: r["launches"] for r in ranks},
         ms_per_step_per_rank={r["rank"]: r["step_ms"] for r in ranks},
         collectives_per_step_per_rank={r["rank"]: r["collectives_by_kind"] for r in ranks},
         collective_ms_per_step_per_rank={r["rank"]: r["collective_ms"] for r in ranks},
         single_process_ms_per_step=single["ms_per_step"], launch_seconds=seconds)
    return {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}


# -----------------------------------------------------------------------------
# Export, dataset preparation, figures


EXPORT_TIMED_FRAMES = 20


def export_answers(fn, images):
    """`fn` on each image, synchronised: the answers as host tensors."""
    answers = [fn(img) for img in images]
    torch.cuda.synchronize()
    return [[t.cpu() for t in a] for a in answers]


def frame_profile(fn, frame_ms, calls=10, tries=4):
    """Where a frame's time goes, from a torch.profiler trace of `calls`
    calls of `fn` (taken again, up to `tries` times, if it holds no device
    event): the card's busy ms a frame (summed device time of every kernel,
    copy and set) and its idle share against `frame_ms`, the device
    operations, the host's ATen calls (all, and the outermost ones, which
    the caller made itself) and its kernel launch calls a frame, the host
    ms a frame in the trace and the part of it inside the outermost ATen
    calls (the rest is the caller's Python between them), and the device
    microseconds a frame of each kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for n in range(1, tries + 1):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3 / calls
        device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if device:
            break
    aten = [e for e in prof.events() if e.name.startswith("aten::")]
    outer = [e for e in aten if e.cpu_parent is None
             or not e.cpu_parent.name.startswith("aten::")]
    busy_ms = sum(e.self_device_time_total for e in device) / calls / 1e3
    return dict(device_busy_ms=busy_ms, idle_share=1 - busy_ms / frame_ms,
                device_ops=sum(e.count for e in device) / calls,
                aten_calls=len(aten) / calls, outer_aten_calls=len(outer) / calls,
                host_ms_traced=host_ms,
                outer_aten_host_ms=sum(e.cpu_time_total for e in outer) / calls / 1e3,
                launch_calls=sum(1 for e in prof.events() if "LaunchKernel" in e.name) / calls,
                device_us_by_kernel={e.key: e.self_device_time_total / calls for e in device},
                traces=n)


def run_exported(program, inputs, output):
    """Run as `chip_smoke.py --run-exported PROGRAM INPUTS OUTPUT`, in a fresh
    process: load the exported pipeline with `utils.export.load_exported`
    (which registers the port's custom ops here: no module of the port's
    ops is imported before it), answer the requests saved in INPUTS on the
    card with the launch counters reset just before, time one request, and
    save the answers, the launches and the times to OUTPUT."""
    if any(m.startswith("fastposecnn_tpu_torch.ops") for m in sys.modules):
        raise AssertionError("the port's ops were imported before the program was loaded")
    from fastposecnn_tpu_torch import kernels
    from fastposecnn_tpu_torch.utils.export import load_exported

    t0 = time.perf_counter()
    fn = load_exported(program)
    load_s = time.perf_counter() - t0
    images = [x.to(fn.meta["device"]) for x in torch.load(inputs)]
    t0 = time.perf_counter()
    fn(images[0])
    torch.cuda.synchronize()
    first_call_s = time.perf_counter() - t0
    kernels.reset_launch_counts()
    answers = export_answers(fn, images)
    launches = kernels.launch_counts()
    frames = event_ms(lambda: fn(images[0]), iters=EXPORT_TIMED_FRAMES, warmup=2)
    ms = statistics.median(frames)
    torch.save(dict(answers=answers, launches=launches, ms=ms, frames_ms=frames,
                    profile=frame_profile(lambda: fn(images[0]), ms),
                    load_s=load_s, first_call_s=first_call_s, meta=fn.meta), output)


def hold_answers(what, got, want):
    """Exported answers against eager ones: mask, class ids and the valid
    slots exactly, xy, z and RT at the golden tolerance. Returns the
    largest differences."""
    worst = {}
    for a, b in zip(got, want, strict=True):
        mask, cls, xy, z, rt = a
        if not (torch.equal(mask, b[0]) and torch.equal(cls, b[1])):
            raise AssertionError(f"{what}: mask or class ids differ from eager")
        for name, x, y in (("xy", xy, b[2]), ("z", z, b[3]), ("RT", rt, b[4])):
            worst[name] = max(worst.get(name, 0.0), float((x - y).abs().max()))
            if not torch.allclose(x, y, atol=2e-4, rtol=1e-4):
                raise AssertionError(f"{what}: {name} differs from eager by {worst[name]}")
    return worst


def phase_export(dev, smi, server, requests=4):
    """The served pipeline (INFERENCE, resnet18, 7 classes, 480x640, 16
    slots, 1024 points, 4096 hypotheses, single shot) exported on the card
    with `utils.export.export_forward` (draws from a seed baked in) and
    saved as a `.pt2`; loaded in a fresh process (`run_exported`), which
    answers the `serve` phase's requests and launches K1 and K2 from the
    loaded program (counted there), held against `InferenceServer` on the
    same draws (mask, class ids and slots exact; xy, z and RT at the golden
    tolerance). Then the adaptive vote loop (HV_ADAPTIVE, 128 hypotheses a
    round, up to 20 rounds) exported as one `while_loop`, run in this
    process against eager `run_pipeline` on the same draws: the same
    answers, and K2 once a round of the eager run. Prints the loaded
    program's frame ms beside the eager served frame's, and where each
    frame's time goes (`frame_profile` of both). Returns the fresh
    process's launches."""
    from fastposecnn_tpu_torch import kernels
    from fastposecnn_tpu_torch import pipeline as P
    from fastposecnn_tpu_torch.device import full_float32
    from fastposecnn_tpu_torch.ops.connected_components import raise_on_error_flag
    from fastposecnn_tpu_torch.utils.export import export_forward, load_exported, make_draws

    images = served_images(dev, requests)
    inv_k = server.inv_K.cpu().numpy()
    draws = make_draws(server.config, 1, seed=5, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        export_forward(server.net, tmp / "served.pt2", image_shape=(1, 3, H, W),
                       pipeline_config=server.config, inv_intrinsics=inv_k, draws=draws)
        export_s = time.perf_counter() - t0
        size = (tmp / "served.pt2").stat().st_size
        torch.save([x.cpu() for x in images], tmp / "inputs.pt")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()),
                               "--run-exported", str(tmp / "served.pt2"),
                               str(tmp / "inputs.pt"), str(tmp / "out.pt")],
                              capture_output=True, text=True, timeout=400, check=False)
        fresh_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"the fresh process failed:\n{proc.stderr[-4000:]}")
        fresh = torch.load(tmp / "out.pt")
    want = export_answers(lambda x: server(x, draws=draws), images)
    worst = hold_answers("exported served pipeline", fresh["answers"], want)
    launches = fresh["launches"]
    if launches["cc_label"] != requests or launches["vote_count"] != requests:
        raise AssertionError(f"the loaded program launched {launches}")
    eager = event_ms(lambda: server(images[0], draws=draws), iters=EXPORT_TIMED_FRAMES, warmup=2)
    # Where the loaded program's extra time goes: both frames traced alike,
    # and the kernels whose device time a frame differs most between them.
    profiles = dict(exported=fresh["profile"], eager=frame_profile(
        lambda: server(images[0], draws=draws), statistics.median(eager)))
    by_kernel = {k: p.pop("device_us_by_kernel") for k, p in profiles.items()}
    names = set(by_kernel["exported"]) | set(by_kernel["eager"])
    kernel_us_diff = dict(sorted(
        ((k, by_kernel["exported"].get(k, 0.0) - by_kernel["eager"].get(k, 0.0)) for k in names),
        key=lambda kv: -abs(kv[1]))[:8])

    # The adaptive loop as one while_loop in the program.
    pcfg = dataclasses.replace(server.config, hv_adaptive=True, hv_num_hypotheses=128)
    adraws = make_draws(pcfg, 1, seed=6, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "adaptive.pt2"
        t0 = time.perf_counter()
        export_forward(server.net, path, image_shape=(1, 3, H, W), pipeline_config=pcfg,
                       inv_intrinsics=inv_k, draws=adraws)
        adaptive_export_s = time.perf_counter() - t0
        adaptive = load_exported(path)
    rounds, a_want = [], []
    for x in images:
        with torch.inference_mode(), full_float32():
            out = P.run_pipeline(server.net(x), pcfg, server.inv_K, draws=adraws)
        agg = out["aggregated"]
        raise_on_error_flag(agg["cc_error"])
        rounds.append(agg["vote_rounds"])
        a_want.append([t.cpu() for t in (out["categorical"]["mask"], agg["class_ids"],
                                         agg["xy"], agg["z"], agg["RT"])])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    a_got = export_answers(adaptive, images)
    a_launches = kernels.launch_counts()
    a_worst = hold_answers("exported adaptive pipeline", a_got, a_want)
    if a_launches["vote_count"] != sum(rounds) or a_launches["cc_label"] != requests:
        raise AssertionError(f"adaptive program launches {a_launches}, eager rounds {rounds}")
    a_ms = event_ms(lambda: adaptive(images[0]), iters=5, warmup=1)
    emit("export", card=smi, shape=[1, 3, H, W], classes=7, slots=16, points=1024,
         hypotheses=4096, adaptive=False, pt2_bytes=size, export_s=export_s,
         fresh_process_s=fresh_s, load_s=fresh["load_s"], first_call_s=fresh["first_call_s"],
         launches=launches, valid_instances=[int((a[1] > 0).sum()) for a in want],
         tolerance=dict(mask_class_ids_slots="exact", xy_z_RT=dict(atol=2e-4, rtol=1e-4)),
         max_abs_diff=worst, exported_frame_ms=fresh["ms"], eager_frame_ms=statistics.median(eager),
         exported_frames_ms=fresh["frames_ms"], eager_frames_ms=eager,
         frame_profiles=profiles, kernel_us_diff_exported_minus_eager=kernel_us_diff,
         adaptive_loop=dict(route="while_loop", hypotheses_a_round=128, max_rounds=20,
                            eager_rounds=rounds, launches=a_launches, export_s=adaptive_export_s,
                            max_abs_diff=a_worst, exported_frame_ms=statistics.median(a_ms)))
    return launches


def render_instance(intrinsics, R, s, h, w, box, z0=1.2):
    """NOCS coordinates and depth of one object seen in the pixel box
    (x0, y0, x1, y1) whose pose is inv_RT = [s R | t], on a curved depth
    surface (a copy of the JAX package's test renderer,
    `tests/test_meta_plus.py::render_instance`): t is the camera-space
    centre of the box, so the patch lies inside the model cube. Returns
    (coord [H, W, 3] in [0, 1], depth uint16 mm, mask, t)."""
    x0, y0, x1, y1 = box
    ys, xs = np.mgrid[y0:y1, x0:x1]
    z = z0 + 0.0004 * (xs - (x0 + x1) / 2) ** 2 + 0.0003 * (ys - y0) ** 2
    inv_K = np.linalg.inv(intrinsics)
    cam = np.stack([xs * z, ys * z, z], axis=-1) @ inv_K.T
    cz = z0 + 0.0001 * ((x1 - x0) ** 2 / 4)
    t = inv_K @ np.array([(x0 + x1) / 2 * cz, (y0 + y1) / 2 * cz, cz])
    p = (cam - t) @ R / s  # model coordinates: (1/s) R^T (c - t)
    keep = np.all(np.abs(p) < 0.5, axis=-1)
    coord = np.zeros((h, w, 3))
    depth = np.zeros((h, w), np.uint16)
    mask = np.zeros((h, w), bool)
    coord[ys[keep], xs[keep]] = p[keep] + 0.5
    depth[ys[keep], xs[keep]] = (z[keep] * 1000).astype(np.uint16)
    mask[ys[keep], xs[keep]] = True
    return coord, depth, mask, t


def write_raw_nocs(root, frames, seed, h=H, w=W):
    """`frames` raw NOCS frames of two rendered instances each, with known
    poses, as a NOCS tree under `root` (`XXXX_{color,mask,coord,depth}.png`
    written by `data/png.py`, `XXXX_meta.txt`; the coord map's z flipped as
    NOCS stores it). Returns the true (scale, R, t) of each frame's
    instances."""
    import scipy.spatial.transform as sst

    from fastposecnn_tpu_torch.constants import INTRINSICS
    from fastposecnn_tpu_torch.data.png import encode_png

    rng = np.random.default_rng(seed)
    K = INTRINSICS["CAMERA"]
    truth = []
    for f in range(frames):
        d = pathlib.Path(root) / f"{f // 4:05d}"
        d.mkdir(parents=True, exist_ok=True)
        prefix = d / f"{f % 4:04d}"
        coord = np.zeros((h, w, 3))
        depth = np.zeros((h, w), np.uint16)
        mask = np.full((h, w), 255, np.uint8)
        lines, poses = [], []
        for iid, box in ((1, (60, 110, 260, 330)), (2, (360, 130, 560, 350))):
            R = sst.Rotation.from_euler("xyz", rng.uniform(-45, 45, 3), degrees=True).as_matrix()
            s = float(rng.uniform(0.6, 0.9))
            c, dep, m, t = render_instance(K, R, s, h, w, box)
            coord[m], depth[m], mask[m] = c[m], dep[m], iid
            lines.append(f"{iid} {int(rng.integers(1, 7))} model_{f}_{iid}")
            poses.append((s, R, t))
        stored = coord.copy()
        stored[..., 2] = np.where(mask != 255, 1.0 - coord[..., 2], 0.0)
        encode_png(f"{prefix}_color.png", rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        encode_png(f"{prefix}_mask.png", mask)
        encode_png(f"{prefix}_coord.png", np.round(stored * 255).astype(np.uint8))
        encode_png(f"{prefix}_depth.png", depth)
        pathlib.Path(f"{prefix}_meta.txt").write_text("\n".join(lines) + "\n")
        truth.append(poses)
    return truth


def phase_create_meta(dev, smi, frames=8):
    """Dataset preparation on the card's host: 8 rendered 480x640 frames of
    two instances with known poses, written as a raw NOCS tree;
    `python -m fastposecnn_tpu_torch.cli.create_meta` on it; each recovered
    RT held against the truth at the JAX test's tolerance (scale rtol
    0.02, rotation atol 0.02, translation atol 0.01 m); the port's
    `NOCSDataset` reads every frame with both instances. Prints the seconds
    a frame."""
    from fastposecnn_tpu_torch.data.nocs import NOCSDataset

    with tempfile.TemporaryDirectory() as tmp:
        truth = write_raw_nocs(tmp, frames, seed=31)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "fastposecnn_tpu_torch.cli.create_meta",
                               "--root", tmp], capture_output=True, text=True, timeout=300,
                              cwd=pathlib.Path(__file__).resolve().parent, check=False)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0 or f"wrote {frames} meta+ files" not in proc.stdout:
            raise AssertionError(f"create_meta: {proc.stdout}{proc.stderr[-3000:]}")
        worst = dict(scale_rel=0.0, rotation=0.0, translation=0.0)
        metas = sorted(pathlib.Path(tmp).rglob("*_meta+.json"))
        for meta_fp, poses in zip(metas, truth, strict=True):
            meta = json.loads(meta_fp.read_text())
            if sorted(meta["instance_dict"]) != ["1", "2"]:
                raise AssertionError(f"{meta_fp}: instances {meta['instance_dict']}")
            for RT, (s, R, t) in zip(meta["RTs"], poses, strict=True):
                inv = np.linalg.inv(np.asarray(RT))
                s2 = float(np.cbrt(np.linalg.det(inv[:3, :3])))
                errs = dict(scale_rel=abs(s2 - s) / s,
                            rotation=float(np.abs(inv[:3, :3] / s2 - R).max()),
                            translation=float(np.abs(inv[:3, 3] - t).max()))
                worst = {k: max(worst[k], v) for k, v in errs.items()}
        if not (worst["scale_rel"] <= 0.02 and worst["rotation"] <= 0.02
                and worst["translation"] <= 0.01):
            raise AssertionError(f"create_meta's poses are off: {worst}")
        ds = NOCSDataset(tmp, max_instances=16)
        valid = [int(ds[i]["agg"]["valid"].sum()) for i in range(len(ds))]
        if valid != [2] * frames:
            raise AssertionError(f"NOCSDataset read {len(ds)} frames, valid instances {valid}")
    emit("create_meta", card=smi, frames=frames, hw=[H, W], instances_per_frame=2,
         seconds=seconds, seconds_per_frame=seconds / frames, max_error=worst,
         tolerance=dict(scale_rel=0.02, rotation=0.02, translation_m=0.01),
         dataset_frames=len(valid))


FIGURE_PACKAGES = ("cv2", "matplotlib", "pandas", "PIL")


def imports(module):
    try:
        __import__(module)
        return True
    except ImportError:
        return False


def expect_refusal(fn, package):
    """fn() must raise an ImportError whose message names `package`; returns
    the message."""
    try:
        fn()
    except ImportError as e:
        if package not in str(e):
            raise AssertionError(f"the refusal does not name {package}: {e}") from e
        return str(e)
    raise AssertionError(f"no refusal without {package}")


def phase_figures(dev, smi):
    """The figures and tables on the card's machine: which of cv2,
    matplotlib, pandas and PIL import; for each that does not, the entry
    points that need it refuse and name it (drawing, the inference CLI's
    `--output`, the evaluate CLI's `--draw`, the figures; pandas: the frames
    of `aps_to_frames`, while `save_aps` writes its CSV with numpy); for each
    that does, the figures at full width (cv2: GT and predicted poses
    drawn on a 480x640 image; pandas: the table through pandas, an xlsx
    with an Excel engine, else CSV). Then the inference CLI with
    `--trace` at full width on 2 synthetic scenes: its Chrome trace names
    K1's and K2's device kernels. Returns the traced run's launches."""
    from fastposecnn_tpu_torch import kernels
    from fastposecnn_tpu_torch.cli import evaluate as ev
    from fastposecnn_tpu_torch.cli import inference as inf
    from fastposecnn_tpu_torch.data.png import encode_png
    from fastposecnn_tpu_torch.utils import draw, report
    from fastposecnn_tpu_torch.utils import visualize as vz

    present = {m: imports(m) for m in FIGURE_PACKAGES}
    small = ["--synthetic", "1", "--device", dev.type]
    refusals, written = {}, {}
    K = np.array([[577.5, 0, 319.5], [0, 577.5, 239.5], [0, 0, 1.0]])
    RT = np.eye(4)
    RT[2, 3] = -1.0
    image = np.zeros((H, W, 3), np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        if not present["cv2"]:
            refusals["cv2"] = [expect_refusal(lambda: draw.draw_RT(image, RT, np.ones(3) * .3, K),
                                              "cv2"),
                               expect_refusal(lambda: vz.visualize_hypothesis(
                                   image / 255.0, np.zeros((1, 2)), [True]), "cv2")]
        if not present["matplotlib"]:
            refusals["matplotlib"] = [
                expect_refusal(lambda: vz.make_summary_figure(rgb=image), "matplotlib"),
                expect_refusal(lambda: inf.main(small + ["--output", str(tmp / "inf"),
                                                         "--draw", "1"]), "matplotlib"),
                expect_refusal(lambda: ev.main(small + ["--output", str(tmp / "ev"),
                                                        "--draw", "1"]), "matplotlib")]
            plot = ev.save_ap_plot(tmp / "aps.png", {"3d_iou": {"mean": np.ones(3)}},
                                   {"3d_iou": np.linspace(0, 1, 3)}, ["mean"])
            if "matplotlib" not in plot or (tmp / "aps.png").exists():
                raise AssertionError(f"phase B's plot without matplotlib: {plot}")
            refusals["matplotlib"].append(plot)
        elif not present["cv2"]:
            refusals["cv2"].append(expect_refusal(lambda: inf.main(
                small + ["--output", str(tmp / "inf"), "--draw", "1"]), "cv2"))
        else:
            summary = inf.main(small + ["--output", str(tmp / "inf"), "--draw", "1"])
            ev_summary = ev.main(small + ["--output", str(tmp / "ev"), "--draw", "1"])
            pngs = sorted(p.name for p in (tmp / "ev").glob("eval_*.png"))
            if len(summary["figures"]) != 1 or len(pngs) != 3 or not ev_summary["ap_plot"].endswith(".png"):
                raise AssertionError(f"figures: {summary['figures']}, {pngs}, {ev_summary['ap_plot']}")
            written = dict(inference=summary["figures"], evaluate=pngs + [ev_summary["ap_plot"]])
        if present["cv2"]:  # the GT and predicted poses drawn at full width
            truth = np.eye(4)
            truth[:3, 3] = (0.0, 0.0, -0.8)
            pred = truth.copy()
            pred[:3, 3] = (0.02, -0.01, -0.82)
            drawn = vz.compare_pose_performance(image / 255.0, truth[None], np.full((1, 3), .2),
                                                pred[None], np.full((1, 3), .2), [True], K)
            changed = int((drawn != 0).any(-1).sum())
            if drawn.shape != (H, W, 3) or changed < 1000:
                raise AssertionError(f"the drawn poses changed {changed} pixels")
            encode_png(tmp / "poses.png", (drawn * 255).astype(np.uint8))
            written["poses_drawn_pixels"] = changed
        thr = {"3d_iou": np.linspace(0, 1, 3)}
        aps = {"3d_iou": {"mean": np.asarray([1.0, 0.5, 0.0])}}
        table = report.save_aps(tmp / "t.xlsx", thr, aps, ["mean"])
        written["table"] = table.name
        if table.suffix != ".xlsx":
            text = (table / "3d_iou.csv").read_text()
            if text != ",mean\n0.0,100.0\n0.5,50.0\n1.0,0.0\n":
                raise AssertionError(f"the CSV table: {text!r}")
        if not present["pandas"]:
            refusals["pandas"] = [expect_refusal(lambda: report.aps_to_frames(thr, aps, ["mean"]),
                                                 "pandas")]

        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        traced = inf.main(["--synthetic", "2", "--device", dev.type, "--trace", str(tmp / "trace")])
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        events = json.loads(pathlib.Path(traced["trace"]).read_text())["traceEvents"]
    names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    k1 = sorted({n for n in names if "cc_tile" in n or "cc_flatten" in n or "cc_border" in n})
    k2 = sorted({n for n in names if "vote_count_kernel" in n})
    if not k1 or not k2 or launches["cc_label"] != 2 or launches["vote_count"] != 2:
        raise AssertionError(f"the trace's kernels {sorted(names)[:20]}, launches {launches}")
    emit("figures", card=smi, packages=present, refusals=refusals, written=written,
         trace=dict(frames=traced["frames"], device_kernels=len(names), k1_kernels=k1,
                    k2_kernels=k2, launches=launches))
    return launches


# -----------------------------------------------------------------------------
# The bfloat16 network (COMPUTE_DTYPE)

# A stage of the bf16 network on the card (`bf16_stage_modules`: one bf16
# convolution, or a head), on the CPU's bf16 input to it, lies within this
# share of the card's own bf16-vs-float32 distance of the stage from the
# CPU's bf16 output (cuDNN's accumulation order is not the CPU's).
BF16_STAGE_SHARE = 0.25
# Two bf16 programs that differ by any float32 rounding drift apart through
# a deep network (each rounding to bf16 turns a relative difference e into
# about sqrt(e * 2^-8)) until each lies from the other as two independent
# roundings do: about sqrt(2) times as far as each lies from float32. The
# whole network and a whole train step on the card are held within twice
# the card's own bf16-vs-float32 distance of the CPU's.
BF16_WHOLE_FACTOR = 2.0
# The logs of a bf16 train step that neither the CC instances of the
# predicted mask nor the matching reach, within one bf16 ulp (2^-7,
# relative) of the CPU's. (The gradients' global norm carries their drift:
# it is held with them, in L2.)
BF16_VOTE_FREE_LOGS = ("mask/loss_cce", "mask/loss_ce", "mask/loss_focal",
                       "mask/task_total_loss", "pose/dense_total")
BF16_LOG_RTOL = 2.0 ** -7
# A gradient of a train-mode stage (`bf16_stages_train_card_vs_cpu`) on the
# card lies within this share of its own bf16-vs-float32 distance from the
# CPU's. A gradient carries two bf16 roundings (its cotangent's cast and the
# convolution's data or weight gradient), and a normalization between them
# in the decoders' conv-GroupNorm-ReLU blocks: on an H100 one such block on
# the 96x128 step's 3x4 p5 map measured 0.32 (its input gradient; every
# other gradient at most 0.072, float32 on the card 4.6e-7 from the CPU's,
# and the CPU's bf16 convolutions exactly rounded there). A float32 backward
# or a cast in the wrong place lies near 1.
BF16_GRAD_SHARE = 0.5
# A BatchNorm of the bf16 network computes in float32 on its bf16 input, on
# the card as on the CPU; only its input gradient is rounded to bf16. In
# train mode its output and gradients on the card lie within one bf16
# rounding (relative L2) of the CPU's on the same input and cotangent.
BF16_NORM_RTOL = 2.0 ** -8


def rel_l2(got, want):
    """||got - want|| / ||want|| over tensors (or lists of them), in float64
    on the host."""
    if isinstance(got, torch.Tensor):
        got, want = [got], [want]
    g = torch.cat([t.detach().double().cpu().reshape(-1) for t in got])
    w = torch.cat([t.detach().double().cpu().reshape(-1) for t in want])
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


def to_device(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, (list, tuple)):
        return type(x)(to_device(v, dev) for v in x)
    return x


def bf16_stage_modules(net, norms=False):
    """The modules the bf16 network is held at, stage by stage: each holds
    one bf16 convolution (a bare one, the decoders' conv-GroupNorm-ReLU
    blocks, their top-down blocks) or is a head (its convolution and its
    bf16 x4 upsample), so that a stage's card-vs-CPU distance is the ops'
    own and not the drift of a chain of bf16 roundings; with `norms`, the
    encoder's BatchNorms too."""
    from fastposecnn_tpu_torch.models.conv import Conv2d
    from fastposecnn_tpu_torch.models.fpn import Conv3x3GNReLU, FPNBlock, SegmentationHead
    from fastposecnn_tpu_torch.models.resnet import BatchNorm

    kinds = (Conv2d, Conv3x3GNReLU, FPNBlock, SegmentationHead) + ((BatchNorm,) if norms else ())
    return {name: m for name, m in net.named_modules() if isinstance(m, kinds)}


def capture_stages(net):
    """Forward hooks on every stage of `net` (`bf16_stage_modules` with the
    norms) that keep each stage's inputs and, through a hook on its output,
    the cotangent the backward brings it. Returns (seen, hooks): seen[name]
    = [inputs, cotangent]."""
    seen = {}

    def hook(module, args, out, name):
        seen[name] = [tuple(a.detach().clone() for a in args), None]
        out.register_hook(lambda g: seen[name].__setitem__(1, g.detach().clone()))

    hooks = [m.register_forward_hook(lambda m, a, o, name=name: hook(m, a, o, name))
             for name, m in bf16_stage_modules(net, norms=True).items()]
    return seen, hooks


def stage_forward_backward(module, args, cot, device):
    """`module` on copies of `args` on `device`, pulled back with `cot`: its
    output and the gradients of its inputs and of its parameters."""
    xs = [a.detach().to(device, copy=True).requires_grad_(a.is_floating_point()) for a in args]
    module.zero_grad(set_to_none=True)
    y = module(*xs)
    y.backward(cot.to(device, y.dtype))
    return dict(output=y.detach(), inputs=[x.grad for x in xs if x.grad is not None],
                params=[q.grad for q in module.parameters() if q.grad is not None])


def bf16_stages_train_card_vs_cpu(dev, state_dict, seen, classes=7):
    """Each stage of the bf16 network in train mode (`capture_stages`, the
    weights `state_dict`) run forward on the CPU's bf16 input to it and
    pulled back with the CPU step's cotangent of its output: in bf16 and in
    float32, on the card and on the CPU. Per stage, for the output, the
    inputs' gradients and the parameters' gradients: the card's bf16
    distance from the CPU's bf16 and from its own float32 stage, and the
    card's float32 distance from the CPU's float32 (relative L2). A
    convolution stage's output is held at `BF16_STAGE_SHARE` of its
    bf16-vs-float32 distance, its gradients at `BF16_GRAD_SHARE`; a
    BatchNorm (batch statistics) computes the same float32 on both sides
    and is held within `BF16_NORM_RTOL`."""
    from fastposecnn_tpu_torch.device import full_float32
    from fastposecnn_tpu_torch.models import PoseRegressorNet
    from fastposecnn_tpu_torch.models.resnet import BatchNorm

    def stages(dtype, device):
        net = PoseRegressorNet(classes, dtype=dtype)
        net.load_state_dict(state_dict)
        return bf16_stage_modules(net.train().to(device), norms=True)

    cpu = torch.device("cpu")
    mods = {"cpu": stages(torch.bfloat16, cpu), "card": stages(torch.bfloat16, dev),
            "card_f32": stages(torch.float32, dev), "cpu_f32": stages(torch.float32, cpu)}
    missing = sorted(name for name, (_, cot) in seen.items() if cot is None)
    if missing or seen.keys() != mods["cpu"].keys():
        raise AssertionError(f"stages without a cotangent {missing} or not run "
                             f"{sorted(mods['cpu'].keys() - seen.keys())}")
    held = {}
    for name, (args, cot) in seen.items():
        got = {}
        for which, m in ((k, v[name]) for k, v in mods.items()):
            with full_float32():  # the step's precision and cuDNN algorithms
                got[which] = stage_forward_backward(m, args, cot, cpu if which.startswith("cpu")
                                                    else dev)
        norm = isinstance(mods["cpu"][name], BatchNorm)
        held[name] = {
            part: dict(card_vs_cpu=rel_l2(got["card"][part], got["cpu"][part]),
                       card_bf16_vs_f32=rel_l2(got["card"][part], got["card_f32"][part]),
                       f32_card_vs_cpu=rel_l2(got["card_f32"][part], got["cpu_f32"][part]),
                       norm=norm)
            for part in ("output", "inputs", "params")}
    return held


def bf16_stages_train_bands(held):
    """`bf16_stages_train_card_vs_cpu`'s distances against their bands:
    (the worst share of each part of the convolution stages and the worst
    distance of each part of the BatchNorms, the stages outside a band)."""
    worst, outside = {}, []
    for name, parts in held.items():
        for part, d in parts.items():
            if d["norm"]:
                key, value, ok = f"norm_{part}_card_vs_cpu", d["card_vs_cpu"], (
                    d["card_vs_cpu"] <= BF16_NORM_RTOL)
            else:
                value = d["card_vs_cpu"] / max(d["card_bf16_vs_f32"], 1e-30)
                share = BF16_STAGE_SHARE if part == "output" else BF16_GRAD_SHARE
                key, ok = f"conv_{part}_share", d["card_vs_cpu"] <= share * d["card_bf16_vs_f32"]
            if not ok:
                outside.append(dict(stage=name, part=part, **d))
            if value > worst.get(key, (-1.0, ""))[0]:
                worst[key] = (value, name)
    return {k: dict(value=v, stage=n) for k, (v, n) in worst.items()}, outside


def bf16_network_card_vs_cpu(dev, state_dict, image, classes=7):
    """The bf16 network with `state_dict` (eval mode) on `image`, on the card
    (in `full_float32()`, as the server runs it) and on the CPU: per logit,
    the card's distance from the CPU's and from its own float32 network on
    the card; per stage (`bf16_stage_modules`), the same for the card's
    stage run on the CPU's bf16 input to it. Relative L2 distances."""
    from fastposecnn_tpu_torch.device import full_float32
    from fastposecnn_tpu_torch.models import PoseRegressorNet

    def network(dtype, device):
        net = PoseRegressorNet(classes, dtype=dtype)
        net.load_state_dict(state_dict)
        return net.eval().to(device)

    cpu16, seen = network(torch.bfloat16, "cpu"), {}
    hooks = [m.register_forward_hook(lambda m, args, out, name=name: seen.__setitem__(
        name, (args, out))) for name, m in bf16_stage_modules(cpu16).items()]
    with torch.inference_mode():
        want = cpu16(image.cpu())
    for hook in hooks:
        hook.remove()
    card16, card32 = network(torch.bfloat16, dev), network(torch.float32, dev)
    stages = {}
    with torch.inference_mode(), full_float32():
        got, ref = card16(image), card32(image)
        mods16, mods32 = bf16_stage_modules(card16), bf16_stage_modules(card32)
        for name, (args, out) in seen.items():
            args = to_device(args, dev)
            out16, out32 = mods16[name](*args), mods32[name](*args)
            stages[name] = dict(card_vs_cpu=rel_l2(out16, out), card_bf16_vs_f32=rel_l2(out16, out32),
                                dtype=str(out16.dtype).removeprefix("torch."))
    if any(t.dtype != torch.float32 for t in (*got.values(), *want.values())):
        raise AssertionError("a bf16 network returned logits other than float32")
    whole = {k: dict(card_vs_cpu=rel_l2(got[k], want[k]), card_bf16_vs_f32=rel_l2(got[k], ref[k]))
             for k in want}
    return whole, stages


def hold_bf16_network(whole, stages):
    """`bf16_network_card_vs_cpu`'s distances within their bands: each stage
    `BF16_STAGE_SHARE`, each logit `BF16_WHOLE_FACTOR` x the card's own
    bf16-vs-float32 distance."""
    for name, d in stages.items():
        if not d["card_vs_cpu"] <= BF16_STAGE_SHARE * d["card_bf16_vs_f32"]:
            raise AssertionError(f"bf16 stage {name}: card vs CPU {d}")
    for k, d in whole.items():
        if not (math.isfinite(d["card_vs_cpu"])
                and d["card_vs_cpu"] <= BF16_WHOLE_FACTOR * d["card_bf16_vs_f32"]):
            raise AssertionError(f"bf16 logits {k}: card vs CPU {d}")


def phase_serve_bf16(dev, smi, server, requests=4, frames=30):
    """`InferenceServer(compute_dtype="bfloat16")`, the counterpart of the
    network `bench.py` serves on its chip: the INFERENCE preset at 480x640,
    batch 1, the serve phase's seeded weights (equal to the float32
    server's), every convolution in bf16, float32 logits. It answers the
    serve phase's requests (K1 and K2 once a frame, finite answers of the
    served shapes); K1's labels and K2's counts of every call in a bf16
    frame equal their plain versions' on the inputs each call was given;
    its logits on the card are held against the CPU's bf16
    forward of the same weights and image, stage by stage
    (`bf16_network_card_vs_cpu`). Then 30 CUDA-event frames of each server
    on the same image and draws, in interleaved pairs: medians and
    quartiles; the network alone; and from a profiler trace of 10 frames
    of each the card's busy ms a frame and its idle share."""
    from fastposecnn_tpu_torch import kernels
    from fastposecnn_tpu_torch.device import full_float32
    from fastposecnn_tpu_torch.models.conv import Conv2d
    from fastposecnn_tpu_torch.serve import InferenceServer
    from fastposecnn_tpu_torch.utils.export import make_draws

    server16 = InferenceServer(device=dev, seed=0, compute_dtype="bfloat16")
    net = server16.net
    convs = {m.compute_dtype for m in net.modules() if isinstance(m, Conv2d)}
    if net.dtype != torch.bfloat16 or convs != {torch.bfloat16}:
        raise AssertionError(f"the bf16 server built a {net.dtype} network ({convs})")
    sd16, sd32 = net.state_dict(), server.net.state_dict()
    if sd16.keys() != sd32.keys() or not all(torch.equal(sd16[k], sd32[k]) for k in sd32):
        raise AssertionError("the bf16 server's weights are not the float32 server's")
    images = served_images(dev, requests)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    answers = [server16(img) for img in images]
    torch.cuda.synchronize()
    launches = {k: kernels.launch_counts()[k] for k in PATH_KERNELS}
    check_answers(answers)
    if launches != {k: requests for k in PATH_KERNELS}:
        raise AssertionError(f"the bf16 server launched {launches} for {requests} frames")
    with kernel_calls_recorded() as calls:
        server16(images[0])
    equal_plain = hold_kernels_plain(calls, "the bf16 frame")
    whole, stages = bf16_network_card_vs_cpu(dev, {k: v.cpu() for k, v in sd16.items()},
                                             images[0])

    draws = make_draws(server.config, 1, 7, dev)
    t32, t16 = paired_ms(lambda: server(images[0], draws), lambda: server16(images[0], draws),
                         pairs=frames)
    with torch.inference_mode(), full_float32():
        network_ms = {"float32": median_ms(lambda: server.net(images[0]), iters=20),
                      "bfloat16": median_ms(lambda: net(images[0]), iters=20)}
    frame = {}
    for name, srv, times in (("float32", server, t32), ("bfloat16", server16, t16)):
        (busy_us, ops), traces = whole_trace(lambda srv=srv: srv(images[0], draws), calls=10,
                                             whole=False)
        med, busy = statistics.median(times), sum(busy_us.values()) / 1e3
        frame[name] = dict(ms=med, quartiles_ms=[float(q) for q in np.percentile(times, [25, 75])],
                           frames=len(times), network_ms=network_ms[name], device_busy_ms=busy,
                           idle_share=1 - busy / med, device_ops_per_frame=ops, traces=traces)
    emit("serve_bf16", card=smi, requests=requests, launches=launches,
         valid_instances=[int((a[1] > 0).sum()) for a in answers],
         calls_equal_plain=equal_plain,
         logits_card_vs_cpu=dict(hw=[H, W], stage_share=BF16_STAGE_SHARE,
                                 whole_factor=BF16_WHOLE_FACTOR, whole=whole, stages=stages),
         served_frame=frame)
    hold_bf16_network(whole, stages)
    return launches


def bf16_step_card_vs_cpu(dev, h=96, w=128):
    """One HEAD_TRAINING step at a reduced size (96x128, 7 classes, batch 2,
    8 slots, 256 points, 64 hypotheses) from one seeded state, with the
    network in bf16 on the card and on the CPU and in float32 on the card,
    on the same batch, dropout masks and vote draws. Held stage by stage in
    train mode (`bf16_stages_train_card_vs_cpu`: each stage on the CPU
    step's bf16 input to it and pulled back with the CPU step's cotangent
    of its output; outputs, input and parameter gradients), and, as a
    sanity check of the whole step, the gradients, the parameter updates
    and the BatchNorm statistics (relative L2 over every tensor) of the
    card's bf16 step within `BF16_WHOLE_FACTOR` x their distance from the
    card's float32 step; the vote-free logs within `BF16_LOG_RTOL` of the
    CPU's. The matched terms follow the instances the argmax of the bf16
    logits makes: reported."""
    from fastposecnn_tpu_torch import config as C
    from fastposecnn_tpu_torch.models import PoseRegressorNet
    from fastposecnn_tpu_torch.models.weights import init_random_
    from fastposecnn_tpu_torch.ops.voting import VoteDraws

    kw = dict(h=h, w=w, batch=2, MAX_INSTANCES=8, MAX_VOTE_POINTS=256, HV_NUM_OF_HYPOTHESES=64)

    def setup(device, dtype):
        return train_setup(device, C.head_training, seed=14, network=lambda hp: init_random_(
            PoseRegressorNet(hp.num_classes, dtype=dtype), 14), **kw)

    runs = {"card": setup(dev, torch.bfloat16), "cpu": setup(torch.device("cpu"), torch.bfloat16),
            "card_f32": setup(dev, torch.float32)}
    hp, gen = runs["cpu"]["hp"], torch.Generator().manual_seed(5)
    keep = runs["cpu"]["state"].net.draw_dropout_keep(2, "cpu", gen)
    b, n, p = 2, hp.MAX_INSTANCES, hp.MAX_VOTE_POINTS
    draws = VoteDraws(ux=torch.rand((b, n, p), generator=gen),
                      uy=torch.rand((b, n, p), generator=gen),
                      pairs=torch.randint(0, p, (20, b * n, hp.HV_NUM_OF_HYPOTHESES, 2),
                                          generator=gen))
    before = {k: v.detach().cpu().clone() for k, v in runs["cpu"]["state"].net.state_dict().items()}
    seen, hooks = capture_stages(runs["cpu"]["state"].net)
    logs, tensors = {}, {}
    for name, r in runs.items():
        d = r["batch"]["image"].device
        r["state"], lg = r["step"](r["state"], r["batch"], seed=0,
                                   dropout_keep={k: v.to(d) for k, v in keep.items()},
                                   draws=VoteDraws(ux=draws.ux.to(d), uy=draws.uy.to(d),
                                                   pairs=draws.pairs.to(d)))
        logs[name] = {k: float(v) for k, v in lg.items()}
        net = r["state"].net
        sd = net.state_dict()
        names = [k for k, q in net.named_parameters() if q.grad is not None]
        tensors[name] = dict(
            gradients=[dict(net.named_parameters())[k].grad for k in names],
            updates=[sd[k].cpu() - before[k] for k in names],
            statistics=[sd[k] for k in sorted(sd) if k.endswith(("running_mean", "running_var"))])
    for hook in hooks:
        hook.remove()
    stages = bf16_stages_train_card_vs_cpu(dev, before, seen)
    held = {part: dict(card_vs_cpu=rel_l2(tensors["card"][part], tensors["cpu"][part]),
                       card_bf16_vs_f32=rel_l2(tensors["card"][part], tensors["card_f32"][part]))
            for part in tensors["cpu"]}
    log_rel = {k: abs(logs["card"][k] - v) / max(abs(v), 1e-30) for k, v in logs["cpu"].items()}
    worst, outside = bf16_stages_train_bands(stages)
    out = dict(hw=[h, w], batch=2, whole_factor=BF16_WHOLE_FACTOR, log_rtol=BF16_LOG_RTOL,
               tensors=held, log_relative_diff=log_rel, logs=logs,
               stages_train=dict(count=len(stages), stage_share=BF16_STAGE_SHARE,
                                 grad_share=BF16_GRAD_SHARE, norm_rtol=BF16_NORM_RTOL,
                                 worst=worst, outside=outside))
    emit("train_bf16_card_vs_cpu", **out)
    if outside:
        raise AssertionError(f"bf16 train-mode stages outside their bands: {outside}")
    for part, d in held.items():
        if not d["card_vs_cpu"] <= BF16_WHOLE_FACTOR * d["card_bf16_vs_f32"]:
            raise AssertionError(f"bf16 step {part}: card vs CPU {d}")
    for k, v in logs["cpu"].items():
        if not math.isfinite(logs["card"][k]):
            raise AssertionError(f"bf16 step log {k} is not finite on the card")
        if k in BF16_VOTE_FREE_LOGS and not log_rel[k] <= BF16_LOG_RTOL:
            raise AssertionError(f"bf16 step log {k}: card {logs['card'][k]}, CPU {v}")
    return out


def phase_train_bf16(dev, smi):
    """Training with the network in bf16, built as `train/loop.py` builds it
    (`loop.initial_network`: the default COMPUTE_DTYPE on CUDA), at full
    width (480x640, 7 classes, batch 3, in-memory synthetic scenes): 8
    MASK_TRAINING steps at LEARNING_RATE 3e-3 (the loss falls, no kernel
    runs) and 6 HEAD_TRAINING steps (finite, no skipped update, K1 once a
    step and K2 once a RANSAC round). Forward hooks check that every
    convolution's output is bf16; every parameter, buffer and optimizer
    tensor stays float32. The same steps with the float32 network (the
    same weights and batches) in the same call: ms a step (medians after
    the first) and, from a profiler trace of 3 more steps, the card's busy
    ms a step and its idle share; in one more bf16 HEAD step each call of
    K1 and K2 equals its plain version on the inputs it was given. Then
    `bf16_step_card_vs_cpu`, and one
    epoch of the train CLI with the default COMPUTE_DTYPE, whose run.log
    must name bfloat16. Returns the kernels' launches of the HEAD steps and
    the CLI run."""
    import logging
    import os

    from fastposecnn_tpu_torch import config as C
    from fastposecnn_tpu_torch import kernels
    from fastposecnn_tpu_torch.models.conv import Conv2d
    from fastposecnn_tpu_torch.train import loop

    records = []
    flog = logging.getLogger("chip_smoke.train_bf16")
    flog.setLevel(logging.INFO)
    flog.propagate = False
    handler = logging.Handler()
    handler.emit = lambda rec: records.append(rec.getMessage())
    flog.addHandler(handler)

    def setup(preset, seed, **overrides):
        return train_setup(dev, preset, seed,
                           network=lambda hp: loop.initial_network(hp, dev, flog), **overrides)

    conv_dtypes = {}

    def count_conv(module, args, out):
        conv_dtypes[str(out.dtype)] = conv_dtypes.get(str(out.dtype), 0) + 1

    steps, launches, out = {"mask_training": 8, "head_training": 6}, {}, {}
    for preset_name, preset, seed, kw in (("mask_training", C.mask_training, 11,
                                           dict(LEARNING_RATE=3e-3)),
                                          ("head_training", C.head_training, 12, {})):
        runs = {"bfloat16": setup(preset, seed, **kw),
                "float32": setup(preset, seed, COMPUTE_DTYPE="float32", **kw)}
        net = runs["bfloat16"]["state"].net
        if net.dtype != torch.bfloat16 or runs["float32"]["state"].net.dtype != torch.float32:
            raise AssertionError(f"{preset_name}: the loop built {net.dtype} for the default")
        convs = [m for m in net.modules() if isinstance(m, Conv2d)]
        hooks = [m.register_forward_hook(count_conv) for m in convs]
        conv_dtypes.clear()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        logs, ms16, _ = timed_steps(runs["bfloat16"], steps[preset_name])
        counts = {k: kernels.launch_counts()[k] for k in PATH_KERNELS}
        for hook in hooks:
            hook.remove()
        if conv_dtypes != {"torch.bfloat16": len(convs) * steps[preset_name]}:
            raise AssertionError(f"{preset_name}: conv outputs {conv_dtypes}, "
                                 f"{len(convs)} convs x {steps[preset_name]} steps")
        st = runs["bfloat16"]["state"]
        tensors = [*st.net.parameters(), *st.net.buffers(),
                   *(v for part in (st.opt_state.mu, st.opt_state.nu, st.opt_state.slow)
                     for v in part.values())]
        if any(t.dtype not in (torch.float32, torch.int64) for t in tensors):
            raise AssertionError(f"{preset_name}: a parameter, buffer or moment is not float32")
        if not all(math.isfinite(v) for lg in logs for v in lg.values()):
            raise AssertionError(f"{preset_name}: non-finite bf16 logs {logs}")
        if any(lg["grad/finite"] != 1.0 for lg in logs) or st.skipped_updates:
            raise AssertionError(f"{preset_name}: {st.skipped_updates} skipped bf16 updates")
        losses = [lg["pose/total_loss"] for lg in logs]
        if preset_name == "mask_training":
            if not losses[-1] < losses[0] or any(counts.values()):
                raise AssertionError(f"bf16 MASK_TRAINING: losses {losses}, launches {counts}")
        else:
            rounds = [int(lg["pose/vote_rounds"]) for lg in logs]
            if counts != {"cc_label": 6, "vote_count": sum(rounds)}:
                raise AssertionError(f"bf16 HEAD_TRAINING launches {counts}, rounds {rounds}")
            launches = counts
            # One more step, outside the counted ones: each K1 and K2 call
            # in it against its plain version on the inputs it was given.
            with kernel_calls_recorded() as calls:
                run = runs["bfloat16"]
                run["state"], _ = run["step"](run["state"], run["batch"], seed=2)
            equal_plain = hold_kernels_plain(calls, "a bf16 HEAD step")
        _, ms32, _ = timed_steps(runs["float32"], 5)
        timing = {}
        for dtype, run, times in (("bfloat16", runs["bfloat16"], ms16),
                                  ("float32", runs["float32"], ms32)):
            def one_step(run=run):
                run["state"], _ = run["step"](run["state"], run["batch"], seed=1)
            (by_kernel, ops), traces = whole_trace(one_step, calls=3, whole=False)
            med, busy = statistics.median(times[1:]), sum(by_kernel.values()) / 1e3
            timing[dtype] = dict(ms_per_step_median=med, ms_per_step=times,
                                 device_busy_ms=busy, idle_share=1 - busy / med,
                                 device_ops_per_step=ops, traces=traces)
        out[preset_name] = dict(steps=steps[preset_name], total_loss=losses, launches=counts,
                                conv_outputs=conv_dtypes.copy(), **timing)
        if preset_name == "head_training":
            out[preset_name]["calls_equal_plain"] = equal_plain
        del runs
    if f"network compute dtype: bfloat16 (COMPUTE_DTYPE=bfloat16 on {dev.type})" not in records:
        raise AssertionError(f"the loop's log: {records}")
    flog.removeHandler(handler)
    card_vs_cpu = bf16_step_card_vs_cpu(dev)

    with tempfile.TemporaryDirectory(prefix="fpcnn_train_bf16_") as tmp:
        old_logs = os.environ.get("LOGS")
        os.environ["LOGS"] = tmp
        try:
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            state, run_dir, probe = run_train_cli(
                ["-e", "SMOKE_BF16", "--preset", "HEAD_TRAINING", "--synthetic", "3",
                 "--IMAGE_HEIGHT", str(H), "--IMAGE_WIDTH", str(W), "--BATCH_SIZE", "3",
                 "--SELECTED_CLASSES", *C.HParams().SELECTED_CLASSES, "--NUM_WORKERS", "2",
                 "--epochs", "1", "--bank_pool_dir", f"{tmp}/banks", "--no_tb",
                 "--device", dev.type], compute_dtype=None)
            cli_launches = {k: kernels.launch_counts()[k] for k in PATH_KERNELS}
            log = (run_dir / "run.log").read_text()
        finally:
            if old_logs is None:
                os.environ.pop("LOGS", None)
            else:
                os.environ["LOGS"] = old_logs
    if f"network compute dtype: bfloat16 (COMPUTE_DTYPE=bfloat16 on {dev.type})" not in log:
        raise AssertionError("the train CLI's run.log does not name bfloat16")
    if state.net.dtype != torch.bfloat16 or state.skipped_updates or min(cli_launches.values()) < 1:
        raise AssertionError(f"the bf16 train CLI: {state.net.dtype}, "
                             f"{state.skipped_updates} skipped, launches {cli_launches}")
    emit("train_bf16", card=smi, hw=[H, W], batch=3, classes=7, **out,
         card_vs_cpu=card_vs_cpu,
         train_cli=dict(epochs=1, train_steps=state.step, launches=cli_launches,
                        run_log_names_bfloat16=True))
    return {k: launches[k] + cli_launches[k] for k in PATH_KERNELS}


def deterministic_caller_order_check():
    """Run as `chip_smoke.py --deterministic-caller-order-check`, in a fresh
    process: the network with seeded random weights at batch 2, 480x640,
    called once in float32 by a caller with deterministic algorithms and no
    timing (TF32 off, `cudnn.deterministic` on, `cudnn.benchmark` off),
    which leaves the algorithms of cuDNN's heuristics in PyTorch's cache;
    then timed in `full_float32()`. Then, not checked but recorded, what
    `device.full_float32` cannot separate: a second caller at the same
    shape with `cudnn.deterministic` off, and `full_float32()` after it.
    Prints one JSON line."""
    from fastposecnn_tpu_torch.device import full_float32
    from fastposecnn_tpu_torch.models import PoseRegressorNet
    from fastposecnn_tpu_torch.models.weights import init_random_

    dev = torch.device("cuda")
    net = init_random_(PoseRegressorNet(7), 0).to(dev).eval()
    x = torch.randn((2, 3, H, W), generator=torch.Generator(dev).manual_seed(321), device=dev)
    set_tf32(False, False)
    torch.backends.cudnn.benchmark = False

    def caller_call(deterministic):
        torch.backends.cudnn.deterministic = deterministic
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net(x)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def float32_b2():
        with full_float32():
            net(x)

    with torch.inference_mode():
        first_ms = caller_call(True)
        after_ms = median_ms(float32_b2, iters=5, warmup=1)
        second_ms = caller_call(False)
        residual_ms = median_ms(float32_b2, iters=3, warmup=1)
    print(json.dumps(dict(caller_first_call_ms=first_ms, full_float32_after_ms=after_ms,
                          second_caller_deterministic_off_first_call_ms=second_ms,
                          full_float32_after_both_callers_ms=residual_ms)), flush=True)


@contextlib.contextmanager
def timed_float32():
    """`device.full_float32()` as it was before it took cuDNN's heuristics
    inside a tensor-parallel group: cuDNN's algorithms chosen by each
    rank's own timing there too."""
    from fastposecnn_tpu_torch.device import body_deterministic

    b = torch.backends
    saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.benchmark,
             b.cudnn.deterministic)
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False
    b.cudnn.benchmark, b.cudnn.deterministic = True, body_deterministic(saved[0], saved[3])
    try:
        yield
    finally:
        (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.benchmark,
         b.cudnn.deterministic) = saved


def train_tp_flags_rank(flags, *args):
    """`train_dp_rank` with the train step's float32 context `flags`:
    "port" (`device.full_float32()`) or "timed" (`timed_float32`)."""
    from fastposecnn_tpu_torch.train import task as T

    if flags == "timed":
        T.full_float32 = timed_float32
    out = train_dp_rank(*args)
    return {k: v for k, v in out.items() if k not in ("state_dict", "opt")}


def tp_algorithms_check():
    """Run as `chip_smoke.py --tp-algorithms`: `train_tp`'s (dp 2, tp 2)
    steps (four gloo ranks sharing the card, `train_dp`'s inputs and
    draws) once with cuDNN's algorithms chosen by each rank's timing
    (`timed_float32`) and once with the port's `full_float32()` (the
    deterministic heuristics in a tp group), each against one process's
    steps. Prints one JSON line per run: each rank's matched xy loss minus
    one process's, step by step (the quantity `train_tp` holds within
    0.1 px and 1e-4 of its value), whether every rank's replicated tensors
    are bit-equal, and each rank's ms a step; then the card's name and
    power limit."""
    from fastposecnn_tpu_torch.kernels.build import load_library
    from fastposecnn_tpu_torch.parallel import mesh

    _, smi = phase_device()
    dev = torch.device("cuda")
    load_library()
    set_tf32(False, False)
    hp, data, inv_k, draws = dp_setup(batch=4, seed=21)
    seed = 22
    _, logs, single_ms, *_ = dp_steps(hp, data, inv_k, draws, dev, seed)
    layout = mesh.make_mesh(TP_LAYOUT[0] * TP_LAYOUT[1], tp=TP_LAYOUT[1])
    for flags in ("timed", "port"):
        torch.cuda.empty_cache()
        ranks = mesh.launch(train_tp_flags_rank, layout.size,
                            (flags, hp, data, inv_k, draws, seed, "cuda:0", DP_STEPS),
                            backend="gloo", deadline_s=DP_DEADLINE_S, layout=layout)
        emit("tp_algorithms", card=smi, flags=flags,
             xy_minus_single=[[got["xy/loss_xy"] - want["xy/loss_xy"]
                               for got, want in zip(r["logs"], logs)] for r in ranks],
             single_xy=[lg["xy/loss_xy"] for lg in logs],
             replicated_bit_equal=len({r["replicated_digest"] for r in ranks}) == 1,
             ms_per_step_per_rank={r["rank"]: r["step_ms"] for r in ranks},
             single_process_ms_per_step=single_ms)
    print(smi, flush=True)


def probe_kernel_lines(probe_lines, probe_launches, errs):
    """The `kernels` entries of P1 and P2 (at the script's shape), and the
    probe's other lines as `at_other_shapes` entries."""
    sources = {"vote_expanded_mm": ("vote_expanded_mma.cu", "scripts/probe_vote_variants.py:106"),
               "vote_expanded_bcast": ("vote_expanded_bcast.cu",
                                       "scripts/probe_vote_variants.py:165")}
    others, entries = {}, []
    for ln in probe_lines:
        name, shape = ln["kernel"], ln["shape"]
        times = dict(kernel=name, shape=shape, ms=ln["us"] / 1e3,
                     plain_ms=ln["plain_us"] / 1e3, bound_ms=ln["bound_us"] / 1e3,
                     bound_by=ln["bound_by"])
        if name in sources and tuple(shape) == (16, 4096, 1024):
            src, replaces = sources[name]
            entries.append(dict(
                name=name, route="cuda", source=f"fastposecnn_tpu_torch/kernels/{src}",
                replaces=replaces, launches=probe_launches[name], max_abs_err=errs[name],
                ms=times["ms"], plain_ms=times["plain_ms"], bound_ms=times["bound_ms"],
                bound_by=times["bound_by"],
                library_ms=None if ln["library_us"] is None else ln["library_us"] / 1e3,
                main_path="probe"))
        else:
            others[f"probe_{name}_{'x'.join(map(str, shape))}"] = times
    return entries, others


def main():
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    kind, smi = phase_device()
    dev = torch.device("cuda")
    phase_build()
    # Float32 throughout, as the port's entry points compute (they turn TF32
    # off themselves); only the network's TF32 timing sets the flags.
    set_tf32(False, False)
    errs = {"cc_label": phase_cc_kernel(dev),
            "vote_count": phase_vote_kernel(dev),
            **phase_vote_variants(dev)}
    phase_known_scene(dev)
    oracle = phase_eval_oracle(dev)
    server, image, launches = phase_serve(dev)
    phase_sync_check(server, image)
    _, eval_launches = phase_evaluate(dev)
    eval_times = phase_eval_timing(dev, oracle, smi)
    kernels = phase_timing(dev, server, image, launches, errs, smi)
    for k in kernels:
        k["main_path"] = "serve"
    other_times = {**eval_times, **phase_vote_scan(dev, smi)}
    probe_lines, probe_launches = phase_probe(dev)
    probe_entries, probe_times = probe_kernel_lines(probe_lines, probe_launches, errs)
    kernels += probe_entries
    other_times.update(probe_times)
    phase_held_out(dev)
    train_launches = phase_train(dev, smi)
    phase_train_kernels(dev)
    phase_train_cpu(dev)
    train_cli_launches = phase_train_cli(dev, smi)
    staged_launches = phase_train_staged(dev, smi)
    phase_network_precision(dev, server, smi)
    new_paths = {"serve_encoders": phase_serve_encoders(dev, smi, server),
                 "serve_soft": phase_serve_soft(dev, smi),
                 "voting_vp": phase_voting_vp(dev, smi),
                 "train_encoders": phase_train_encoders(dev, smi)}
    new_paths["train_dp"], dp_single = phase_train_dp(dev, smi)
    new_paths["train_tp"] = phase_train_tp(dp_single)
    del dp_single
    new_paths["export"] = phase_export(dev, smi, server)
    phase_create_meta(dev, smi)
    new_paths["figures"] = phase_figures(dev, smi)
    new_paths["serve_bf16"] = phase_serve_bf16(dev, smi, server)
    new_paths["train_bf16"] = phase_train_bf16(dev, smi)
    for k in kernels:
        name = k["name"]
        k["launches_by_path"] = {"serve": launches[name],
                                 "eval_oracle": oracle["launches"][name],
                                 "evaluate": eval_launches[name],
                                 "probe": probe_launches[name],
                                 "train": train_launches[name],
                                 "train_cli": train_cli_launches[name],
                                 "train_staged": staged_launches[name],
                                 **{path: counts.get(name, 0)
                                    for path, counts in new_paths.items()}}
        k["at_other_shapes"] = [dict(what=what, **{f: v[f] for f in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by")})
            for what, v in other_times.items() if v.get("kernel") == name]
        times = [k] + k["at_other_shapes"]
        if not all(math.isfinite(t[f]) for t in times
                   for f in ("ms", "plain_ms", "bound_ms")):
            raise AssertionError(f"non-finite timing for {name}")
    faulthandler.cancel_dump_traceback_later()
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--deterministic-caller-order-check"]:
        deterministic_caller_order_check()
    elif sys.argv[1:] == ["--tp-algorithms"]:
        tp_algorithms_check()
    elif sys.argv[1:2] == ["--run-exported"] and len(sys.argv) == 5:
        run_exported(*sys.argv[2:])
    else:
        main()
