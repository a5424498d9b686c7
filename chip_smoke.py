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
scenes (checkpoints, a full resume and a weights-only resume, the native
augmentation against numpy on the card's host), measures what TF32
would change in the network (and checks that the entry points' float32
does not reuse a convolution algorithm that cuDNN's heuristics chose
outside them), checks that a served frame enqueues with
no host sync until it reads the CC kernel's error flag at its end, and
times the kernels at the served and the evaluated shapes (K1 beside its
floor: its launches with empty kernels), their plain versions, the
adaptive loop's host syncs, 30 served frames, and what a host sync right
after K1 cost the frame, and the train steps of each preset with the
share of a HEAD_TRAINING step spent voting, with CUDA events. Everything runs
in full float32 (TF32 off), as the port's entry points compute, but for
the network's TF32 timing, which sets the flags around a direct call.

Every phase prints one flushed JSON line before the next begins. Any failure
prints a traceback to stderr and exits non-zero; only a run in which every
phase passed ends with the line
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
A watchdog dumps every thread's stack and exits non-zero after 900 s.
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


def phase_serve(dev, requests=5):
    """The main path: `InferenceServer` at full width answers `requests`
    seeded random 480x640 images with seeded random weights. The caller
    leaves both TF32 flags on, and the network must run with both off."""
    from fastposecnn_tpu_torch import kernels
    from fastposecnn_tpu_torch.serve import InferenceServer

    server = InferenceServer(device="cuda", seed=0)
    gen = torch.Generator(dev).manual_seed(123)
    images = [torch.randn((1, 3, H, W), generator=gen, device=dev)
              for _ in range(requests)]
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
    for mask, class_ids, xy, z, RT in answers:
        shapes = [tuple(t.shape) for t in (mask, class_ids, xy, z, RT)]
        if shapes != [(1, H, W), (1, 16), (1, 16, 2), (1, 16), (1, 16, 4, 4)]:
            raise AssertionError(f"served shapes {shapes}")
        if not all(bool(torch.isfinite(t).all()) for t in (xy, z, RT)):
            raise AssertionError("served outputs are not finite")
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
    from fastposecnn_tpu_torch.ops.connected_components import label_components

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
    def k1_reads_at_once(fg, impl=None, err=None):
        return label_components(fg, impl=impl)

    def frame_with_k1_sync():
        aggregation.label_components = k1_reads_at_once
        try:
            server(image)
        finally:
            aggregation.label_components = label_components

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
    objects gives it, and the evaluation shape with the first 0, 1, 4, 15,
    32 and 64 of 64 slots active (its fixed costs against the cells' work)."""
    from fastposecnn_tpu_torch.kernels.build import load_library

    lib = load_library()
    out = {}
    for name, (m, h, n_active) in (
            ("vote_count_served_shape_4_active", (16, 4096, 4)),
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


def train_setup(dev, preset, seed, h=H, w=W, classes=7, batch=3, **overrides):
    """A port train step at `preset`, with seeded random weights and a batch
    of seeded synthetic scenes on `dev`."""
    from fastposecnn_tpu_torch import config as C
    from fastposecnn_tpu_torch.constants import CAMERA_CLASSES, scaled_intrinsics
    from fastposecnn_tpu_torch.data.synthetic import SceneConfig, make_batch
    from fastposecnn_tpu_torch.models import PoseRegressorNet
    from fastposecnn_tpu_torch.models.weights import init_random_
    from fastposecnn_tpu_torch.train import task as T

    hp = preset(IMAGE_HEIGHT=h, IMAGE_WIDTH=w, SELECTED_CLASSES=CAMERA_CLASSES[:classes],
                BATCH_SIZE=batch, **overrides)
    net = init_random_(PoseRegressorNet(hp.num_classes), seed).to(dev)
    opt = T.make_optimizer(hp, net)
    scenes = SceneConfig(height=h, width=w, num_classes=classes,
                         max_instances=hp.MAX_INSTANCES, max_scene_instances=6)
    data = T.upcast_batch(make_batch(np.random.default_rng(seed), scenes, batch), dev)
    inv_k = np.linalg.inv(scaled_intrinsics("CAMERA", h, w))
    pcfg = C.pipeline_config_from(hp)
    return dict(hp=hp, opt=opt, pcfg=pcfg, inv_k=inv_k, batch=data,
                state=T.create_train_state(net, opt),
                step=T.make_train_step(net, opt, hp, pcfg, inv_k, dev))


def timed_steps(run, n, seed=0):
    """`n` steps of run["step"] from run["state"] (updated), each timed with
    CUDA events, and the time of its hough-voting stage (events around
    `pipeline.stage_hough_voting`). Returns (logs, step ms, voting ms)."""
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
            run["state"], step_logs = run["step"](run["state"], run["batch"], seed=seed)
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
        sink.append(out.detach().clone())
        return out

    setattr(module, name, wrapper)
    return original


def phase_train_kernels(dev):
    """One full-width HEAD_TRAINING step from one state through the kernels
    and through their plain versions (`impl="reference"`): the CC labels,
    every round's vote counts and the rounds exactly equal; the logs,
    gradients, updated parameters and BatchNorm statistics at the golden
    tolerance (atol 2e-4, rtol 1e-4)."""
    import copy

    from fastposecnn_tpu_torch import config as C
    from fastposecnn_tpu_torch.ops import aggregation, voting
    from fastposecnn_tpu_torch.train import task as T

    run = train_setup(dev, C.head_training, seed=13)
    ref_net = copy.deepcopy(run["state"].net)
    ref = dict(run, state=T.TrainState(ref_net, copy.deepcopy(run["state"].opt_state)),
               step=T.make_train_step(ref_net, run["opt"], run["hp"],
                                      dataclasses.replace(run["pcfg"], impl="reference"),
                                      run["inv_k"], dev))
    seen = {}
    for name, r in (("kernels", run), ("reference", ref)):
        labels, counts = [], []
        orig_cc = recorded(aggregation, "label_components", labels)
        orig_vote = recorded(voting, "vote_counts", counts)
        try:
            r["state"], logs = r["step"](r["state"], r["batch"], seed=3)
        finally:
            aggregation.label_components, voting.vote_counts = orig_cc, orig_vote
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
    for n, p in run["state"].net.named_parameters():
        hold("grads", p.grad, params[n].grad)
    ref_sd = ref["state"].net.state_dict()
    for n, t in run["state"].net.state_dict().items():
        hold("params_and_batch_stats", t.float(), ref_sd[n].float())
    emit("train_kernels", hw=[H, W], batch=3, tolerance=dict(
        cc_labels="exact", vote_counts="exact", rounds="exact", logs_grads_params=dict(
            atol=2e-4, rtol=1e-4)), rounds=len(b["counts"]), max_abs_diff=worst)


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


class CliProbe:
    """Instruments the train CLI's path while it runs: the metrics handed to
    the run logger, each train step's CUDA-event time, and the train state
    at the first step of the run (what a resume loaded)."""

    def __init__(self):
        from fastposecnn_tpu_torch.train import loop
        from fastposecnn_tpu_torch.utils import tb

        self.loop, self.tb = loop, tb
        self.logged, self.step_ms, self.eval_steps, self.first_state = [], [], 0, None

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
                start.record()
                out = step(state, batch, seed=seed)
                end.record()
                end.synchronize()
                probe.step_ms.append(start.elapsed_time(end))
                return out
            return timed

        def make_eval_step(*args):
            step = probe.originals[1](*args)

            def counted(*a, **kw):
                probe.eval_steps += 1
                return step(*a, **kw)
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


def run_train_cli(argv):
    """`cli.train.main(argv)` with its printed lines kept off the smoke's
    output (run.log holds them); returns (state, run dir, probe)."""
    from fastposecnn_tpu_torch.cli import train as train_cli

    with CliProbe() as probe, contextlib.redirect_stdout(io.StringIO()):
        state, run_dir = train_cli.main(argv)
    torch.cuda.synchronize()
    return state, run_dir, probe


def phase_train_cli(dev, smi, scenes=12, epochs=2):
    """The train CLI (`cli.train.main`, called as a function) on the card at
    full width: HEAD_TRAINING, 480x640, 7 CAMERA classes, batch 3,
    `--synthetic 12` (train: 12 scenes with the train augmentation through
    the native operators; valid: 3 scenes), 4 loader threads, 2 epochs, no
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

    common = ["--preset", "HEAD_TRAINING", "--synthetic", str(scenes),
              "--IMAGE_HEIGHT", str(H), "--IMAGE_WIDTH", str(W), "--BATCH_SIZE", "3",
              "--SELECTED_CLASSES", *C.HParams().SELECTED_CLASSES, "--NUM_WORKERS", "4",
              "--no_tb", "--device", dev.type]
    with tempfile.TemporaryDirectory(prefix="fpcnn_train_cli_") as tmp:
        old_logs = os.environ.get("LOGS")
        os.environ["LOGS"] = tmp
        try:
            # ---- the loader alone, one epoch of augmented batches ----
            args = train_cli.build_parser().parse_args(common)
            hp = C.apply_cli_overrides(C.head_training(), args)
            train_ds, _ = train_cli.synthetic_sources(hp, args)
            loader = PrefetchLoader(train_ds, hp.BATCH_SIZE, num_workers=hp.NUM_WORKERS)
            t0 = time.perf_counter()
            n_batches = sum(1 for b in loader if b is not None)
            loader_s = time.perf_counter() - t0

            # ---- the main path: 2 epochs ----
            labels, counts = [], []
            orig_cc = recorded(aggregation, "label_components", labels)
            orig_vote = recorded(voting, "vote_counts", counts)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            try:
                state, run_dir, probe = run_train_cli(
                    ["-e", "SMOKE", "--epochs", str(epochs), *common])
            finally:
                aggregation.label_components, voting.vote_counts = orig_cc, orig_vote
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
         native_augment=dict(build_s=native_build_s, bit_equal=True, seeds=6, warped=warped,
                             ms_per_sample_native=statistics.median(aug_ms["native"]),
                             ms_per_sample_numpy=statistics.median(aug_ms["numpy"])),
         full_resume=dict(from_step=saved["step"], to_step=resumed.step,
                          state_bit_equal_after_load=same),
         weights_only_resume=weights_only, tensorboard=tensorboard,
         seconds=time.perf_counter() - phase_t0)
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
                bound_by=times["bound_by"], library_ms=None, main_path="probe"))
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
    phase_network_precision(dev, server, smi)
    for k in kernels:
        name = k["name"]
        k["launches_by_path"] = {"serve": launches[name],
                                 "eval_oracle": oracle["launches"][name],
                                 "evaluate": eval_launches[name],
                                 "probe": probe_launches[name],
                                 "train": train_launches[name],
                                 "train_cli": train_cli_launches[name]}
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
    else:
        main()
