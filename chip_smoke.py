"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (into
fastposecnn_tpu_torch/_build/, reused by a later run), holds each kernel
against its plain PyTorch version, runs a crafted scene through the
INFERENCE pipeline, runs the EVALUATING preset (adaptive RANSAC, matching,
float64 errors) on perfect logits of synthetic scenes through the kernels
and through their plain versions, serves a few full-width requests through
`InferenceServer` and evaluates a few synthetic scenes through the
evaluate CLI (the two main paths: the kernels' launch counters are reset
just before each and read just after), and times the kernels at the
served and the evaluated shapes, their plain versions, the adaptive loop's
host syncs and one served frame with CUDA events.

Every phase prints one flushed JSON line before the next begins. Any failure
prints a traceback to stderr and exits non-zero; only a run in which every
phase passed ends with the line
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
A watchdog dumps every thread's stack and exits non-zero after 900 s.
"""

import dataclasses
import faulthandler
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

WATCHDOG_S = 900
H, W = 480, 640
# Published H100 SXM peaks (NVIDIA data sheet), at the full 700 W power
# limit: HBM bytes/s, and FP32 (non tensor core) 67 TFLOP/s, which counts a
# fused multiply-add as two operations. The kernels are built with
# -fmad=false, so each FP32 add or multiply is one instruction, issued at
# half that rate.
HBM_BYTES_PER_S = 3.35e12
FP32_UNFUSED_OPS_PER_S = 67e12 / 2
# FP32 arithmetic per (m, h, p) cell of the vote count: 2 sub, 6 mul, 3 add.
VOTE_FLOPS_PER_CELL = 11


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


def median_ms(fn, iters=20, warmup=3):
    """Median of `iters` CUDA-event timings of fn()."""
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


def device_us_by_kernel(fn, calls=20):
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


def loop_ms(fn, launches=50, repeats=5):
    """Device time per call of a launch-only fn (no host syncs inside): CUDA
    events around `launches` back-to-back calls, median of `repeats`."""
    return median_ms(lambda: [fn() for _ in range(launches)],
                     iters=repeats, warmup=1) / launches


# -----------------------------------------------------------------------------
# Inputs


def cc_masks(dev):
    """480x640 masks for the CC kernel: filled ellipses, a thick and a thin
    serpentine with many U-turns, >1000 small components, random noise, a
    comb of one-pixel teeth, empty and all-foreground."""
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
    }
    batches = {f"{k}_b1": v[None] for k, v in masks.items()}
    batches["ellipses+serpentine_b2"] = np.stack([ellipses, serpentine(1)])
    batches["dots+full_b2"] = np.stack([dots, np.ones((H, W), bool)])
    return {k: torch.from_numpy(v).to(dev) for k, v in batches.items()}


def vote_inputs(dev, m, h, p, n_active, seed):
    """Points around a centre per slot with noisy directions at it, and
    hypotheses scattered near the centre (so counts are large and tie)."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform([50, 50], [W - 50, H - 50], size=(m, 1, 2))
    pts = np.floor(centre + rng.uniform(-80, 80, size=(m, p, 2)))
    d = centre - pts + rng.normal(scale=3.0, size=(m, p, 2))
    dirs = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-6)
    hyps = centre + np.round(rng.normal(scale=4.0, size=(m, h, 2)) * 2) / 2
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
        n_comp = int((want.reshape(want.shape[0], -1)
                      == torch.arange(H * W, device=dev)).sum())
        results[name] = n_comp
    if results["small_components_b1"] <= 1000:
        raise AssertionError("the small-components mask has too few components")
    emit("cc_kernel", tolerance="exact", max_abs_err=max_err, components=results)
    return max_err


def phase_vote_kernel(dev):
    from fastposecnn_tpu_torch.ops.voting import (
        vote_counts_cuda,
        vote_counts_reference,
    )

    shapes = {"main": (16, 4096, 1024, 8), "padding": (5, 1000, 777, 4)}
    out, max_err = {}, 0.0
    for name, (m, h, p, n_active) in shapes.items():
        hyps, pts, dirs, pv, act = vote_inputs(dev, m, h, p, n_active, seed=m)
        got = vote_counts_cuda(hyps, pts, dirs, pv, 0.999, active=act)
        want = vote_counts_reference(hyps, pts, dirs, pv, 0.999, active=act)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            raise AssertionError(f"vote_count differs from its plain version at "
                                 f"{name} {m}x{h}x{p}: max abs err {err}")
        if float(got.max()) <= 0 or got[n_active:].any():
            raise AssertionError(f"vote_count {name}: no votes, or votes in "
                                 "an inactive slot")
        out[name] = dict(shape=[m, h, p], active=n_active,
                         max_count=float(got.max()))
    emit("vote_kernel", tolerance="exact", max_abs_err=max_err, shapes=out)
    return max_err


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
    if min(launches.values()) < 1:
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
    seeded random 480x640 images with seeded random weights."""
    from fastposecnn_tpu_torch import kernels
    from fastposecnn_tpu_torch.serve import InferenceServer

    server = InferenceServer(device="cuda", seed=0)
    gen = torch.Generator(dev).manual_seed(123)
    images = [torch.randn((1, 3, H, W), generator=gen, device=dev)
              for _ in range(requests)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    answers = [server(img) for img in images]
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    for mask, class_ids, xy, z, RT in answers:
        shapes = [tuple(t.shape) for t in (mask, class_ids, xy, z, RT)]
        if shapes != [(1, H, W), (1, 16), (1, 16, 2), (1, 16), (1, 16, 4, 4)]:
            raise AssertionError(f"served shapes {shapes}")
        if not all(bool(torch.isfinite(t).all()) for t in (xy, z, RT)):
            raise AssertionError("served outputs are not finite")
    if min(launches.values()) < requests:
        raise AssertionError(f"the main path skipped a kernel: {launches}")
    emit("serve", requests=requests, launches=launches,
         valid_instances=[int((a[1] > 0).sum()) for a in answers],
         tf32=dict(matmul=torch.backends.cuda.matmul.allow_tf32,
                   cudnn=torch.backends.cudnn.allow_tf32))
    return server, images[0], launches



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
    if min(launches.values()) < 1:
        raise AssertionError(f"phase A skipped a kernel: {launches}")
    if summary["frames"] != scenes:
        raise AssertionError(f"evaluated {summary['frames']} of {scenes} scenes")
    lines = printed.getvalue().splitlines()
    emit("evaluate_scenes", scenes=scenes, seconds=summary["scene_seconds"])
    emit("evaluate", frames=summary["frames"], batches=summary["batches"],
         seconds=summary["seconds"],
         frames_per_s=summary["frames_per_s"], vote_rounds=summary["vote_rounds"],
         stage_ms=summary["stage_ms"], launches=launches,
         summary_lines=[ln for ln in lines if ln.startswith(("phase", "3D-IoU", "rotation"))])
    return summary, launches


def vote_bound(active_slots, h, p, tensors):
    """K2's least time: unfused FP32 operations on the active slots' cells,
    or the bytes of its inputs and output, whichever is larger."""
    op_s = active_slots * h * p * VOTE_FLOPS_PER_CELL / FP32_UNFUSED_OPS_PER_S
    byte_s = sum(t.numel() * t.element_size() for t in tensors) / HBM_BYTES_PER_S
    return max(op_s, byte_s) * 1e3, "operations" if op_s >= byte_s else "bytes"


def phase_eval_timing(dev, oracle, smi):
    """K2 at the evaluation shapes (the oracle batch's first round, 64 x 1000
    x 1024, and the held-out recipe's 64 x 128 x 1024), K1 at B=4 on the
    oracle batch, and the adaptive loop's host syncs: 20 rounds with the
    per-round flag read against the same rounds without it."""
    from fastposecnn_tpu_torch.kernels.build import check, load_library
    from fastposecnn_tpu_torch.ops import voting as V
    from fastposecnn_tpu_torch.ops.connected_components import label_components_reference

    lib = load_library()
    stream = torch.cuda.current_stream().cuda_stream
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
    t2 = float(np.float32(0.999 ** 2))
    out = {}

    def time_vote(name, hyps, pts, dirs, pv, act32):
        mm, hh = hyps.shape[:2]
        counts = torch.empty((mm, hh), dtype=torch.float32, device=dev)

        def call():
            check(lib.fpcnn_vote_count(
                hyps.data_ptr(), pts.data_ptr(), dirs.data_ptr(), pv.data_ptr(),
                act32.data_ptr(), counts.data_ptr(), mm, hh, pts.shape[1], t2, stream),
                "vote_count")

        ms = loop_ms(call)
        plain = median_ms(lambda: V.vote_counts_reference(
            hyps, pts, dirs, pv, 0.999, active=act32.bool()), iters=5)
        n_act = int(act32.sum())
        bound, by = vote_bound(n_act, hh, pts.shape[1], (hyps, pts, dirs, pv, act32, counts))
        out[name] = dict(kernel="vote_count", shape=[mm, hh, pts.shape[1]],
                         active=n_act, ms=ms, plain_ms=plain, bound_ms=bound,
                         bound_by=by, device_us_by_kernel=device_us_by_kernel(call))
        emit("timing", what=name, card=smi, **out[name])

    time_vote("vote_count_eval_oracle_round1", hyps, pts, dirs, pv, act32)
    h2, p2, d2, v2, a2 = vote_inputs(dev, 64, 128, 1024, 16, seed=9)
    time_vote("vote_count_held_out_shape", h2, p2, d2, v2, a2.to(torch.int32))

    fg = oracle["out"]["categorical"]["mask"] != 0
    fg8 = fg.contiguous().view(torch.uint8)
    labels = torch.empty(fg.shape, dtype=torch.int32, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)

    def cc_call():
        check(lib.fpcnn_cc_label(fg8.data_ptr(), labels.data_ptr(), err.data_ptr(),
                                 fg.shape[0], H, W, stream), "cc_label")

    cc_ms = loop_ms(cc_call)
    if int(err.item()) != 0:
        raise AssertionError("cc_label passed its step bound on the oracle batch")
    out["cc_label_eval_oracle_b4"] = dict(
        kernel="cc_label", shape=list(fg.shape), foreground=int(fg.sum()), ms=cc_ms,
        plain_ms=median_ms(lambda: label_components_reference(fg), iters=5),
        bound_ms=fg.numel() * (1 + 4) / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        device_us_by_kernel=device_us_by_kernel(cc_call))
    emit("timing", what="cc_label_eval_oracle_b4", card=smi,
         **out["cc_label_eval_oracle_b4"])

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
    from fastposecnn_tpu_torch.kernels.build import check, load_library
    from fastposecnn_tpu_torch.ops.connected_components import label_components_reference
    from fastposecnn_tpu_torch.ops.voting import vote_counts_reference

    lib = load_library()
    stream = torch.cuda.current_stream().cuda_stream
    card = dict(card=smi)

    # K1, B=1, 480x640, on the served frame's own foreground (the main
    # path's input: the kernels line), on the known scene's and on an
    # all-foreground mask.
    logits, _ = known_scene(dev)
    with torch.inference_mode():
        served_fg = P.stage_class_compress(server.net(image))["mask"] != 0
    cc_masks_timed = {
        "known_scene": logits["mask"].argmax(1) != 0,
        "served_frame": served_fg,
        "all_foreground": torch.ones((1, H, W), dtype=torch.bool, device=dev),
    }
    labels = torch.empty((1, H, W), dtype=torch.int32, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    # Read the bool mask once (1 byte a pixel), write the labels once (4).
    cc_bound = H * W * (1 + 4) / HBM_BYTES_PER_S * 1e3
    cc_times = {}
    for name, fg in cc_masks_timed.items():
        fg8 = fg.contiguous().view(torch.uint8)
        ms = loop_ms(lambda: check(lib.fpcnn_cc_label(
            fg8.data_ptr(), labels.data_ptr(), err.data_ptr(), 1, H, W, stream),
            "cc_label"))
        plain = median_ms(lambda: label_components_reference(fg), iters=5)
        if int(err.item()) != 0:
            raise AssertionError(f"cc_label passed its step bound on '{name}'")
        cc_times[name] = (ms, plain)
        by_kernel = device_us_by_kernel(lambda: check(lib.fpcnn_cc_label(
            fg8.data_ptr(), labels.data_ptr(), err.data_ptr(), 1, H, W, stream),
            "cc_label"))
        emit("timing", kernel="cc_label", mask=name, shape=[1, H, W],
             foreground=int(fg.sum()), ms=ms, plain_ms=plain, bound_ms=cc_bound,
             bound_by="bytes", device_us_by_kernel=by_kernel, **card)
    cc_ms, cc_plain = cc_times["served_frame"]

    # K2 at the main-path shape with every slot active.
    m, h, p = 16, 4096, 1024
    hyps, pts, dirs, pv, act = vote_inputs(dev, m, h, p, m, seed=3)
    act32 = act.to(torch.int32)
    counts = torch.empty((m, h), dtype=torch.float32, device=dev)
    t2 = float(np.float32(0.999 ** 2))
    vote_ms = loop_ms(lambda: check(lib.fpcnn_vote_count(
        hyps.data_ptr(), pts.data_ptr(), dirs.data_ptr(), pv.data_ptr(),
        act32.data_ptr(), counts.data_ptr(), m, h, p, t2, stream), "vote_count"))
    vote_plain = median_ms(lambda: vote_counts_reference(hyps, pts, dirs, pv, 0.999,
                                                         active=act), iters=5)
    cells = int(act.sum()) * h * p
    vote_flops = cells * VOTE_FLOPS_PER_CELL
    vote_bytes = sum(t.numel() * 4 for t in (hyps, pts, dirs, pv, act32, counts))
    vote_op_s = vote_flops / FP32_UNFUSED_OPS_PER_S
    vote_bound = max(vote_op_s, vote_bytes / HBM_BYTES_PER_S) * 1e3
    vote_by = "operations" if vote_op_s >= vote_bytes / HBM_BYTES_PER_S else "bytes"
    vote_by_kernel = device_us_by_kernel(lambda: check(lib.fpcnn_vote_count(
        hyps.data_ptr(), pts.data_ptr(), dirs.data_ptr(), pv.data_ptr(),
        act32.data_ptr(), counts.data_ptr(), m, h, p, t2, stream), "vote_count"))
    emit("timing", kernel="vote_count", shape=[m, h, p], ms=vote_ms,
         plain_ms=vote_plain, bound_ms=vote_bound, bound_by=vote_by,
         cells=cells, flops=vote_flops, device_us_by_kernel=vote_by_kernel, **card)

    frame_ms = median_ms(lambda: server(image), iters=10)
    emit("timing", what="served_frame", shape=[1, 3, H, W], ms=frame_ms,
         fps=1e3 / frame_ms, **card)

    # The served frame by stage, each timed alone on the previous stage's
    # output; and the post-network stages on the 6-object known scene.
    cfg, gens = server.config, dict(generator=server.generator,
                                    cpu_generator=server.cpu_generator)
    with torch.inference_mode():
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
             launches=launches["cc_label"], max_abs_err=errs["cc_label"], ms=cc_ms,
             plain_ms=cc_plain, bound_ms=cc_bound, bound_by="bytes",
             library_ms=None),
        dict(name="vote_count", route="cuda",
             source="fastposecnn_tpu_torch/kernels/vote_count.cu",
             replaces="fastposecnn_tpu/ops/voting.py:282",
             launches=launches["vote_count"], max_abs_err=errs["vote_count"], ms=vote_ms,
             plain_ms=vote_plain, bound_ms=vote_bound, bound_by=vote_by,
             library_ms=None),
    ]


def main():
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    kind, smi = phase_device()
    dev = torch.device("cuda")
    phase_build()
    defaults = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
    set_tf32(False, False)  # the parity phases compare in full float32
    errs = {"cc_label": phase_cc_kernel(dev),
            "vote_count": phase_vote_kernel(dev)}
    phase_known_scene(dev)
    oracle = phase_eval_oracle(dev)
    set_tf32(*defaults)  # serve, evaluate and time as a user would
    server, image, launches = phase_serve(dev)
    _, eval_launches = phase_evaluate(dev)
    eval_times = phase_eval_timing(dev, oracle, smi)
    kernels = phase_timing(dev, server, image, launches, errs, smi)
    for k in kernels:
        name = k["name"]
        k["launches_by_path"] = {"serve": launches[name],
                                 "eval_oracle": oracle["launches"][name],
                                 "evaluate": eval_launches[name]}
        k["at_eval_shapes"] = [dict(what=what, **{f: v[f] for f in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by")})
            for what, v in eval_times.items() if v.get("kernel") == name]
        times = [k] + k["at_eval_shapes"]
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
    main()
