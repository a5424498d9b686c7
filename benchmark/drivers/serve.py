"""Serving: one client sends frames in a closed loop to the port's
`InferenceServer` and waits for each answer.

Set-up makes the weights on the card from the seed, builds the server,
renders the traffic's pool of scenes, and makes every frame's vote draws
(uniforms on the card, the rolled pairing's shifts on the host), handed to
the server as an exported program fixes them. It then runs the pool
`warmup_passes` times. The window sends frame after frame, round the pool,
until `--seconds` have passed; a frame ends when its answer (class ids,
centres, depths and R/T) is on the host, after the server has read K1's
error flag. `frame_ms_p95` is the 95th percentile of all the window's
latencies; a traced run's `frame_mean_ms.serve` is its window without the
profiler over the frames completed.

The last answer of each frame of the pool is kept with the stages' output
that produced it, and judged after the window (`check_frames`), stage by
stage from the program's own input to each stage:
  logits_gap      the network's logits against the reference network's on
                  the same image (worst head's max |diff| / max |ref|);
  mask_mismatch   pixels of the class-compressed mask that differ from the
                  reference's compression of the program's logits;
  labels_mismatch pixels of K1's labels, and instance slots, that differ
                  from the reference's labelling of the program's mask;
  counts_mismatch slots whose best vote ratio (K2's best count over the
                  slot's points) differs from the reference's vote on the
                  program's instances with the same draws;
  pose_gap        the worst relative gap of the compressed fields, the
                  instances' means, the refined centres and R/T against
                  the reference's, each from the program's inputs.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

import harness
import instrument
from reference import geometry, stages
from reference.constants import scaled_intrinsics
from reference.nets import from_config
from reference.step import serve_frame, upcast_image
from scenes import SceneConfig, scene_pool
from weights import make_weights

CHECKS = ("logits_gap", "mask_mismatch", "labels_mismatch", "counts_mismatch", "pose_gap")
# What this driver does, which a traffic file states: one client sends one
# frame at a time and waits for its answer, to the server's INFERENCE preset.
FIXED = {"batch": 1, "clients": 1, "loop": "closed", "preset": "inference"}


def frame_inputs(cell: harness.Cell, seed: int, device: torch.device) -> Dict:
    """The pool's images (float32 NCHW, on the device) and each frame's
    vote draws, from the seed."""
    cfg, tr = cell.config, cell.traffic
    h, w = cfg["image_height"], cfg["image_width"]
    sc = SceneConfig(height=h, width=w, num_classes=len(cfg["classes"]),
                     max_instances=tr["max_instances"], **tr["scenes"])
    n = tr["pool"]
    wire = scene_pool(seed, sc, n)
    images = upcast_image(torch.from_numpy(wire["image"]).to(device))
    gen = torch.Generator(device).manual_seed(int(seed) % (2 ** 62) + 1)
    shape = (n, 1, tr["max_instances"], tr["max_points"])
    ux = torch.rand(shape, generator=gen, device=device)
    uy = torch.rand(shape, generator=gen, device=device)
    chunks = -(-tr["hypotheses"] // tr["max_points"])
    host = np.random.default_rng(seed)
    shifts = [tuple(int(s) for s in host.integers(1, tr["max_points"], chunks))
              for _ in range(n)]
    return {"images": images, "ux": ux, "uy": uy, "shifts": shifts}


def stage_cfg(tr: Dict) -> Dict:
    return {"aggregation": True, "voting": True, "rt": True,
            "max_instances": tr["max_instances"], "max_points": tr["max_points"],
            "hypotheses": tr["hypotheses"], "adaptive": tr["adaptive"]}


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t0: float, control: Optional[str] = None,
        fault: Optional[str] = None) -> Dict:
    cfg, tr = cell.config, cell.traffic
    harness.check_fixed(tr, FIXED, "serve")
    harness.log("torch and the harness imported", t0)
    weights = make_weights(cfg, seed, device)
    harness.log("weights made", t0)
    inputs = frame_inputs(cell, seed, device)
    harness.log("scenes and draws made", t0)
    n = tr["pool"]
    ref_draws = [stages.VoteDraws(ux=inputs["ux"][i], uy=inputs["uy"][i],
                                  shifts=inputs["shifts"][i]) for i in range(n)]
    inv_k = torch.tensor(np.linalg.inv(scaled_intrinsics(
        "CAMERA", cfg["image_height"], cfg["image_width"])), dtype=torch.float32, device=device)
    out: Dict = {"attempted": 0, "failed": 0}
    captured: Dict[int, Dict] = {}
    if control is None:
        serve_program(cell, weights, inputs, seconds, trace, device, t0, fault, captured, out)
    else:
        serve_control(cell, weights, inputs, ref_draws, inv_k, control, device, t0, captured, out)
    out["device"] = harness.device_info(device, cell.workload["chips"])
    if device.type == "cuda":
        torch.cuda.empty_cache()
    harness.log("window closed", t0)
    out["numbers"] = check_frames(cell, weights, inputs, ref_draws, inv_k, captured, device)
    harness.log("checked", t0)
    return out


def serve_program(cell, weights, inputs, seconds, trace, device, t0, fault, captured, out):
    from fastposecnn_tpu_torch import serve as port_serve
    from fastposecnn_tpu_torch.ops.voting import VoteDraws

    cfg, tr = cell.config, cell.traffic
    n = tr["pool"]
    try:
        server = port_serve.InferenceServer(
            weights=weights, device=device, compute_dtype=tr["compute_dtype"],
            ENCODER=cfg["encoder"], SELECTED_CLASSES=tuple(cfg["classes"]),
            IMAGE_HEIGHT=cfg["image_height"], IMAGE_WIDTH=cfg["image_width"],
            MAX_INSTANCES=tr["max_instances"], MAX_VOTE_POINTS=tr["max_points"],
            HV_NUM_OF_HYPOTHESES=tr["hypotheses"], HV_ADAPTIVE=tr["adaptive"])
    except RuntimeError as exc:  # the configuration's weights do not fit its network
        raise harness.Refused(f"the program's network is not the configuration's: "
                              f"{str(exc)[:300]}") from exc
    harness.check_network(cfg, server.net, "program")
    harness.log("server built", t0)
    draws = [VoteDraws(ux=inputs["ux"][i], uy=inputs["uy"][i], shifts=inputs["shifts"][i])
             for i in range(n)]
    images = inputs["images"]
    current = [0]
    spans = harness.Spans(device) if trace else None

    def frame(i):
        current[0] = i
        mask, class_ids, xy, z, RT = server(images[i:i + 1], draws=draws[i])
        return torch.cat([class_ids.float().flatten(), xy.flatten(), z.flatten(),
                          RT.flatten()]).cpu()

    with instrument.capture_pipeline(port_serve, captured, lambda: current[0], spans), \
            instrument.fault(fault):
        for k in range(tr["warmup_passes"] * n):
            frame(k % n)
        harness.sync(device)
        out["setup_s"] = time.perf_counter() - t0
        harness.log("warmed up", t0)
        if trace:
            frames = tr["trace_frames"]
            record = harness.TraceRecord(window_s=0.0, units=frames, images=frames,
                                         spans=spans)
            spans.on = True
            with instrument.time_network(server.net, spans):
                start = time.perf_counter()
                for k in range(frames):
                    frame(k % n)
                harness.sync(device)
                record.span_window_s = time.perf_counter() - start
            spans.on = False
            with instrument.kernel_bounds(record), harness.profiled(device) as held:
                start = time.perf_counter()
                for k in range(frames):
                    frame(k % n)
                harness.sync(device)
                record.window_s = time.perf_counter() - start
            spans.flush()
            harness.reduce_trace(held.prof, record)
            record.flops = frames * network_flops(cell)
            record.peak_flops = peak(tr)
            out["record"] = record
            out["attempted"] = 2 * frames
        else:
            lat, k = [], 0
            start = time.perf_counter()
            deadline = start + seconds
            while True:
                t = time.perf_counter()
                try:
                    frame(k % n)
                except RuntimeError:
                    out["failed"] += 1
                now = time.perf_counter()
                lat.append((now - t) * 1e3)
                k += 1
                if now >= deadline:
                    break
            out["attempted"] = k
            out["metrics"] = {"frame_ms_p95": harness.percentile(lat, 95.0),
                              "setup_s": out["setup_s"]}
    del server


def serve_control(cell, weights, inputs, ref_draws, inv_k, control, device, t0, captured, out):
    """The reference, put in the program's place, in the control's
    precision: every frame of the pool once."""
    cfg, tr = cell.config, cell.traffic
    net = control_net(cfg, weights, device, control)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    tf32 = control == "tf32" and device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        for i in range(tr["pool"]):
            captured[i] = serve_frame(net, inputs["images"][i:i + 1], stage_cfg(tr),
                                      inv_k, ref_draws[i])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    out["attempted"] = tr["pool"]
    out["setup_s"] = time.perf_counter() - t0


def control_net(cfg, weights, device, control):
    """The reference network in the control's precision: "tf32" rounds the
    convolutions' operands on a device without TF32 units (on the card
    the TF32 flags are turned on instead), "fp8" rounds them to float8."""
    operands = control if (control == "fp8" or device.type != "cuda") else None
    net = from_config(cfg, operands=operands).to(device)
    harness.check_network(cfg, net, "reference")
    net.load_state_dict(weights)
    return net


def reference_flags():
    """Float32 with TF32 off; cuDNN picks its algorithms by timing them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True


def check_frames(cell, weights, inputs, ref_draws, inv_k, captured, device) -> Dict[str, float]:
    cfg, tr = cell.config, cell.traffic
    reference_flags()
    ref = from_config(cfg).to(device)
    harness.check_network(cfg, ref, "reference")
    ref.load_state_dict(weights)
    ref.eval()
    nums = {k: 0.0 for k in CHECKS}
    valid = [int(c["aggregated"]["valid"].sum()) for c in captured.values()]
    print(f"benchmark: instances a frame over the pool: {valid}", file=sys.stderr)
    with torch.no_grad():
        for i in sorted(captured):
            prog = captured.pop(i)
            logits = ref(inputs["images"][i:i + 1])
            nums["logits_gap"] = max([nums["logits_gap"]] + [
                harness.rel_gap(prog["logits"][k], logits[k]) for k in logits])
            del logits
            try:
                part = check_stages(prog, ref_draws[i], inv_k, stage_cfg(tr))
            except (RuntimeError, ValueError, IndexError):  # shapes the stages refuse
                part = {k: harness.UNREADABLE for k in CHECKS if k != "logits_gap"}
            for k, v in part.items():
                nums[k] = max(nums[k], v) if k == "pose_gap" else nums[k] + v
    return nums


def check_stages(prog: Dict, draws, inv_k, cfg: Dict) -> Dict[str, float]:
    """Each post-network stage of the reference from the program's input
    to it, against the program's output of it."""
    pc, pa = prog["categorical"], prog["aggregated"]
    cat = stages.class_compress(prog["logits"])
    nums = {"mask_mismatch": float(harness.mismatches(pc["mask"], cat["mask"]))}
    gaps = [harness.rel_gap(pc[k], cat[k]) for k in ("quaternion", "xy", "z", "scales")]
    labels = stages.label_components_reference(pc["mask"] != 0)
    agg = stages.aggregate_instances(pc, cfg["max_instances"], labels=labels)
    nums["labels_mismatch"] = float(
        harness.mismatches(pa["cc_labels"], labels)
        + harness.mismatches(pa["cc_roots"], agg["cc_roots"])
        + harness.mismatches(pa["valid"], agg["valid"])
        + harness.mismatches(pa["class_ids"], agg["class_ids"]))
    gaps += [harness.rel_gap(pa[k], agg[k]) for k in ("quaternion", "scales", "z")]
    if cfg["voting"]:
        voted = stages.hough_vote(
            {k: pa[k] for k in ("instance_masks", "xy_dense", "cc_labels", "cc_roots", "valid")},
            draws, max_points=cfg["max_points"], round_hyp_num=cfg["hypotheses"],
            adaptive=cfg["adaptive"])
        nums["counts_mismatch"] = float(harness.mismatches(pa["win_ratio"], voted["win_ratio"])
                                        + abs(int(pa["vote_rounds"]) - voted["vote_rounds"]))
        gaps.append(harness.rel_gap(pa["xy"], voted["xy"]))
    if cfg["rt"]:
        _, _, RT = geometry.batch_get_RT(pa["quaternion"], pa["xy"], pa["z"][..., None], inv_k)
        gaps.append(harness.rel_gap(pa["RT"], RT))
    nums["pose_gap"] = max(gaps)
    return nums


def network_flops(cell) -> float:
    import counts

    cfg = cell.config
    with torch.device("meta"):
        net = from_config(cfg)
    return counts.conv_flops(net, (3, cfg["image_height"], cfg["image_width"]))["forward"]


def peak(tr: Dict) -> float:
    import counts

    return counts.PEAK_FLOPS[tr["compute_dtype"]]
