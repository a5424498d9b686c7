"""Training: the port's train step (`train/task.py::make_train_step`, the
step `train/staged.py` drives) run back to back on batches gathered from a
pool of scenes held on the card in the staged trainer's wire layout.

Set-up makes the weights on the card from the seed, builds the network in
the trainers' compute dtype, the optimizer and the step, renders the pool
(`pool` scenes, `pool / batch` batches of distinct rows) and makes each
batch's dropout keep masks and vote draws, handed to the step as a replay
of given draws. It drives the step through its first `compared_steps`
steps (one per batch, so every row differs), keeping the parameters and
BatchNorm statistics before the first and after the last of them, the
optimizer's first moments after the first, each step's losses and, where
the preset runs them, the post-network stages' outputs. The optimizer
syncs its Lookahead weights at step 5 and first takes RAdam's rectified
step at step 6, so 6 steps or more cover every branch of its update. The
window then runs steps until `--seconds` have passed:
`train_images_per_s` is the rows of every step completed over the window.

After the window the reference follows the same steps from the same
weights, batches and draws (`check_steps`):
  loss_gap        each step's pixel-wise loss (`pixel_loss`), | prog - ref |
                  / | ref |, worst step;
  grad_gap        the first step's gradient as the optimizer gets it
                  (`unclipped`), the median leaf's gap of norms against the
                  larger of that leaf's and the median leaf's reference
                  norm; leaves whose reference gradient is under a
                  thousandth of the median leaf's are left out;
  change_gap      the change of the parameters over those steps, by the
                  same measure over the same leaves;
  stats_gap       the change of the BatchNorm running statistics over
                  those steps, the median statistic's gap of norms;
and, where the preset runs the stages, K1's labels and K2's counts of every
step from the program's own mask and instances (`labels_mismatch`,
`counts_mismatch`; see `drivers/serve.py`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

import harness
import instrument
from reference import stages
from reference.constants import scaled_intrinsics
from reference.nets import from_config
from reference.optim import RAdamLookahead
from reference.step import train_step as ref_train_step, upcast
from scenes import SceneConfig, scene_pool
from weights import make_weights

DECODERS = ("mask", "rotation", "translation", "scales")


def stage_cfg(hp: Dict, tr: Dict) -> Dict:
    return {"aggregation": hp["PERFORM_AGGREGATION"], "voting": hp["PERFORM_HOUGH_VOTING"],
            "rt": hp["PERFORM_RT_CALCULATION"], "max_instances": tr["max_instances"],
            "max_points": tr["max_points"], "hypotheses": tr["hypotheses"],
            "adaptive": tr["adaptive"]}


def batch_inputs(cell: harness.Cell, seed: int, device: torch.device) -> Dict:
    """The pool on the device (wire layout), each batch's rows, dropout keep
    masks and vote draws, from the seed."""
    cfg, tr = cell.config, cell.traffic
    h, w, b = cfg["image_height"], cfg["image_width"], tr["batch"]
    sc = SceneConfig(height=h, width=w, num_classes=len(cfg["classes"]),
                     max_instances=tr["max_instances"], **tr["scenes"])
    wire = scene_pool(seed, sc, tr["pool"])
    pool = {"image": torch.from_numpy(wire["image"]).to(device),
            "mask": torch.from_numpy(wire["mask"]).to(device),
            "agg": {k: torch.from_numpy(v).to(device) for k, v in wire["agg"].items()}}
    nb = tr["pool"] // b
    if nb < tr["compared_steps"]:
        raise harness.Refused(f"a pool of {tr['pool']} gives {nb} batches of distinct rows, "
                              f"fewer than the {tr['compared_steps']} steps compared")
    order = torch.from_numpy(np.random.default_rng(seed).permutation(tr["pool"])).to(device)
    rows = [order[i * b:(i + 1) * b] for i in range(nb)]
    gen = torch.Generator(device).manual_seed(int(seed) % (2 ** 62) + 2)
    seg, rate = cfg["decoder_segmentation_channels"], cfg["decoder_dropout"]
    keeps = [{d: torch.rand((b, seg, 1, 1), generator=gen, device=device) < 1.0 - rate
              for d in DECODERS} for _ in range(nb)]
    n, p = tr["max_instances"], tr["max_points"]
    draws = [{"ux": torch.rand((b, n, p), generator=gen, device=device),
              "uy": torch.rand((b, n, p), generator=gen, device=device),
              "pairs": torch.randint(0, p, (tr["max_rounds"], b * n, tr["hypotheses"], 2),
                                     generator=gen, device=device)}
             for _ in range(nb)]
    return {"pool": pool, "rows": rows, "keeps": keeps, "draws": draws}


def gather(pool: Dict, rows: torch.Tensor) -> Dict:
    return {"image": pool["image"].index_select(0, rows),
            "mask": pool["mask"].index_select(0, rows),
            "agg": {k: v.index_select(0, rows) for k, v in pool["agg"].items()}}


def snapshot(net: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Parameters and float buffers, cloned."""
    out = {n: p.detach().clone() for n, p in net.named_parameters()}
    out.update({n: b.detach().clone() for n, b in net.named_buffers()
                if b.is_floating_point()})
    return out


@dataclasses.dataclass
class FirstSteps:
    """What the first steps leave for the check."""
    p0: Dict[str, torch.Tensor]
    mu1: Dict[str, torch.Tensor]
    p_end: Dict[str, torch.Tensor]  # after the last compared step
    logs: List[Dict[str, float]]
    outs: Dict[int, Dict]
    grads1: Optional[Dict[str, torch.Tensor]] = None


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t0: float, control: Optional[str] = None,
        fault: Optional[str] = None) -> Dict:
    cfg, tr = cell.config, cell.traffic
    hp = dict(tr["hparams"])
    harness.log("torch and the harness imported", t0)
    weights = make_weights(cfg, seed, device)
    harness.log("weights made", t0)
    inputs = batch_inputs(cell, seed, device)
    harness.log("scenes and draws made", t0)
    out: Dict = {"attempted": 0, "failed": 0}
    if control is None:
        first = train_program(cell, hp, weights, inputs, seconds, trace, device, t0, fault, out)
    else:
        first = reference_steps(cell, hp, weights, inputs, device, control)
        out["setup_s"] = time.perf_counter() - t0
        out["attempted"] = len(first.logs)
    out["device"] = harness.device_info(device, cell.workload["chips"])
    if device.type == "cuda":
        torch.cuda.empty_cache()
    harness.log("window closed", t0)
    out["numbers"] = check_steps(cell, hp, weights, inputs, device, first)
    harness.log("checked", t0)
    return out


def train_program(cell, hp, weights, inputs, seconds, trace, device, t0, fault, out) -> FirstSteps:
    from fastposecnn_tpu_torch import config as C
    from fastposecnn_tpu_torch.data.loader import upcast_batch
    from fastposecnn_tpu_torch.device import compute_dtype
    from fastposecnn_tpu_torch.models import network_from_hparams
    from fastposecnn_tpu_torch.ops.voting import VoteDraws
    from fastposecnn_tpu_torch.train import task

    cfg, tr = cell.config, cell.traffic
    port_hp = getattr(C, tr["preset"])(
        IMAGE_HEIGHT=cfg["image_height"], IMAGE_WIDTH=cfg["image_width"],
        SELECTED_CLASSES=tuple(cfg["classes"]), ENCODER=cfg["encoder"],
        BATCH_SIZE=tr["batch"], MAX_INSTANCES=tr["max_instances"],
        MAX_VOTE_POINTS=tr["max_points"], HV_NUM_OF_HYPOTHESES=tr["hypotheses"],
        HV_ADAPTIVE=tr["adaptive"], COMPUTE_DTYPE=tr["compute_dtype"], **hp)
    net = network_from_hparams(port_hp, compute_dtype(port_hp, device))
    harness.check_network(cfg, net, "program")
    net.load_state_dict(weights)
    net.to(device)
    opt = task.make_optimizer(port_hp, net)
    state = task.create_train_state(net, opt)
    inv_k = np.linalg.inv(scaled_intrinsics("CAMERA", cfg["image_height"], cfg["image_width"]))
    step = task.make_train_step(net, opt, port_hp, C.pipeline_config_from(port_hp), inv_k,
                                device)
    harness.log("network and step built", t0)
    nb = len(inputs["rows"])
    half = tr["batch"] // 2 if fault == "half_batch" else tr["batch"]
    draws = [VoteDraws(ux=d["ux"][:half], uy=d["uy"][:half],
                       pairs=d["pairs"][:, :half * tr["max_instances"]]) for d in inputs["draws"]]
    keeps = [{k: v[:half] for k, v in keep.items()} for keep in inputs["keeps"]]
    rows = [r[:half] for r in inputs["rows"]]
    outs: Dict[int, Dict] = {}
    current = [0]
    spans = harness.Spans(device) if trace else None

    def run_step(i):
        nonlocal state
        current[0] = i
        batch = upcast_batch(gather(inputs["pool"], rows[i % nb]), device)
        state, logs = step(state, batch, dropout_keep=keeps[i % nb], draws=draws[i % nb])
        return logs

    keep_outs = {}
    with instrument.capture_pipeline(task, keep_outs, lambda: current[0]), \
            instrument.fault(fault):
        p0 = snapshot(net)
        first_logs, mu1 = [], None
        compared = tr["compared_steps"]
        for i in range(compared):
            logs = run_step(i)
            first_logs.append({k: float(v) for k, v in logs.items()})
            if i == 0:
                mu1 = {n: t.detach().clone() for n, t in state.opt_state.mu.items()}
            o = keep_outs.pop(i)
            if o["aggregated"] is not None:
                outs[i] = o
        p_end = snapshot(net)
        harness.sync(device)
        out["setup_s"] = time.perf_counter() - t0
        harness.log("first steps run", t0)
        k = compared
        if trace:
            steps = tr["trace_steps"]
            record = harness.TraceRecord(window_s=0.0, units=steps, images=steps * half,
                                         spans=spans)
            rounds = []
            spans.on = True
            with instrument.time_vote(spans):
                start = time.perf_counter()
                for j in range(steps):
                    logs = run_step(k + j)
                    keep_outs.clear()
                    if "pose/vote_rounds" in logs:
                        rounds.append(float(logs["pose/vote_rounds"]))
                harness.sync(device)
                record.span_window_s = time.perf_counter() - start
            spans.on = False
            with instrument.kernel_bounds(record), harness.profiled(device) as held:
                start = time.perf_counter()
                for j in range(steps):
                    run_step(k + steps + j)
                    keep_outs.clear()
                harness.sync(device)
                record.window_s = time.perf_counter() - start
            spans.flush()
            if rounds:
                spans.counters["vote_rounds"] = sum(rounds) / len(rounds)
            harness.reduce_trace(held.prof, record)
            record.flops = record.images * train_flops(cell, tr, hp)
            record.peak_flops = harness_peak(tr)
            out["record"] = record
            out["attempted"] = 2 * steps
        else:
            start = time.perf_counter()
            deadline = start + seconds
            done = 0
            while True:
                try:
                    run_step(k + done)
                except RuntimeError:
                    out["failed"] += 1
                keep_outs.clear()
                done += 1
                if time.perf_counter() >= deadline:
                    break
            harness.sync(device)
            window = time.perf_counter() - start
            out["attempted"] = done
            out["metrics"] = {"train_images_per_s": done * half / window,
                              "setup_s": out["setup_s"]}
    return FirstSteps(p0=p0, mu1=mu1, p_end=p_end, logs=first_logs, outs=outs)


def reference_steps(cell, hp, weights, inputs, device, operands) -> FirstSteps:
    """The reference's first `compared_steps` steps (its network's
    convolutions with `operands`: None for the stated precision, "fp8" for
    the control)."""
    cfg, tr = cell.config, cell.traffic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    net = from_config(cfg, operands=operands).to(device)
    harness.check_network(cfg, net, "reference")
    net.load_state_dict(weights)
    opt = RAdamLookahead(hp, dict(net.named_parameters()))
    inv_k = torch.tensor(np.linalg.inv(scaled_intrinsics(
        "CAMERA", cfg["image_height"], cfg["image_width"])), dtype=torch.float32, device=device)
    p0 = snapshot(net)
    first_logs, outs, mu1, grads1 = [], {}, None, None
    for i in range(tr["compared_steps"]):
        batch = upcast(gather(inputs["pool"], inputs["rows"][i]))
        d = inputs["draws"][i]
        draws = stages.VoteDraws(ux=d["ux"], uy=d["uy"], pairs=d["pairs"])
        logs, grads, pipe = ref_train_step(net, opt, batch, hp, stage_cfg(hp, tr), inv_k,
                                           inputs["keeps"][i], draws)
        first_logs.append({k: float(v) for k, v in logs.items()})
        if i == 0:
            mu1 = {n: t.clone() for n, t in opt.mu.items()}
            grads1 = grads
        if pipe["aggregated"] is not None:
            outs[i] = pipe
        del pipe
    return FirstSteps(p0=p0, mu1=mu1, p_end=snapshot(net), logs=first_logs, outs=outs,
                      grads1=grads1)


def check_steps(cell, hp, weights, inputs, device, prog: FirstSteps) -> Dict[str, float]:
    tr = cell.traffic
    ref = reference_steps(cell, hp, weights, inputs, device, None)
    norms = {n: g.double().norm().item() for n, g in ref.grads1.items()}
    med = median(norms.values())
    moved = {n: v >= 1e-3 * med for n, v in norms.items()}
    stats = [n for n in ref.p_end if n not in norms]  # BatchNorm statistics

    def delta(first, names):
        return {n: first.p_end[n] - first.p0[n] for n in names}

    grad = harness.leaf_gaps(unclipped(prog, hp), ref.grads1, moved)
    change = harness.leaf_gaps(delta(prog, norms), delta(ref, norms), moved)
    stat = harness.leaf_gaps(delta(prog, stats), delta(ref, stats))
    describe(prog, ref, {"grad": grad, "change": change, "stats": stat})
    nums = {
        "loss_gap": max(abs(pixel_loss(a, hp) - pixel_loss(b, hp)) / abs(pixel_loss(b, hp))
                        for a, b in zip(prog.logs, ref.logs)),
        "grad_gap": median(grad.values()),
        "change_gap": median(change.values()),
        "stats_gap": median(stat.values()),
    }
    if stage_cfg(hp, tr)["aggregation"]:
        nums["labels_mismatch"] = nums["counts_mismatch"] = 0.0
        for i, po in prog.outs.items():
            d = inputs["draws"][i]
            draws = stages.VoteDraws(ux=d["ux"], uy=d["uy"], pairs=d["pairs"])
            try:
                part = stage_checks(po["aggregated"], po["categorical"], draws,
                                    stage_cfg(hp, tr))
            except (RuntimeError, ValueError, IndexError):  # shapes the stages refuse
                part = {"labels_mismatch": harness.UNREADABLE,
                        "counts_mismatch": harness.UNREADABLE}
            nums["labels_mismatch"] += part["labels_mismatch"]
            nums["counts_mismatch"] += part["counts_mismatch"]
    return nums


def unclipped(first: FirstSteps, hp: Dict) -> Dict[str, torch.Tensor]:
    """The first gradient as the optimizer got it, worked out from its first
    moments after one step, m = (1 - b1) clip(g), and the step's logged
    global norm of g: clipping scaled every leaf by clip / norm when the
    norm passed the clip."""
    from reference.optim import B1

    norm = first.logs[0]["grad/global_norm"]
    scale = max(1.0, norm / hp["GRADIENT_CLIP_VAL"]) / (1.0 - B1)
    return {n: m * scale for n, m in first.mu1.items()}


def median(values) -> float:
    xs = sorted(values)
    return xs[len(xs) // 2]


def pixel_loss(logs: Dict[str, float], hp: Dict) -> float:
    """The step's loss over its pixel-wise terms: the mask's cross-entropy
    (twice, as CE and CCE) and focal loss, and the dense supervision; the
    matched terms, whose pairs come from the vote and the matching, are
    left out."""
    return (hp["MASK_WEIGHT"] * (2 * logs["mask/loss_ce"] + logs["mask/loss_focal"])
            + logs.get("pose/dense_total", 0.0))


def describe(prog: FirstSteps, ref: FirstSteps, leaves: Dict[str, Dict[str, float]]
             ) -> None:
    """Standard error: each step's losses on both sides, the worst leaves
    and the median leaf of both gaps."""
    import sys

    for i, (a, b) in enumerate(zip(prog.logs, ref.logs)):
        terms = " ".join(f"{k}={a[k]:.6g}/{b[k]:.6g}" for k in b if k in a)
        print(f"benchmark: step {i + 1} program/reference {terms}", file=sys.stderr)
        total = abs(a["pose/total_loss"] - b["pose/total_loss"]) / abs(b["pose/total_loss"])
        print(f"benchmark: step {i + 1} total loss gap {total:.6g}", file=sys.stderr)
    for what, gaps in leaves.items():
        worst = sorted(gaps, key=gaps.get, reverse=True)[:5]
        med = median(gaps.values())
        print(f"benchmark: {what} gaps: median leaf {med:.4g}; worst "
              + ", ".join(f"{n} {gaps[n]:.4g}" for n in worst), file=sys.stderr)


def stage_checks(pa: Dict, pc: Dict, draws, cfg: Dict) -> Dict[str, float]:
    labels = stages.label_components_reference(pc["mask"] != 0)
    agg = stages.aggregate_instances(pc, cfg["max_instances"], labels=labels)
    nums = {"labels_mismatch": float(
        harness.mismatches(pa["cc_labels"], labels)
        + harness.mismatches(pa["cc_roots"], agg["cc_roots"])
        + harness.mismatches(pa["valid"], agg["valid"]))}
    voted = stages.hough_vote(
        {k: pa[k] for k in ("instance_masks", "xy_dense", "cc_labels", "cc_roots", "valid")},
        draws, max_points=cfg["max_points"], round_hyp_num=cfg["hypotheses"],
        adaptive=cfg["adaptive"])
    nums["counts_mismatch"] = float(harness.mismatches(pa["win_ratio"], voted["win_ratio"])
                                    + abs(int(pa["vote_rounds"]) - voted["vote_rounds"]))
    return nums


def train_flops(cell, tr, hp) -> float:
    """Convolution operations of one image's step: the forward, and the
    backward of the modules the preset leaves to train."""
    import counts
    from reference.optim import frozen_modules

    cfg = cell.config
    with torch.device("meta"):
        net = from_config(cfg)
    trained = [name for name, _ in net.named_children() if name not in frozen_modules(hp)]
    c = counts.conv_flops(net, (3, cfg["image_height"], cfg["image_width"]), trained)
    return c["forward"] + c["backward"]


def harness_peak(tr) -> float:
    import counts

    return counts.PEAK_FLOPS[tr["compute_dtype"]]
