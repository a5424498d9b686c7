"""The plain reference's frame and train step.

`upcast` turns the benchmark's wire batch (uint8 NHWC image, uint8 masks)
into float32 tensors; `serve_frame` runs the network in eval mode and the
stages; `train_step` runs one step of the FastPoseCNN trainer: the network
in training mode with the given dropout keep masks, the stages the preset
turns on with the given vote draws, the weighted multi-task loss (a frozen
copy of the port's `train/task.py::compute_losses`), the backward pass and
`optim.RAdamLookahead`. Everything in float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from reference import losses as L
from reference.constants import IMAGENET_MEAN, IMAGENET_STD
from reference.matching import gather_matched, match_instances
from reference.stages import VoteDraws, run_pipeline

MATCH_KEYS = ("quaternion", "scales", "z", "xy", "T", "R", "RT")


def upcast_image(image: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> float32 NCHW, ImageNet-normalised."""
    image = image.float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=image.device)
    std = torch.tensor(IMAGENET_STD, device=image.device)
    return ((image - mean) / std).permute(0, 3, 1, 2).contiguous()


def upcast(batch: Dict) -> Dict:
    """Wire tensors -> the float32 image (`upcast_image`), int32 mask,
    float32 GT instance masks; other GT fields as they are."""
    agg = dict(batch["agg"])
    agg["instance_masks"] = agg["instance_masks"].float()
    return {"image": upcast_image(batch["image"]), "mask": batch["mask"].to(torch.int32),
            "agg": agg}


@torch.no_grad()
def serve_frame(net, image: torch.Tensor, cfg: Dict, inv_k: torch.Tensor,
                draws: VoteDraws) -> Dict:
    logits = net.eval()(image)
    return dict(run_pipeline(logits, cfg, inv_k, draws), logits=logits)


def compute_losses(out: Dict, batch: Dict, hp: Dict, perform_matching: bool
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logs: Dict[str, torch.Tensor] = {}
    mask_logits = out["logits"]["mask"]
    ce = L.cross_entropy(mask_logits, batch["mask"])
    focal = L.focal_loss(mask_logits, batch["mask"])
    logs["mask/loss_ce"] = ce
    logs["mask/loss_focal"] = focal
    total = hp["MASK_WEIGHT"] * (ce + ce + focal)
    dense_weights = {"quaternion": hp["DENSE_QUAT_WEIGHT"], "xy": hp["DENSE_XY_WEIGHT"],
                     "z": hp["DENSE_Z_WEIGHT"], "scales": hp["DENSE_SCALES_WEIGHT"]}
    if any(dense_weights.values()):
        dense_total, dense_logs = L.dense_supervision(
            out["logits"], batch["mask"], batch["agg"], dense_weights,
            sym_quat_mode=hp["DENSE_SYM_QUAT_MODE"])
        logs.update(dense_logs)
        total = total + dense_total
    if perform_matching and out["aggregated"] is not None:
        agg = out["aggregated"]
        matched = gather_matched(agg, batch["agg"], match_instances(agg, batch["agg"]),
                                 keys=MATCH_KEYS)
        q, q_has = L.quaternion_loss(matched)
        xy, xy_has = L.xy_loss(matched, hp["XYLOSS_TYPE"])
        z, z_has = L.z_loss(matched, hp["ZLOSS_TYPE"])
        s, s_has = L.scales_loss(matched, hp["SCALESLOSS_TYPE"])
        logs["quaternion/loss_quat"] = q
        logs["xy/loss_xy"] = xy
        logs["z/loss_z"] = z
        logs["scales/loss_scales"] = s
        total = (total + hp["QUAT_WEIGHT"] * q * q_has + hp["XY_WEIGHT"] * xy * xy_has
                 + hp["Z_WEIGHT"] * z * z_has + hp["SCALES_WEIGHT"] * s * s_has)
    logs["pose/total_loss"] = total
    return total, logs


def train_step(net, opt, batch: Dict, hp: Dict, cfg: Dict, inv_k: torch.Tensor,
               keep: Dict[str, torch.Tensor], draws: Optional[VoteDraws]):
    """One step, in place on `net` and `opt`. Returns (logs, gradients by
    parameter name, the pipeline's output)."""
    net.train()
    params = dict(net.named_parameters())
    for p in params.values():
        p.grad = None
    logits = net(batch["image"], dropout_keep=keep)
    out = dict(run_pipeline(logits, cfg, inv_k, draws), logits=logits)
    total, logs = compute_losses(out, batch, hp, hp["PERFORM_MATCHING"] and cfg["aggregation"])
    total.backward()
    grads = {n: torch.zeros_like(p) if p.grad is None else torch.nan_to_num(p.grad)
             for n, p in params.items()}
    logs["grad/global_norm"] = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    opt.step(params, grads)
    if out["aggregated"] is not None:
        logs["pose/vote_rounds"] = torch.tensor(float(out["aggregated"]["vote_rounds"]))
    return {k: v.detach() for k, v in logs.items()}, grads, out
