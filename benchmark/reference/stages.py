"""The plain reference's post-network stages: class compression,
connected components (4-connectivity, min-propagation and pointer jumping,
in place of kernel K1), instance extraction and aggregation, RANSAC Hough
voting with the bbox sampler (plain inlier counts in place of kernel K2;
single shot or adaptive) and the dense least-squares refinement, then R/T
(`geometry.batch_get_RT`).

Frozen copies of the port's `ops/class_compress.py`,
`ops/connected_components.py`, `ops/aggregation.py` and `ops/voting.py`,
with the kernels' plain versions only, no process group, and every random
draw given (`VoteDraws`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from reference import geometry
from reference.geometry import safe_normalize

_BIG = 2**31 - 1
_INT32_MAX = 2**31 - 1
_DEGENERATE_EPS = 1e-6
_MIN_POINTS = 5
_P_CHUNK = 512


def _select_class(field: torch.Tensor, cls_idx: torch.Tensor,
                  fg: torch.Tensor, k: int) -> torch.Tensor:
    """field [B, (C-1)k, H, W], cls_idx/fg [B, H, W] -> [B, H, W, k]: the k
    channels of each pixel's class, zero on background."""
    b, _, h, w = field.shape
    f = field.reshape(b, -1, k, h * w)
    idx = cls_idx.reshape(b, 1, 1, h * w).expand(b, 1, k, h * w)
    out = torch.gather(f, 1, idx)[:, 0]  # [B, k, HW]
    out = torch.where(fg.reshape(b, 1, h * w), out, torch.zeros_like(out))
    return out.transpose(1, 2).reshape(b, h, w, k)


def class_compress(logits: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """NCHW logits -> categorical data:
      mask       [B, H, W] int32 argmax class (background 0)
      quaternion [B, H, W, 4] L2-normalized, 0 on background
      xy         [B, H, W, 2] L2-normalized, 0 on background
      z          [B, H, W]    0 on background
      scales     [B, H, W, 3] 0 on background
    """
    cat_mask = torch.argmax(logits["mask"], dim=1).to(torch.int32)
    fg = cat_mask > 0
    cls_idx = (cat_mask.long() - 1).clamp_min(0)
    quat = _select_class(logits["quaternion"], cls_idx, fg, 4)
    xy = _select_class(logits["xy"], cls_idx, fg, 2)
    z = _select_class(logits["z"], cls_idx, fg, 1)[..., 0]
    scales = _select_class(logits["scales"], cls_idx, fg, 3)
    return {
        "mask": cat_mask,
        "quaternion": safe_normalize(quat),
        "xy": safe_normalize(xy),
        "z": z,
        "scales": scales,
    }


def label_components_reference(fg: torch.Tensor) -> torch.Tensor:
    """Plain version: 4-neighbour min-propagation plus pointer jumping, up to
    the fixpoint, with a hard bound of H*W iterations.

    fg [B, H, W] (bool or 0/1 ints) -> [B, H, W] int32 root index / -1.
    """
    fgb = fg != 0
    b, h, w = fgb.shape
    hw = h * w
    lin = torch.arange(hw, device=fg.device).reshape(1, h, w)
    big = torch.full((), _BIG, dtype=torch.int64, device=fg.device)
    lbl = torch.where(fgb, lin, big)
    for _ in range(hw + 1):
        new = lbl.clone()
        new[..., 1:] = torch.minimum(new[..., 1:], lbl[..., :-1])
        new[..., :-1] = torch.minimum(new[..., :-1], lbl[..., 1:])
        new[..., 1:, :] = torch.minimum(new[..., 1:, :], lbl[..., :-1, :])
        new[..., :-1, :] = torch.minimum(new[..., :-1, :], lbl[..., 1:, :])
        new = torch.where(fgb, new, big).reshape(b, hw)
        is_bg = new == _BIG
        jumped = torch.gather(new, 1, torch.where(is_bg, 0, new))
        new = torch.where(is_bg, big, jumped).reshape(b, h, w)
        if torch.equal(new, lbl):
            break
        lbl = new
    else:
        raise RuntimeError(f"label_components_reference did not converge "
                           f"within {hw + 1} iterations")
    return torch.where(fgb, lbl, -1).to(torch.int32)


def extract_instances(labels: torch.Tensor, max_instances: int):
    """Root-index label map [B, H, W] -> padded per-instance binary masks.

    Returns masks [B, K, H, W] float32, valid [B, K] bool and roots [B, K]
    int32 (int32 max on invalid slots).

    The K components with the largest area estimate are kept: areas are
    counted on a strided subsample (stride max(1, round(sqrt(HW/4800))), 8
    at 480x640) plus 0.5, so every root stays eligible; among equal scores
    the smallest root wins (a stable descending sort over the score). The
    kept slots are then ordered by root; invalid slots sink to the end.
    """
    b, h, w = labels.shape
    hw = h * w
    k = max_instances
    stride = max(1, int(round((hw / 4800.0) ** 0.5)))
    flat = labels.reshape(b, hw).long()
    lin = torch.arange(hw, device=labels.device)
    is_root = flat == lin
    sub = labels[:, ::stride, ::stride].reshape(b, -1).long()
    fg_s = sub >= 0
    areas = torch.zeros(b, hw, dtype=torch.float32, device=labels.device)
    areas.scatter_add_(1, torch.where(fg_s, sub, 0), fg_s.float())
    score = torch.where(is_root, areas + 0.5, torch.full_like(areas, -1.0))
    top = torch.sort(score, dim=1, descending=True, stable=True)
    big = torch.full((), _BIG, dtype=torch.int64, device=labels.device)
    roots = torch.where(top.values[:, :k] > 0.0, top.indices[:, :k], big)
    roots = torch.sort(roots, dim=1).values
    valid = roots != _BIG
    masks = (flat[:, None, :] == roots[:, :, None]) & valid[:, :, None]
    return masks.reshape(b, k, h, w).float(), valid, roots.to(torch.int32)


def aggregate_instances(cat_data: Dict[str, torch.Tensor], max_instances: int,
                        labels: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Categorical data (from `class_compress`) -> padded instance data:
    instance_masks [B, K, H, W], valid [B, K], class_ids [B, K] int32,
    quaternion [B, K, 4], scales [B, K, 3], z [B, K], plus `xy_dense`,
    `cat_mask`, `cc_labels` and `cc_roots` passed through for voting, and
    `cc_error`: the CC kernel's error flag on a CUDA device, unread (the
    entry point reads it once, with `raise_on_error_flag`), None on the
    CPU."""
    cat_mask = cat_data["mask"]
    b, h, w = cat_mask.shape
    hw = h * w
    if labels is None:
        labels = label_components_reference(cat_mask != 0)
    masks, valid, roots = extract_instances(labels, max_instances)
    flat_masks = masks.reshape(b, max_instances, hw)
    safe_area = flat_masks.sum(-1).clamp_min(1.0)

    cls = cat_mask.reshape(b, 1, hw)
    masked_cls = torch.where((flat_masks > 0) & (cls > 0), cls,
                             torch.full_like(cls, _INT32_MAX))
    class_ids = masked_cls.amin(dim=-1)
    class_ids = torch.where(valid, class_ids, 0).to(torch.int32)

    def masked_mean(field: torch.Tensor) -> torch.Tensor:
        flat = field.reshape(b, hw, field.shape[-1])
        return torch.bmm(flat_masks, flat) / safe_area[..., None]

    quat = safe_normalize(masked_mean(cat_data["quaternion"]))
    scales = masked_mean(cat_data["scales"])
    z = torch.exp(masked_mean(cat_data["z"][..., None])[..., 0])

    vf = valid.float()
    return {
        "instance_masks": masks * vf[..., None, None],
        "valid": valid,
        "class_ids": class_ids,
        "quaternion": quat * vf[..., None],
        "scales": scales * vf[..., None],
        "z": z * vf,
        "xy_dense": cat_data["xy"],
        "cat_mask": cat_mask,
        "cc_labels": labels,
        "cc_roots": roots,
    }


@dataclasses.dataclass
class VoteDraws:
    """The random draws of one `hough_vote` call. Each path reads its own:

    ux, uy: f32 [B, N, P] uniforms of the bbox sampler;
    shifts: ints [ceil(H/P)] in [1, P) of the single-shot rolled pairing
      (host values: `torch.roll` needs host ints);
    pairs: int [R, B*N, H, 2] point indices in [0, P) of the adaptive
      loop, one [B*N, H, 2] per round (R >= the rounds that run).
    """

    ux: Optional[torch.Tensor] = None
    uy: Optional[torch.Tensor] = None
    shifts: Optional[Tuple[int, ...]] = None
    pairs: Optional[torch.Tensor] = None


def sample_mask_points_bbox(
    ux: torch.Tensor,  # [B, N, P] uniforms
    uy: torch.Tensor,
    inst_masks: torch.Tensor,  # [B, N, H, W] binary
    xy_dense: torch.Tensor,  # [B, H, W, 2] unit-vector field
    labels: torch.Tensor,  # [B, H, W] CC root map
    roots: torch.Tensor,  # [B, N] per-slot root index
):
    """Rejection sampling from each instance's bounding box: one uniform
    (x, y) per point inside the bbox; a point whose pixel's CC label is not
    the slot's root is invalid (zero point and direction).

    Returns pts [B, N, P, 2] (x, y), dirs [B, N, P, 2], npts [B, N],
    pt_valid [B, N, P]."""
    b, n, h, w = inst_masks.shape
    hw = h * w
    flat = inst_masks.reshape(b, n, hw)
    npts = flat.sum(-1)
    dev = inst_masks.device
    xs = torch.arange(w, dtype=torch.float32, device=dev).repeat(h)
    ys = torch.arange(h, dtype=torch.float32, device=dev).repeat_interleave(w)
    big = torch.full((), 1e9, dtype=torch.float32, device=dev)  # no host copy: no sync
    on = flat > 0
    x0 = torch.where(on, xs, big).amin(-1)
    x1 = torch.where(on, xs, -big).amax(-1)
    y0 = torch.where(on, ys, big).amin(-1)
    y1 = torch.where(on, ys, -big).amax(-1)
    empty = npts < 1
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    x0, x1, y0, y1 = (torch.where(empty, zero, v) for v in (x0, x1, y0, y1))

    px = torch.floor(x0[..., None] + ux * (x1 - x0 + 1.0)[..., None])
    py = torch.floor(y0[..., None] + uy * (y1 - y0 + 1.0)[..., None])
    px = px.clamp(0, w - 1)
    py = py.clamp(0, h - 1)
    idx = (py * w + px).long().reshape(b, -1)  # [B, N*P]

    dirs = torch.gather(xy_dense.reshape(b, hw, 2), 1,
                        idx[..., None].expand(-1, -1, 2)).reshape(b, n, -1, 2)
    lbl = torch.gather(labels.reshape(b, hw), 1, idx).reshape(b, n, -1)
    on_mask = lbl == roots[..., None]
    pt_valid = on_mask & (npts > 0)[..., None]
    pts = torch.stack([px, py], dim=-1)
    keep = pt_valid[..., None].float()
    return pts * keep, dirs * keep, npts, pt_valid


def _intersect_pairs(p0, d0, p1, d1):
    """Normal-form intersection of ray pairs: n_i = (d_i.y, -d_i.x), solve
    [n0; n1] x = [n0.p0; n1.p1]; |det| < 1e-6 -> (0, 0)."""
    n0x, n0y = d0[..., 1], -d0[..., 0]
    n1x, n1y = d1[..., 1], -d1[..., 0]
    b0 = n0x * p0[..., 0] + n0y * p0[..., 1]
    b1 = n1x * p1[..., 0] + n1y * p1[..., 1]
    det = n0x * n1y - n0y * n1x
    degenerate = torch.abs(det) < _DEGENERATE_EPS
    safe_det = torch.where(degenerate, torch.ones_like(det), det)
    hx = (b0 * n1y - b1 * n0y) / safe_det
    hy = (b1 * n0x - b0 * n1x) / safe_det
    hyp = torch.stack([hx, hy], dim=-1)
    return torch.where(degenerate[..., None], torch.zeros_like(hyp), hyp)


def generate_hypotheses(pts: torch.Tensor, dirs: torch.Tensor,
                        pairs: torch.Tensor) -> torch.Tensor:
    """[M, H, 2] candidate centres from the point pairs `pairs` [M, H, 2]
    (indices into P)."""
    def take(x, i):
        return torch.gather(x, 1, pairs[..., i:i + 1].expand(-1, -1, 2))

    return _intersect_pairs(take(pts, 0), take(dirs, 0), take(pts, 1),
                            take(dirs, 1))


def generate_hypotheses_rolled(pts: torch.Tensor, dirs: torch.Tensor,
                               num_hyp: int, shifts) -> torch.Tensor:
    """[M, num_hyp, 2] candidate centres: point i paired with point
    (i - s_c) mod P, one rolled pairing per chunk of P hypotheses."""
    hyps = [
        _intersect_pairs(pts, dirs, torch.roll(pts, s, dims=1),
                         torch.roll(dirs, s, dims=1))
        for s in shifts
    ]
    return torch.cat(hyps, dim=1)[:, :num_hyp].contiguous()


def thresh_sq(inlier_thresh: float) -> float:
    """t^2 in Python double, rounded once to float32 (as the JAX code's
    weakly-typed `thresh_sq` constant)."""
    return float(np.float32(float(inlier_thresh) ** 2))


def _thresh_sq(inlier_thresh: float, device) -> torch.Tensor:
    # Filled on the device: a host-to-device copy would wait for the stream.
    return torch.full((), thresh_sq(inlier_thresh), dtype=torch.float32, device=device)


def vote_counts_reference(hyps, pts, dirs, pvalid, inlier_thresh: float,
                          active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K2, chunked over P, in the kernel's arithmetic order
    (subtract first; unit-or-zero directions, so no |d|^2 factor)."""
    m, h, _ = hyps.shape
    t2 = _thresh_sq(inlier_thresh, hyps.device)
    pv = pvalid.float()
    if active is not None:
        pv = pv * active.reshape(m, 1).float()
    acc = torch.zeros((m, h), dtype=torch.float32, device=hyps.device)
    hx, hy = hyps[..., 0, None], hyps[..., 1, None]
    for s in range(0, pts.shape[1], _P_CHUNK):
        c = slice(s, s + _P_CHUNK)
        ax = hx - pts[:, None, c, 0]
        ay = hy - pts[:, None, c, 1]
        dot = ax * dirs[:, None, c, 0] + ay * dirs[:, None, c, 1]
        vsq = ax * ax + ay * ay
        inlier = (dot > 0) & (dot * dot > t2 * vsq)
        acc = acc + torch.where(inlier, pv[:, None, c], 0.0).sum(-1)
    return acc


def _solve_sym2x2(ATA: torch.Tensor, ATb: torch.Tensor) -> torch.Tensor:
    """Solve symmetric PSD 2x2 systems; a singular system takes the rank-1
    pseudo-inverse (1/tr^2) * ATA @ ATb."""
    a, b, c = ATA[..., 0, 0], ATA[..., 0, 1], ATA[..., 1, 1]
    det = a * c - b * b
    tr = a + c
    singular = torch.abs(det) <= 1e-10 * torch.clamp_min(tr * tr, 1e-30)
    safe_det = torch.where(singular, torch.ones_like(det), det)
    x0 = (c * ATb[..., 0] - b * ATb[..., 1]) / safe_det
    x1 = (-b * ATb[..., 0] + a * ATb[..., 1]) / safe_det
    safe_tr = torch.where(tr > 1e-20, tr, torch.ones_like(tr))
    p0 = (a * ATb[..., 0] + b * ATb[..., 1]) / (safe_tr * safe_tr)
    p1 = (b * ATb[..., 0] + c * ATb[..., 1]) / (safe_tr * safe_tr)
    return torch.where(singular[..., None], torch.stack([p0, p1], dim=-1),
                       torch.stack([x0, x1], dim=-1))


def refine_centers_dense(win: torch.Tensor, masks: torch.Tensor,
                         field: torch.Tensor, inlier_thresh: float) -> torch.Tensor:
    """Least squares over the winner's inliers among ALL in-mask pixels:
    win [B, N, 2], masks [B, N, H, W], field [B, H, W, 2] -> [B, N, 2]. The
    five normal-equation sums are one [N, HW] x [HW, 5] product per image.
    No gradient reaches `field`."""
    field = field.detach()
    b, n, h, w = masks.shape
    hw = h * w
    dev = masks.device
    px = torch.arange(w, dtype=torch.float32, device=dev).repeat(h)
    py = torch.arange(h, dtype=torch.float32, device=dev).repeat_interleave(w)
    dx = field[..., 0].reshape(b, 1, hw)
    dy = field[..., 1].reshape(b, 1, hw)
    ax = win[..., 0:1] - px  # [B, N, HW]
    ay = win[..., 1:2] - py
    dot = ax * dx + ay * dy
    vsq = ax * ax + ay * ay
    inl = (dot > 0) & (dot * dot > _thresh_sq(inlier_thresh, dev) * vsq)
    wgt = inl.float() * masks.reshape(b, n, hw)

    nx, ny = dy[:, 0], -dx[:, 0]  # [B, HW]
    bvec = nx * px + ny * py
    feats = torch.stack([nx * nx, nx * ny, ny * ny, nx * bvec, ny * bvec], dim=-1)
    sums = torch.bmm(wgt, feats)  # [B, N, 5]
    ATA = torch.stack([
        torch.stack([sums[..., 0], sums[..., 1]], dim=-1),
        torch.stack([sums[..., 1], sums[..., 2]], dim=-1),
    ], dim=-2)
    return _solve_sym2x2(ATA, sums[..., 3:5])


def _pick_winners(hyps: torch.Tensor, counts: torch.Tensor):
    """First-max winner per slot: (winning hypothesis [M, 2], its count [M])."""
    win_idx = torch.argmax(counts, dim=-1)
    win_pts = torch.gather(hyps, 1, win_idx[:, None, None].expand(-1, 1, 2))[:, 0]
    return win_pts, torch.gather(counts, 1, win_idx[:, None])[:, 0]


def ransac_vote_centers(pts, dirs, npts, active, pt_valid, shifts,
                        round_hyp_num: int, inlier_thresh: float = 0.999):
    """Single-shot RANSAC (the JAX `adaptive=False` branch): one vote over
    `round_hyp_num` rolled hypotheses. pts/dirs [M, P, 2], npts/active [M],
    pt_valid [M, P].

    Returns (centers [M, 2], win_ratio [M], hypotheses [M, round_hyp_num, 2]);
    slots with fewer than 5 pixels get (0, 0)."""
    active = active & (npts >= _MIN_POINTS)
    pvalid = (pt_valid & active[:, None]).float()
    count_denom = pvalid.sum(-1).clamp_min(1.0)

    hyps = generate_hypotheses_rolled(pts, dirs, round_hyp_num, shifts)
    counts = vote_counts_reference(hyps, pts, dirs, pvalid, inlier_thresh, active=active)
    best_pts, win_counts = _pick_winners(hyps, counts)
    best_ratio = win_counts / count_denom
    centers = torch.where(active[:, None], best_pts, torch.zeros_like(best_pts))
    return centers, best_ratio, hyps


def slot_confident(best_ratio: torch.Tensor, rounds, round_hyp_num: int,
                   confidence: float) -> torch.Tensor:
    """The adaptive loop's exit test per slot, on the device:
    1 - (1 - r^2)^(rounds * H) > confidence. Float32, in the JAX order
    (`ops/voting.py:698-703`): r*r, 1 - that, a float32 power, 1 - that.
    `rounds` is an int, or an int64 scalar tensor in a traced loop."""
    base = 1.0 - best_ratio * best_ratio
    if isinstance(rounds, torch.Tensor):  # a traced loop's counter
        hyp_num = (rounds * round_hyp_num).to(base.dtype).expand_as(base)
    else:
        hyp_num = torch.full_like(base, float(np.float32(rounds * round_hyp_num)))
    conf = 1.0 - torch.pow(base, hyp_num)
    return conf > torch.full((), confidence, dtype=conf.dtype, device=conf.device)


def _vote_round(pts, dirs, pvalid, active, count_denom, idx, inlier_thresh,
                best_pts, best_ratio):
    """One adaptive round on the point pairs `idx` [M, H, 2]: (its
    hypotheses, the best winners and ratios so far; strictly better ratios
    replace a slot's winner)."""
    hyps = generate_hypotheses(pts, dirs, idx)
    counts = vote_counts_reference(hyps, pts, dirs, pvalid, inlier_thresh, active=active)
    win_pts, win_counts = _pick_winners(hyps, counts)
    ratio = win_counts / count_denom
    better = ratio > best_ratio
    return (hyps, torch.where(better[:, None], win_pts, best_pts),
            torch.maximum(best_ratio, ratio))


def ransac_vote_centers_adaptive(pts, dirs, npts, active, pt_valid, round_hyp_num: int,
                                 pairs: torch.Tensor, inlier_thresh: float = 0.999,
                                 confidence: float = 0.99, max_iter: int = 20):
    """Adaptive RANSAC: rounds of `round_hyp_num` hypotheses from the point
    pairs `pairs[round]` [M, H, 2] until every active slot is confident or
    `max_iter` rounds ran; a slot keeps its best winner over the rounds
    (strictly better ratios replace it). Returns (centers [M, 2], win_ratio
    [M], the last round's hypotheses [M, H, 2], rounds run)."""
    m = pts.shape[0]
    active = active & (npts >= _MIN_POINTS)
    pvalid = (pt_valid & active[:, None]).float()
    count_denom = pvalid.sum(-1).clamp_min(1.0)
    fixed = (pts, dirs, pvalid, active, count_denom)
    best_pts = torch.zeros((m, 2), dtype=torch.float32, device=pts.device)
    best_ratio = torch.zeros((m,), dtype=torch.float32, device=pts.device)
    last_hyps = torch.zeros((m, round_hyp_num, 2), dtype=torch.float32, device=pts.device)
    rounds = 0
    while rounds < max_iter and not bool(torch.where(
            active, slot_confident(best_ratio, rounds, round_hyp_num, confidence),
            True).all()):
        idx = pairs[rounds].to(device=pts.device, dtype=torch.int64)
        last_hyps, best_pts, best_ratio = _vote_round(*fixed, idx, inlier_thresh,
                                                      best_pts, best_ratio)
        rounds += 1
    centers = torch.where(active[:, None], best_pts, torch.zeros_like(best_pts))
    return centers, best_ratio, last_hyps, rounds


def hough_vote(agg: dict, draws: VoteDraws, max_points: int = 1024,
               round_hyp_num: int = 128, inlier_thresh: float = 0.999,
               adaptive: bool = False, confidence: float = 0.99,
               max_iter: int = 20) -> dict:
    """Voted 2D centres on the aggregation payload with the given draws:
    the bbox sampler with the CC-label fold, single-shot RANSAC over rolled
    pairs (`draws.shifts`) or adaptive rounds (`draws.pairs`), then the
    dense refinement over every mask pixel. Adds 'xy' [B, N, 2],
    'win_ratio' [B, N] and 'vote_rounds'."""
    b, n = agg["valid"].shape
    pts, dirs, npts, pt_valid = sample_mask_points_bbox(
        draws.ux, draws.uy, agg["instance_masks"], agg["xy_dense"],
        agg["cc_labels"], agg["cc_roots"])
    m = b * n
    pts, dirs = pts.detach(), dirs.detach()
    slots = (pts.reshape(m, max_points, 2), dirs.reshape(m, max_points, 2),
             npts.reshape(m), agg["valid"].reshape(m), pt_valid.reshape(m, max_points))
    if adaptive:
        winners, ratio, _, rounds = ransac_vote_centers_adaptive(
            *slots, round_hyp_num, draws.pairs, inlier_thresh=inlier_thresh,
            confidence=confidence, max_iter=max_iter)
    else:
        winners, ratio, _ = ransac_vote_centers(
            *slots, draws.shifts, round_hyp_num, inlier_thresh=inlier_thresh)
        rounds = 1
    centers = refine_centers_dense(winners.reshape(b, n, 2), agg["instance_masks"],
                                   agg["xy_dense"], inlier_thresh)
    active = agg["valid"] & (npts >= _MIN_POINTS)
    out = dict(agg)
    out["xy"] = torch.where(active[..., None], centers, torch.zeros_like(centers))
    out["win_ratio"] = ratio.reshape(b, n)
    out["vote_rounds"] = rounds
    return out


def run_pipeline(logits: Dict[str, torch.Tensor], cfg: Dict[str, Any],
                 inv_k: torch.Tensor, draws: Optional[VoteDraws]) -> Dict[str, Any]:
    """The stages that `cfg` turns on (keys `aggregation`, `voting`, `rt`,
    `max_instances`, `max_points`, `hypotheses`, `adaptive`), from the
    network's logits: {'categorical', 'aggregated' (None without
    aggregation)}."""
    categorical = class_compress(logits)
    agg = None
    if cfg["aggregation"]:
        agg = aggregate_instances(categorical, cfg["max_instances"])
        if cfg["voting"]:
            agg = hough_vote(agg, draws, max_points=cfg["max_points"],
                             round_hyp_num=cfg["hypotheses"], adaptive=cfg["adaptive"])
            if cfg["rt"]:
                R, T, RT = geometry.batch_get_RT(agg["quaternion"], agg["xy"],
                                                 agg["z"][..., None], inv_k)
                agg = dict(agg, R=R, T=T, RT=RT)
    return {"categorical": categorical, "aggregated": agg}
