"""Soft Hough voting: the weighted mean of hypotheses after outlier pruning
(counterpart of the JAX package's `ops/voting_soft.py`, the reference's
pure-PyTorch voting path, FPC/lib/hough_voting.py:68-297 and 474-579).

  1. point pairs from the exact inverse-CDF sampler
     (`ops.voting.sample_mask_points`) give the hypotheses
     (`ops.voting.generate_hypotheses`);
  2. outliers are pruned per instance by z-score or IQR, then dropped
     (zero weight) or replaced by the mean or median hypothesis;
  3. each hypothesis is weighted by the number of points whose direction
     points toward it, times `in_mask_multiplier` where exactly one sampled
     point lies on the hypothesis's pixel;
  4. the centre is the weight-normalised mean of the hypotheses.

No kernel runs on this path: the JAX functions are plain `jnp`, and so is
this port. The random draws are injected, as in `ops.voting`: the cdf
sampler's uniforms `u` [B, N, P] and one round of point pairs [M, H, 2]
(`VoteDraws.u`, `VoteDraws.pairs[0]`), or both drawn from a generator.

The medians are numpy's (and `jnp.median`'s): the mean of the two middle
values of an even count, where `torch.median` would take the lower one.
Only the positive z tail is trimmed, a quirk of the reference kept as it
stands. No gradient passes: the points and directions are detached, as the
JAX code stops them (`ops/voting_soft.py:177-178`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from fastposecnn_tpu_torch.ops.voting import (
    VoteDraws,
    generate_hypotheses,
    sample_mask_points,
)
from fastposecnn_tpu_torch.parallel import mesh

# Slots with fewer foreground pixels than this get a (0, 0) centre.
_MIN_POINTS = 5
_P_CHUNK = 256


def _median(x: torch.Tensor, dim: int) -> torch.Tensor:
    """`jnp.median`: the sorted values at floor and ceil of (n-1)/2, added
    and halved."""
    s = torch.sort(x, dim=dim).values
    n = x.shape[dim]
    return (s.select(dim, (n - 1) // 2) + s.select(dim, n // 2)) * 0.5


def zscore_outliers(hyps: torch.Tensor, threshold: float) -> torch.Tensor:
    """[M, H, 2] -> [M, H] outlier mask: z > threshold in x or in y, with
    the unbiased standard deviation (ddof 1) over the H hypotheses."""
    n = hyps.shape[1]
    mean = hyps.sum(1, keepdim=True) / n
    centred = hyps - mean
    std = torch.sqrt((centred * centred).sum(1, keepdim=True) / (n - 1))
    z = (hyps - mean) / torch.clamp_min(std, 1e-8)
    out = z > threshold
    return out[..., 0] | out[..., 1]


def _masked_median(x: torch.Tensor, valid_at_front: bool) -> torch.Tensor:
    """Median over dim 1 of the finite entries of x [M, H, 2], whose others
    are +inf (sorted to the back) or -inf (sorted to the front)."""
    s = torch.sort(x, dim=1).values
    count = torch.isfinite(x).sum(1, keepdim=True)
    if valid_at_front:
        lo, hi = (count - 1) // 2, count // 2
    else:
        n = x.shape[1]
        lo, hi = n - 1 - (count - 1) // 2, n - 1 - count // 2
    return 0.5 * (torch.gather(s, 1, lo) + torch.gather(s, 1, hi))


def iqr_outliers(hyps: torch.Tensor, multiplier: float) -> torch.Tensor:
    """[M, H, 2] -> [M, H] outlier mask: outside [Q1 - k IQR, Q3 + k IQR]
    in x or in y, Q1 and Q3 the medians of the halves at or below and at or
    above the median."""
    q2 = _median(hyps, 1)[:, None, :]
    inf = torch.full((), float("inf"), dtype=hyps.dtype, device=hyps.device)
    q1 = _masked_median(torch.where(hyps <= q2, hyps, inf), True)
    q3 = _masked_median(torch.where(hyps >= q2, hyps, -inf), False)
    iqr = q3 - q1
    out = (hyps > q3 + multiplier * iqr) | (hyps < q1 - multiplier * iqr)
    return out[..., 0] | out[..., 1]


def prune_hypotheses(hyps: torch.Tensor, method: Optional[str], drop: bool,
                     replacement: str = "median", zscore_threshold: float = 1.0,
                     iqr_multiplier: float = 1.5
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pruned hypotheses [M, H, 2], keep mask [M, H]): `method` None or
    "none" keeps everything; "z-score" or "iqr" flags outliers, which
    `drop` zero-weights (keep False) or else replaces by the "mean" or
    "median" hypothesis."""
    every = torch.ones(hyps.shape[:2], dtype=torch.bool, device=hyps.device)
    if method is None or method == "none":
        return hyps, every
    if method == "z-score":
        out = zscore_outliers(hyps, zscore_threshold)
    elif method == "iqr":
        out = iqr_outliers(hyps, iqr_multiplier)
    else:
        raise RuntimeError("Invalid PRUN_METHOD")
    if drop:
        return hyps, ~out
    if replacement == "mean":
        rep = hyps.sum(1, keepdim=True) / hyps.shape[1]
    elif replacement == "median":
        rep = _median(hyps, 1)[:, None, :]
    else:
        raise RuntimeError("Invalid PRUN_OUTLIER_REPLACEMENT_STYLE")
    return torch.where(out[..., None], rep, hyps), every


def hypothesis_weights(hyps: torch.Tensor, pts: torch.Tensor, dirs: torch.Tensor,
                       pvalid: torch.Tensor, in_mask_multiplier: float = 3.0
                       ) -> torch.Tensor:
    """[M, H] weights, summing to 1 per slot (or 0): the valid points whose
    direction has a positive dot product with the unit vector from the
    point to the hypothesis, times `in_mask_multiplier` where exactly one
    valid point equals the hypothesis's floor. Chunked over P."""
    m, h, _ = hyps.shape
    pv = pvalid.float()
    weights = torch.zeros((m, h), dtype=torch.float32, device=hyps.device)
    in_mask = torch.zeros((m, h), dtype=torch.float32, device=hyps.device)
    hx, hy = hyps[..., 0, None], hyps[..., 1, None]
    fx, fy = torch.floor(hx), torch.floor(hy)
    for s in range(0, pts.shape[1], _P_CHUNK):
        c = slice(s, s + _P_CHUNK)
        cx, cy = pts[:, None, c, 0], pts[:, None, c, 1]
        ax, ay = hx - cx, hy - cy
        norm = torch.clamp_min(torch.sqrt(ax * ax + ay * ay), 1e-8)
        ax, ay = ax / norm, ay / norm
        dot = ax * dirs[:, None, c, 0] + ay * dirs[:, None, c, 1]
        cpv = pv[:, None, c]
        weights = weights + torch.where(dot > 0, cpv, 0.0).sum(-1)
        hit = (fx == cx) & (fy == cy)
        in_mask = in_mask + torch.where(hit, cpv, 0.0).sum(-1)
    factor = torch.where(in_mask == 1.0, float(in_mask_multiplier), 1.0)
    weights = factor * weights
    return weights / torch.clamp_min(weights.sum(1, keepdim=True), 1.0)


def soft_vote_centers(pts: torch.Tensor, dirs: torch.Tensor, active: torch.Tensor,
                      pairs: torch.Tensor, prun_method: Optional[str] = "iqr",
                      prun_drop: bool = False, prun_replacement: str = "median",
                      zscore_threshold: float = 1.0, iqr_multiplier: float = 1.5,
                      in_mask_multiplier: float = 3.0,
                      pt_valid: Optional[torch.Tensor] = None):
    """pts/dirs [M, P, 2], active [M], pairs [M, H, 2] point indices ->
    (centres [M, 2], zero on inactive slots; raw hypotheses [M, H, 2];
    pruned hypotheses [M, H, 2])."""
    pts, dirs = pts.detach(), dirs.detach()
    m, p, _ = pts.shape
    if pt_valid is None:
        pt_valid = torch.ones((m, p), dtype=torch.bool, device=pts.device)
    pvalid = (pt_valid & active[:, None]).float()
    hyps = generate_hypotheses(pts, dirs, pairs.to(device=pts.device, dtype=torch.int64))
    pruned, keep = prune_hypotheses(hyps, prun_method, prun_drop, prun_replacement,
                                    zscore_threshold, iqr_multiplier)
    weights = hypothesis_weights(pruned, pts, dirs, pvalid, in_mask_multiplier)
    weights = weights * keep.float()
    total = torch.clamp_min(weights.sum(1, keepdim=True), 1e-8)
    centers = (pruned * (weights / total)[..., None]).sum(1)
    centers = torch.where(active[:, None], centers, torch.zeros_like(centers))
    return centers, hyps, pruned


def soft_hough_vote(agg: dict, max_points: int = 1024, num_hypotheses: int = 128,
                    draws: Optional[VoteDraws] = None,
                    generator: Optional[torch.Generator] = None,
                    **kwargs) -> dict:
    """Attach soft-voted 2D centres to the aggregation payload, as
    `ops.voting.hough_vote` does: adds 'xy' [B, N, 2], 'hypothesis' and
    'pruned_hypothesis' [B, N, num_hypotheses, 2]. A slot votes when it is
    valid and has at least 5 pixels. `draws.u` and `draws.pairs[0]` are the
    draws; without `draws` both come from `generator`, on the data's
    device. Inside a process group both are the global batch's, of which
    this rank takes its own (`VoteDraws.rank_rows`). `kwargs` go to
    `soft_vote_centers`."""
    b, n = agg["valid"].shape
    m = b * n
    dev = agg["instance_masks"].device
    if draws is None:
        if generator is None:
            raise ValueError("soft_hough_vote needs `draws` or a generator")
        ranks = mesh.world_size()
        u = torch.rand((b * ranks, n, max_points), generator=generator, device=dev)
        pairs = torch.randint(0, max_points, (m * ranks, num_hypotheses, 2),
                              generator=generator, device=dev)
        draws = VoteDraws(u=u, pairs=pairs[None])
    draws = draws.rank_rows()
    u, pairs = draws.u, draws.pairs[0]
    pts, dirs, npts, pt_valid = sample_mask_points(u, agg["instance_masks"],
                                                   agg["xy_dense"])
    centers, hyps, pruned = soft_vote_centers(
        pts.reshape(m, max_points, 2), dirs.reshape(m, max_points, 2),
        agg["valid"].reshape(m) & (npts.reshape(m) >= _MIN_POINTS), pairs,
        pt_valid=pt_valid.reshape(m, max_points), **kwargs)
    out = dict(agg)
    out["xy"] = centers.reshape(b, n, 2)
    out["hypothesis"] = hyps.reshape(b, n, num_hypotheses, 2)
    out["pruned_hypothesis"] = pruned.reshape(b, n, num_hypotheses, 2)
    return out
