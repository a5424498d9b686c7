"""Vanishing-point RANSAC with homogeneous hypotheses (counterpart of the
JAX package's `ops/voting_vp.py`; the reference ships these CUDA kernels
but its pipeline never calls them,
FPC/lib/ransac_voting_gpu_layer/src/ransac_voting_kernel.cu:170-351).

A hypothesis is the homogeneous intersection (x, y, z) of two pixel rays'
lines, so parallel rays vote for a point at infinity (z = 0):
  line_i = (d_y, -d_x, c_y d_x - c_x d_y)          (kernel:201-208)
  hyp    = line_0 x line_1                          (kernel:211-213)
  sign fix: if all four direction tests are negative, negate the point;
  inconsistent signs (the rays cannot both reach it) zero it
                                                    (kernel:216-225)
  vote: diff = (h_x - c_x h_z, h_y - c_y h_z); diff . d >= 0 componentwise
  and |cos(angle(d, diff))| > thresh                (kernel:287-309)

The point pairs are injected ([M, H, 2] indices into P), as in
`ops.voting`. No path of the port calls these functions; they are plain
torch ops, as the JAX functions are plain `jnp`, each a separate multiply
or add (nothing for a compiler to contract), so the CPU and the card count
alike. The count is chunked over P as in JAX.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

_P_CHUNK = 512


def _take(x: torch.Tensor, pairs: torch.Tensor, i: int) -> torch.Tensor:
    return torch.gather(x, 1, pairs[..., i:i + 1].expand(-1, -1, 2))


def generate_hypotheses_vp(pts: torch.Tensor, dirs: torch.Tensor,
                           pairs: torch.Tensor) -> torch.Tensor:
    """pts/dirs [M, P, 2], pairs [M, H, 2] -> homogeneous hypotheses
    [M, H, 3]."""
    pairs = pairs.to(device=pts.device, dtype=torch.int64)
    p0, d0, p1, d1 = (_take(pts, pairs, 0), _take(dirs, pairs, 0),
                      _take(pts, pairs, 1), _take(dirs, pairs, 1))
    cx0, cy0, cx1, cy1 = p0[..., 0], p0[..., 1], p1[..., 0], p1[..., 1]
    dx0, dy0, dx1, dy1 = d0[..., 0], d0[..., 1], d1[..., 0], d1[..., 1]
    # line_i = (a_i, b_i, c_i); hyp = line_0 x line_1, written out (as
    # `jnp.cross` computes it) in separate multiplies and subtractions, so
    # that no compiler contracts them: the CPU and the card give the same
    # bits, and the counts near the threshold agree exactly.
    a0, b0, c0 = dy0, -dx0, cy0 * dx0 - cx0 * dy0
    a1, b1, c1 = dy1, -dx1, cy1 * dx1 - cx1 * dy1
    x = b0 * c1 - c0 * b1
    y = c0 * a1 - a0 * c1
    z = a0 * b1 - b0 * a1
    h = torch.stack([x, y, z], dim=-1)
    val_x0 = dx0 * (x - z * cx0)
    val_x1 = dx1 * (x - z * cx1)
    val_y0 = dy0 * (y - z * cy0)
    val_y1 = dy1 * (y - z * cy1)
    flip = (val_x0 < 0) & (val_x1 < 0) & (val_y0 < 0) & (val_y1 < 0)
    h = torch.where(flip[..., None], -h, h)
    inconsistent = (val_x0 * val_x1 < 0) | (val_y0 * val_y1 < 0)
    return torch.where(inconsistent[..., None], torch.zeros_like(h), h)


def vote_counts_vp(hyps: torch.Tensor, pts: torch.Tensor, dirs: torch.Tensor,
                   pvalid: torch.Tensor, inlier_thresh: float = 0.999
                   ) -> torch.Tensor:
    """Inlier counts [M, H] of homogeneous hypotheses [M, H, 3] over the
    points pts/dirs [M, P, 2] weighted by pvalid [M, P]. |cos| > t is
    tested as dot^2 > t^2 |d|^2 |diff|^2, t^2 rounded once to float32."""
    thr_sq = float(np.float32(float(inlier_thresh) ** 2))
    pv = pvalid.float()
    hx, hy, hz = hyps[..., 0, None], hyps[..., 1, None], hyps[..., 2, None]
    acc = torch.zeros(hyps.shape[:2], dtype=torch.float32, device=hyps.device)
    for s in range(0, pts.shape[1], _P_CHUNK):
        c = slice(s, s + _P_CHUNK)
        cx, cy = pts[:, None, c, 0], pts[:, None, c, 1]
        dx, dy = dirs[:, None, c, 0], dirs[:, None, c, 1]
        diff_x = hx - cx * hz
        diff_y = hy - cy * hz
        dot = dx * diff_x + dy * diff_y
        n1_sq = dx * dx + dy * dy
        n2_sq = diff_x * diff_x + diff_y * diff_y
        ok_norm = (n1_sq >= 1e-12) & (n2_sq >= 1e-12)
        ok_sign = (diff_x * dx >= 0) & (diff_y * dy >= 0)
        inlier = ok_norm & ok_sign & (dot * dot > thr_sq * n1_sq * n2_sq)
        acc = acc + torch.where(inlier, pv[:, None, c], 0.0).sum(-1)
    return acc


def ransac_vanishing_points(pts: torch.Tensor, dirs: torch.Tensor,
                            active: torch.Tensor, pairs: torch.Tensor,
                            inlier_thresh: float = 0.999,
                            pt_valid: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-shot vanishing-point estimate: the first hypothesis of most
    inliers per slot, unit-normalised [M, 3] (zero on inactive slots), and
    its inlier count [M]. pairs [M, H, 2] are the point pairs."""
    m, p, _ = pts.shape
    if pt_valid is None:
        pt_valid = torch.ones((m, p), dtype=torch.bool, device=pts.device)
    pvalid = (pt_valid & active[:, None]).float()
    hyps = generate_hypotheses_vp(pts, dirs, pairs)
    counts = vote_counts_vp(hyps, pts, dirs, pvalid, inlier_thresh)
    win = torch.argmax(counts, dim=-1)
    best = torch.gather(hyps, 1, win[:, None, None].expand(-1, 1, 3))[:, 0]
    norm = torch.sqrt((best * best).sum(-1, keepdim=True))
    best = best / torch.where(norm > 0, norm, torch.ones_like(norm))
    best_counts = torch.gather(counts, 1, win[:, None])[:, 0]
    return torch.where(active[:, None], best, torch.zeros_like(best)), best_counts
