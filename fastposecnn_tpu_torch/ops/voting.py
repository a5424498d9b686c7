"""RANSAC Hough voting for 2D object centres (counterpart of the JAX
package's `ops/voting.py`): the bbox point sampler with the CC-label fold
and the exact inverse-CDF sampler, hypotheses from rolled or random point
pairs, inlier counting (kernel K2, `kernels/vote_count.cu`), single-shot and
adaptive (confidence-driven) RANSAC, and the least-squares refinement over
the sampled points or over every mask pixel.

Random draws are injected: `torch` cannot reproduce `jax.random` streams, so
`hough_vote` takes `draws` (`VoteDraws`), or makes them from explicit
generators.

The adaptive loop runs on the host: before each round it reads one flag
from the device (all active slots confident), so a batch costs at most
`max_iter` + 1 host syncs.

Voting passes no gradient, as in the JAX package (`ops/voting.py:529-535`,
:573, :660-661): the sampled points and directions, the refinements' inlier
weights and directions and the dense refinement's whole field are detached,
so a loss on the voted centres trains nothing. The field is trained by the
dense supervision of `losses.dense_supervision` instead.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from fastposecnn_tpu_torch.kernels import count_launch
from fastposecnn_tpu_torch.kernels.build import check, load_library

_DEGENERATE_EPS = 1e-6
# Slots with fewer foreground pixels than this get a (0, 0) centre
# (ransac_voting_gpu.py:535-539 in the reference).
_MIN_POINTS = 5
_P_CHUNK = 512


@dataclasses.dataclass
class VoteDraws:
    """The random draws of one `hough_vote` call. Each path reads its own:

    ux, uy: f32 [B, N, P] uniforms of the bbox sampler;
    shifts: ints [ceil(H/P)] in [1, P) of the single-shot rolled pairing
      (host values: `torch.roll` needs host ints);
    u: f32 [B, N, P] uniforms of the cdf sampler;
    pairs: int [R, B*N, H, 2] point indices in [0, P) of the adaptive
      loop, one [B*N, H, 2] per round (R >= the rounds that run); None
      draws each round's pairs from the generator instead.
    """

    ux: Optional[torch.Tensor] = None
    uy: Optional[torch.Tensor] = None
    shifts: Optional[Tuple[int, ...]] = None
    u: Optional[torch.Tensor] = None
    pairs: Optional[torch.Tensor] = None


def sample_draws(b: int, n: int, max_points: int, num_hyp: int,
                 generator: torch.Generator,
                 cpu_generator: torch.Generator,
                 sampler: str = "bbox") -> VoteDraws:
    """Fresh sampler draws: uniforms on `generator`'s device, shifts on a
    CPU generator (so reading them needs no device sync). The adaptive
    loop's pairs are drawn round by round, as it runs."""
    dev = generator.device
    if sampler == "cdf":
        u = torch.rand((b, n, max_points), generator=generator, device=dev)
        draws = VoteDraws(u=u)
    else:
        ux = torch.rand((b, n, max_points), generator=generator, device=dev)
        uy = torch.rand((b, n, max_points), generator=generator, device=dev)
        draws = VoteDraws(ux=ux, uy=uy)
    n_chunks = max(1, -(-num_hyp // max_points))
    shifts = torch.randint(1, max_points, (n_chunks,), generator=cpu_generator)
    draws.shifts = tuple(int(s) for s in shifts)
    return draws


# -----------------------------------------------------------------------------
# Point sampling


def sample_mask_points(
    u: torch.Tensor,  # [B, N, P] uniforms
    inst_masks: torch.Tensor,  # [B, N, H, W] binary
    xy_dense: torch.Tensor,  # [B, H, W, 2] unit-vector field
):
    """Exact inverse-CDF sampling of P mask pixels per instance (uniform,
    with replacement): the cumsum of the mask, then a binary search for
    each draw u * npts (the first index whose cdf exceeds it). Counts are
    sums of 0/1 values in float32, exact below 2^24 pixels.

    Returns pts [B, N, P, 2] (x, y), dirs [B, N, P, 2], npts [B, N],
    pt_valid [B, N, P]."""
    b, n, h, w = inst_masks.shape
    hw = h * w
    p = u.shape[-1]
    flat = inst_masks.reshape(b, n, hw).float()
    npts = flat.sum(-1)
    cdf = torch.cumsum(flat, dim=-1)
    target = u * npts[..., None]
    lo = torch.zeros((b, n, p), dtype=torch.int64, device=u.device)
    hi = torch.full((b, n, p), hw - 1, dtype=torch.int64, device=u.device)
    for _ in range(max(1, int(np.ceil(np.log2(hw))))):
        mid = (lo + hi) // 2
        gt = torch.gather(cdf, -1, mid) > target
        lo, hi = torch.where(gt, lo, mid + 1), torch.where(gt, mid, hi)
    idx = hi

    pt_valid = (npts > 0)[..., None].expand(b, n, p)
    pts = torch.stack([(idx % w).float(), (idx // w).float()], dim=-1)
    dirs = torch.gather(xy_dense.reshape(b, hw, 2), 1,
                        idx.reshape(b, n * p, 1).expand(-1, -1, 2)).reshape(b, n, p, 2)
    keep = pt_valid[..., None].float()
    return pts * keep, dirs * keep, npts, pt_valid


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


# -----------------------------------------------------------------------------
# Hypothesis generation


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


# -----------------------------------------------------------------------------
# Inlier counting: kernel K2 and its plain version


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


def vote_counts_cuda(hyps, pts, dirs, pvalid, inlier_thresh: float,
                     active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel K2 (`kernels/vote_count.cu`) on CUDA tensors."""
    m, h, _ = hyps.shape
    p = pts.shape[1]
    tensors = {"hyps": (hyps, (m, h, 2)), "pts": (pts, (m, p, 2)),
               "dirs": (dirs, (m, p, 2)), "pvalid": (pvalid, (m, p))}
    for name, (t, shape) in tensors.items():
        if not t.is_cuda or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"vote_count: {name} must be a CUDA float32 "
                             f"tensor of shape {shape}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 8:
            raise ValueError(f"vote_count: {name} must be contiguous and "
                             "8-byte aligned")
    act = None
    if active is not None:
        if tuple(active.shape) != (m,) or not active.is_cuda:
            raise ValueError("vote_count: active must be a CUDA [M] tensor")
        act = active.to(torch.int32).contiguous()
    lib = load_library()
    out = torch.empty((m, h), dtype=torch.float32, device=hyps.device)
    t2 = thresh_sq(inlier_thresh)
    with torch.cuda.device(hyps.device):
        stream = torch.cuda.current_stream().cuda_stream
        check(lib.fpcnn_vote_count(
            hyps.data_ptr(), pts.data_ptr(), dirs.data_ptr(), pvalid.data_ptr(),
            None if act is None else act.data_ptr(), out.data_ptr(),
            m, h, p, t2, stream), "vote_count")
    count_launch("vote_count")
    return out


def vote_counts(hyps, pts, dirs, pvalid, inlier_thresh: float,
                active: Optional[torch.Tensor] = None,
                impl: Optional[str] = None) -> torch.Tensor:
    """Inlier counts [M, H]. CUDA tensors go to the kernel, CPU tensors to
    the plain version; `impl="reference"` forces the plain version. A slot
    whose `active` is False counts zero."""
    if impl == "reference":
        return vote_counts_reference(hyps, pts, dirs, pvalid, inlier_thresh,
                                     active)
    if impl is not None:
        raise ValueError(f"unknown impl {impl!r}")
    if hyps.is_cuda:
        return vote_counts_cuda(hyps, pts, dirs, pvalid, inlier_thresh, active)
    if hyps.device.type == "cpu":
        return vote_counts_reference(hyps, pts, dirs, pvalid, inlier_thresh,
                                     active)
    raise ValueError(f"unsupported device {hyps.device}")


# -----------------------------------------------------------------------------
# Least-squares refinement


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


def _inlier_mask(win, pts, dirs, pvalid, inlier_thresh: float):
    """win [M, 2], pts/dirs [M, P, 2] -> [M, P] float: the points voting for
    their slot's winner (this test keeps the |d|^2 factor)."""
    a = win[:, None, :] - pts
    dot = (a * dirs).sum(-1)
    vsq = (a * a).sum(-1) * (dirs * dirs).sum(-1)
    inl = (dot > 0) & (dot * dot > _thresh_sq(inlier_thresh, pts.device) * vsq)
    return inl.float() * pvalid


def refine_centers(win: torch.Tensor, pts: torch.Tensor, dirs: torch.Tensor,
                   pvalid: torch.Tensor, inlier_thresh: float) -> torch.Tensor:
    """Normal-form least squares over the winner's inliers among the
    sampled points: n = (d.y, -d.x), b = n . p, centre = (A^T A)^-1 A^T b.
    win [M, 2], pts/dirs [M, P, 2], pvalid [M, P] -> [M, 2]."""
    dirs = dirs.detach()
    w = _inlier_mask(win, pts, dirs, pvalid, inlier_thresh)
    nrm = torch.stack([dirs[..., 1], -dirs[..., 0]], dim=-1)
    bvec = (nrm * pts).sum(-1)
    nw = nrm * w[..., None]
    ATA = torch.einsum("mpi,mpj->mij", nw, nrm)
    ATb = torch.einsum("mpi,mp->mi", nw, bvec)
    return _solve_sym2x2(ATA, ATb)


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


# -----------------------------------------------------------------------------
# RANSAC: single shot and adaptive rounds


def _pick_winners(hyps: torch.Tensor, counts: torch.Tensor):
    """First-max winner per slot: (winning hypothesis [M, 2], its count [M])."""
    win_idx = torch.argmax(counts, dim=-1)
    win_pts = torch.gather(hyps, 1, win_idx[:, None, None].expand(-1, 1, 2))[:, 0]
    return win_pts, torch.gather(counts, 1, win_idx[:, None])[:, 0]


def ransac_vote_centers(pts, dirs, npts, active, pt_valid, shifts,
                        round_hyp_num: int, inlier_thresh: float = 0.999,
                        impl: Optional[str] = None, refine: str = "none"):
    """Single-shot RANSAC (the JAX `adaptive=False` branch): one vote over
    `round_hyp_num` rolled hypotheses. pts/dirs [M, P, 2], npts/active [M],
    pt_valid [M, P]. `refine="sampled"` refines the winners over the
    sampled points.

    Returns (centers [M, 2], win_ratio [M], hypotheses [M, round_hyp_num, 2]);
    slots with fewer than 5 pixels get (0, 0)."""
    active = active & (npts >= _MIN_POINTS)
    pvalid = (pt_valid & active[:, None]).float()
    count_denom = pvalid.sum(-1).clamp_min(1.0)

    hyps = generate_hypotheses_rolled(pts, dirs, round_hyp_num, shifts)
    counts = vote_counts(hyps, pts, dirs, pvalid, inlier_thresh,
                         active=active, impl=impl)
    best_pts, win_counts = _pick_winners(hyps, counts)
    best_ratio = win_counts / count_denom
    if refine == "sampled":
        best_pts = refine_centers(best_pts, pts, dirs, pvalid, inlier_thresh)
    centers = torch.where(active[:, None], best_pts, torch.zeros_like(best_pts))
    return centers, best_ratio, hyps


def slot_confident(best_ratio: torch.Tensor, rounds: int, round_hyp_num: int,
                   confidence: float) -> torch.Tensor:
    """The adaptive loop's exit test per slot, on the device:
    1 - (1 - r^2)^(rounds * H) > confidence. Float32, in the JAX order
    (`ops/voting.py:698-703`): r*r, 1 - that, a float32 power, 1 - that."""
    base = 1.0 - best_ratio * best_ratio
    hyp_num = torch.full_like(base, float(np.float32(rounds * round_hyp_num)))
    conf = 1.0 - torch.pow(base, hyp_num)
    return conf > torch.tensor(confidence, dtype=conf.dtype, device=conf.device)


def ransac_vote_centers_adaptive(
        pts, dirs, npts, active, pt_valid, round_hyp_num: int,
        inlier_thresh: float = 0.999, confidence: float = 0.99,
        max_iter: int = 20,
        pairs: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        impl: Optional[str] = None, refine: str = "none"):
    """Adaptive RANSAC (the JAX `round_body`/`round_cond` loop,
    `ops/voting.py:681-719`): rounds of `round_hyp_num` hypotheses from
    random point pairs until every active slot is confident or `max_iter`
    rounds ran. Each round's pairs are `pairs[round]` [M, H, 2], or drawn
    from `generator` when `pairs` is None. A slot keeps its best winner
    over the rounds (strictly better ratios replace it).

    Returns (centers [M, 2], win_ratio [M], the last round's hypotheses
    [M, H, 2] (zeros if no round ran), rounds run)."""
    m, p, _ = pts.shape
    if pairs is None and generator is None:
        raise ValueError("the adaptive vote needs `pairs` or a generator")
    active = active & (npts >= _MIN_POINTS)
    pvalid = (pt_valid & active[:, None]).float()
    count_denom = pvalid.sum(-1).clamp_min(1.0)

    best_pts = torch.zeros((m, 2), dtype=torch.float32, device=pts.device)
    best_ratio = torch.zeros((m,), dtype=torch.float32, device=pts.device)
    last_hyps = torch.zeros((m, round_hyp_num, 2), dtype=torch.float32,
                            device=pts.device)
    rounds = 0
    while rounds < max_iter and not bool(torch.where(
            active, slot_confident(best_ratio, rounds, round_hyp_num,
                                   confidence), True).all()):
        if pairs is not None:
            idx = pairs[rounds].to(device=pts.device, dtype=torch.int64)
        else:
            idx = torch.randint(0, p, (m, round_hyp_num, 2),
                                generator=generator, device=pts.device)
        hyps = generate_hypotheses(pts, dirs, idx)
        counts = vote_counts(hyps, pts, dirs, pvalid, inlier_thresh,
                             active=active, impl=impl)
        win_pts, win_counts = _pick_winners(hyps, counts)
        ratio = win_counts / count_denom
        better = ratio > best_ratio
        best_pts = torch.where(better[:, None], win_pts, best_pts)
        best_ratio = torch.maximum(best_ratio, ratio)
        last_hyps = hyps
        rounds += 1

    if refine == "sampled":
        best_pts = refine_centers(best_pts, pts, dirs, pvalid, inlier_thresh)
    centers = torch.where(active[:, None], best_pts, torch.zeros_like(best_pts))
    return centers, best_ratio, last_hyps, rounds


def hough_vote(agg: dict, max_points: int = 1024, round_hyp_num: int = 128,
               inlier_thresh: float = 0.999,
               draws: Optional[VoteDraws] = None,
               generator: Optional[torch.Generator] = None,
               cpu_generator: Optional[torch.Generator] = None,
               impl: Optional[str] = None, adaptive: bool = False,
               confidence: float = 0.99, max_iter: int = 20,
               sampler: str = "bbox", refine: str = "dense") -> dict:
    """Attach voted 2D centres to the aggregation payload: point sampling
    (`sampler` "bbox" with the CC-label fold, or the exact "cdf"), RANSAC
    (single shot with rolled pairing, or `adaptive` rounds of random
    pairs), then refinement (`refine` "dense" over every mask pixel, or
    "sampled" over the sampled points). Adds 'xy' [B, N, 2], 'win_ratio'
    [B, N], 'hypothesis' and 'pruned_hypothesis' [B, N, round_hyp_num, 2]
    (the last round's cloud) and 'vote_rounds' (an int: 1 for a single
    shot).

    `draws` holds the random draws; without it they come from `generator`
    (on the data's device) and `cpu_generator`. The adaptive loop draws
    each round's pairs from `generator` unless `draws.pairs` holds them.
    Unlike the JAX function, the default is the single shot."""
    if sampler not in ("bbox", "cdf") or refine not in ("dense", "sampled"):
        raise ValueError(f"unknown sampler {sampler!r} or refine {refine!r}")
    b, n = agg["valid"].shape
    if draws is None:
        if generator is None or cpu_generator is None:
            raise ValueError("hough_vote needs `draws` or both generators")
        draws = sample_draws(b, n, max_points, round_hyp_num, generator,
                             cpu_generator, sampler)
    if sampler == "cdf":
        pts, dirs, npts, pt_valid = sample_mask_points(
            draws.u, agg["instance_masks"], agg["xy_dense"])
    else:
        pts, dirs, npts, pt_valid = sample_mask_points_bbox(
            draws.ux, draws.uy, agg["instance_masks"], agg["xy_dense"],
            agg["cc_labels"], agg["cc_roots"],
        )
    m = b * n
    # Voting is gradient-opaque: the single-shot and adaptive rounds see
    # detached points and directions (the JAX `s_pts`/`s_dirs`).
    pts, dirs = pts.detach(), dirs.detach()
    slots = (pts.reshape(m, max_points, 2), dirs.reshape(m, max_points, 2),
             npts.reshape(m), agg["valid"].reshape(m))
    inner_refine = "sampled" if refine == "sampled" else "none"
    if adaptive:
        winners, ratio, hyps, rounds = ransac_vote_centers_adaptive(
            *slots, pt_valid.reshape(m, max_points), round_hyp_num,
            inlier_thresh=inlier_thresh, confidence=confidence,
            max_iter=max_iter, pairs=draws.pairs,
            generator=generator, impl=impl, refine=inner_refine)
    else:
        winners, ratio, hyps = ransac_vote_centers(
            *slots, pt_valid.reshape(m, max_points), draws.shifts,
            round_hyp_num, inlier_thresh=inlier_thresh, impl=impl,
            refine=inner_refine)
        rounds = 1
    centers = winners.reshape(b, n, 2)
    if refine == "dense":
        centers = refine_centers_dense(centers, agg["instance_masks"],
                                       agg["xy_dense"], inlier_thresh)
        active = agg["valid"] & (npts >= _MIN_POINTS)
        centers = torch.where(active[..., None], centers,
                              torch.zeros_like(centers))
    out = dict(agg)
    out["xy"] = centers
    out["win_ratio"] = ratio.reshape(b, n)
    out["hypothesis"] = hyps.reshape(b, n, round_hyp_num, 2)
    out["pruned_hypothesis"] = out["hypothesis"]
    out["vote_rounds"] = rounds
    return out
