"""Probe of K2's formulation: the RANSAC inlier counts in the expanded form,
on the tensor cores (P1) and on the CUDA cores (P2), against K2's direct
form, on CUDA unless `--device cpu` is given.

    python -m fastposecnn_tpu_torch.probes.vote_variants [--device cpu]

The counterpart of the JAX package's TPU probe `scripts/probe_vote_variants.py`,
whose two Pallas kernels it ports:
- P1, `kernel_b`: the counts as two small matrix products,
  dot = [hx, hy, 1] . [dx, dy, -(px*dx + py*dy)] (K = 3) and
  vsq = [hx^2, hy^2, hx, hy, 1] . [1, 1, -2px, -2py, px^2 + py^2] (K = 5);
  here `kernels/vote_expanded_mma.cu`: one 3xTF32 product on the tensor
  cores (`wgmma`) whose columns alternate dot and t2*vsq, the split folded
  into K = 16.
- P2, `kernel_c`: the same expanded form as broadcast arithmetic, with
  cc = px*dx + py*dy and qq = px^2 + py^2 per point; here
  `kernels/vote_expanded_bcast.cu` on the CUDA cores, K2's structure.

K2 (`ops/voting.py`) computes (h - p) . d and |h - p|^2 directly. The
expanded form cancels (|h|^2 - 2h.p + |p|^2 loses about three digits at
coordinates near 500), so its counts differ from K2's near the inlier
margin, and from one framework or rounding order to another: the parity
check of P1 and P2 is the rounding band of `expanded_vote_band`, and P2's
kernel, written in its plain version's order, is also exactly equal to it.

For each shape of `SHAPES` (`make_inputs`, the TPU script's data, seed 0)
`main` prints one JSON line per kernel (K2, P1, P2): its time (CUDA events around
50 back-to-back launches, median of 5, and device time from torch.profiler),
its plain version's time, its bound, for P1 the time of its two products
as float32 `torch.matmul`s (`library_us`, TF32 off), how far its counts are
from K2's, and whether they lie in the band. Each kernel's wrapper is called once per
shape (counted); the timed launches go through the C entry points and are
not counted.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from fastposecnn_tpu_torch.device import full_float32, resolve_device
from fastposecnn_tpu_torch.kernels import count_launch
from fastposecnn_tpu_torch.kernels.build import check, load_library
from fastposecnn_tpu_torch.ops.voting import thresh_sq, vote_counts, vote_counts_reference
from fastposecnn_tpu_torch.utils.timer import (
    FP32_UNFUSED_OPS_PER_S,
    HBM_BYTES_PER_S,
    TF32_TENSOR_OPS_PER_S,
    device_us_by_kernel,
    loop_ms,
    median_ms,
)

INLIER_THRESH = 0.999
SHAPES = ((16, 4096, 1024), (64, 1000, 1024))
# The band's constant c (see `expanded_vote_band`) for float32 evaluation of
# the expanded form, in any order (P2, the plain P1, JAX's variants), and for
# P1's 3xTF32 tensor-core products.
BAND_C_FP32 = 8
BAND_C_3XTF32 = 32
_P_CHUNK = 512
_BAND_CHUNK = 64

# Operations a valid (m, h, p) cell needs, counted from each kernel's source:
# K2 11 FP32 (2 sub, 6 mul, 3 add); P2 11 FP32 (6 mul, 3 add, 2 sub:
# `kernel_c`'s 2*(hx*px + hy*py) is hx*(2px) + hy*(2py), bitwise the same);
# P1 3 passes x (3 + 5) multiply-adds on the tensor cores (the K = 3 dot
# product and the K = 5 vsq, 48 operations; the kernel issues 64, two k8
# steps of a (dot, vsq) column pair, which the bound does not count) and 1
# FP32 multiply in the test (t2 is folded into the products). Compares and
# the count's add are not counted.
K2_FP32_OPS_PER_CELL = 11
P2_FP32_OPS_PER_CELL = 11
P1_TENSOR_OPS_PER_CELL = 3 * (3 + 5) * 2
P1_FP32_OPS_PER_CELL = 1


def make_inputs(m: int = 16, h: int = 4096, p: int = 1024, seed: int = 0):
    """The TPU script's inputs (`scripts/probe_vote_variants.py::make_inputs`,
    the same generator calls in the same order): M slots of P points around
    a centre, unit directions at it with noise, H hypotheses near it, 90% of
    the points valid. Returns float32 numpy (hyps [M,H,2], pts [M,P,2],
    dirs [M,P,2], pv [M,P])."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(100, 500, size=(m, 1, 2))
    pts = centers + rng.normal(size=(m, p, 2)) * 40
    d = centers - pts
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    noise = rng.normal(size=d.shape) * 0.02
    d = d + noise
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    hyps = centers + rng.normal(size=(m, h, 2)) * 5
    pv = (rng.uniform(size=(m, p)) < 0.9).astype(np.float32)
    return (hyps.astype(np.float32), pts.astype(np.float32),
            d.astype(np.float32), pv)


# The kernels' edge cases (M, H, P): the script's shape, K2's evaluated
# shape, one hypothesis and one point, ragged under a tile, past a tile in
# both dimensions and past P1's 1536-point chunk, H one past a 64-row tile,
# M = 1, a slot whose pv is all 0, and valid-point counts that are no
# multiple of a tile (`edge_inputs`).
EDGE_CASES = {"script": (16, 4096, 1024), "eval": (64, 1000, 1024),
              "one_by_one": (3, 1, 1), "ragged_under_tile": (2, 33, 31),
              "past_tile": (9, 1921, 2100), "h_65": (4, 65, 130), "m_1": (1, 4096, 1024),
              "zero_pv_slot": (4, 256, 1024), "ragged_valid": (3, 200, 1024)}


def edge_inputs(name: str, seed: int = 0):
    """`make_inputs` at `EDGE_CASES[name]`; in "zero_pv_slot" slot 1 has no
    valid point, in "ragged_valid" the slots have 37, 33 and 342 (every
    third) valid points."""
    hyps, pts, dirs, pv = make_inputs(*EDGE_CASES[name], seed=seed)
    if name == "zero_pv_slot":
        pv[1] = 0
    elif name == "ragged_valid":
        pv[:] = 0
        pv[0, :37] = 1
        pv[1, 5:38] = 1
        pv[2, ::3] = 1
    return hyps, pts, dirs, pv


def _count(dot, vsq, pv, t2):
    inlier = (dot > 0) & (dot * dot > t2 * vsq)
    return torch.where(inlier, pv, 0.0).sum(-1)


# -----------------------------------------------------------------------------
# Plain versions


def expanded_operands(hyps, pts, dirs):
    """The stacked operands of `kernel_b`: (hd [M,H,3], pd [M,3,P],
    hmat [M,H,5], pmat [M,5,P]); dot = hd @ pd, |v|^2 = hmat @ pmat."""
    hx, hy = hyps[..., 0], hyps[..., 1]
    ones = torch.ones_like(hx)
    px, py = pts[..., 0], pts[..., 1]
    dx, dy = dirs[..., 0], dirs[..., 1]
    ones_p = torch.ones_like(px)
    return (torch.stack([hx, hy, ones], dim=-1),
            torch.stack([dx, dy, -(px * dx + py * dy)], dim=-2),
            torch.stack([hx * hx, hy * hy, hx, hy, ones], dim=-1),
            torch.stack([ones_p, ones_p, -2 * px, -2 * py, px * px + py * py], dim=-2))


def vote_counts_expanded_mm_reference(hyps, pts, dirs, pvalid,
                                      inlier_thresh: float = INLIER_THRESH):
    """Plain version of P1: the stacked operands of `kernel_b` and two
    float32 `torch.matmul`s, chunked over P. hyps [M,H,2], pts/dirs [M,P,2],
    pvalid [M,P] -> counts [M,H]."""
    t2 = torch.tensor(thresh_sq(inlier_thresh), device=hyps.device)
    acc = torch.zeros(hyps.shape[:2], dtype=torch.float32, device=hyps.device)
    for s in range(0, pts.shape[1], _P_CHUNK):
        c = slice(s, s + _P_CHUNK)
        hd, pd, hmat, pmat = expanded_operands(hyps, pts[:, c], dirs[:, c])
        acc = acc + _count(torch.matmul(hd, pd), torch.matmul(hmat, pmat),
                           pvalid[:, None, c], t2)
    return acc


def vote_counts_expanded_bcast_reference(hyps, pts, dirs, pvalid,
                                         inlier_thresh: float = INLIER_THRESH):
    """Plain version of P2, in `kernel_c`'s order of operations:
    dot = (hx*dx + hy*dy) - cc, vsq = (hsq - 2*(hx*px + hy*py)) + qq, with
    cc = px*dx + py*dy, qq = px*px + py*py, hsq = hx*hx + hy*hy, chunked over P."""
    t2 = torch.tensor(thresh_sq(inlier_thresh), device=hyps.device)
    hx, hy = hyps[..., 0, None], hyps[..., 1, None]
    hsq = hx * hx + hy * hy
    px, py = pts[..., 0], pts[..., 1]
    dx, dy = dirs[..., 0], dirs[..., 1]
    cc = px * dx + py * dy
    qq = px * px + py * py
    acc = torch.zeros(hyps.shape[:2], dtype=torch.float32, device=hyps.device)
    for s in range(0, pts.shape[1], _P_CHUNK):
        c = slice(s, s + _P_CHUNK)
        dot = (hx * dx[:, None, c] + hy * dy[:, None, c]) - cc[:, None, c]
        vsq = (hsq - 2.0 * (hx * px[:, None, c] + hy * py[:, None, c])) + qq[:, None, c]
        acc = acc + _count(dot, vsq, pvalid[:, None, c], t2)
    return acc


def expanded_vote_band(hyps, pts, dirs, pvalid, inlier_thresh: float = INLIER_THRESH,
                       c: float = BAND_C_FP32) -> Tuple[torch.Tensor, torch.Tensor]:
    """The counts any rounding of the expanded form within its error bound can
    give: (lower, upper), float64 [M, H]. A point counts in `lower` if it is
    an inlier for every dot and vsq within the bound, in `upper` if for some.

    In float64, from the float32 inputs, dot = (h - p) . d and vsq = |h - p|^2
    are computed to about 2^-50 of their terms (the true values: the expanded
    and the direct form are equal in exact arithmetic). A float32 evaluation
    of the expanded form is within e_dot = c u S_dot of dot and e_vsq = c u
    S_vsq of vsq, u = 2^-24, where S sums the magnitudes of the expanded terms:
    S_dot = |hx dx| + |hy dy| + |px dx| + |py dy|,
    S_vsq = hx^2 + hy^2 + 2|hx px| + 2|hy py| + px^2 + py^2.
    The test's own products dot*dot and t2*vsq add a relative u each.

    Why c = 8 for float32 (`BAND_C_FP32`): a sum of k rounded terms is within
    gamma_k ~ k u of the sum of magnitudes, in any order and with or without
    fused multiply-adds. P2 rounds each vsq term at most 4 times (square, add,
    subtract, add) and each dot term at most 3 times. The plain P1 forms
    px^2 + py^2 and px dx + py dy (2 roundings) and then sums K = 5 or 3
    products (at most 5 more): at most 7 for vsq, 5 for dot. So c = 8 holds
    for every float32 order, on the CPU, the card or XLA. K2's direct form
    is within about 4 u (|ax dx| + |ay dy|) and 4 u vsq of the same values,
    and both are at most the expanded S, so its counts lie in the band too.

    Why c = 32 for 3xTF32 (`BAND_C_3XTF32`, P1's kernel,
    `kernels/vote_expanded_mma.cu`). The kernel computes dot = [hx, hy, 1] .
    [dx, dy, -cc] and t2 * vsq = [hx, hy, 1, hsq] . [t2 (-2px), t2 (-2py),
    t2 qq, t2], and tests dot > 0 and dot*dot > (t2 * vsq). Operands are
    formed in float32: -cc in 2 roundings, t2 qq in 3, hsq in 2, t2 (-2px)
    in 1, so within 2 u of dot's terms and 3 u of t2 vsq's. Splitting x into
    big = tf32(x) (11 bits, |x - big| <= 2^-11 |x|) and small = tf32(x - big)
    leaves |x - big - small| <= 2^-22 |x| = 4 u |x| (t2 is split too); the
    product big*big + big*small + small*big then misses a b by at most
    (4 + 4 + 4) u |a b| (the two split errors and the dropped small*small):
    12 u. The tensor core multiplies TF32 exactly and adds in float32 with
    truncation (alignment to the largest term and round toward zero, as
    measured on earlier NVIDIA tensor cores by Fasi et al., 2021): at most
    2 u of the largest term for each of its addends and 2 u more to
    normalise. The kernel sums the small products first (one k8 step; their
    sum is below 2^-10 S, so its error is below 0.02 u S), then the big ones
    with the small sum as C, all four within one half of the second k8 step,
    so a tensor core that adds a k8 step in two halves rounds them together
    too: for t2 vsq (4 products + C) 2 u (5 + 1) = 12 u, for dot (3 + C)
    10 u. In all, 3 + 12 + 12 = 27 u t2 S_vsq for t2 vsq, which lies inside
    t2 (vsq -+ e_vsq) and needs no rounding of its own, and 2 + 12 + 10 = 24
    u S_dot for dot: below 32.
    """
    u = 2.0 ** -24
    t2 = thresh_sq(inlier_thresh)
    hx = hyps[..., 0, None].double()
    hy = hyps[..., 1, None].double()
    lower = torch.zeros(hyps.shape[:2], dtype=torch.float64, device=hyps.device)
    upper = torch.zeros_like(lower)
    for s in range(0, pts.shape[1], _BAND_CHUNK):
        ch = slice(s, s + _BAND_CHUNK)
        px, py = pts[:, None, ch, 0].double(), pts[:, None, ch, 1].double()
        dx, dy = dirs[:, None, ch, 0].double(), dirs[:, None, ch, 1].double()
        pv = pvalid[:, None, ch].double()
        ax, ay = hx - px, hy - py
        dot = ax * dx + ay * dy
        vsq = ax * ax + ay * ay
        e_dot = c * u * ((hx * dx).abs() + (hy * dy).abs()
                         + (px * dx).abs() + (py * dy).abs())
        e_vsq = c * u * (hx * hx + hy * hy + 2 * (hx * px).abs()
                         + 2 * (hy * py).abs() + px * px + py * py)
        d_lo, d_hi = dot - e_dot, dot + e_dot
        rhs_hi = t2 * (vsq + e_vsq)
        rhs_hi = rhs_hi + rhs_hi.abs() * u
        rhs_lo = t2 * (vsq - e_vsq)
        rhs_lo = rhs_lo - rhs_lo.abs() * u
        surely = (d_lo > 0) & (d_lo * d_lo * (1 - u) > rhs_hi)
        maybe = (d_hi > 0) & (d_hi * d_hi * (1 + u) > rhs_lo)
        lower += torch.where(surely, pv, 0.0).sum(-1)
        upper += torch.where(maybe, pv, 0.0).sum(-1)
    return lower, upper


# -----------------------------------------------------------------------------
# Kernels P1 and P2


def _check_inputs(what: str, hyps, pts, dirs, pvalid) -> Tuple[int, int, int]:
    m, h = hyps.shape[:2]
    p = pts.shape[1]
    tensors = {"hyps": (hyps, (m, h, 2)), "pts": (pts, (m, p, 2)),
               "dirs": (dirs, (m, p, 2)), "pvalid": (pvalid, (m, p))}
    for name, (t, shape) in tensors.items():
        if (not t.is_cuda or t.device != hyps.device or t.dtype != torch.float32
                or tuple(t.shape) != shape):
            raise ValueError(f"{what}: {name} must be a float32 tensor of shape "
                             f"{shape} on {hyps.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 8:
            raise ValueError(f"{what}: {name} must be contiguous and 8-byte aligned")
    return m, h, p


# Each kernel's C entry point (`kernels/build.py` sets their argument types).
ENTRY_POINTS = {"vote_count": "fpcnn_vote_count",
                "vote_expanded_mm": "fpcnn_vote_expanded_mma",
                "vote_expanded_bcast": "fpcnn_vote_expanded_bcast"}


def _c_call(kernel: str, hyps, pts, dirs, pvalid, out,
            inlier_thresh: float = INLIER_THRESH):
    """A launch of `kernel` through its C entry point on the current stream,
    as a closure that raises on a CUDA error; it counts no launch (the
    probe times these)."""
    m, h = hyps.shape[:2]
    p = pts.shape[1]
    ptrs = [hyps.data_ptr(), pts.data_ptr(), dirs.data_ptr(), pvalid.data_ptr()]
    if kernel == "vote_count":
        ptrs.append(None)  # no `active` flags: every slot counts
    fn = getattr(load_library(), ENTRY_POINTS[kernel])
    args = (*ptrs, out.data_ptr(), m, h, p, thresh_sq(inlier_thresh),
            torch.cuda.current_stream().cuda_stream)
    return lambda: check(fn(*args), kernel)


def _launch(kernel: str, hyps, pts, dirs, pvalid, inlier_thresh):
    m, h, _ = _check_inputs(kernel, hyps, pts, dirs, pvalid)
    out = torch.empty((m, h), dtype=torch.float32, device=hyps.device)
    with torch.cuda.device(hyps.device):
        _c_call(kernel, hyps, pts, dirs, pvalid, out, inlier_thresh)()
    count_launch(kernel)
    return out


def vote_counts_expanded_mm_cuda(hyps, pts, dirs, pvalid,
                                 inlier_thresh: float = INLIER_THRESH):
    """Kernel P1 (`kernels/vote_expanded_mma.cu`) on CUDA tensors; pvalid 0 or 1."""
    return _launch("vote_expanded_mm", hyps, pts, dirs, pvalid, inlier_thresh)


def vote_counts_expanded_bcast_cuda(hyps, pts, dirs, pvalid,
                                    inlier_thresh: float = INLIER_THRESH):
    """Kernel P2 (`kernels/vote_expanded_bcast.cu`) on CUDA tensors; pvalid 0 or 1."""
    return _launch("vote_expanded_bcast", hyps, pts, dirs, pvalid, inlier_thresh)


def _dispatch(cuda_fn, reference_fn, hyps, *args):
    if hyps.is_cuda:
        return cuda_fn(hyps, *args)
    if hyps.device.type == "cpu":
        return reference_fn(hyps, *args)
    raise ValueError(f"unsupported device {hyps.device}")


def vote_counts_expanded_mm(hyps, pts, dirs, pvalid, inlier_thresh: float = INLIER_THRESH):
    """P1's counts [M, H]: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    return _dispatch(vote_counts_expanded_mm_cuda, vote_counts_expanded_mm_reference,
                     hyps, pts, dirs, pvalid, inlier_thresh)


def vote_counts_expanded_bcast(hyps, pts, dirs, pvalid,
                               inlier_thresh: float = INLIER_THRESH):
    """P2's counts [M, H]: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    return _dispatch(vote_counts_expanded_bcast_cuda,
                     vote_counts_expanded_bcast_reference,
                     hyps, pts, dirs, pvalid, inlier_thresh)


# -----------------------------------------------------------------------------
# The probe


def bound_us(kernel: str, pvalid, h: int, tensors: Sequence[torch.Tensor],
             out_bytes: int) -> Tuple[float, str]:
    """The least time of `kernel` on these inputs, in µs: the operations of
    the cells of valid points (a point with pv = 0 adds nothing), or the
    bytes of the inputs read once and the output written once, whichever is
    larger."""
    cells = int((pvalid != 0).sum()) * h
    if kernel == "vote_expanded_mm":
        op_s = max(cells * P1_TENSOR_OPS_PER_CELL / TF32_TENSOR_OPS_PER_S,
                   cells * P1_FP32_OPS_PER_CELL / FP32_UNFUSED_OPS_PER_S)
    else:
        per_cell = {"vote_count": K2_FP32_OPS_PER_CELL,
                    "vote_expanded_bcast": P2_FP32_OPS_PER_CELL}[kernel]
        op_s = cells * per_cell / FP32_UNFUSED_OPS_PER_S
    byte_s = (sum(t.numel() * t.element_size() for t in tensors)
              + out_bytes) / HBM_BYTES_PER_S
    return max(op_s, byte_s) * 1e6, "operations" if op_s >= byte_s else "bytes"


KERNEL_FUNCS = {
    # name: (dispatching function, plain version, band constant)
    "vote_count": (lambda *a: vote_counts(*a, INLIER_THRESH),
                   lambda *a: vote_counts_reference(*a, INLIER_THRESH), BAND_C_FP32),
    "vote_expanded_mm": (vote_counts_expanded_mm, vote_counts_expanded_mm_reference,
                         BAND_C_3XTF32),
    "vote_expanded_bcast": (vote_counts_expanded_bcast,
                            vote_counts_expanded_bcast_reference, BAND_C_FP32),
}


def probe_shape(m: int, h: int, p: int, device: torch.device) -> List[Dict]:
    """K2, P1 and P2 on `make_inputs(m, h, p)`: one dict per kernel."""
    hyps, pts, dirs, pv = (torch.from_numpy(a).to(device)
                           for a in make_inputs(m, h, p))
    args = (hyps, pts, dirs, pv)
    counts = {k: fn(*args) for k, (fn, _, _) in KERNEL_FUNCS.items()}
    bands = {c: expanded_vote_band(*args, INLIER_THRESH, c)
             for c in {c for _, _, c in KERNEL_FUNCS.values()}}
    on_card = device.type == "cuda"
    lines = []
    for name, (_, plain, c) in KERNEL_FUNCS.items():
        got = counts[name]
        diff = (got - counts["vote_count"]).abs()
        lo, hi = bands[c]
        line = dict(probe="vote_variants", kernel=name, shape=[m, h, p],
                    valid_points=int((pv != 0).sum()),
                    max_count_diff_vs_vote_count=float(diff.max()),
                    cells_differing_vs_vote_count=int((diff != 0).sum()),
                    in_band=bool(((lo <= got) & (got <= hi)).all()), band_c=c,
                    band_width_max=float((hi - lo).max()),
                    band_width_mean=float((hi - lo).mean()))
        if on_card:
            out = torch.empty((m, h), dtype=torch.float32, device=device)
            call = _c_call(name, *args, out)
            b_us, by = bound_us(name, pv, h, args, out.numel() * out.element_size())
            by_kernel = device_us_by_kernel(call)
            line.update(us=loop_ms(call) * 1e3,
                        device_us=sum(by_kernel.values()) if by_kernel else None,
                        plain_us=median_ms(lambda: plain(*args), iters=5, warmup=1) * 1e3,
                        bound_us=b_us, bound_by=by, library_us=None)
            if name == "vote_expanded_mm":  # its matrix part as float32 torch.matmul
                hd, pd, hmat, pmat = expanded_operands(*args[:3])
                line["library_us"] = median_ms(
                    lambda: (torch.matmul(hd, pd), torch.matmul(hmat, pmat)),
                    iters=5, warmup=1) * 1e3
                del hd, pd, hmat, pmat
        else:
            line.update(us=None, device_us=None, plain_us=None, bound_us=None,
                        bound_by=None, library_us=None)
        lines.append(line)
    return lines


def main(argv=None) -> List[Dict]:
    """Probe every shape of `SHAPES`; print and return one dict per kernel
    and shape. Times are taken on CUDA only (null on the CPU)."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default=None, help="'cuda' (the default) or 'cpu'")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    lines = []
    with torch.inference_mode(), full_float32():
        for m, h, p in SHAPES:
            for line in probe_shape(m, h, p, device):
                line["device"] = (torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else "cpu")
                print(json.dumps(line), flush=True)
                lines.append(line)
    return lines


if __name__ == "__main__":
    main()
