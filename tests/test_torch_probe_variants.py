"""The port of the vote-variant probe (`fastposecnn_tpu_torch/probes/vote_variants.py`)
against the TPU script it ports (`scripts/probe_vote_variants.py`), on the CPU.

The script's Pallas kernels `kernel_b` (P1, two small matrix products) and
`kernel_c` (P2, broadcasts) are nested in its `main`: they are taken out of
its source with `ast` and run in Pallas interpret mode, the script itself
unchanged. The expanded form they compute cancels, so neither framework is
bit-equal to the other: the parity check is the rounding band of
`expanded_vote_band` (c = 8 for float32, derived in its docstring), and the
band is checked to be sound (it holds the exact float64 counts and K2's)
and narrower than the trivial [0, sum pv]. The CUDA kernels' arithmetic is
emulated in numpy: P2's order bit for bit against its plain version, P1's
folded 3xTF32 layout against float64 and the c = 32 band.
"""

import ast
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from fastposecnn_tpu.ops.voting import _round_up
from fastposecnn_tpu_torch.ops.voting import vote_counts_reference
from fastposecnn_tpu_torch.probes import vote_variants as V

SCRIPT = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "probe_vote_variants.py"
# At most 8 x 256 x 1024: the float64 band holds several [M, H, chunk] arrays.
BAND_SHAPES = [(8, 128, 512), (4, 256, 1024)]


class _InterpretPallas:
    """`pl` with `pallas_call` in interpret mode and without TPU compiler
    parameters."""

    def __getattr__(self, name):
        return getattr(pl, name)

    @staticmethod
    def pallas_call(*args, compiler_params=None, **kwargs):
        return pl.pallas_call(*args, interpret=True, **kwargs)


@functools.lru_cache(maxsize=None)
def _script():
    """The script as a module (its top level imports numpy alone)."""
    spec = importlib.util.spec_from_file_location("probe_vote_variants", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.lru_cache(maxsize=None)
def _script_variants():
    """`variant_b` and `variant_c` (with their kernels) from the script's `main`."""
    tree = ast.parse(SCRIPT.read_text(), str(SCRIPT))
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    wanted = {"kernel_b", "variant_b", "kernel_c", "variant_c"}
    defs = [n for n in main.body if isinstance(n, ast.FunctionDef) and n.name in wanted]
    assert {d.name for d in defs} == wanted
    ns = dict(jax=jax, jnp=jnp, lax=lax, functools=functools, pl=_InterpretPallas(),
              pltpu=pltpu, _round_up=_round_up)
    exec(compile(ast.Module(body=defs, type_ignores=[]), str(SCRIPT), "exec"), ns)
    return ns["variant_b"], ns["variant_c"]


@functools.lru_cache(maxsize=None)
def _case(m, h, p, seed=0):
    """Inputs as numpy and as CPU tensors, the float32 band, and the exact
    float64 direct-form counts."""
    arrays = V.make_inputs(m, h, p, seed)
    tensors = tuple(torch.from_numpy(a) for a in arrays)
    lo, hi = V.expanded_vote_band(*tensors)
    hyps, pts, dirs, pv = (a.astype(np.float64) for a in arrays)
    a = hyps[:, :, None, :] - pts[:, None, :, :]
    dot = (a * dirs[:, None, :, :]).sum(-1)
    vsq = (a * a).sum(-1)
    exact = (((dot > 0) & (dot * dot > V.thresh_sq(0.999) * vsq)) * pv[:, None, :]).sum(-1)
    return arrays, tensors, lo.numpy(), hi.numpy(), exact


def _in_band(counts, lo, hi):
    counts = np.asarray(counts, np.float64)
    return bool(((lo <= counts) & (counts <= hi)).all())


@pytest.mark.parametrize("m,h,p,seed", [(16, 4096, 1024, 0), (8, 128, 512, 3), (3, 1, 1, 1)])
def test_make_inputs_is_the_scripts(m, h, p, seed):
    want = _script().make_inputs(m, h, p, seed)
    got = V.make_inputs(m, h, p, seed)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("which", ["jax_variant_b", "jax_variant_c",
                                   "port_mm_reference", "port_bcast_reference"])
@pytest.mark.parametrize("m,h,p", BAND_SHAPES)
def test_expanded_counts_lie_in_the_band(m, h, p, which):
    arrays, tensors, lo, hi, _ = _case(m, h, p)
    if which.startswith("jax"):
        variant_b, variant_c = _script_variants()
        fn = variant_b if which == "jax_variant_b" else variant_c
        counts = np.asarray(fn(*(jnp.asarray(a) for a in arrays)))
    elif which == "port_mm_reference":
        counts = V.vote_counts_expanded_mm_reference(*tensors).numpy()
    else:
        counts = V.vote_counts_expanded_bcast_reference(*tensors).numpy()
    assert counts.shape == (m, h)
    assert _in_band(counts, lo, hi)


@pytest.mark.parametrize("m,h,p", BAND_SHAPES)
def test_band_is_sound_and_not_vacuous(m, h, p):
    arrays, tensors, lo, hi, exact = _case(m, h, p)
    pv_sum = arrays[3].sum(-1)[:, None]
    assert (lo <= hi).all()
    # The exact counts (float64, where the direct and the expanded form are
    # the same number) and K2's float32 direct form lie in the band.
    assert _in_band(exact, lo, hi)
    assert _in_band(vote_counts_reference(*tensors, 0.999).numpy(), lo, hi)
    # Narrower than [0, sum pv] everywhere, and far narrower on average.
    assert (hi - lo < pv_sum).all()
    assert (hi - lo).mean() < 0.2 * pv_sum.mean()
    # The 3xTF32 band is wider, and contains the float32 one.
    lo32, hi32 = V.expanded_vote_band(*tensors, c=V.BAND_C_3XTF32)
    assert (lo32.numpy() <= lo).all() and (hi <= hi32.numpy()).all()


def _crafted_inputs(m, h, p, seed):
    """Coordinates far from the probe's: magnitudes from 1e-3 to 1e6 of
    either sign, integers (exact products and ties), points on hypotheses
    (dot = vsq = 0), unnormalised directions; pv 0 or 1."""
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(-3, 6, size=(m, 1, 1))
    hyps = (rng.normal(size=(m, h, 2)) * mag).astype(np.float32)
    pts = (rng.normal(size=(m, p, 2)) * mag).astype(np.float32)
    pts[:, ::3] = np.round(pts[:, ::3])
    hyps[:, ::2] = np.round(hyps[:, ::2])
    pts[:, 1, :] = hyps[:, 0, :]
    dirs = rng.normal(size=(m, p, 2)).astype(np.float32)
    pv = (rng.uniform(size=(m, p)) < 0.7).astype(np.float32)
    return hyps, pts, dirs, pv


_ORDER_CASES = [("probe", (8, 128, 512)), ("probe", (2, 33, 31)), ("probe", (3, 1, 1)),
                ("edge", "h_65"), ("edge", "zero_pv_slot"), ("edge", "ragged_valid"),
                ("crafted", (4, 96, 300)), ("crafted", (2, 17, 1000))]


def _order_inputs(kind, what, seed):
    if kind == "probe":
        return V.make_inputs(*what, seed=seed)
    if kind == "edge":
        return V.edge_inputs(what, seed=seed)
    return _crafted_inputs(*what, seed=seed)


@pytest.mark.parametrize("kind,what", _ORDER_CASES)
def test_bcast_reference_is_the_kernels_order(kind, what):
    """P2's plain version equals, bit for bit, numpy float32 in the order
    the CUDA kernel computes each cell (which the card holds exactly equal):
    hx*(2px) + hy*(2py) in place of `kernel_c`'s 2*(hx*px + hy*py), and an
    integer count of the valid points that pass."""
    hyps, pts, dirs, pv = _order_inputs(kind, what, seed=7)
    t2 = np.float32(V.thresh_sq(0.999))
    hx, hy = hyps[..., 0, None], hyps[..., 1, None]
    hsq = hx * hx + hy * hy
    want = np.zeros(hyps.shape[:2], np.int64)
    for s in range(0, pts.shape[1], 128):
        c = slice(s, s + 128)
        px, py = pts[:, None, c, 0], pts[:, None, c, 1]
        dx, dy = dirs[:, None, c, 0], dirs[:, None, c, 1]
        cc = px * dx + py * dy
        qq = px * px + py * py
        px2, py2 = np.float32(2.0) * px, np.float32(2.0) * py
        dot = (hx * dx + hy * dy) - cc
        vsq = (hsq - (hx * px2 + hy * py2)) + qq
        inlier = (dot > 0) & (dot * dot > t2 * vsq) & (pv[:, None, c] != 0)
        want += inlier.sum(-1)
    got = V.vote_counts_expanded_bcast_reference(
        *(torch.from_numpy(a) for a in (hyps, pts, dirs, pv)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


def _tf32(x):
    """Round float32 to TF32 as the kernel does (`cvt.rna.tf32.f32`: nearest,
    ties away from zero; then the 13 low bits cleared)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    big = _tf32(x)
    return big, _tf32(np.float32(x) - big)


def _p1_folded(hyps, pts, dirs, t2, chunk=64):
    """P1's arithmetic as `kernels/vote_expanded_mma.cu` lays it out, in
    numpy: A', A'' and the (dot, t2*vsq) columns of B', B'' split into TF32
    as the kernel splits them, the small products of step 1 summed first,
    then the four big products of step 2 added to that sum, in float32 with
    round to nearest (each TF32 product is exact in float64). Yields (chunk
    slice, dot, t2*vsq) as float32 [M, H, chunk]."""
    f32 = np.float32
    hx, hy = hyps[..., 0, None], hyps[..., 1, None]
    hsq = hx * hx + hy * hy
    (hxb, hxs), (hyb, hys), (hqb, hqs) = _split(hx), _split(hy), _split(hsq)
    t2b, t2s = _split(np.full((1, 1, 1), t2, np.float32))
    one = f32(1.0)
    a1 = [hxs, hxb, hys, hyb, one, hqs, hqb]      # A', step 1 (feature 7 is 0)
    a2 = [hxb, hyb, one, hqb]                     # A'', step 2 (features 4-7 are 0)
    for s in range(0, pts.shape[1], chunk):
        c = slice(s, s + chunk)
        px, py = pts[:, None, c, 0], pts[:, None, c, 1]
        dx, dy = dirs[:, None, c, 0], dirs[:, None, c, 1]
        ncc = -(px * dx + py * dy)
        npx, npy = t2 * (f32(-2.0) * px), t2 * (f32(-2.0) * py)
        tqq = t2 * (px * px + py * py)
        (dxb, dxs), (dyb, dys), (nb, ns) = _split(dx), _split(dy), _split(ncc)
        (pxb, pxs), (pyb, pys), (qb, qs) = _split(npx), _split(npy), _split(tqq)
        zero = np.zeros_like(dxb)
        cols = {"dot": ([dxb, dxs, dyb, dys, ns, zero, zero], [dxb, dyb, nb, zero]),
                "tvsq": ([pxb, pxs, pyb, pys, qs, t2b + zero, t2s + zero],
                         [pxb, pyb, qb, t2b + zero])}
        out = []
        for b1, b2 in cols.values():
            acc = np.zeros(np.broadcast_shapes(hx.shape, dxb.shape), np.float32)
            for a, b in zip(a1 + a2, b1 + b2):
                acc = (acc.astype(np.float64) + np.float64(a) * np.float64(b)).astype(np.float32)
            out.append(acc)
        yield c, out[0], out[1]


_P1_CASES = [("probe", (8, 128, 512)), ("probe", (2, 33, 31)), ("edge", "h_65"),
             ("edge", "ragged_valid"), ("crafted", (4, 96, 300))]


@pytest.mark.parametrize("kind,what", _P1_CASES)
def test_p1_folded_layout_lies_in_the_band(kind, what):
    """P1's folded layout, emulated: its dot and t2*vsq lie within 32 u S of
    the float64 values (the budget `expanded_vote_band` derives for the
    kernel's order: 24 u and 27 u), and its counts, tested as the kernel
    tests (dot > 0 and dot*dot > t2*vsq), lie inside the c = 32 band."""
    hyps, pts, dirs, pv = _order_inputs(kind, what, seed=5)
    u = 2.0 ** -24
    t2 = np.float32(V.thresh_sq(0.999))
    counts = np.zeros(hyps.shape[:2], np.float64)
    h64 = hyps.astype(np.float64)
    hx, hy = h64[..., 0, None], h64[..., 1, None]
    worst = 0.0
    for c, dot, tvsq in _p1_folded(hyps, pts, dirs, t2):
        px, py = pts[:, None, c, 0].astype(np.float64), pts[:, None, c, 1].astype(np.float64)
        dx, dy = dirs[:, None, c, 0].astype(np.float64), dirs[:, None, c, 1].astype(np.float64)
        ax, ay = hx - px, hy - py
        s_dot = np.abs(hx * dx) + np.abs(hy * dy) + np.abs(px * dx) + np.abs(py * dy)
        s_vsq = hx * hx + hy * hy + 2 * np.abs(hx * px) + 2 * np.abs(hy * py) + px * px + py * py
        for err, scale in ((np.abs(dot - (ax * dx + ay * dy)), u * s_dot),
                           (np.abs(tvsq - np.float64(t2) * (ax * ax + ay * ay)),
                            u * np.float64(t2) * s_vsq)):
            # S = 0 only where every term is 0, and then so is the error.
            ratio = np.divide(err, scale, out=np.where(err > 0, np.inf, 0.0), where=scale > 0)
            worst = max(worst, float(ratio.max()))
        inlier = (dot > 0) & (dot * dot > tvsq)
        counts += (inlier * pv[:, None, c]).sum(-1)
    assert worst <= V.BAND_C_3XTF32
    lo, hi = V.expanded_vote_band(*(torch.from_numpy(a) for a in (hyps, pts, dirs, pv)),
                                  c=V.BAND_C_3XTF32)
    assert _in_band(counts, lo.numpy(), hi.numpy())


@pytest.mark.parametrize("case", list(V.EDGE_CASES))
def test_edge_inputs(case):
    """The card's edge cases: the script's inputs at their shape, with the
    stated valid points."""
    m, h, p = V.EDGE_CASES[case]
    hyps, pts, dirs, pv = V.edge_inputs(case, seed=m)
    want = V.make_inputs(m, h, p, seed=m)
    for got, w in zip((hyps, pts, dirs), want):
        np.testing.assert_array_equal(got, w)
    valid = (pv != 0).sum(-1)
    if case == "zero_pv_slot":
        assert valid[1] == 0 and valid.sum() > 0
    elif case == "ragged_valid":
        assert valid.tolist() == [37, 33, 342]
    else:
        np.testing.assert_array_equal(pv, want[3])


@pytest.mark.parametrize("name", ["mm", "bcast"])
def test_wrappers_dispatch_by_device(name):
    """CPU tensors go to the plain version; the CUDA wrapper refuses them
    (and CPU/CUDA mixes) before it loads any library."""
    tensors = [torch.from_numpy(a) for a in V.make_inputs(2, 33, 31, seed=2)]
    dispatch = getattr(V, f"vote_counts_expanded_{name}")
    reference = getattr(V, f"vote_counts_expanded_{name}_reference")
    cuda = getattr(V, f"vote_counts_expanded_{name}_cuda")
    assert torch.equal(dispatch(*tensors), reference(*tensors))
    with pytest.raises(ValueError):
        cuda(*tensors)


def test_probe_main_on_cpu(capsys, monkeypatch):
    monkeypatch.setattr(V, "SHAPES", ((4, 64, 256), (2, 33, 31)))
    lines = V.main(["--device", "cpu"])
    assert [ln["kernel"] for ln in lines] == list(V.KERNEL_FUNCS) * 2
    assert len(capsys.readouterr().out.splitlines()) == 6
    for ln in lines:
        assert ln["in_band"] and ln["us"] is None and ln["device"] == "cpu"
        if ln["kernel"] == "vote_count":
            assert ln["max_count_diff_vs_vote_count"] == 0
