"""The port of the vote-variant probe (`fastposecnn_tpu_torch/probes/vote_variants.py`)
against the TPU script it ports (`scripts/probe_vote_variants.py`), on the CPU.

The script's Pallas kernels `kernel_b` (P1, two small matrix products) and
`kernel_c` (P2, broadcasts) are nested in its `main`: they are taken out of
its source with `ast` and run in Pallas interpret mode, the script itself
unchanged. The expanded form they compute cancels, so neither framework is
bit-equal to the other: the parity check is the rounding band of
`expanded_vote_band` (c = 8 for float32, derived in its docstring), and the
band is checked to be sound (it holds the exact float64 counts and K2's)
and narrower than the trivial [0, sum pv].
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


@pytest.mark.parametrize("m,h,p", [(8, 128, 512), (2, 33, 31), (3, 1, 1)])
def test_bcast_reference_is_the_kernels_order(m, h, p):
    """P2's plain version equals, bit for bit, numpy float32 in the order
    the CUDA kernel computes each cell (which the card holds exactly equal)."""
    hyps, pts, dirs, pv = V.make_inputs(m, h, p, seed=m)
    hx, hy = hyps[..., 0, None], hyps[..., 1, None]
    px, py = pts[:, None, :, 0], pts[:, None, :, 1]
    dx, dy = dirs[:, None, :, 0], dirs[:, None, :, 1]
    cc = px * dx + py * dy
    qq = px * px + py * py
    hsq = hx * hx + hy * hy
    dot = (hx * dx + hy * dy) - cc
    vsq = (hsq - np.float32(2.0) * (hx * px + hy * py)) + qq
    t2 = np.float32(V.thresh_sq(0.999))
    want = np.where((dot > 0) & (dot * dot > t2 * vsq), pv[:, None, :],
                    np.float32(0)).sum(-1, dtype=np.float32)
    got = V.vote_counts_expanded_bcast_reference(
        *(torch.from_numpy(a) for a in (hyps, pts, dirs, pv)))
    np.testing.assert_array_equal(got.numpy(), want)


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
