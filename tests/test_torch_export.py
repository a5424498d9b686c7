"""The port's export (`utils/export.py`, `torch.export` to a `.pt2`) and its
custom ops against the JAX package's export (`jax.export` to StableHLO):
counterparts of `tests/test_export.py`'s two tests, on the CPU.

- The loaded network equals eager at atol 1e-5.
- The loaded pipeline at the JAX test's config (32x32, 3 classes, 4 slots,
  64 points, 16 hypotheses, adaptive: the vote loop is one `while_loop` in
  the program) equals eager at the golden tolerance (atol 2e-4, rtol 1e-4)
  and is held against JAX's exported program on the same weights and the
  draws JAX makes from `key(0)`: the mask and class ids exactly, xy, z and
  RT at the golden tolerance.
- A fresh process loads the program: `load_exported` registers the ops.
- `torch.library.opcheck` on both custom ops' CPU implementations and fake
  registrations.
"""

import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_adaptive import jax_adaptive_draws
from torch_cleanup import tmp_path  # noqa: F401

from fastposecnn_tpu.models import PoseRegressorNet as JaxNet
from fastposecnn_tpu.pipeline import PipelineConfig as JaxPipelineConfig
from fastposecnn_tpu.utils.export import export_forward as jax_export
from fastposecnn_tpu.utils.export import load_exported as jax_load
from fastposecnn_tpu_torch.device import full_float32
from fastposecnn_tpu_torch.models import PoseRegressorNet
from fastposecnn_tpu_torch.models.weights import from_jax_params
from fastposecnn_tpu_torch.ops import connected_components as tcc
from fastposecnn_tpu_torch.ops import voting as tv
from fastposecnn_tpu_torch.pipeline import PipelineConfig, run_pipeline
from fastposecnn_tpu_torch.utils.export import export_forward, load_exported, make_draws

ATOL, RTOL = 2e-4, 1e-4
REPO = pathlib.Path(__file__).resolve().parents[1]
INV_K = np.linalg.inv(np.asarray([[60.0, 0, 16], [0, 60, 16], [0, 0, 1]]))


def nets(x):
    """The JAX network's `init(key(0))` variables and the port's network
    holding them (eval mode)."""
    jnet = JaxNet(num_classes=3)
    v = jnet.init(jax.random.key(0), jnp.asarray(x))
    net = PoseRegressorNet(num_classes=3)
    net.load_state_dict(from_jax_params(jax.tree.map(np.asarray, v)))
    return jnet, v, net.eval()


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_network_roundtrip(tmp_path):
    x = np.random.default_rng(0).normal(size=(1, 32, 32, 3)).astype(np.float32)
    _, _, net = nets(x)
    path = export_forward(net, tmp_path / "m.pt2", image_shape=(1, 3, 32, 32))
    fn = load_exported(path)
    assert fn.meta == {"kind": "network", "image_shape": [1, 3, 32, 32], "device": "cpu"}
    out = fn(nchw(x))
    with torch.no_grad(), full_float32():
        ref = net(nchw(x))
    assert sorted(out) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), ref[k].numpy(), atol=1e-5, err_msg=k)


def test_full_pipeline_export(tmp_path):
    """Adaptive, as the JAX test's config; JAX's program runs its plain
    versions (use_pallas=False), the port's its ops' CPU implementations."""
    x = np.random.default_rng(0).normal(size=(1, 32, 32, 3)).astype(np.float32)
    jnet, v, net = nets(x)
    jcfg = JaxPipelineConfig(max_instances=4, max_points=64, hv_num_hypotheses=16,
                             use_pallas=False)
    pcfg = PipelineConfig(max_instances=4, max_points=64, hv_num_hypotheses=16)
    assert pcfg.hv_adaptive and jcfg.hv_adaptive
    jpath = jax_export(jnet, v, tmp_path / "full.jaxexport", image_shape=(1, 32, 32, 3),
                       pipeline_config=jcfg, inv_intrinsics=INV_K)
    want = [np.asarray(t) for t in jax_load(jpath)(v, jnp.asarray(x))]

    draws = jax_adaptive_draws(jax.random.key(0), 1, 4, 64, 16, pcfg.hv_max_iter, "bbox")
    path = export_forward(net, tmp_path / "full.pt2", image_shape=(1, 3, 32, 32),
                          pipeline_config=pcfg, inv_intrinsics=INV_K, draws=draws)
    fn = load_exported(path)
    got = [t.numpy() for t in fn(nchw(x))]
    with torch.no_grad(), full_float32():
        out = run_pipeline(net(nchw(x)), pcfg, torch.tensor(INV_K, dtype=torch.float32),
                           draws=draws)
    agg = out["aggregated"]
    eager = [t.numpy() for t in (out["categorical"]["mask"], agg["class_ids"], agg["xy"],
                                 agg["z"], agg["RT"])]
    assert [g.shape for g in got] == [(1, 32, 32), (1, 4), (1, 4, 2), (1, 4), (1, 4, 4, 4)]
    assert (got[1] > 0).sum() >= 1  # a valid instance to hold
    for g, e, w, name in zip(got, eager, want, ("mask", "class_ids", "xy", "z", "RT")):
        if name in ("mask", "class_ids"):
            np.testing.assert_array_equal(g, e, err_msg=name)
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, e, atol=ATOL, rtol=RTOL, err_msg=name)
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg=name)

    # The single shot, with draws from a seed; a refused configuration.
    single = dataclasses.replace(pcfg, hv_adaptive=False)
    draws = make_draws(single, 1, 3, "cpu")
    assert draws.pairs is None and len(draws.shifts) == 1
    fn = load_exported(export_forward(net, tmp_path / "single.pt2", image_shape=(1, 3, 32, 32),
                                      pipeline_config=single, inv_intrinsics=INV_K, seed=3))
    with torch.no_grad(), full_float32():
        out = run_pipeline(net(nchw(x)), single, torch.tensor(INV_K, dtype=torch.float32),
                           draws=draws)
    for g, w in zip(fn(nchw(x)), (out["categorical"]["mask"], out["aggregated"]["class_ids"],
                                  out["aggregated"]["xy"], out["aggregated"]["z"],
                                  out["aggregated"]["RT"])):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError, match="pairs"):
        export_forward(net, tmp_path / "x.pt2", image_shape=(1, 3, 32, 32), pipeline_config=pcfg,
                       inv_intrinsics=INV_K, draws=make_draws(single, 1, 0, "cpu"))


_FRESH = """
import sys, torch
from fastposecnn_tpu_torch.utils.export import load_exported
assert not any(m.startswith("fastposecnn_tpu_torch.ops") for m in sys.modules)
fn = load_exported(sys.argv[1])
mask, cls, xy, z, RT = fn(torch.zeros(1, 3, 32, 32))
assert "fastposecnn_tpu_torch.ops.voting" in sys.modules
print("ok", tuple(mask.shape), tuple(RT.shape))
"""


def test_fresh_process_loads_the_pipeline(tmp_path):
    """A process that imported none of the port's ops loads the program:
    `load_exported` registers them before it deserializes."""
    x = np.zeros((1, 32, 32, 3), np.float32)
    _, _, net = nets(x)
    path = export_forward(net, tmp_path / "p.pt2", image_shape=(1, 3, 32, 32),
                          pipeline_config=PipelineConfig(max_instances=4, max_points=64,
                                                         hv_num_hypotheses=16),
                          inv_intrinsics=INV_K, seed=1)
    proc = subprocess.run([sys.executable, "-c", _FRESH, str(path)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == ["ok", "(1,", "32,", "32)", "(1,", "4,", "4,", "4)"]


def _vote_args(m, h, p, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    dirs = rng.normal(size=(m, p, 2)).astype(f32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return (torch.from_numpy(rng.uniform(0, 20, (m, h, 2)).astype(f32)),
            torch.from_numpy(rng.uniform(0, 20, (m, p, 2)).astype(f32)),
            torch.from_numpy(dirs),
            torch.from_numpy((rng.random((m, p)) > 0.2).astype(f32)))


@pytest.mark.parametrize("active", [None, "some"])
def test_vote_count_op_opcheck(active):
    args = _vote_args(3, 7, 11, seed=1)
    act = None if active is None else torch.tensor([True, False, True])
    torch.library.opcheck(tv.vote_count, args + (act, 0.999))
    got = torch.ops.fastposecnn.vote_count(*args, act, 0.999)
    assert torch.equal(got, tv.vote_counts_reference(*args, 0.999, act))
    assert torch.equal(tv.vote_counts(*args, 0.999, act), got)


@pytest.mark.parametrize("shape", [(2, 9, 13), (1, 1, 1), (3, 16, 5)])
def test_cc_label_op_opcheck(shape):
    fg = torch.from_numpy(np.random.default_rng(sum(shape)).random(shape) > 0.5)
    torch.library.opcheck(tcc.cc_label, (fg,))
    labels, err = torch.ops.fastposecnn.cc_label(fg)
    assert torch.equal(labels, tcc.label_components_reference(fg))
    assert err.dtype == torch.int32 and tuple(err.shape) == (1,) and int(err) == 0
    assert tcc.label_components_deferred(fg)[1] is None  # the CPU carries no flag
    with pytest.raises(ValueError, match="impl"):
        tcc.label_components_deferred(fg, impl="pallas")
