"""Port parity: the NCHW network of `fastposecnn_tpu_torch`, with weights
carried over from the JAX package by `from_jax_params`, against
`PoseRegressorNet.apply` on the same seeded input (CPU, float32)."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastposecnn_tpu.models import PoseRegressorNet as JaxNet
from fastposecnn_tpu_torch.models import PoseRegressorNet
from fastposecnn_tpu_torch.models.weights import (
    from_jax_params,
    init_random_,
    load_npz_checkpoint,
)

# The repo's golden tolerance (tests/test_weights.py:137).
ATOL, RTOL = 2e-4, 1e-4
CKPT = pathlib.Path(__file__).resolve().parents[1] / "evidence/rot_demo/ckpt_FULL_c5.npz"
KEYS = ("mask", "quaternion", "xy", "z", "scales")


def _unflatten(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value, jnp.float32)
    return tree


def _compare(variables, classes, x_nchw):
    want = JaxNet(num_classes=classes).apply(
        variables, jnp.asarray(x_nchw.transpose(0, 2, 3, 1), jnp.float32), train=False)
    net = PoseRegressorNet(classes)
    net.load_state_dict(from_jax_params(jax.tree.map(np.asarray, variables)))
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x_nchw))
    for key in KEYS:
        np.testing.assert_allclose(
            got[key].numpy(), np.asarray(want[key]).transpose(0, 3, 1, 2),
            atol=ATOL, rtol=RTOL, err_msg=f"logit mismatch in '{key}'")


def test_random_jax_params_match():
    rng = np.random.default_rng(0)
    classes = 3
    x = rng.normal(size=(1, 3, 64, 64)).astype(np.float32)
    variables = JaxNet(num_classes=classes).init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    # Non-trivial BatchNorm running statistics so eval-mode BN is tested.
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    stats = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.uniform(0.5, 1.5, v.shape) if path[-1].key == "var"
                         else rng.normal(0, 0.5, v.shape)).astype(np.float32), stats)
    _compare({"params": variables["params"], "batch_stats": stats}, classes, x)


def test_npz_checkpoint_matches():
    flat, hp = load_npz_checkpoint(CKPT)
    assert len(flat) == 224 and hp["SELECTED_CLASSES"][0] == "bg"  # + hparams
    x = np.random.default_rng(1).normal(size=(1, 3, 64, 96)).astype(np.float32)
    _compare(_unflatten(flat), len(hp["SELECTED_CLASSES"]), x)


def test_from_jax_params_layout():
    flat, _ = load_npz_checkpoint(CKPT)
    sd = from_jax_params(flat)
    k = flat["params/encoder/conv1/kernel"].astype(np.float32)
    # The JAX stem's 4th input channel meets an always-zero alpha input, so
    # its (trained, nonzero) weights never contribute and are dropped.
    assert k.shape == (7, 7, 4, 64)
    np.testing.assert_array_equal(sd["encoder.conv1.weight"].numpy(),
                                  k[:, :, :3].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["segmentation_head.0.bias"].numpy(),
        flat["params/mask_head/conv/bias"].astype(np.float32))
    # Nested and flat forms convert alike.
    nested = from_jax_params(jax.tree.map(np.asarray, _unflatten(flat)))
    assert nested.keys() == sd.keys()
    assert all(torch.equal(nested[k_], sd[k_]) for k_ in sd)
    with pytest.raises(KeyError):
        from_jax_params({"params/encoder/nope/kernel": np.zeros((1, 1, 1, 1))})


def test_seeded_random_weights():
    a = init_random_(PoseRegressorNet(3), seed=4).state_dict()
    b = init_random_(PoseRegressorNet(3), seed=4).state_dict()
    c = init_random_(PoseRegressorNet(3), seed=5).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.conv1.weight"], c["encoder.conv1.weight"])
    with pytest.raises(ValueError):
        PoseRegressorNet(3)(torch.zeros(1, 3, 48, 64))


@pytest.mark.parametrize("shape,scale", [((2, 3, 5, 7), 2), ((1, 4, 16, 12), 4), ((2, 2, 1, 3), 2)])
def test_upsample_bilinear_float32_backward(shape, scale):
    """A float32 map's bilinear upsample: `F.interpolate` forward (bit for
    bit, with or without a gradient), the backward the adjoint of JAX's
    interpolation matrices (gradcheck in float64, its fast mode: one
    random projection; JAX's own vjp of its upsample in float32, to
    float32 rounding)."""
    from fastposecnn_tpu.models import fpn as jfpn
    from fastposecnn_tpu_torch.models import fpn

    rng = np.random.default_rng(sum(shape) + scale)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(*shape[:2], shape[2] * scale, shape[3] * scale))
                         .astype(np.float32))
    plain = torch.nn.functional.interpolate(x, scale_factor=scale, mode="bilinear",
                                            align_corners=True)
    xg = x.clone().requires_grad_(True)
    y = fpn.upsample_bilinear(xg, scale)
    assert torch.equal(y.detach(), plain) and torch.equal(fpn.upsample_bilinear(x, scale), plain)
    (got,) = torch.autograd.grad(y, xg, g)
    _, vjp = jax.vjp(lambda a: jfpn.upsample_bilinear(a, scale),
                     jnp.asarray(x.numpy().transpose(0, 2, 3, 1)))
    want = np.asarray(vjp(jnp.asarray(g.numpy().transpose(0, 2, 3, 1)))[0]).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))
    x64 = x.double().requires_grad_(True)
    assert torch.autograd.gradcheck(lambda t: fpn.upsample_bilinear(t, scale), (x64,),
                                    fast_mode=True)
