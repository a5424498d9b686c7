"""Port parity for the resnet34 and resnet50 encoders in training mode:
the port's `ResNetEncoder` and `BottleneckBlock` against the JAX modules
from the same weights, on the same seeded input (CPU, float32, 64x64,
batch 2): the features, the BatchNorm running statistics they update, and
the parameter gradients of a seeded linear functional of the features.

Held at the golden tolerance (atol 2e-4, rtol 1e-4), gradients in L2 per
tensor (2e-3 of the JAX norm, as `tests/torch_train_helpers.py` holds the
train step's): the bottleneck blocks, resnet34, and resnet50's stem,
layer1 and layer2 with their statistics. Resnet50's layer3, layer4 and
gradients: see `DEEP_ATOL` below.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastposecnn_tpu.models.resnet import BottleneckBlock as JaxBottleneck
from fastposecnn_tpu.models.resnet import ResNetEncoder as JaxEncoder
from fastposecnn_tpu_torch.models.resnet import BottleneckBlock, ResNetEncoder
from fastposecnn_tpu_torch.models.weights import from_jax_params
from test_torch_encoders import ATOL, ENCODERS, RTOL, random_stats

GRAD_REL = 2e-3


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_sd(params, batch_stats=None, block=False):
    """The JAX subtrees of an encoder (or, `block`, of one encoder block)
    -> its port state_dict."""
    def place(tree):
        return {"encoder": {"layer1_0": tree} if block else tree}

    tree = {"params": place(params)}
    if batch_stats is not None:
        tree["batch_stats"] = place(batch_stats)
    prefix = "encoder.layer1.0." if block else "encoder."
    return {k[len(prefix):]: t for k, t in
            from_jax_params(jax.tree.map(np.asarray, tree)).items()}


def train_mode_pair(jmod, mod, x, seed):
    """One train-mode forward of the JAX module and of the port module from
    the same weights (random BatchNorm running statistics): (JAX outputs
    NCHW, port outputs, JAX updated stats as a port state_dict, JAX
    parameter gradients of a seeded linear functional as a port
    state_dict, the port module after its forward and backward, the
    functional's cotangents)."""
    rng = np.random.default_rng(seed)
    v = jmod.init(jax.random.key(seed), jnp.asarray(x))
    stats = random_stats(v["batch_stats"], rng)
    out, mut = jmod.apply({"params": v["params"], "batch_stats": stats}, jnp.asarray(x),
                          train=True, mutable=["batch_stats"])
    outs = out if isinstance(out, list) else [out]
    cts = [rng.normal(size=o.shape).astype(np.float32) for o in outs]

    def functional(params):
        o, _ = jmod.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                          train=True, mutable=["batch_stats"])
        return sum(jnp.sum(a * c) for a, c in zip(o if isinstance(o, list) else [o], cts))

    jgrads = jax.grad(functional)(v["params"])
    block = not isinstance(mod, ResNetEncoder)
    mod.load_state_dict(port_sd(v["params"], stats, block))
    got = mod.train()(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    got = got if isinstance(got, list) else [got]
    sum((g * torch.from_numpy(c.transpose(0, 3, 1, 2).copy())).sum()
        for g, c in zip(got, cts)).backward()
    want = [np.asarray(o).transpose(0, 3, 1, 2) for o in outs]
    return (want, [g.detach().numpy() for g in got],
            port_sd(v["params"], mut["batch_stats"], block), port_sd(jgrads, None, block), mod,
            cts)


def assert_grads_close(mod, want_grads):
    for n, p in mod.named_parameters():
        want = want_grads[n].numpy().astype(np.float64)
        err = np.linalg.norm(p.grad.numpy().astype(np.float64) - want)
        assert err <= GRAD_REL * np.linalg.norm(want) + 1e-30, (n, err)


def assert_stats_close(mod, want_sd, atol=ATOL, rtol=RTOL, only=None):
    mine = mod.state_dict()
    for k, t in want_sd.items():
        if "running_" in k and (only is None or only(k)):
            np.testing.assert_allclose(mine[k].numpy(), t.numpy(), atol=atol, rtol=rtol,
                                       err_msg=k)


@pytest.mark.parametrize("in_ch,width,stride", [(64, 64, 1), (256, 128, 2), (256, 64, 1)])
def test_bottleneck_block_train_mode_matches_jax(in_ch, width, stride):
    """One bottleneck block in training mode: resnet50's layer1.0 (a
    downsample at stride 1, 64 -> 256 channels), a strided first block
    (the stride on conv2 and on the downsample), and an identity block:
    output, every BatchNorm's updated running statistics (bn3 and the
    downsample's included) and the parameter gradients."""
    x = np.random.default_rng(7).normal(size=(2, 16, 16, in_ch)).astype(np.float32)
    want, got, stats, grads, block, _ = train_mode_pair(
        JaxBottleneck(width, strides=stride), BottleneckBlock(in_ch, width, stride), x, 8)
    assert (block.downsample is None) == (in_ch == 4 * width and stride == 1)
    np.testing.assert_allclose(got[0], want[0], atol=ATOL, rtol=RTOL)
    assert_stats_close(block, stats)
    assert_grads_close(block, grads)


# Training mode in a whole encoder carries float32 rounding that grows
# with depth: flax's BatchNorm takes the variance as E[x^2] - E[x]^2, the
# residual stream's mean grows block after block, and the backward pass
# through batch statistics cancels most of each gradient. On resnet50 at
# this size (64x64, batch 2; layer4 normalises over 8 values a channel),
# measured against a float64 evaluation of the same weights: the JAX
# features of layer3 and layer4 lie 1.3e-3 and 6.3e-3 (max abs) from it,
# the port's 4.1e-4 and 3.7e-3; the JAX parameter gradients 5-6% (L2 per
# tensor), the port's 1-2%. Neither package holds the golden tolerance
# there against the other. So on resnet50 the port is held to be no
# farther from the float64 evaluation than JAX (features of layer3 and
# layer4 in max abs, every gradient in L2), to JAX's layer3 and layer4
# features and their running statistics within atol 1e-2, rtol 1e-3, and
# to JAX's gradients within 10% in L2 (a wrong stride, downsample or
# momentum exceeds each many times over). The bottleneck blocks alone
# (above), resnet34, eval mode and the shallower resnet50 features and
# statistics hold the golden tolerance.
DEEP_ATOL, DEEP_RTOL, DEEP_GRAD_REL = 1e-2, 1e-3, 0.1


@pytest.mark.parametrize("name", ENCODERS)
def test_encoder_train_mode_matches_jax(name):
    """The encoder alone in training mode: its six features, the BatchNorm
    running statistics it updates (flax's momentum 0.9 on the biased batch
    variance), and the gradients of a seeded linear functional of the
    features with respect to every parameter."""
    x = np.random.default_rng(4).normal(size=(2, 64, 64, 3)).astype(np.float32)
    want, got, stats, grads, enc, cts = train_mode_pair(JaxEncoder(name), ResNetEncoder(name),
                                                        x, 5)
    if name == "resnet34":
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg=f"feature {i}")
        assert_stats_close(enc, stats)
        assert_grads_close(enc, grads)
        return
    for i, (g, w) in enumerate(zip(got, want)):
        tol = (DEEP_ATOL, DEEP_RTOL) if i >= 4 else (ATOL, RTOL)
        np.testing.assert_allclose(g, w, atol=tol[0], rtol=tol[1], err_msg=f"feature {i}")
    assert_stats_close(enc, stats, only=lambda k: k.startswith(("bn1.", "layer1.", "layer2.")))
    assert_stats_close(enc, stats, DEEP_ATOL, DEEP_RTOL)
    # The float64 evaluation: the same weights (the running statistics are
    # not read in training), input and cotangents.
    exact = ResNetEncoder(name).double()
    exact.load_state_dict(enc.state_dict())
    ref = exact.train()(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).double())
    sum((r * torch.from_numpy(c.transpose(0, 3, 1, 2).astype(np.float64))).sum()
        for r, c in zip(ref, cts)).backward()
    for i in (4, 5):
        r = ref[i].detach().numpy()
        assert np.abs(got[i] - r).max() <= np.abs(want[i] - r).max(), i
    exact_grads = dict(exact.named_parameters())
    for n, p in enc.named_parameters():
        e = exact_grads[n].grad.numpy()
        g, w = p.grad.numpy().astype(np.float64), grads[n].numpy().astype(np.float64)
        assert np.linalg.norm(g - e) <= np.linalg.norm(w - e), n
        assert np.linalg.norm(g - w) <= DEEP_GRAD_REL * np.linalg.norm(w), n
