"""Port parity for the resnet34 and resnet50 encoders: the port's
`ResNetEncoder` and `PoseRegressorNet(encoder_name=...)`, with weights
carried over from the JAX package by `from_jax_params`, against the JAX
modules on the same seeded input (CPU, float32, 64x64, 3 classes).

Held at the golden tolerance (atol 2e-4, rtol 1e-4): eval-mode logits,
and the logits after converting a seeded torchvision-layout state_dict
(the port's `convert_reference_state_dict` against the JAX
`load_full_checkpoint`). Exact: the key layout and shapes against the JAX
init, and the `to_jax_flat` round trip. Training mode is in
`test_torch_encoders_train.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastposecnn_tpu.models import PoseRegressorNet as JaxNet
from fastposecnn_tpu.models.torch_ref import TorchFPNDecoder, TorchPoseRegressor
from fastposecnn_tpu.models.weights import load_full_checkpoint
from fastposecnn_tpu_torch.models import PoseRegressorNet
from fastposecnn_tpu_torch.models.resnet import RESNET_SPECS, BottleneckBlock, ResNetEncoder
from fastposecnn_tpu_torch.models.weights import (
    convert_reference_state_dict,
    from_jax_params,
    init_random_,
    to_jax_flat,
)

ATOL, RTOL = 2e-4, 1e-4
ENCODERS = ("resnet34", "resnet50")
KEYS = ("mask", "quaternion", "xy", "z", "scales")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(flat_tree(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def random_stats(stats, rng):
    """Non-trivial BatchNorm running statistics, so eval mode tests them."""
    return jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.uniform(0.5, 1.5, v.shape) if path[-1].key == "var"
                         else rng.normal(0, 0.5, v.shape)).astype(np.float32),
        jax.tree.map(np.asarray, stats))


@pytest.fixture(scope="module", params=ENCODERS)
def jax_net(request):
    name = request.param
    net = JaxNet(num_classes=3, encoder_name=name)
    variables = net.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    rng = np.random.default_rng(1)
    variables = {"params": jax.tree.map(np.asarray, variables["params"]),
                 "batch_stats": random_stats(variables["batch_stats"], rng)}
    return name, net, variables


def test_encoder_specs():
    """Block counts, channels and where the downsample branches sit; an
    unknown name raises rather than building resnet18."""
    for name, spec in RESNET_SPECS.items():
        enc = ResNetEncoder(name)
        assert enc.out_channels == spec.out_channels
        assert [len(getattr(enc, f"layer{i}")) for i in range(1, 5)] == list(spec.stage_sizes)
        feats = enc(torch.zeros(1, 3, 64, 64))
        assert [f.shape[1] for f in feats] == list(spec.out_channels)
    r34, r50 = ResNetEncoder("resnet34"), ResNetEncoder("resnet50")
    assert r34.layer1[0].downsample is None and r34.layer2[0].downsample is not None
    # resnet50's layer1.0 projects 64 -> 256 channels at stride 1
    assert isinstance(r50.layer1[0], BottleneckBlock)
    assert r50.layer1[0].downsample[0].weight.shape == (256, 64, 1, 1)
    assert r50.layer1[0].downsample[0].stride == (1, 1)
    assert r50.layer1[1].downsample is None
    # the stride sits on the 3x3 conv2 (torchvision v1.5, the JAX block)
    assert r50.layer2[0].conv1.stride == (1, 1) and r50.layer2[0].conv2.stride == (2, 2)
    assert r50.layer2[0].downsample[0].stride == (2, 2)
    for bad in ("resnet101", "resnet"):
        with pytest.raises(ValueError, match="unknown encoder"):
            ResNetEncoder(bad)
        with pytest.raises(ValueError, match="unknown encoder"):
            PoseRegressorNet(3, encoder_name=bad)


def test_eval_logits_match_jax(jax_net):
    name, jnet, variables = jax_net
    x = np.random.default_rng(2).normal(size=(2, 3, 64, 64)).astype(np.float32)
    want = jnet.apply(variables, jnp.asarray(x.transpose(0, 2, 3, 1)), train=False)
    net = PoseRegressorNet(3, encoder_name=name)
    net.load_state_dict(from_jax_params(variables))
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x))
    for key in KEYS:
        np.testing.assert_allclose(got[key].numpy(),
                                   np.asarray(want[key]).transpose(0, 3, 1, 2),
                                   atol=ATOL, rtol=RTOL, err_msg=f"{name} {key}")


def test_layout_and_round_trip(jax_net):
    """`to_jax_flat` gives the JAX init's keys and shapes (the stem kernel
    with its alpha channel, (7, 7, 4, 64)), and `from_jax_params` inverts
    it exactly; a seeded random port network fits the JAX layout too."""
    name, _, variables = jax_net
    want = flat_tree(variables)
    sd = from_jax_params(variables)
    flat = to_jax_flat(sd)
    assert sorted(flat) == sorted(want)
    assert all(flat[k].shape == want[k].shape for k in want)
    back = from_jax_params(flat)
    assert sorted(back) == sorted(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    for k, a in flat.items():
        if k != "params/encoder/conv1/kernel":
            np.testing.assert_array_equal(a, want[k], err_msg=k)
    np.testing.assert_array_equal(flat["params/encoder/conv1/kernel"][:, :, :3],
                                  want["params/encoder/conv1/kernel"][:, :, :3])
    assert not flat["params/encoder/conv1/kernel"][:, :, 3].any()
    rand = to_jax_flat(init_random_(PoseRegressorNet(3, encoder_name=name), 0).state_dict())
    assert sorted(rand) == sorted(want)
    assert all(rand[k].shape == want[k].shape for k in want)


def test_init_random_covers_bottlenecks():
    """Every convolution of resnet50's encoder, conv3 and the downsample
    included, gets the lecun-normal draw (std 1/sqrt(fan_in)); every norm
    starts at unit scale and zero bias; the same seed gives the same
    weights."""
    net = init_random_(PoseRegressorNet(3, encoder_name="resnet50"), 3)
    convs = [(n, m) for n, m in net.encoder.named_modules() if isinstance(m, torch.nn.Conv2d)]
    assert len(convs) == 1 + 3 * 16 + 4
    for n, m in convs:
        w = m.weight.detach()
        fan_in = w[0].numel()
        if w.numel() >= 4096:
            assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.1, n
    for m in net.encoder.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            assert torch.equal(m.weight, torch.ones_like(m.weight)) and not m.bias.any()
    again = init_random_(PoseRegressorNet(3, encoder_name="resnet50"), 3).state_dict()
    assert all(torch.equal(t, again[k]) for k, t in net.state_dict().items())


def torchvision_encoder_sd(name, gen):
    """A seeded state_dict in torchvision's ResNet key layout, written out
    from the architecture's description (not from the port's modules)."""
    spec = RESNET_SPECS[name]
    sd = {}

    def conv(key, out_ch, in_ch, k):
        sd[f"encoder.{key}.weight"] = torch.randn((out_ch, in_ch, k, k), generator=gen) / np.sqrt(in_ch * k * k)

    def bn(key, ch):
        sd[f"encoder.{key}.weight"] = 1 + 0.1 * torch.randn(ch, generator=gen)
        sd[f"encoder.{key}.bias"] = 0.1 * torch.randn(ch, generator=gen)
        sd[f"encoder.{key}.running_mean"] = 0.1 * torch.randn(ch, generator=gen)
        sd[f"encoder.{key}.running_var"] = 0.5 + torch.rand(ch, generator=gen)
        sd[f"encoder.{key}.num_batches_tracked"] = torch.tensor(7)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    in_ch = 64
    for i, (blocks, width) in enumerate(zip(spec.stage_sizes, (64, 128, 256, 512))):
        for b in range(blocks):
            t = f"layer{i + 1}.{b}"
            if spec.block == "basic":
                out_ch = width
                conv(f"{t}.conv1", width, in_ch, 3)
                bn(f"{t}.bn1", width)
                conv(f"{t}.conv2", width, width, 3)
                bn(f"{t}.bn2", width)
            else:
                out_ch = 4 * width
                conv(f"{t}.conv1", width, in_ch, 1)
                bn(f"{t}.bn1", width)
                conv(f"{t}.conv2", width, width, 3)
                bn(f"{t}.bn2", width)
                conv(f"{t}.conv3", out_ch, width, 1)
                bn(f"{t}.bn3", out_ch)
            if b == 0 and (i > 0 or in_ch != out_ch):
                conv(f"{t}.downsample.0", out_ch, in_ch, 1)
                bn(f"{t}.downsample.1", out_ch)
            in_ch = out_ch
    return sd


@pytest.mark.parametrize("name", ENCODERS)
def test_reference_state_dict_matches_jax_conversion(name):
    """A seeded reference checkpoint (torchvision encoder, smp decoders and
    heads) through the port's `convert_reference_state_dict` and through
    the JAX `load_full_checkpoint`: the same logits; for resnet34 also
    those of the reference-layout torch model `models/torch_ref.py`."""
    gen = torch.Generator().manual_seed(11)
    ec = RESNET_SPECS[name].out_channels
    heads = TorchPoseRegressor(classes=3)
    for task in ("mask", "rotation", "translation", "scales"):
        setattr(heads, f"{task}_decoder", TorchFPNDecoder(ec))
    with torch.no_grad():
        for p in heads.parameters():
            p.copy_(0.05 * torch.randn(p.shape, generator=gen))
    sd = {k: v for k, v in heads.state_dict().items() if not k.startswith("encoder.")}
    sd.update(torchvision_encoder_sd(name, gen))

    net = PoseRegressorNet(3, encoder_name=name)
    net.load_state_dict(convert_reference_state_dict(sd, net))
    jnet = JaxNet(num_classes=3, encoder_name=name)
    init = jnet.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    jvars = load_full_checkpoint(init, {k: v.numpy() for k, v in sd.items()}, name)
    x = np.random.default_rng(6).normal(size=(1, 3, 64, 64)).astype(np.float32)
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x))
    want = jnet.apply(jvars, jnp.asarray(x.transpose(0, 2, 3, 1)), train=False)
    ref = None
    if name == "resnet34":
        tmodel = TorchPoseRegressor(classes=3, encoder_name=name).eval()
        tmodel.load_state_dict(sd)
        with torch.no_grad():
            ref = tmodel(torch.from_numpy(x))
    for key in KEYS:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]).transpose(0, 3, 1, 2),
                                   atol=ATOL, rtol=RTOL, err_msg=f"{name} {key}")
        if ref is not None:
            np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(), atol=ATOL,
                                       rtol=RTOL, err_msg=f"{name} {key} (torch_ref)")
    with pytest.raises(KeyError, match="missing"):
        convert_reference_state_dict({k: v for k, v in sd.items() if "bn3" not in k
                                      and "layer3.5" not in k}, net)
