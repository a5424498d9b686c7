"""Port parity of the bfloat16 network: `PoseRegressorNet(dtype=torch.bfloat16)`
against the JAX package's `PoseRegressorNet(dtype=jnp.bfloat16)` on the CPU,
with the same float32 weights carried across by `from_jax_params` (64x64,
3 classes, resnet18; inputs from numpy seeds). JAX runs op by op, so every
value is rounded where flax's modules put the casts.

Two bf16 programs that differ anywhere by a float32 rounding (the
convolutions' accumulation order, the norms' rsqrt and reductions) drift
apart through the network: each rounding to bf16 turns a relative
difference e into about sqrt(e * 2^-8), so after a few layers the two lie
about as far apart as bf16 lies from float32. XLA's own compiled bf16
program on the CPU lies that far from JAX's op-by-op one (it keeps excess
precision between fused operations). So the network is held stage by
stage, each stage (the stem, every encoder block, every decoder and head)
on JAX's bf16 input to it: within relative L2 1e-3 of JAX's bf16 output,
and within 0.2 x JAX's own bf16-vs-float32 distance of that stage, which
shows that the casts sit where flax puts them. The whole forward is held
nearer to JAX's op-by-op bf16 logits than XLA's compiled program and than
float32. Modules are held bit for bit, up to 1 bf16 ulp on a few elements
where the two convolutions' accumulation orders round a tie apart.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastposecnn_tpu.models import PoseRegressorNet as JaxNet
from fastposecnn_tpu.models import fpn as jfpn
from fastposecnn_tpu.models import resnet as jresnet
from fastposecnn_tpu_torch.models import PoseRegressorNet
from fastposecnn_tpu_torch.models import fpn, resnet
from fastposecnn_tpu_torch.models.weights import from_jax_params

CLASSES = 3
KEYS = ("mask", "quaternion", "xy", "z", "scales")
DECODERS = ("mask", "rotation", "translation", "scales")
BF16 = torch.bfloat16
# Relative L2 bound against JAX's bf16 logits, and the share of JAX's own
# bf16-vs-float32 distance that the port may lie from JAX's bf16.
LOGIT_RTOL = 1e-3
SHARE = 0.2
# At most this share of a module's elements may differ, each by 1 bf16 ulp.
ULP_SHARE = 1e-3


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def nchw(a):
    return np.asarray(a, np.float32).transpose(0, 3, 1, 2)


def to_nhwc(x_nchw, dtype=jnp.float32):
    return jnp.asarray(np.asarray(x_nchw, np.float32).transpose(0, 2, 3, 1), dtype)


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """The bf16 value of each element as its ordered integer (monotonic in
    the value, so a difference of 1 is 1 ulp)."""
    bits = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(BF16).view(torch.int16)
    b = bits.to(torch.int32).numpy()
    return np.where(b < 0, -(b & 0x7FFF), b)


def hold_ulp(got, want, what):
    """bf16 `got` equal to bf16 `want` but for at most ULP_SHARE of the
    elements, each 1 ulp apart. Prints how many differ."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.array_equal(got, bf16_round(got)) and np.array_equal(want, bf16_round(want))
    ulps = np.abs(bf16_bits(got) - bf16_bits(want))
    share = float((ulps > 0).mean())
    print(f"{what}: {int((ulps > 0).sum())} of {got.size} elements differ "
          f"({share:.3e}), worst {int(ulps.max())} bf16 ulp")
    assert share <= ULP_SHARE, (what, share)
    assert ulps.max() <= 1, (what, int(ulps.max()))


def bf16_round(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(BF16).float().numpy()


def make_variables():
    """Random JAX variables of the bf16 network (float32 leaves), with
    non-trivial BatchNorm running statistics so eval-mode BN is tested."""
    rng = np.random.default_rng(0)
    v = JaxNet(num_classes=CLASSES, dtype=jnp.bfloat16).init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 1.5, a.shape) if path[-1].key == "var"
                         else rng.normal(0, 0.5, a.shape)).astype(np.float32),
        jax.tree.map(np.asarray, v["batch_stats"]))
    return {"params": jax.tree.map(np.asarray, v["params"]), "batch_stats": stats}


@pytest.fixture(scope="module")
def variables():
    return make_variables()


def port_net(variables, dtype=BF16):
    net = PoseRegressorNet(CLASSES, dtype=dtype)
    net.load_state_dict(from_jax_params(variables))
    return net


def image(seed, batch=2):
    return np.random.default_rng(seed).normal(size=(batch, 3, 64, 64)).astype(np.float32)


def test_state_dict_is_float32_and_unchanged(variables):
    a, b = port_net(variables).state_dict(), port_net(variables, torch.float32).state_dict()
    assert a.keys() == b.keys()
    assert all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)
    assert {t.dtype for t in a.values()} == {torch.float32, torch.int64}


# resnet18's blocks, each held on JAX's own bf16 input to it:
# (flax name, port module path, (width, stride)).
STAGES = [(f"layer{i}_{b}", f"encoder.layer{i}.{b}", (w, 2 if (b == 0 and i > 1) else 1))
          for i, w in zip((1, 2, 3, 4), (64, 128, 256, 512)) for b in (0, 1)]
HEAD_OUT = {"mask": CLASSES, "rotation": 4 * (CLASSES - 1),
            "translation": 3 * (CLASSES - 1), "scales": 3 * (CLASSES - 1)}
HEAD_KEYS = {"mask": ("mask",), "rotation": ("quaternion",), "translation": ("xy", "z"),
             "scales": ("scales",)}
XY = [i for i in range(3 * (CLASSES - 1)) if i % 3 != 2]
Z = [i for i in range(3 * (CLASSES - 1)) if i % 3 == 2]


def _jax_forward(variables, dtype, x, train, key, jit=False):
    """JAX's forward of the whole network: the logits, the updated
    batch_stats (train) and every module's output (`intermediates`); in
    train mode each decoder's channel keep mask as its `Dropout_0` drew it
    (a dropped channel is all zero, a kept one is not). Op by op unless
    `jit` (XLA's CPU compile with its default flags)."""
    net = JaxNet(num_classes=CLASSES, dtype=dtype)

    def apply(v, xx):
        return net.apply(v, xx, train=train, mutable=["batch_stats", "intermediates"],
                         rngs={"dropout": key}, capture_intermediates=True)

    out, mut = (jax.jit(apply) if jit else apply)(variables, to_nhwc(x))
    inter = mut["intermediates"]
    keep = {}
    if train:
        for name in DECODERS:
            drop = np.asarray(inter[f"{name}_decoder"]["Dropout_0"]["__call__"][0])
            keep[name] = torch.from_numpy(np.abs(drop).max(axis=(1, 2)) > 0)[:, :, None, None]
    return out, jax.tree.map(np.asarray, mut.get("batch_stats", {})), inter, keep


def _sub(variables, *path):
    out = {}
    for col, tree in variables.items():
        node = tree
        for p in path:
            node = node.get(p, {}) if isinstance(node, dict) else {}
        if node:
            out[col] = node
    return out


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module", params=["eval", "train"])
def forward(request, variables):
    """Both networks' forwards on one seeded batch in `mode`, and the port's
    stages each run on JAX's bf16 input to that stage."""
    train = request.param == "train"
    x = image(1 if not train else 2)
    key = jax.random.key(3)
    out16, stats16, inter, keep = _jax_forward(variables, jnp.bfloat16, x, train, key)
    out32, stats32, _, keep32 = _jax_forward(variables, jnp.float32, x, train, key)
    jit16 = _jax_forward(variables, jnp.bfloat16, x, train, key, jit=True)[0]
    assert all(torch.equal(keep[n], keep32[n]) for n in keep)
    net = port_net(variables).train(train)
    with torch.no_grad():
        whole = net(torch.from_numpy(x), dropout_keep=keep or None)
    return dict(mode=request.param, train=train, x=x, out16=out16, out32=out32, jit16=jit16,
                stats16=stats16, inter=inter, keep=keep, net=port_net(variables).train(train),
                whole=whole, variables=variables)


def test_stages_match_jax_bf16(forward):
    """The whole network, stage by stage: the stem, each encoder block, each
    decoder and each head, the port's stage and JAX's float32 stage each on
    JAX's bf16 input to the stage. Each stage within relative L2 1e-3 of
    JAX's bf16 output, and within 0.2 x JAX's own bf16-vs-float32 distance
    of the stage. In train mode the BatchNorms' updated running statistics
    of each stage are held to the same share."""
    f, net, v, train = forward, forward["net"], forward["variables"], forward["train"]
    inter = f["inter"]["encoder"]
    feats16 = inter["__call__"][0]
    enc_v = _sub(v, "encoder")
    rows = []

    def hold(what, got, want16, want32, stats=None):
        d_port, d_jax = rel_l2(got, want16), rel_l2(want16, want32)
        rows.append((what, d_port, d_jax))
        print(f"{f['mode']} {what}: port-vs-jax bf16 {d_port:.3e}, "
              f"jax bf16-vs-f32 {d_jax:.3e}")
        assert d_port <= LOGIT_RTOL, (what, d_port)
        assert d_port <= SHARE * d_jax, (what, d_port, d_jax)

    def hold_stats(what, port_module, stats16, stats32):
        sd = port_module.state_dict()
        for leaf, jleaf in (("running_mean", "mean"), ("running_var", "var")):
            names = sorted(k for k in sd if k.endswith(leaf))
            got = np.concatenate([sd[k].numpy() for k in names])
            w16 = np.concatenate([_leaf(stats16, k, jleaf) for k in names])
            w32 = np.concatenate([_leaf(stats32, k, jleaf) for k in names])
            hold(f"{what} {leaf}", got, w16, w32)

    with torch.no_grad():
        # The stem: image -> relu(bn1(conv1)).
        enc = net.encoder
        got = torch.relu(enc.bn1(enc.conv1(torch.from_numpy(f["x"]))))
        stem32, stem_stats32 = jresnet_stem(enc_v, to_nhwc(f["x"]), train)
        hold("stem", got.numpy(), nchw(feats16[1]), nchw(jax.nn.relu(stem32)))
        if train:
            hold_stats("stem", enc.bn1, f["stats16"]["encoder"]["bn1"], stem_stats32)
        y16 = enc.maxpool(_t(feats16[1]))
        for name, port_path, (width, stride) in STAGES:
            block = net.get_submodule(port_path)
            got = block(y16)
            jblock32 = jresnet.BasicBlock(width, strides=stride, dtype=jnp.float32)
            bv = _sub(enc_v, name)
            if train:
                want32, mut = jblock32.apply(bv, to_nhwc(y16.numpy()), train=True,
                                             mutable=["batch_stats"])
            else:
                want32 = jblock32.apply(bv, to_nhwc(y16.numpy()), train=False)
            want16 = inter[name]["__call__"][0]
            hold(name, got.numpy(), nchw(want16), nchw(want32))
            if train:
                hold_stats(name, block, f["stats16"]["encoder"][name],
                           jax.tree.map(np.asarray, mut["batch_stats"]))
            y16 = _t(want16)
        feats = [_t(a) for a in feats16]
        for dec in DECODERS:
            d16 = f["inter"][f"{dec}_decoder"]["__call__"][0]
            got = getattr(net, f"{dec}_decoder")(feats, f["keep"].get(dec))
            d32 = jfpn.FPNDecoder(dtype=jnp.float32).apply(
                _sub(v, f"{dec}_decoder"), [to_nhwc(a.numpy()) for a in feats], train=False)
            d32 = nchw(d32)
            if train:
                d32 = np.where(f["keep"][dec].numpy(), d32 / np.float32(0.8), 0.0)
            hold(f"{dec}_decoder", got.numpy(), nchw(d16), d32)
            head = getattr(net, "segmentation_head" if dec == "mask" else f"{dec}_head")
            h16 = f["inter"][f"{dec}_head"]["__call__"][0]
            got = head(_t(d16)).float().numpy()
            h32 = nchw(jfpn.SegmentationHead(HEAD_OUT[dec], dtype=jnp.float32).apply(
                _sub(v, f"{dec}_head"), d16))
            h16 = nchw(np.asarray(h16, np.float32))
            if dec == "translation":
                hold("xy head", got[:, XY], h16[:, XY], h32[:, XY])
                hold("z head", got[:, Z], h16[:, Z], h32[:, Z])
            else:
                hold(f"{HEAD_KEYS[dec][0]} head", got, h16, h32)


class JaxStem(flax.linen.Module):
    """JAX's stem (conv1, bn1) in `dtype`, as `ResNetEncoder` runs it."""
    dtype: jnp.dtype = jnp.float32
    train: bool = False

    @flax.linen.compact
    def __call__(self, x):
        x = jnp.pad(x, ((0, 0), (0, 0), (0, 0), (0, 1)))
        y = flax.linen.Conv(64, (7, 7), strides=2, padding=3, use_bias=False,
                            dtype=self.dtype, name="conv1")(x)
        return flax.linen.BatchNorm(use_running_average=not self.train, momentum=0.9,
                                    epsilon=1e-5, dtype=jnp.float32, name="bn1")(y)


def stem_variables(enc_v):
    return {"params": {k: enc_v["params"][k] for k in ("conv1", "bn1")},
            "batch_stats": {"bn1": enc_v["batch_stats"]["bn1"]}}


def jresnet_stem(enc_v, x, train):
    """JAX's stem in float32 on `x`: (output, updated bn1 statistics or
    None)."""
    v = stem_variables(enc_v)
    if train:
        y, mut = JaxStem(train=True).apply(v, x, mutable=["batch_stats"])
        return y, jax.tree.map(np.asarray, mut["batch_stats"]["bn1"])
    return JaxStem().apply(v, x), None


def _leaf(stats, torch_key, jleaf):
    """The JAX statistic `jleaf` of the BatchNorm that `torch_key` names,
    within one block's (or the stem's) batch_stats."""
    parts = torch_key.split(".")[:-1]
    if not parts:
        node = stats
    elif parts[0] == "downsample":
        node = stats["downsample_bn"]
    else:
        node = stats[parts[0]]
    return np.asarray(node[jleaf], np.float32)


def test_whole_network_against_jax_bf16(forward):
    """The whole forward, end to end: float32 outputs, each head nearer to
    JAX's bf16 logits (op by op, the roundings where flax puts them) than
    XLA's compiled bf16 program on the CPU is (which keeps excess precision
    between fused operations), and nearer than JAX's float32 logits."""
    f = forward
    for k in KEYS:
        got = f["whole"][k]
        assert got.dtype == torch.float32
        want16 = nchw(f["out16"][k])
        d_port = rel_l2(got.numpy(), want16)
        d_jit = rel_l2(nchw(f["jit16"][k]), want16)
        d_jax = rel_l2(want16, nchw(f["out32"][k]))
        print(f"{f['mode']} whole {k}: port-vs-jax bf16 {d_port:.3e}, "
              f"jax compiled-vs-op-by-op bf16 {d_jit:.3e}, jax bf16-vs-f32 {d_jax:.3e}")
        assert d_port <= d_jit, (k, d_port, d_jit)
        assert d_port <= d_jax, (k, d_port, d_jax)


def test_upsample_bilinear_bf16_bit_equal():
    x = np.random.default_rng(4).normal(size=(2, 5, 16, 12)).astype(np.float32)
    xt = torch.from_numpy(x).to(BF16)
    for scale in (2, 4):
        got = fpn.upsample_bilinear(xt, scale)
        assert got.dtype == BF16
        want = jfpn.upsample_bilinear(to_nhwc(x, jnp.bfloat16), scale)
        np.testing.assert_array_equal(got.float().numpy(),
                                      nchw(np.asarray(want, np.float32)))


def _module_state(tree, prefix):
    """The port state_dict of one JAX module's variables, placed at the
    flax path `prefix` (e.g. 'encoder/layer1_0') and read back without
    the corresponding torch prefix."""
    nested = {}
    for collection, sub in tree.items():
        node = nested.setdefault(collection, {})
        *parents, leaf = prefix.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = sub
    sd = from_jax_params(nested)
    torch_prefix = {
        "encoder/layer1_0": "encoder.layer1.0.", "mask_head": "segmentation_head.",
        "mask_decoder/p4": "mask_decoder.p4."}[prefix]
    out = {}
    for k, v in sd.items():
        assert k.startswith(torch_prefix), k
        out[k[len(torch_prefix):]] = v
    return out


def test_segmentation_head_bf16_matches_flax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 128, 16, 16)).astype(np.float32)  # the decoder's f32 output
    head = jfpn.SegmentationHead(8, dtype=jnp.bfloat16,
                                 bias_init_values=tuple(rng.normal(size=8)))
    v = jax.tree.map(np.asarray, head.init(jax.random.key(1), to_nhwc(x)))
    want = head.apply(v, to_nhwc(x))
    assert want.dtype == jnp.bfloat16
    port = fpn.SegmentationHead(128, 8, dtype=BF16)
    port.load_state_dict(_module_state(v, "mask_head"))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == BF16
    hold_ulp(got.float().numpy(), nchw(np.asarray(want, np.float32)), "SegmentationHead")


def test_fpn_block_bf16_matches_flax():
    rng = np.random.default_rng(6)
    p5 = rng.normal(size=(2, 256, 4, 4)).astype(np.float32)
    c4 = rng.normal(size=(2, 256, 8, 8)).astype(np.float32)
    lateral = flax.linen.Conv(256, (1, 1), dtype=jnp.bfloat16)  # the decoder's `lateral`
    v = lateral.init(jax.random.key(2), to_nhwc(c4))
    v = {"params": {"kernel": np.asarray(v["params"]["kernel"]),
                    "bias": rng.normal(0, 0.1, 256).astype(np.float32)}}
    p5_16 = to_nhwc(p5, jnp.bfloat16)
    want = jfpn.upsample_nearest(p5_16, 2) + lateral.apply(v, to_nhwc(c4))
    assert want.dtype == jnp.bfloat16
    port = fpn.FPNBlock(256, 256, dtype=BF16)
    port.load_state_dict(_module_state(v, "mask_decoder/p4"))
    with torch.no_grad():
        got = port(torch.from_numpy(p5).to(BF16), torch.from_numpy(c4))
    assert got.dtype == BF16
    hold_ulp(got.float().numpy(), nchw(np.asarray(want, np.float32)), "FPNBlock")


def _flax_block(block, v, x, train):
    """The flax block's output, its updated batch_stats (train) and each of
    its convolutions' and norms' outputs, keyed by module name."""
    out, mut = block.apply(
        v, x, train=train, mutable=["batch_stats", "intermediates"],
        capture_intermediates=lambda mdl, _: isinstance(mdl, (flax.linen.Conv,
                                                               flax.linen.BatchNorm)))
    inner = {k: np.asarray(c["__call__"][0], np.float32)
             for k, c in mut["intermediates"].items() if k != "__call__"}
    return out, jax.tree.map(np.asarray, mut["batch_stats"]), inner


@pytest.mark.parametrize("kind,train", [("basic", False), ("basic", True),
                                        ("bottleneck", False), ("bottleneck", True)])
def test_encoder_block_bf16_matches_flax(kind, train):
    """resnet18's BasicBlock and resnet50's BottleneckBlock, each with a
    strided downsample branch, in eval mode (random running statistics)
    and in train mode (batch statistics, updated running ones). Each of the
    block's convolutions, on the input flax's block gave it, within 1 bf16
    ulp on at most 0.1% of its elements; each norm, on flax's input, within
    float32 rounding (its updated running statistics too); the whole block
    as the network's stages are held."""
    rng = np.random.default_rng(7)
    x = np.abs(rng.normal(size=(2, 64, 16, 16))).astype(np.float32)  # a ReLU's output
    if kind == "basic":
        jblock, pblock = jresnet.BasicBlock(128, strides=2, dtype=jnp.bfloat16), \
            resnet.BasicBlock(64, 128, 2, dtype=BF16)
        jblock32 = jresnet.BasicBlock(128, strides=2)
        inputs = {"conv1": None, "conv2": "bn1", "downsample_conv": None}
    else:
        jblock, pblock = jresnet.BottleneckBlock(32, strides=2, dtype=jnp.bfloat16), \
            resnet.BottleneckBlock(64, 32, 2, dtype=BF16)
        jblock32 = jresnet.BottleneckBlock(32, strides=2)
        inputs = {"conv1": None, "conv2": "bn1", "conv3": "bn2", "downsample_conv": None}
    v = jax.tree.map(np.asarray, jblock.init(jax.random.key(3), to_nhwc(x)))
    v["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(0.5, 1.5, a.shape) if path[-1].key == "var"
                         else rng.normal(0, 0.5, a.shape)).astype(np.float32), v["batch_stats"])
    state = _module_state(v, "encoder/layer1_0")
    pblock.load_state_dict(state)
    pblock.train(train)
    want, stats, inner = _flax_block(jblock, v, to_nhwc(x), train)
    want32 = _flax_block(jblock32, v, to_nhwc(x), train)[0]
    assert want.dtype == jnp.float32
    mode = "train" if train else "eval"
    module = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}
    with torch.no_grad():
        for conv, src in inputs.items():
            xin = torch.from_numpy(x) if src is None else torch.relu(_t(inner[src]))
            got = pblock.get_submodule(module.get(conv, conv))(xin)
            assert got.dtype == BF16
            hold_ulp(got.float().numpy(), nchw(inner[conv]), f"{kind} {mode} {conv}")
            bn = conv.replace("conv", "bn")
            got = pblock.get_submodule(module.get(bn, bn))(_t(inner[conv]).to(BF16))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), nchw(inner[bn]), rtol=1e-5,
                                       atol=1e-5 * float(np.abs(inner[bn]).max()), err_msg=bn)
        if train:
            sd = pblock.state_dict()
            for k, t in _module_state({"batch_stats": stats}, "encoder/layer1_0").items():
                if k.endswith(("running_mean", "running_var")):
                    np.testing.assert_allclose(sd[k].numpy(), t.numpy(), rtol=1e-5, atol=1e-7,
                                               err_msg=k)
        pblock.load_state_dict(state)
        got = pblock(torch.from_numpy(x))
    assert got.dtype == torch.float32
    d_port, d_jax = rel_l2(got.numpy(), nchw(want)), rel_l2(nchw(want), nchw(want32))
    print(f"{kind} block ({mode}): port-vs-flax bf16 {d_port:.3e}, "
          f"flax bf16-vs-f32 {d_jax:.3e}")
    assert d_port <= LOGIT_RTOL and d_port <= SHARE * d_jax, (d_port, d_jax)
