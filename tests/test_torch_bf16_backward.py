"""The backward of the port's bfloat16 network against the JAX package's, stage
by stage, on the CPU (64x64, 3 classes, resnet18; the weights and inputs of
`tests/test_torch_bf16_network.py`).

Each stage (the stem, every encoder block, every decoder, every head) runs
on JAX's op-by-op bf16 input to it, in eval and in train mode (batch
statistics; the decoders' dropout with JAX's own keep masks), and is pulled
back with one seeded cotangent of its output, rounded to bf16 so that the
bf16 and float32 runs pull back the same values. Held: the gradient of the
stage's input and the gradients of its parameters (relative L2 over every
tensor), the port's against JAX's bf16 ones, each within 0.2 x JAX's own
bf16-vs-float32 distance of the same gradient, the share the forward's
stages are held to; and every gradient of a parameter float32. A float32
backward lies at 1 x that distance, so it fails.

One reference is not JAX's op-by-op value: a head's bias gradient, a bf16
reduction that XLA's op-by-op CPU reduce accumulates in bf16 (about 0.03
from the exact sum of its own bf16 terms, as far as bf16 lies from float32)
and the port in float32. It is held against JAX's bf16 cotangent of the
head's convolution output, summed exactly and rounded once to bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastposecnn_tpu.models import fpn as jfpn
from fastposecnn_tpu.models import resnet as jresnet
from fastposecnn_tpu_torch.models.weights import from_jax_params
from test_torch_bf16_network import (
    DECODERS, HEAD_OUT, SHARE, STAGES, JaxStem, _jax_forward, _sub, _t, bf16_round, image,
    make_variables, nchw, port_net, rel_l2, stem_variables, to_nhwc)

NAMES = ["stem", *(name for name, _, _ in STAGES), *(f"{d}_decoder" for d in DECODERS),
         *(f"{d}_head" for d in DECODERS)]
HEAD_MODULE = {"mask": "segmentation_head", "rotation": "rotation_head",
               "translation": "translation_head", "scales": "scales_head"}


@pytest.fixture(scope="module", params=["eval", "train"])
def network(request):
    """JAX's bf16 forward of one seeded batch in `mode` (every stage's bf16
    input), and the port's bf16 network in that mode."""
    train = request.param == "train"
    v = make_variables()
    x = image(1 if not train else 2)
    _, _, inter, keep = _jax_forward(v, jnp.bfloat16, x, train, jax.random.key(3))
    return dict(mode=request.param, train=train, x=x, v=v, inter=inter, keep=keep,
                net=port_net(v).train(train))


def _stage(n, name):
    """(JAX module factory of a dtype, its variables, its inputs [NHWC],
    the port's call on NCHW tensors, flax path, torch prefix) of stage
    `name`. A decoder's dropout is its keep mask (as JAX drew it) times
    1/0.8, applied to its train=False output on both sides."""
    v, net, train, inter = n["v"], n["net"], n["train"], n["inter"]
    enc_v, enc = _sub(v, "encoder"), net.encoder
    feats16 = inter["encoder"]["__call__"][0]
    if name == "stem":
        return (lambda dt: lambda p, x: jax.nn.relu(JaxStem(dtype=dt, train=train).apply(
                    _vars(p, stem_variables(enc_v)), x[0], mutable=["batch_stats"])[0]),
                stem_variables(enc_v), [to_nhwc(n["x"])],
                lambda x: torch.relu(enc.bn1(enc.conv1(x[0]))), "encoder", "encoder.")
    blocks = {b: (path, spec) for b, path, spec in STAGES}
    if name in blocks:
        path, (width, stride) = blocks[name]
        i = [b for b, _, _ in STAGES].index(name)
        x16 = (enc.maxpool(_t(feats16[1])).numpy() if i == 0
               else nchw(inter["encoder"][STAGES[i - 1][0]]["__call__"][0]))
        block = net.get_submodule(path)
        return (lambda dt: lambda p, x: jresnet.BasicBlock(width, strides=stride, dtype=dt).apply(
                    _vars(p, _sub(enc_v, name)), x[0], train=train,
                    mutable=["batch_stats"])[0],
                _sub(enc_v, name), [to_nhwc(x16)], lambda x: block(x[0]),
                f"encoder/{name}", f"{path}.")
    dec = name.rsplit("_", 1)[0]
    keep = n["keep"].get(dec)
    if name.endswith("_decoder"):
        scale = (jnp.asarray(keep.numpy().transpose(0, 2, 3, 1), jnp.float32) / 0.8
                 if train else 1.0)
        decoder = getattr(net, name)
        return (lambda dt: lambda p, x: jfpn.FPNDecoder(dtype=dt).apply(
                    {"params": p}, x, train=False) * scale,
                _sub(v, name), [jnp.asarray(a) for a in feats16[-4:]],
                lambda x: decoder(x, keep), name, f"{name}.")
    head = getattr(net, HEAD_MODULE[dec])
    return (lambda dt: lambda p, x: jfpn.SegmentationHead(HEAD_OUT[dec], dtype=dt).apply(
                {"params": p}, x[0]),
            _sub(v, name), [jnp.asarray(inter[f"{dec}_decoder"]["__call__"][0])],
            lambda x: head(x[0]), name, f"{HEAD_MODULE[dec]}.")


def _vars(params, variables):
    return {"params": params, "batch_stats": variables["batch_stats"]}


def _nest(tree, flax_path):
    for part in reversed(flax_path.split("/")):
        tree = {part: tree}
    return tree


def _jax_grads(module_of, variables, inputs, cot, dtype, flax_path, prefix):
    """JAX's op-by-op vjp of the stage in `dtype`: (input gradients as NCHW
    arrays, parameter gradients keyed by the port's names)."""
    out, vjp = jax.vjp(module_of(dtype), variables["params"], inputs)
    g_params, g_inputs = vjp(jnp.asarray(cot, out.dtype))
    sd = from_jax_params({"params": _nest(jax.tree.map(np.asarray, g_params), flax_path)})
    return ([nchw(g) for g in g_inputs],
            {k[len(prefix):]: t.numpy() for k, t in sd.items() if k.startswith(prefix)})


@pytest.mark.parametrize("name", NAMES)
def test_stage_backward_matches_jax_bf16(network, name):
    module_of, variables, inputs, call, flax_path, prefix = _stage(network, name)
    out16 = module_of(jnp.bfloat16)(variables["params"], inputs)
    seed = NAMES.index(name) + (100 if network["train"] else 0)
    cot = bf16_round(np.random.default_rng(seed).normal(size=out16.shape).astype(np.float32))
    dx16, dw16 = _jax_grads(module_of, variables, inputs, cot, jnp.bfloat16, flax_path, prefix)
    dx32, dw32 = _jax_grads(module_of, variables, inputs, cot, jnp.float32, flax_path, prefix)
    if name.endswith("_head"):
        # The bias gradient is a bf16 reduction over the batch and the
        # pixels: JAX's op-by-op CPU reduce accumulates it in bf16, the port
        # (as a compiled XLA program does) in float32. Its reference is
        # JAX's own bf16 cotangent of the convolution's output, summed
        # exactly and rounded once to bf16.
        _, pull = jax.vjp(lambda y: jfpn.upsample_bilinear(y, 4), jnp.zeros(
            (*out16.shape[:1], out16.shape[1] // 4, out16.shape[2] // 4, out16.shape[3]),
            jnp.bfloat16))
        g_y = np.asarray(pull(jnp.asarray(cot, jnp.bfloat16))[0], np.float64)
        exact = bf16_round(g_y.sum(axis=(0, 1, 2)).astype(np.float32))
        print(f"{network['mode']} {name} bias gradient: jax op-by-op bf16 reduce vs its exact "
              f"sum rounded to bf16 {rel_l2(dw16['0.bias'], exact):.3e}")
        dw16["0.bias"] = exact

    xs = [_t(a).requires_grad_(True) for a in inputs]
    module = network["net"].get_submodule(prefix[:-1])
    module.zero_grad(set_to_none=True)
    out = call(xs)
    assert out.dtype == torch.float32 if out16.dtype == jnp.float32 else out.dtype == torch.bfloat16
    out.backward(_t(cot).to(out.dtype))
    params = dict(module.named_parameters())
    names = sorted(dw16)
    assert names and set(names) <= set(params), (names, sorted(params))
    assert all(params[k].grad.dtype == torch.float32 for k in names)
    got = {"input": [x.grad.numpy() for x in xs], "params": [params[k].grad.numpy() for k in names]}
    want16 = {"input": dx16, "params": [dw16[k] for k in names]}
    want32 = {"input": dx32, "params": [dw32[k] for k in names]}
    for part in got:
        cat = lambda arrays: np.concatenate([np.ravel(a) for a in arrays])  # noqa: E731
        d_port = rel_l2(cat(got[part]), cat(want16[part]))
        d_jax = rel_l2(cat(want16[part]), cat(want32[part]))
        print(f"{network['mode']} {name} {part} gradient: port-vs-jax bf16 {d_port:.3e}, "
              f"jax bf16-vs-f32 {d_jax:.3e} ({d_port / d_jax:.3f})")
        assert d_port <= SHARE * d_jax, (name, part, d_port, d_jax)
