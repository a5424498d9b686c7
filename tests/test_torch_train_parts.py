"""The parts of the port's train path, each against the JAX package on the
same seeded inputs (CPU, float32): the train-mode BatchNorm (flax's biased
running variance), the stem max pool's gradient on ties, the channel
dropout's semantics, the pipeline's PERFORM_* gates, the training fields and
presets of the config, the non-finite-gradient skip and the step's own
draws.

Tolerances: the golden atol 2e-4 / rtol 1e-4 on values and gradients; the
max pool's routing exactly (integer cotangents, so the sums are exact).
"""

import dataclasses
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastposecnn_tpu import config as JC
from fastposecnn_tpu.data.synthetic import SceneConfig, generate_scene, make_batch, perfect_logits
from fastposecnn_tpu.models.fpn import FPNDecoder as JaxDecoder
from fastposecnn_tpu.ops.pooling import max_pool_3x3_s2
from fastposecnn_tpu.pipeline import run_pipeline as jax_run_pipeline
from fastposecnn_tpu_torch import config as TC
from fastposecnn_tpu_torch.models import PoseRegressorNet
from fastposecnn_tpu_torch.models.fpn import FPNDecoder, draw_keep
from fastposecnn_tpu_torch.models.resnet import BatchNorm, ResNetEncoder
from fastposecnn_tpu_torch.models.weights import from_jax_params, init_random_
from fastposecnn_tpu_torch.ops import aggregation as TA
from fastposecnn_tpu_torch.ops import voting as TV
from fastposecnn_tpu_torch.pipeline import run_pipeline
from fastposecnn_tpu_torch.train import task as TT

ATOL, RTOL = 2e-4, 1e-4


def close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL, rtol=RTOL,
                               err_msg=what)


def test_batchnorm_train_update_matches_flax():
    """Output, input and parameter gradients, and the running statistics
    after two train-mode calls: momentum 0.9 and the biased batch variance
    (nn.BatchNorm2d would scale the variance by n/(n-1) = 8/7 here)."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 2, 2, 16)) * 3 + 1).astype(np.float32)  # n = 8 per channel
    ct = rng.normal(size=x.shape).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = bn.init(jax.random.key(0), jnp.asarray(x))
    v = {"params": {"scale": jnp.asarray(rng.uniform(0.5, 1.5, 16), jnp.float32),
                    "bias": jnp.asarray(rng.normal(size=16), jnp.float32)},
         "batch_stats": {"mean": jnp.asarray(rng.normal(size=16), jnp.float32),
                         "var": jnp.asarray(rng.uniform(0.5, 2, 16), jnp.float32)}}

    def f(params, x):
        y, mut = bn.apply({"params": params, "batch_stats": v["batch_stats"]}, x,
                          mutable=["batch_stats"])
        return jnp.sum(y * ct), (y, mut["batch_stats"])

    (_, (y, stats)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        v["params"], jnp.asarray(x))
    _, stats2 = bn.apply({"params": v["params"], "batch_stats": stats}, jnp.asarray(x),
                         mutable=["batch_stats"])

    tbn = BatchNorm(16, eps=1e-5).train()
    with torch.no_grad():
        tbn.weight.copy_(torch.from_numpy(np.array(v["params"]["scale"])))
        tbn.bias.copy_(torch.from_numpy(np.array(v["params"]["bias"])))
        tbn.running_mean.copy_(torch.from_numpy(np.array(v["batch_stats"]["mean"])))
        tbn.running_var.copy_(torch.from_numpy(np.array(v["batch_stats"]["var"])))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    yt = tbn(xt)
    (yt * torch.from_numpy(ct.transpose(0, 3, 1, 2).copy())).sum().backward()
    close(yt.detach().numpy().transpose(0, 2, 3, 1), y, "output")
    close(xt.grad.numpy().transpose(0, 2, 3, 1), gx, "input gradient")
    close(tbn.weight.grad, gp["scale"], "scale gradient")
    close(tbn.bias.grad, gp["bias"], "bias gradient")
    close(tbn.running_mean, stats["mean"], "mean")
    close(tbn.running_var, stats["var"], "var")
    tbn(xt)
    close(tbn.running_mean, stats2["batch_stats"]["mean"], "mean, 2nd call")
    close(tbn.running_var, stats2["batch_stats"]["var"], "var, 2nd call")
    torch_default = torch.nn.BatchNorm2d(16, momentum=0.1).train()
    torch_default(xt)
    biased = x.reshape(-1, 16).var(0)
    close(torch_default.running_var, 0.9 + 0.1 * biased * 8 / 7)  # what we avoid
    # eval mode uses the running statistics and updates nothing
    before = tbn.running_var.clone()
    tbn.eval()(xt)
    assert torch.equal(tbn.running_var, before)


def test_stem_max_pool_gradient_on_ties_matches_jax():
    """nn.MaxPool2d(3, 2, 1) routes each window's cotangent to the first
    maximum in row-major order, as the JAX custom VJP (`ops/pooling.py`),
    on inputs full of ties: a constant patch and 3-valued noise."""
    rng = np.random.default_rng(1)
    x = rng.integers(0, 3, size=(2, 9, 12, 4)).astype(np.float32)
    x[0, :5, :6] = 1.0
    x[1] = 2.0
    ct = rng.integers(-8, 9, size=(2, 5, 6, 4)).astype(np.float32)
    y, vjp = jax.vjp(max_pool_3x3_s2, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    enc = ResNetEncoder()
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    yt = enc.maxpool(xt)
    np.testing.assert_array_equal(yt.detach().numpy().transpose(0, 2, 3, 1), np.asarray(y))
    yt.backward(torch.from_numpy(ct.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_array_equal(xt.grad.numpy().transpose(0, 2, 3, 1), want)


def test_channel_dropout_semantics_match_flax():
    """A decoder in train mode with flax's keep mask injected gives flax's
    output and gradient; the mask drops whole channels per sample and scales
    the kept ones by 1/(1-p); drawn masks keep ~1-p of the channels; eval
    mode and p = 0 drop nothing."""
    rng = np.random.default_rng(2)
    chans = (3, 64, 64, 128, 256, 512)
    feats = [rng.normal(size=(2, 32 // s, 32 // s, c)).astype(np.float32)
             for s, c in zip((1, 2, 4, 8, 16, 32), chans)]
    jdec = JaxDecoder()
    v = jdec.init(jax.random.key(0), [jnp.asarray(f) for f in feats])
    key = jax.random.key(9)
    y, mut = jdec.apply(v, [jnp.asarray(f) for f in feats], train=True,
                        rngs={"dropout": key}, mutable=["intermediates"],
                        capture_intermediates=lambda m, _: isinstance(m, fnn.Dropout))
    drop_out = np.asarray(mut["intermediates"]["Dropout_0"]["__call__"][0])
    keep = torch.from_numpy(np.abs(drop_out).max(axis=(1, 2)) > 0)[:, :, None, None]
    assert 0 < keep.float().mean() < 1  # some channels dropped, most kept
    y_eval = np.asarray(jdec.apply(v, [jnp.asarray(f) for f in feats], train=False))
    # flax's output is the eval output where kept, scaled by 1/0.8, else 0
    close(np.asarray(y), np.where(keep.numpy().transpose(0, 2, 3, 1), y_eval / 0.8, 0))

    net = PoseRegressorNet(3)
    sd = {k[len("mask_decoder."):]: t for k, t in from_jax_params(
        {"params": {"mask_decoder": v["params"]}}).items()}
    dec = FPNDecoder(net.encoder.out_channels)
    dec.load_state_dict(sd)
    tfeats = [torch.from_numpy(f.transpose(0, 3, 1, 2).copy()) for f in feats]
    out = dec.train()(tfeats, keep=keep)
    close(out.detach().numpy().transpose(0, 2, 3, 1), y)
    ct = rng.normal(size=y.shape).astype(np.float32)
    gj = jax.grad(lambda f0: jnp.sum(jdec.apply(
        v, [jnp.asarray(f) for f in feats[:-1]] + [f0], train=True,
        rngs={"dropout": key}) * ct))(jnp.asarray(feats[-1]))
    tfeats[-1].requires_grad_()
    (dec(tfeats, keep=keep) * torch.from_numpy(ct.transpose(0, 3, 1, 2).copy())).sum().backward()
    close(tfeats[-1].grad.numpy().transpose(0, 2, 3, 1), gj, "gradient")
    # drawn masks: per sample and channel, about 80% kept
    drawn = draw_keep(64, 128, 0.2, "cpu", torch.Generator().manual_seed(0))
    assert drawn.shape == (64, 128, 1, 1) and abs(drawn.float().mean() - 0.8) < 0.01
    gen = torch.Generator().manual_seed(5)
    a = dec(tfeats, generator=gen)
    b = dec(tfeats, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    with torch.no_grad():
        np.testing.assert_array_equal(dec.eval()(tfeats).numpy(), dec.eval()(tfeats, keep=keep).numpy())
    close(dec.eval()(tfeats).detach().numpy().transpose(0, 2, 3, 1), y_eval)


def _scene_logits(seed=0, h=64, w=64):
    cfg = SceneConfig(height=h, width=w, num_classes=3, max_instances=4,
                      max_scene_instances=2, box_half_extent=(6, 12))
    scene = generate_scene(np.random.default_rng(seed), cfg)
    logits = {k: np.asarray(v, np.float32) for k, v in perfect_logits(scene, 3).items()}
    return logits, np.linalg.inv(scene["intrinsics"]).astype(np.float32)


@pytest.mark.parametrize("preset", ["MASK_TRAINING", "HEAD_TRAINING", "no_hough", "no_rt"])
def test_perform_gates_match_jax(preset, monkeypatch):
    """`pipeline_config_from` passes the PERFORM_* gates and `run_pipeline`
    stops where JAX's does: nothing after class compression under
    MASK_TRAINING (and then neither the CC labelling nor the vote count
    runs), no centres without hough voting, no R/T without RT calculation."""
    gates = {"no_hough": dict(PERFORM_HOUGH_VOTING=False),
             "no_rt": dict(PERFORM_RT_CALCULATION=False)}
    kw = dict(MAX_INSTANCES=4, MAX_VOTE_POINTS=128, HV_NUM_OF_HYPOTHESES=32)
    if preset in gates:
        jhp, thp = JC.head_training(**gates[preset], **kw), TC.head_training(**gates[preset], **kw)
    else:
        jhp, thp = JC.PRESETS[preset](**kw), TC.PRESETS[preset](**kw)
    jcfg, tcfg = JC.pipeline_config_from(jhp, use_pallas=False), TC.pipeline_config_from(thp)
    for f in ("perform_aggregation", "perform_hough_voting", "perform_rt_calculation"):
        assert getattr(tcfg, f) == getattr(jcfg, f)
    calls = {"cc": 0, "vote": 0}

    def counted(fn, name):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(TA, "label_components_deferred",
                        counted(TA.label_components_deferred, "cc"))
    monkeypatch.setattr(TV, "vote_counts", counted(TV.vote_counts, "vote"))
    logits, inv_k = _scene_logits()
    key = jax.random.key(0)
    want = jax_run_pipeline({k: jnp.asarray(v) for k, v in logits.items()}, key, jcfg,
                            jnp.asarray(inv_k))
    got = run_pipeline({k: torch.from_numpy(v.transpose(0, 3, 1, 2).copy())
                        for k, v in logits.items()}, tcfg, torch.from_numpy(inv_k),
                       generator=torch.Generator().manual_seed(0),
                       cpu_generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(got["categorical"]["mask"].numpy(),
                                  np.asarray(want["categorical"]["mask"]))
    if want["aggregated"] is None:
        assert got["aggregated"] is None and calls == {"cc": 0, "vote": 0}
        return
    jkeys = set(want["aggregated"])
    tkeys = set(got["aggregated"]) - {"cc_error", "vote_rounds"}
    assert tkeys == jkeys, tkeys ^ jkeys
    assert calls["cc"] == 1 and (calls["vote"] > 0) == jcfg.perform_hough_voting
    np.testing.assert_array_equal(got["aggregated"]["class_ids"].numpy(),
                                  np.asarray(want["aggregated"]["class_ids"]))


def test_training_config_matches_jax(tmp_path):
    """Every JAX HParams field is in the port with its default, each preset
    sets the same values, and JSON round-trips (save/load)."""
    jf = {f.name: f.default for f in dataclasses.fields(JC.HParams)}
    tf = {f.name: f.default for f in dataclasses.fields(TC.HParams)}
    assert set(jf) == set(tf)
    for name in JC.PRESETS:
        j, t = JC.PRESETS[name](), TC.PRESETS[name]()
        assert json.loads(t.to_json()) == json.loads(j.to_json()), name
    hp = TC.head_training(LEARNING_RATE=3e-3, FREEZE_ENCODER=True)
    hp.save(tmp_path / "HPARAM.json")
    assert TC.HParams.load(tmp_path / "HPARAM.json") == hp
    assert TC.HParams.from_json(JC.head_training(LEARNING_RATE=3e-3).to_json()) == \
        TC.head_training(LEARNING_RATE=3e-3)
    assert TC.mask_training(PERFORM_AGGREGATION=True).PERFORM_AGGREGATION


def _port_step(preset, **kw):
    hp = preset(IMAGE_HEIGHT=32, IMAGE_WIDTH=32, SELECTED_CLASSES=("bg", "bottle", "bowl"),
                MAX_INSTANCES=4, MAX_VOTE_POINTS=128, HV_NUM_OF_HYPOTHESES=32, **kw)
    net = init_random_(PoseRegressorNet(hp.num_classes), seed=0)
    opt = TT.make_optimizer(hp, net)
    scfg = SceneConfig(height=32, width=32, num_classes=3, max_instances=4,
                       max_scene_instances=2, box_half_extent=(4, 9))
    batch = make_batch(np.random.default_rng(0), scfg, 2)
    inv_k = np.linalg.inv(np.array([[60.0, 0, 16], [0, 60.0, 16], [0, 0, 1]]))
    step = TT.make_train_step(net, opt, hp, TC.pipeline_config_from(hp), inv_k, "cpu")
    return TT.create_train_state(net, opt), step, batch


def test_non_finite_gradient_skips_the_update_but_keeps_batch_stats():
    """A NaN injected into one gradient: parameters and optimizer state stay
    as they were, `skipped_updates` and `step` count up, `grad/finite` is
    0, `grad/global_norm` is that of the gradients with the NaN zeroed, and
    the BatchNorm running statistics of the step's forward are kept (the
    JAX step's quirk)."""
    state, step, batch = _port_step(TC.mask_training)
    net = state.net
    weight = net.segmentation_head[0].weight
    hook = weight.register_hook(lambda g: torch.where(
        torch.arange(g.numel()).reshape(g.shape) == 3, torch.nan, g))
    params0 = {n: p.detach().clone() for n, p in net.named_parameters()}
    stats0 = net.encoder.bn1.running_var.clone()
    opt0 = state.opt_state
    state, logs = step(state, batch)
    hook.remove()
    assert (state.step, state.skipped_updates) == (1, 1)
    assert float(logs["grad/finite"]) == 0.0 and np.isfinite(float(logs["grad/global_norm"]))
    assert state.opt_state is opt0 and opt0.count == 0
    for n, p in net.named_parameters():
        assert torch.equal(p, params0[n]), n
    assert not torch.equal(net.encoder.bn1.running_var, stats0)
    assert torch.isnan(weight.grad).sum() == 1
    safe = [torch.nan_to_num(p.grad) for p in net.parameters() if p.grad is not None]
    close(logs["grad/global_norm"], torch.sqrt(sum((g * g).sum() for g in safe)))
    # the next, finite step updates
    state, logs = step(state, batch)
    assert (state.step, state.skipped_updates, state.opt_state.count) == (2, 1, 1)
    assert not torch.equal(weight, params0["segmentation_head.0.weight"])


def test_step_draws_its_own_masks_and_votes_from_the_seed():
    """Without injected draws the step draws dropout masks and vote draws
    from generators seeded by (seed, step): the same seed and state give
    the same step, another seed another; HEAD_TRAINING logs its adaptive
    rounds. A DENSE_XY_WEIGHT of 0 with voting on warns, as JAX prints."""
    results = []
    for seed in (4, 4, 5):
        state, step, batch = _port_step(TC.head_training)
        state, logs = step(state, batch, seed=seed)
        results.append(float(logs["pose/total_loss"]))
        assert 1 <= float(logs["pose/vote_rounds"]) <= 20
    assert results[0] == results[1] != results[2]
    with pytest.warns(UserWarning, match="DENSE_XY_WEIGHT=0"):
        _port_step(TC.head_training, DENSE_XY_WEIGHT=0.0)
