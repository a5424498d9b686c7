"""Shared set-up of the port's train-step parity tests
(`test_torch_train_step_*.py`): one JAX `TrainState` carried across to the
port, JAX's random draws of a step (the dropout keep masks of each decoder
and the vote draws) and the comparisons.

Sizes are `tests/test_train.py::tiny_setup`'s: 3 classes, MAX_INSTANCES 4,
MAX_VOTE_POINTS 128, 32 hypotheses, batch 2, here at 64x64.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import torch

from fastposecnn_tpu.data.synthetic import make_batch
from fastposecnn_tpu.train import optim as JO
from fastposecnn_tpu.train.task import create_train_state, make_train_step, upcast_batch
from fastposecnn_tpu_torch import config as TC
from fastposecnn_tpu_torch.models import PoseRegressorNet
from fastposecnn_tpu_torch.models.weights import from_jax_params, from_jax_train_state
from fastposecnn_tpu_torch.ops.voting import VoteDraws
from fastposecnn_tpu_torch.train import task as TT
from test_train import tiny_setup

# The repo's golden tolerance (tests/test_weights.py:137).
ATOL, RTOL = 2e-4, 1e-4
H = W = 64
DECODERS = ("mask", "rotation", "translation", "scales")


def setup(preset, seed=0):
    """Both sides of one step: the JAX (hp, net, optimizer, state, jitted
    step, batch, rng) and the port (hp, net, optimizer, state, step)."""
    hp, net, pcfg, scfg, inv_k = tiny_setup(hp=preset(), h=H, w=W)
    opt = JO.make_optimizer(hp)
    state = create_train_state(net, opt, jax.random.key(seed), hp)
    batch = make_batch(np.random.default_rng(seed), scfg, 2)
    jax_side = dict(hp=hp, net=net, pcfg=pcfg, opt=opt, state=state, batch=batch,
                    inv_k=inv_k, step=jax.jit(make_train_step(net, opt, hp, pcfg, inv_k)))

    thp = TC.HParams.from_json(hp.to_json())
    tnet = PoseRegressorNet(thp.num_classes)
    sd, opt_state, step, skipped = from_jax_train_state(state)
    tnet.load_state_dict(sd)
    topt = TT.make_optimizer(thp, tnet)
    tstate = TT.TrainState(tnet, opt_state, step, skipped)
    pcfg_t = TC.pipeline_config_from(thp)
    port = dict(hp=thp, net=tnet, opt=topt, state=tstate, pcfg=pcfg_t,
                step=TT.make_train_step(tnet, topt, thp, pcfg_t, inv_k, "cpu"))
    return jax_side, port


def step_keys(rng, step):
    """(k_drop, k_pipe) of the JAX train step (`train/task.py:184`)."""
    return jax.random.split(jax.random.fold_in(rng, step))


def dropout_keep(j, k_drop):
    """Each decoder's channel keep mask [B, C, 1, 1] as the JAX step draws
    it: the output of its `Dropout_0` captured from a flax apply with the
    step's dropout key (a dropped channel is all zero, a kept one is not)."""
    state, batch = j["state"], upcast_batch(j["batch"])
    _, mut = j["net"].apply(
        {"params": state.params, "batch_stats": state.batch_stats}, batch["image"],
        train=True, mutable=["batch_stats", "intermediates"], rngs={"dropout": k_drop},
        capture_intermediates=lambda mdl, _: isinstance(mdl, flax.linen.Dropout))
    inter = mut["intermediates"]
    keep = {}
    for name in DECODERS:
        out = np.asarray(inter[f"{name}_decoder"]["Dropout_0"]["__call__"][0])
        keep[name] = torch.from_numpy(np.abs(out).max(axis=(1, 2)) > 0)[:, :, None, None]
    return keep


def vote_draws(k_pipe, b, n, p, num_hyp, max_iter=20):
    """The vote draws of JAX `hough_vote` with the pipeline key (bbox
    sampler, adaptive rounds: `ops/voting.py:683-684`, :746, :88)."""
    k_sample, k_vote = jax.random.split(k_pipe)
    kx, ky = jax.random.split(k_sample)

    def uniform(k):
        return torch.from_numpy(np.array(jax.random.uniform(k, (b, n, p), dtype=jnp.float32)))

    k, pairs = k_vote, []
    for _ in range(max_iter):
        k, k_hyp = jax.random.split(k)
        pairs.append(np.asarray(jax.random.randint(k_hyp, (b * n, num_hyp, 2), 0, p)))
    return VoteDraws(ux=uniform(kx), uy=uniform(ky), pairs=torch.from_numpy(np.stack(pairs)))


def jax_grads(j, rng):
    """The gradients of the JAX step's loss (its `loss_fn`, jitted alone)."""
    from fastposecnn_tpu.pipeline import run_pipeline
    from fastposecnn_tpu.train.task import _compute_losses

    hp, pcfg, state = j["hp"], j["pcfg"], j["state"]
    inv_k = jnp.asarray(j["inv_k"], jnp.float32)
    perform_matching = hp.PERFORM_MATCHING and pcfg.perform_aggregation

    def loss_fn(params, batch, rng):
        batch = upcast_batch(batch)
        k_drop, k_pipe = step_keys(rng, state.step)
        logits, _ = j["net"].apply(
            {"params": params, "batch_stats": state.batch_stats}, batch["image"],
            train=True, mutable=["batch_stats"], rngs={"dropout": k_drop})
        out = run_pipeline(logits, k_pipe, pcfg, inv_k)
        return _compute_losses(out, batch, hp, perform_matching)[0]

    return jax.jit(jax.grad(loss_fn))(state.params, j["batch"], rng)


def close(got, want, what, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol, rtol=rtol, err_msg=what)


# Gradients are held in L2 per tensor: ||port - JAX|| <= GRAD_REL ||JAX||.
# The jitted JAX step rounds some pre-activations differently from the
# port (XLA fuses GroupNorm's arithmetic), and one that lies at a ReLU's
# kink can fall on the other side: a pixel's cotangent then passes in one
# package and not in the other. In the MASK step one such pixel at the
# finest FPN level (its GroupNorm's bias gradient off by 1.5e-4 relative
# while its scale gradient, which weighs the pixel by its ~0 activation,
# agrees to 1e-6) moves every gradient upstream of it by ~2e-4 relative in
# L2 and by more than atol 2e-4 on elements of small magnitude.
GRAD_REL = 2e-3


def close_l2(got, want, what, rel=GRAD_REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, norm = np.linalg.norm(got - want), np.linalg.norm(want)
    assert err <= rel * norm + 1e-30, f"{what}: |diff| {err} > {rel} * |want| {norm}"


def compare_states(tstate, jstate):
    """The port's state after a step against JAX's, leaf by leaf: params,
    batch_stats and slow weights at the golden tolerance; RAdam's moments,
    which are the clipped gradients (mu) and their squares (nu) scaled by
    1e-1 and 1e-3, in L2 as the gradients (twice the bound for nu); counts
    exactly."""
    sd, opt, step, skipped = from_jax_train_state(jstate)
    mine = tstate.net.state_dict()
    for name, want in sd.items():
        if not name.endswith("num_batches_tracked"):
            close(mine[name], want, name)
    assert (tstate.step, tstate.skipped_updates) == (step, skipped)
    o = tstate.opt_state
    assert (o.count, o.lookahead_step, o.hyper_count) == (
        opt.count, opt.lookahead_step, opt.hyper_count)
    assert o.lr_scale == opt.lr_scale
    for name in opt.mu:
        close_l2(o.mu[name], opt.mu[name], f"mu {name}")
        close_l2(o.nu[name], opt.nu[name], f"nu {name}", rel=2 * GRAD_REL)
        close(o.slow[name], opt.slow[name], f"slow {name}")


def compare_grads(tnet, jgrads):
    """The port's raw gradients (`.grad`, None where no loss reaches)
    against JAX's, in L2 per tensor (`GRAD_REL`); a tensor that JAX gives
    no gradient gets none in the port. Returns the number of tensors with
    a gradient."""
    want = from_jax_params({"params": jgrads})
    nonzero = 0
    for name, p in tnet.named_parameters():
        if not want[name].any():
            assert p.grad is None or not p.grad.any(), name
            continue
        close_l2(p.grad, want[name], f"grad {name}")
        nonzero += 1
    return nonzero


def compare_logs(tlogs, jlogs, loose=None):
    """Every JAX log against the port's, at the golden tolerance or at
    `loose[key]` (atol) where given."""
    loose = loose or {}
    missing = set(jlogs) - set(tlogs)
    assert not missing, missing
    for key, want in jlogs.items():
        close(tlogs[key], want, key, atol=loose.get(key, ATOL))
