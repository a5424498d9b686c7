"""Shared set-up of the port's train-step parity tests
(`test_torch_train_step_*.py`, `test_torch_dp_step_*.py`): one JAX
`TrainState` carried across to the port, JAX's random draws of a step
(the dropout keep masks of each decoder and the vote draws) and the
comparisons.

Sizes are `tests/test_train.py::tiny_setup`'s: 3 classes, MAX_INSTANCES 4,
MAX_VOTE_POINTS 128, 32 hypotheses, batch 2, here at 64x64.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
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


def setup(preset, seed=0, batch_size=2, jit_init=False):
    """Both sides of one step: the JAX (hp, net, optimizer, state, jitted
    step, batch, rng) and the port (hp, net, optimizer, state, step). With
    `jit_init` the JAX state is initialised jitted (about 7 s here, against
    19 s op by op)."""
    hp, net, pcfg, scfg, inv_k = tiny_setup(hp=preset(), h=H, w=W)
    opt = JO.make_optimizer(hp)
    init = lambda key: create_train_state(net, opt, key, hp)  # noqa: E731
    state = (jax.jit(init) if jit_init else init)(jax.random.key(seed))
    batch = make_batch(np.random.default_rng(seed), scfg, batch_size)
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


TP_MIN_CHANNELS = 16  # tests/test_train.py::test_tp_sharded_matches_replicated


def run_dp_step(preset, ranks=2, batch_size=4, with_eval=False, tp=1):
    """One train step of the global batch of `batch_size` three ways, from
    one JAX `TrainState` and with JAX's dropout masks and vote draws: the
    JAX step jitted over `make_mesh(ranks)` with the batch sharded
    (`shard_batch`) and the state replicated; the port in this process on
    the whole batch; and the port over `ranks` gloo processes
    (`torch_dp_ranks.train_step`, one thread each). JAX's adaptive rounds
    are counted by a debug callback around its `generate_hypotheses`. With
    `with_eval`, the port's eval step follows, in this process and over the
    ranks. With `tp` > 1, the port also runs over `ranks` x `tp` gloo
    processes laid out as `make_mesh(ranks * tp, tp=tp)` with the state
    `shard_state_tp`'d at `TP_MIN_CHANNELS` ("tp"), and the JAX state is
    placed by the JAX `shard_state_tp` over the same mesh (the conftest's
    virtual CPU devices; no step is compiled over it): "jax_shards" holds
    `jax_shard_report` of each of its devices."""
    import copy

    from fastposecnn_tpu.ops import voting as JV
    from fastposecnn_tpu.parallel import make_mesh, replicate, shard_batch
    from fastposecnn_tpu_torch import metrics as TM
    from fastposecnn_tpu_torch.parallel import mesh

    import torch_dp_ranks

    rounds, original = [], JV.generate_hypotheses

    def counted(*args, **kwargs):
        jax.debug.callback(lambda: rounds.append(1))
        return original(*args, **kwargs)

    patch = pytest.MonkeyPatch()
    patch.setattr(JV, "generate_hypotheses", counted)
    try:
        j, t = setup(preset, batch_size=batch_size, jit_init=True)
        hp = j["hp"]
        rng = jax.random.key(1)
        k_drop, k_pipe = step_keys(rng, 0)
        keep = dropout_keep(j, k_drop)
        draws = (vote_draws(k_pipe, batch_size, hp.MAX_INSTANCES, hp.MAX_VOTE_POINTS,
                            hp.HV_NUM_OF_HYPOTHESES) if hp.PERFORM_HOUGH_VOTING else None)
        jmesh = make_mesh(ranks)
        jstate, jlogs = j["step"](replicate(j["state"], jmesh),
                                  shard_batch(j["batch"], jmesh), rng)
        jax.block_until_ready(jlogs)
        jax.effects_barrier()
        jax_rounds = len(rounds)
    finally:
        patch.undo()

    tstate = t["state"]
    start = ({k: v.clone() for k, v in tstate.net.state_dict().items()},
             copy.deepcopy(tstate.opt_state), tstate.step)
    eval_draws = (vote_draws(jax.random.key(3), batch_size, hp.MAX_INSTANCES,
                             hp.MAX_VOTE_POINTS, hp.HV_NUM_OF_HYPOTHESES)
                  if with_eval else None)
    single_state, single_logs = t["step"](tstate, j["batch"], dropout_keep=keep, draws=draws)
    single = dict(state=single_state, logs=single_logs)
    if with_eval:
        estep = TT.make_eval_step(single_state.net, t["hp"], t["pcfg"], j["inv_k"], "cpu")
        elogs, bank, eout = estep(single_state, j["batch"], TM.init_pose_metric_bank(),
                                  draws=eval_draws)
        single["eval"] = dict(logs=elogs, bank=bank, out=eout["aggregated"])
    args = (t["hp"].to_json(), *start, j["batch"], keep, draws, j["inv_k"], eval_draws)
    dp = mesh.launch(torch_dp_ranks.train_step, ranks, args, backend="gloo", threads=1,
                     deadline_s=300.0)
    out = dict(jstate=jstate, jlogs=jlogs, jax_rounds=jax_rounds, single=single, dp=dp)
    if tp > 1:
        layout = mesh.make_mesh(ranks * tp, tp=tp)
        out["tp"] = mesh.launch(torch_dp_ranks.train_step, layout.size,
                                (*args, TP_MIN_CHANNELS), backend="gloo", threads=1,
                                deadline_s=300.0, layout=layout)
        out["jax_shards"] = jax_shard_report(j["state"], ranks * tp, tp)
    return out


def jax_shard_report(state, n_devices, tp):
    """The JAX `shard_state_tp` of `state` over `make_mesh(n_devices, tp=tp)`
    at `TP_MIN_CHANNELS`: (the number of parameter leaves it shards, and for
    each device of the mesh, in rank order, `torch_dp_ranks.shard_report`'s
    shapes and digests of the port's weight carrier applied to that
    device's shards)."""

    from fastposecnn_tpu.parallel import make_mesh, shard_state_tp

    from torch_dp_ranks import digest

    jmesh = make_mesh(n_devices, tp=tp)
    placed = shard_state_tp(state, jmesh, min_channels=TP_MIN_CHANNELS)
    n_sharded = sum("tp" in str(x.sharding.spec) for x in jax.tree.leaves(placed.params))
    reports = []
    for dev in jmesh.devices.reshape(-1):
        def on_dev(x):
            if not isinstance(x, jax.Array):
                return x
            (shard,) = [s for s in x.addressable_shards if s.device == dev]
            return np.asarray(shard.data)

        sd, opt, _, _ = from_jax_train_state(jax.tree.map(on_dev, placed))
        tensors = {**sd, **{f"{part}/{k}": v for part in ("mu", "nu", "slow")
                            for k, v in getattr(opt, part).items()}}
        reports.append({k: (tuple(v.shape), digest([v])) for k, v in tensors.items()})
    del placed
    return n_sharded, reports


def dp_train_state(rank0, num_classes):
    """A port `TrainState` from rank 0's results of `torch_dp_ranks.train_step`."""
    from fastposecnn_tpu_torch.train import optim as TO

    net = PoseRegressorNet(num_classes)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in rank0["state_dict"].items()})
    for n, p in net.named_parameters():
        g = rank0["grads"][n]
        p.grad = None if g is None else torch.from_numpy(g)
    count, la_step, hyper_count, lr_scale = rank0["counts"]
    tensors = {k: {n: torch.from_numpy(v) for n, v in rank0[k].items()}
               for k in ("mu", "nu", "slow")}
    opt = TO.OptState(tensors["mu"], tensors["nu"], count, tensors["slow"], la_step,
                      lr_scale, hyper_count)
    return TT.TrainState(net, opt, rank0["step"], rank0["skipped"])


def compare_dp(r, num_classes, loose=None, key="dp"):
    """The data-parallel step of `run_dp_step` (or, with `key` "tp", its
    dp x tp step, rank 0's state gathered over its tp group) against the
    JAX step over the mesh (logs, parameters, batch statistics, slow
    weights at the golden tolerance; moments in L2) and against the port's
    single-process step (the same, and the gradients in L2 per tensor);
    the parameters, statistics and optimizer state bit-equal on every rank
    of one tp index, and the gathered ones on every rank."""
    ranks = r[key]
    dp0 = ranks[0]
    for t in {d["coords"][1] for d in ranks}:
        assert len({d["digest"] for d in ranks if d["coords"][1] == t}) == 1, (
            f"the states of tp index {t} differ")
    assert len({d["whole_digest"] for d in ranks}) == 1, "the gathered states differ"
    state = dp_train_state(dp0, num_classes)
    compare_logs(dp0["logs"], {k: float(v) for k, v in r["jlogs"].items()}, loose=loose)
    compare_states(state, r["jstate"])
    single = r["single"]["state"]
    compare_logs(dp0["logs"], {k: float(v) for k, v in r["single"]["logs"].items()})
    mine, want = state.net.state_dict(), single.net.state_dict()
    for name in want:
        close(mine[name], want[name], name)
    want_grads = dict(single.net.named_parameters())
    reached = 0
    for name, p in state.net.named_parameters():
        g = want_grads[name].grad
        assert (p.grad is None) == (g is None), name
        if g is not None and g.any():
            close_l2(p.grad, g, f"grad {name}")
            reached += 1
    assert reached > 0
    o, w = state.opt_state, single.opt_state
    for name in w.mu:
        close_l2(o.mu[name], w.mu[name], f"mu {name}")
        close_l2(o.nu[name], w.nu[name], f"nu {name}", rel=2 * GRAD_REL)
        close(o.slow[name], w.slow[name], f"slow {name}")
    assert (state.step, state.skipped_updates) == (single.step, single.skipped_updates)
    return state
