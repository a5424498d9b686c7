"""Port parity for `fastposecnn_tpu_torch.train.optim`: each transform of the
chain against optax (or the JAX package's own lookahead), the whole chain
over 8 steps (a Lookahead sync at step 5, RAdam's rectification from step
6) with frozen modules, the encoder ratio, clipping, decoupled weight decay
and the plateau scale, and counterparts of `tests/test_train.py`'s
`test_plateau`, `test_lookahead_sync` and `test_encoder_updates_scaled`.

Seeded numpy inputs, CPU, float32. Tolerances: rtol 1e-5 on updates,
moments and slow weights (each transform is a few float32 roundings; the JAX
chain under `jax_enable_x64`, as the tests run it, carries the modules whose
multiplier is a default-dtype `jnp.ones(())` in float64), with atol 1e-7 on
a lone transform and 1e-9 on moments, and atol 5e-7 on the chain's updates
and slow weights: Lookahead's update is (p + u) - p, rounded at the scale of
p (|p| < 4 here, a float32 ulp is below 2.4e-7); the golden atol 2e-4 /
rtol 1e-4 on parameters; counts exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fastposecnn_tpu import config as JC
from fastposecnn_tpu.train import optim as JO
from fastposecnn_tpu_torch import config as TC
from fastposecnn_tpu_torch.train import optim as TO

ATOL, RTOL = 1e-7, 1e-5
U_ATOL = 5e-7
P_ATOL, P_RTOL = 2e-4, 1e-4
# JAX top-level module -> the port's name for it
PORT_NAME = {"encoder": "encoder", "mask_head": "segmentation_head",
             "rotation_head": "rotation_head", "scales_decoder": "scales_decoder"}


def close(got, want, atol=ATOL, rtol=RTOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol, rtol=rtol, err_msg=what)


def tensors(arrays):
    return [torch.from_numpy(np.array(a, np.float32)) for a in arrays]


def test_clip_by_global_norm_matches_optax():
    rng = np.random.default_rng(0)
    for scale in (0.01, 1.0):  # below and above the 0.15 norm
        arrays = [rng.normal(size=s).astype(np.float32) * scale for s in ((3, 4), (5,), (2, 2, 2))]
        want, _ = optax.clip_by_global_norm(0.15).update([jnp.asarray(a) for a in arrays], None)
        got = TO.clip_by_global_norm(tensors(arrays), 0.15)
        for g, w in zip(got, want):
            close(g, w)
        close(TO.global_norm(tensors(arrays)), optax.global_norm(arrays), rtol=1e-6)


def test_scale_by_radam_matches_optax_across_rectification():
    """Eight steps of fresh gradients: RAdam's plain momentum for steps 1-5,
    the rectified update from step 6 (optax's threshold 5)."""
    rng = np.random.default_rng(1)
    shapes = ((4, 3), (7,))
    opt = optax.scale_by_radam()
    jstate = opt.init([jnp.zeros(s, jnp.float32) for s in shapes])
    mu = tensors([np.zeros(s) for s in shapes])
    nu = tensors([np.zeros(s) for s in shapes])
    count, rectified = 0, []
    for _ in range(8):
        g = [rng.normal(size=s).astype(np.float32) for s in shapes]
        want, jstate = opt.update([jnp.asarray(a) for a in g], jstate)
        got, mu, nu, count = TO.scale_by_radam(tensors(g), mu, nu, count)
        rectified.append(TO.radam_scalars(count)["rectified"])
        assert count == int(jstate.count)
        for a, b in ((got, want), (mu, jstate.mu), (nu, jstate.nu)):
            for x, y in zip(a, b):
                close(x, y)
    assert rectified == [False] * 5 + [True] * 3


def test_add_decayed_weights_and_scales_match_optax():
    rng = np.random.default_rng(2)
    u = [rng.normal(size=(3, 2)).astype(np.float32)]
    p = [rng.normal(size=(3, 2)).astype(np.float32)]
    want, _ = optax.add_decayed_weights(3e-4).update([jnp.asarray(a) for a in u], None,
                                                     [jnp.asarray(a) for a in p])
    close(TO.add_decayed_weights(tensors(u), tensors(p), 3e-4)[0], want[0])
    want, _ = optax.scale(-1e-5).update([jnp.asarray(a) for a in u], None)
    close(TO.scale_each(tensors(u), [-1e-5])[0], want[0])


def test_lookahead_matches_jax_over_two_syncs():
    rng = np.random.default_rng(3)
    la = JO.lookahead(sync_period=5, slow_step_size=0.5)
    p = rng.normal(size=(6,)).astype(np.float32)
    jparams, jstate = jnp.asarray(p), la.init(jnp.asarray(p))
    tparams = torch.from_numpy(p.copy())
    slow, step = [tparams.clone()], 0
    for _ in range(11):
        u = rng.normal(size=(6,)).astype(np.float32) * 0.1
        ju, jstate = la.update(jnp.asarray(u), jstate, jparams)
        jparams = optax.apply_updates(jparams, ju)
        tu, slow, step = TO.lookahead(tensors([u]), [tparams], slow, step)
        TO.apply_updates({"p": tparams}, {"p": tu[0]})
        close(tu[0], ju)
        close(tparams, jparams)
        close(slow[0], jstate.slow)
        assert step == int(jstate.step)


def jax_params(rng):
    return {top: {"w": jnp.asarray(rng.normal(size=(5, 3)).astype(np.float32)),
                  "b": jnp.asarray(rng.normal(size=(3,)).astype(np.float32))}
            for top in PORT_NAME}


def to_port(tree):
    return {f"{PORT_NAME[top]}.{leaf}": torch.from_numpy(np.array(v, np.float32))
            for top, d in tree.items() for leaf, v in d.items()}


@pytest.mark.parametrize("lr_scale", [1.0, 0.25])
def test_whole_chain_matches_optax_over_eight_steps(lr_scale):
    """MASK_TRAINING's freezing (rotation and scales frozen), the encoder at
    half the learning rate, clipping on (gradient norms ~8 > 0.15) and off
    (a step of tiny gradients), weight decay, Lookahead's sync at step 5 and
    the rectified updates of steps 6-8. Frozen parameters stay bit-equal."""
    rng = np.random.default_rng(4)
    kw = dict(LEARNING_RATE=3e-3, ENCODER_LEARNING_RATE=1.5e-3)
    jhp, thp = JC.mask_training(**kw), TC.mask_training(**kw)
    jopt = JO.make_optimizer(jhp)
    jp = jax_params(rng)
    jstate = jopt.init(jp)
    if lr_scale != 1.0:
        jstate = JO.set_lr_scale(jstate, lr_scale)
    tp = to_port(jp)
    topt = TO.Optimizer(thp, list(tp))
    tstate = topt.init(tp)
    tstate = TO.set_lr_scale(tstate, lr_scale)
    frozen0 = {n: t.clone() for n, t in tp.items()
               if n.startswith(("rotation_head", "scales_decoder"))}
    for step in range(8):
        scale = 1e-3 if step == 2 else 1.0
        jg = jax.tree.map(lambda x: jnp.asarray(
            rng.normal(size=x.shape).astype(np.float32) * scale), jp)
        ju, jstate = jopt.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, ju)
        tu, tstate = topt.update(to_port(jg), tstate, tp)
        TO.apply_updates(tp, tu)
        for name, want in to_port(ju).items():
            close(tu[name], want, atol=U_ATOL, rtol=RTOL, what=f"update {name} step {step}")
        for name, want in to_port(jp).items():
            close(tp[name], want, atol=P_ATOL, rtol=P_RTOL, what=f"param {name}")
        inner = jstate[1].inner_state
        adam, la = inner[1], inner[6]
        assert tstate.count == int(adam.count) == step + 1
        assert tstate.lookahead_step == int(la.step)
        assert tstate.hyper_count == int(jstate[1].count)
        for ours, theirs, atol in ((tstate.mu, adam.mu, 1e-9), (tstate.nu, adam.nu, 1e-9),
                                   (tstate.slow, la.slow, U_ATOL)):
            for name, want in to_port(theirs).items():
                close(ours[name], want, atol=atol, rtol=RTOL, what=name)
    np.testing.assert_allclose(tstate.lr_scale, float(jstate[1].hyperparams["lr_scale"]))
    for name, t in frozen0.items():
        assert torch.equal(tp[name], t)


def test_plateau():
    st = TO.plateau_init()
    st = TO.plateau_update(st, 1.0)
    for _ in range(4):  # no improvement -> trigger after patience=2
        st = TO.plateau_update(st, 2.0)
    assert st.scale == pytest.approx(0.25)
    # against the JAX update over a longer trace, with a floor
    jst, tst = JO.plateau_init(), TO.plateau_init()
    for m in (3.0, 2.0, 2.5, 2.5, 2.5, 1.0, 1.5, 1.5, 1.5, 1.5, 1.5, 1.5, 1.5):
        jst = JO.plateau_update(jst, jnp.asarray(m), patience=1, factor=0.1, min_scale=0.005)
        tst = TO.plateau_update(tst, m, patience=1, factor=0.1, min_scale=0.005)
        assert tst.scale == pytest.approx(float(jst.scale), rel=1e-6)
        assert tst.bad_epochs == int(jst.bad_epochs) and tst.best == float(jst.best)


def test_lookahead_sync():
    params = torch.ones(3)
    slow, step = [params.clone()], 0
    upd = [torch.full((3,), 0.1)]
    u1, slow, step = TO.lookahead(upd, [params], slow, step, sync_period=2)
    p1 = params + u1[0]
    np.testing.assert_allclose(p1.numpy(), 1.1, rtol=1e-6)
    u2, slow, step = TO.lookahead(upd, [p1], slow, step, sync_period=2)
    p2 = p1 + u2[0]
    # after sync: slow = 1.0 + 0.5*(1.2-1.0) = 1.1
    np.testing.assert_allclose(p2.numpy(), 1.1, rtol=1e-6)


def test_encoder_updates_scaled():
    """Encoder updates are ENCODER_LR/LR of an equivalent run. In float64,
    as the JAX test's default-dtype arrays are under `jax_enable_x64` (in
    float32 an update of 2.7e-7 at a parameter of 1 is lost to rounding)."""
    hp_full = TC.mask_training()
    hp_half = dataclasses.replace(hp_full, ENCODER_LEARNING_RATE=hp_full.LEARNING_RATE * 0.5)
    hp_eq = dataclasses.replace(hp_full, ENCODER_LEARNING_RATE=hp_full.LEARNING_RATE)
    params = {"encoder.w": torch.ones(4, dtype=torch.float64),
              "segmentation_head.w": torch.ones(4, dtype=torch.float64)}
    grads = {k: torch.full_like(v, 0.3) for k, v in params.items()}

    def one_update(hp):
        opt = TO.Optimizer(hp, list(params))
        upd, _ = opt.update(grads, opt.init(params), params)
        return upd

    u_half, u_eq = one_update(hp_half), one_update(hp_eq)
    np.testing.assert_allclose(u_half["encoder.w"].numpy(), 0.5 * u_eq["encoder.w"].numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(u_half["segmentation_head.w"].numpy(),
                               u_eq["segmentation_head.w"].numpy(), rtol=1e-6)
