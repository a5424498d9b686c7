"""One MASK_TRAINING train step and one eval step of the port against the
JAX package's, from one JAX `TrainState` carried across, on the same batch
and the same dropout masks (`tests/torch_train_helpers.py`; 64x64, 3
classes, batch 2). The JAX steps are jitted, as `tests/test_train.py` runs
them.

Compared: every log, the updated parameters and BatchNorm statistics
(flax's biased variance) and Lookahead's slow weights at the golden
tolerance (atol 2e-4, rtol 1e-4); the gradients and RAdam's moments in L2
per tensor, within 2e-3 of the JAX tensor's norm (4e-3 for the second
moment; `torch_train_helpers.GRAD_REL` says why); counts (step, skipped
updates, RAdam and Lookahead steps) exactly. Under MASK_TRAINING the pipeline stops after class compression:
no aggregation, so neither kernel would launch.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import fastposecnn_tpu.metrics as JM
from fastposecnn_tpu import config as JC
from fastposecnn_tpu.train.task import make_eval_step
from fastposecnn_tpu_torch import metrics as TM
from fastposecnn_tpu_torch.train import task as TT
from torch_train_helpers import (compare_grads, compare_logs, compare_states, dropout_keep,
                                 jax_grads, setup, step_keys)


@pytest.fixture(scope="module")
def mask_step():
    j, t = setup(JC.mask_training)
    rng = jax.random.key(1)
    k_drop, _ = step_keys(rng, 0)
    keep = dropout_keep(j, k_drop)
    jstate, jlogs = j["step"](j["state"], j["batch"], rng)
    jgrads = jax_grads(j, rng)
    tstate, tlogs = t["step"](t["state"], j["batch"], dropout_keep=keep)
    return j, t, jstate, jlogs, jgrads, tstate, tlogs


def test_mask_step_matches_jax(mask_step):
    j, t, jstate, jlogs, jgrads, tstate, tlogs = mask_step
    compare_logs(tlogs, jlogs)
    assert float(tlogs["grad/finite"]) == 1.0 and "quaternion/loss_quat" not in tlogs
    assert compare_grads(tstate.net, jgrads) > 0
    # no loss reaches the frozen heads under MASK_TRAINING
    assert tstate.net.rotation_head[0].weight.grad is None
    compare_states(tstate, jstate)


def test_mask_eval_step_matches_jax(mask_step):
    j, t, jstate, _, _, tstate, _ = mask_step
    estep = jax.jit(make_eval_step(j["net"], j["hp"], j["pcfg"], j["inv_k"]))
    jlogs, jbank, jout = estep(jstate, j["batch"], jax.random.key(3), JM.init_pose_metric_bank())
    tstep = TT.make_eval_step(tstate.net, t["hp"], t["pcfg"], j["inv_k"], "cpu")
    tlogs, tbank, tout = tstep(tstate, j["batch"], TM.init_pose_metric_bank())
    assert jout["aggregated"] is None and tout["aggregated"] is None
    np.testing.assert_array_equal(tout["categorical"]["mask"].numpy(),
                                  np.asarray(jout["categorical"]["mask"]))
    compare_logs(tlogs, jlogs)
    assert all(float(v["total"]) == 0 for v in tbank.values())  # no matching under MASK
    assert not tstate.net.training


def test_eight_mask_steps_lower_the_loss(mask_step):
    """The port alone, from the carried state at LEARNING_RATE 3e-3: the
    loss falls over 8 steps and the frozen heads stay bit-equal, as
    `tests/test_train.py::test_mask_training_loss_decreases_and_freezing`
    asserts of JAX."""
    j = mask_step[0]
    _, t = setup(JC.mask_training)  # a fresh copy of the carried state
    hp = dataclasses.replace(t["hp"], LEARNING_RATE=3e-3)
    opt = TT.make_optimizer(hp, t["net"])
    step = TT.make_train_step(t["net"], opt, hp, t["pcfg"], j["inv_k"], "cpu")
    state = TT.TrainState(t["net"], opt.init(t["state"].params()))
    rot0 = [p.detach().clone() for p in t["net"].rotation_head.parameters()]
    mask0 = [p.detach().clone() for p in t["net"].segmentation_head.parameters()]
    losses = []
    for i in range(8):
        state, logs = step(state, j["batch"], seed=1)
        losses.append(float(logs["pose/total_loss"]))
    assert losses[-1] < losses[0] and state.step == 8 and state.skipped_updates == 0
    for a, b in zip(rot0, state.net.rotation_head.parameters()):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in zip(mask0, state.net.segmentation_head.parameters()))
