"""One HEAD_TRAINING train step and one eval step of the port against the
JAX package's, from one JAX `TrainState` carried across, on the same batch,
the same dropout masks and the same vote draws
(`tests/torch_train_helpers.py`; 64x64, 3 classes, batch 2, MAX_INSTANCES
4, MAX_VOTE_POINTS 128, 32 hypotheses, adaptive RANSAC). The JAX steps are
jitted with `use_pallas=False`, as `tests/test_train.py` runs them.

Compared: as the MASK step (golden tolerance on logs, parameters, batch
statistics and slow weights; gradients and RAdam's moments in L2 per
tensor; counts exactly), and the adaptive rounds exactly: JAX's are counted
by a debug callback wrapped around its `generate_hypotheses`, which each
round calls once. Compiled, XLA fuses the hypotheses' multiply-adds inside
the while loop (ROADMAP.md C4), so JAX's voted centres lie within 0.05 px
of the port's: the logged matched xy loss (a mean |dx| plus a mean |dy|)
is held within 0.1 and nothing else moves, since voting passes no
gradient. The eval step's instances (masks, validity, class ids, CC
labels) and win ratios are exactly equal, its centres within 0.05 px.
"""

import jax
import numpy as np
import pytest

import fastposecnn_tpu.metrics as JM
from fastposecnn_tpu import config as JC
from fastposecnn_tpu.ops import voting as JV
from fastposecnn_tpu.train.task import make_eval_step
from fastposecnn_tpu_torch import metrics as TM
from fastposecnn_tpu_torch.train import task as TT
from torch_train_helpers import (ATOL, RTOL, close, compare_grads, compare_logs,
                                 compare_states, dropout_keep, jax_grads, setup, step_keys,
                                 vote_draws)

XY_BAND = 0.05  # px, ROADMAP.md C4


@pytest.fixture(scope="module")
def head_step():
    rounds = []
    original = JV.generate_hypotheses

    def counted(*args, **kwargs):
        jax.debug.callback(lambda: rounds.append(1))
        return original(*args, **kwargs)

    patch = pytest.MonkeyPatch()
    patch.setattr(JV, "generate_hypotheses", counted)
    try:
        j, t = setup(JC.head_training)
        hp = j["hp"]
        rng = jax.random.key(1)
        k_drop, k_pipe = step_keys(rng, 0)
        keep = dropout_keep(j, k_drop)
        draws = vote_draws(k_pipe, 2, hp.MAX_INSTANCES, hp.MAX_VOTE_POINTS,
                           hp.HV_NUM_OF_HYPOTHESES)
        jstate, jlogs = j["step"](j["state"], j["batch"], rng)
        jax.block_until_ready(jlogs)
        jax.effects_barrier()
        step_rounds = len(rounds)
        jgrads = jax_grads(j, rng)
        tstate, tlogs = t["step"](t["state"], j["batch"], dropout_keep=keep, draws=draws)

        rounds.clear()
        estep = jax.jit(make_eval_step(j["net"], hp, j["pcfg"], j["inv_k"]))
        eval_key = jax.random.key(3)
        jeval = estep(jstate, j["batch"], eval_key, JM.init_pose_metric_bank())
        jax.block_until_ready(jeval)
        jax.effects_barrier()
        eval_rounds = len(rounds)
        k_sample, k_vote = jax.random.split(eval_key)
        teval = TT.make_eval_step(tstate.net, t["hp"], t["pcfg"], j["inv_k"], "cpu")(
            tstate, j["batch"], TM.init_pose_metric_bank(),
            draws=vote_draws(eval_key, 2, hp.MAX_INSTANCES, hp.MAX_VOTE_POINTS,
                             hp.HV_NUM_OF_HYPOTHESES))
    finally:
        patch.undo()
    return dict(jstate=jstate, jlogs=jlogs, jgrads=jgrads, tstate=tstate, tlogs=tlogs,
                step_rounds=step_rounds, jeval=jeval, teval=teval, eval_rounds=eval_rounds)


def test_head_step_matches_jax(head_step):
    r = head_step
    tlogs, jlogs = r["tlogs"], r["jlogs"]
    assert 1 <= r["step_rounds"] <= 20
    assert int(tlogs["pose/vote_rounds"]) == r["step_rounds"]
    assert float(tlogs["pose/num_matched"]) == float(jlogs["pose/num_matched"])
    compare_logs(tlogs, jlogs, loose={"xy/loss_xy": 2 * XY_BAND})
    assert float(tlogs["grad/finite"]) == 1.0 and r["tstate"].skipped_updates == 0
    assert compare_grads(r["tstate"].net, r["jgrads"]) > 0
    compare_states(r["tstate"], r["jstate"])


def test_head_eval_step_matches_jax(head_step):
    r = head_step
    jlogs, jbank, jout = r["jeval"]
    tlogs, tbank, tout = r["teval"]
    ja, ta = jout["aggregated"], tout["aggregated"]
    assert ta["vote_rounds"] == r["eval_rounds"]
    for key in ("instance_masks", "valid", "class_ids", "cc_labels", "win_ratio"):
        np.testing.assert_array_equal(ta[key].numpy(), np.asarray(ja[key]), err_msg=key)
    np.testing.assert_allclose(ta["xy"].numpy(), np.asarray(ja["xy"]), atol=XY_BAND)
    compare_logs(tlogs, jlogs, loose={"xy/loss_xy": 2 * XY_BAND})
    # the pose metric bank: the degree, IoU and offset sums of the matched
    # instances (offsets follow the voted centres: the C4 band)
    jvals, tvals = JM.compute_pose_metric_bank(jbank), TM.compute_pose_metric_bank(tbank)
    for key in jvals:
        if "offset" in key:
            continue
        close(tvals[key], jvals[key], key, atol=ATOL, rtol=RTOL)
    assert float(tbank["degree_error"]["total"]) == float(jbank["degree_error"]["total"]) > 0
