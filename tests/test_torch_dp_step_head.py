"""One HEAD_TRAINING train step and one eval step of the global batch over
2 data-parallel ranks of the port (gloo processes on the CPU, one thread
each), against the JAX step jitted over `make_mesh(2)` with the batch
sharded and against the port's single-process steps, from one JAX
`TrainState` with JAX's dropout masks and vote draws of the global batch
(`tests/torch_train_helpers.py::run_dp_step`; 64x64, 3 classes,
MAX_INSTANCES 4, MAX_VOTE_POINTS 128, 32 hypotheses, adaptive RANSAC,
global batch 4, 2 a rank).

Compared: as the MASK step (`test_torch_dp_step_mask.py`), with the
matched xy loss against JAX within 0.1 (the ROADMAP.md C4 band of
`test_torch_train_step_head.py`); the adaptive rounds exactly equal on
every rank, in one process and in JAX (counted by a debug callback); the
eval step's logs and pose metric bank (the global batch's) at the golden
tolerance, its win ratios and validity exactly equal to one process's and
its centres within the same 0.05 px band: the network's float32 fields at
batch 2 and at batch 4 differ in their last bits (the CPU's convolutions
block the batch differently), and the dense least-squares refinement over
every mask pixel moves the centres by up to 1e-2 px with them.

The same fixture runs the step and the eval step over 4 ranks laid out as
`make_mesh(4, tp=2)` (dp 2 x tp 2) with the state `shard_state_tp`'d at
min_channels 16 (`run_dp_step(tp=2)`), and holds them to the same bounds
against the same JAX step over `make_mesh(2)` and one process: JAX's own
`test_tp_sharded_matches_replicated` (`tests/test_train.py:123-160`,
`slow`) shows its tp step to be the replicated one within rtol 1e-4, so
the JAX step is not compiled again over a (2, 2) mesh. The port's rule is
held against the JAX `shard_state_tp` placing the same state over that
mesh (device_put only): the same parameters and optimizer leaves sharded,
and each rank's tensors bit-equal to its device's shards.
"""

import numpy as np
import pytest
import torch

from fastposecnn_tpu import config as JC
from fastposecnn_tpu_torch import metrics as TM
from torch_train_helpers import close, compare_dp, compare_logs, run_dp_step

XY_BAND = 0.05  # px, ROADMAP.md C4


@pytest.fixture(scope="module")
def head_dp():
    return run_dp_step(JC.head_training, with_eval=True, tp=2)


def test_head_dp_step_matches_jax_mesh_and_one_process(head_dp):
    r = head_dp
    compare_dp(r, num_classes=3, loose={"xy/loss_xy": 2 * XY_BAND})
    rounds = int(r["single"]["logs"]["pose/vote_rounds"])
    assert 1 <= rounds <= 20 and r["jax_rounds"] == rounds
    assert [d["rounds"] for d in r["dp"]] == [rounds] * len(r["dp"])
    assert r["dp"][0]["logs"]["pose/num_matched"] == float(
        r["single"]["logs"]["pose/num_matched"]) > 0


def test_head_dp_eval_step_matches_one_process(head_dp):
    r = head_dp
    single, ranks = r["single"]["eval"], [d["eval"] for d in r["dp"]]
    assert {e["rounds"] for e in ranks} == {single["out"]["vote_rounds"]}
    for key in ("valid", "win_ratio"):
        np.testing.assert_array_equal(np.concatenate([e[key] for e in ranks]),
                                      single["out"][key].numpy(), err_msg=key)
    np.testing.assert_allclose(np.concatenate([e["xy"] for e in ranks]),
                               single["out"]["xy"].numpy(), atol=XY_BAND, rtol=0)
    for e in ranks:  # every rank logs the global batch
        compare_logs(e["logs"], {k: float(v) for k, v in single["logs"].items()})
        want = TM.compute_pose_metric_bank(single["bank"])
        got = TM.compute_pose_metric_bank(
            {k: {f: torch.tensor(v) for f, v in s.items()}
             for k, s in e["bank"].items()})
        for key in want:
            close(got[key], want[key], key)
    assert float(single["bank"]["degree_error"]["total"]) > 0


def full_shapes(state):
    o = state.opt_state
    return {**{k: tuple(v.shape) for k, v in state.net.state_dict().items()},
            **{f"{part}/{k}": tuple(v.shape) for part in ("mu", "nu", "slow")
               for k, v in getattr(o, part).items()}}


def test_tp_rule_shards_what_jax_shard_state_tp_shards(head_dp):
    """The port's `shard_state_tp` against JAX's (torch's [cout, cin, kh,
    kw] cut on dim 0, JAX's kernel on its last axis): the same sharded
    parameters and optimizer leaves, names and full shapes, and every
    rank's tensors bit-equal to its device's shards."""
    n_sharded, jax_ranks = head_dp["jax_shards"]
    full = full_shapes(head_dp["single"]["state"])
    jax_set = {k: full[k] for k, (shape, _) in jax_ranks[0].items() if shape != full[k]}
    params = {k for k in jax_set if "/" not in k}
    assert len(params) == n_sharded == 64  # min_channels 16: all but the 4 heads
    for part in ("mu", "nu", "slow"):
        assert {k.split("/", 1)[1] for k in jax_set if k.startswith(part)} == params
    for r, (rank, want) in enumerate(zip(head_dp["tp"], jax_ranks, strict=True)):
        got = rank["shards"]
        assert set(got) == set(want) == set(full)
        assert {k: full[k] for k, (_, sharded, _) in got.items() if sharded} == jax_set
        for k, (shape, _, digest) in got.items():
            assert (shape, digest) == want[k], f"rank {r}: {k}"
        for k in jax_set:
            assert got[k][0] == (full[k][0] // 2, *full[k][1:]), k


def test_head_tp_step_matches_jax_mesh_and_one_process(head_dp):
    r = head_dp
    compare_dp(r, num_classes=3, loose={"xy/loss_xy": 2 * XY_BAND}, key="tp")
    single = {k: float(v) for k, v in r["single"]["logs"].items()}
    rounds = int(single["pose/vote_rounds"])
    assert [d["rounds"] for d in r["tp"]] == [rounds] * 4 and r["jax_rounds"] == rounds
    assert [d["coords"] for d in r["tp"]] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for d in r["tp"]:  # every rank logs the global batch
        compare_logs(d["logs"], single)


def test_head_tp_eval_step_matches_one_process(head_dp):
    r = head_dp
    single = r["single"]["eval"]
    by_tp = [[d["eval"] for d in r["tp"] if d["coords"][1] == t] for t in (0, 1)]
    assert {e["rounds"] for e in by_tp[0] + by_tp[1]} == {single["out"]["vote_rounds"]}
    for ranks in by_tp:  # the dp ranks of each tp index, in row order
        for key in ("valid", "win_ratio"):
            np.testing.assert_array_equal(np.concatenate([e[key] for e in ranks]),
                                          single["out"][key].numpy(), err_msg=key)
        np.testing.assert_allclose(np.concatenate([e["xy"] for e in ranks]),
                                   single["out"]["xy"].numpy(), atol=XY_BAND, rtol=0)
    for a, b in zip(*by_tp):  # a tp group's ranks compute alike
        for key in ("valid", "win_ratio", "xy"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    want = TM.compute_pose_metric_bank(single["bank"])
    for e in by_tp[0] + by_tp[1]:
        compare_logs(e["logs"], {k: float(v) for k, v in single["logs"].items()})
        got = TM.compute_pose_metric_bank(
            {k: {f: torch.tensor(v) for f, v in s.items()} for k, s in e["bank"].items()})
        for key in want:
            close(got[key], want[key], key)
