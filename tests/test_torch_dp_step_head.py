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
    return run_dp_step(JC.head_training, with_eval=True)


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
