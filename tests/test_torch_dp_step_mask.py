"""One MASK_TRAINING train step of the global batch over 2 data-parallel
ranks of the port (gloo processes on the CPU, one thread each), against
the JAX step jitted over `make_mesh(2)` with the batch sharded and against
the port's single-process step, from one JAX `TrainState` with JAX's
dropout masks (`tests/torch_train_helpers.py::run_dp_step`; 64x64, 3
classes, global batch 4, 2 a rank).

Compared at the golden tolerance (atol 2e-4, rtol 1e-4): every log (the
global batch's), the updated parameters and BatchNorm statistics (of the
global batch) and Lookahead's slow weights; RAdam's moments and, against
the single process, the gradients in L2 per tensor
(`torch_train_helpers.GRAD_REL`); counts exactly; and the state bit-equal
on both ranks.
"""

import pytest

from fastposecnn_tpu import config as JC
from torch_train_helpers import compare_dp, run_dp_step


@pytest.fixture(scope="module")
def mask_dp():
    return run_dp_step(JC.mask_training)


def test_mask_dp_step_matches_jax_mesh_and_one_process(mask_dp):
    r = mask_dp
    state = compare_dp(r, num_classes=3)
    assert r["dp"][0]["logs"]["grad/finite"] == 1.0 and state.skipped_updates == 0
    assert "quaternion/loss_quat" not in r["dp"][0]["logs"]
    # no loss reaches the frozen heads, on the ranks as in one process
    assert state.net.rotation_head[0].weight.grad is None
