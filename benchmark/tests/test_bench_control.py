"""What `correct` must refuse, at the small size on the CPU, with the
harness's look for a card skipped: the control (the reference in a lower
precision put in the program's place: TF32 for the float32 server, fp8 for
the bfloat16 trainers) and each fault the cell can have, planted where the
answer is produced."""

from __future__ import annotations

import pytest

from conftest import small_run


@pytest.mark.parametrize("workload,control", [("r18-serve", "tf32"),
                                              ("r18-train-head", "fp8"),
                                              ("r50-train-mask", "fp8")])
def test_the_control_is_not_correct(workload, control):
    result = small_run(workload, 11, "cpu", "--control", control)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload,fault", [("r18-serve", "count"),
                                            ("r18-train-head", "count"),
                                            ("r18-train-head", "state_unchanged"),
                                            ("r18-train-head", "half_batch"),
                                            ("r50-train-mask", "state_unchanged"),
                                            ("r50-train-mask", "half_batch")])
def test_a_fault_is_not_correct(workload, fault):
    result = small_run(workload, 12, "cpu", "--fault", fault)
    assert not result["correct"], result["checks"]
