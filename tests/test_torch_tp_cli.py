"""The evaluate CLI over tensor-parallel ranks on the CPU (gloo): phase A
with `--NUM_DEVICES 2 --NUM_TP 2` (dp 1 x tp 2, the network's 59 wide
convolutions sharded over the two ranks) gives the single-device raw
errors (rtol/atol 1e-4, the tolerance of the JAX package's slow
`tests/test_eval_dp.py`) and the same vote rounds; a `BATCH_SIZE` that
dp = NUM_DEVICES // NUM_TP does not divide falls back to one device with
the JAX CLI's warning (`fastposecnn_tpu/cli/evaluate.py:330-338`), and a
`--NUM_TP` that does not divide `--NUM_DEVICES` raises. The train CLI's
`--NUM_TP` run is `test_torch_dp_cli.py::test_train_cli_refuses_tensor_parallelism`.
"""

import pytest
import torch

from fastposecnn_tpu_torch.cli import evaluate as tev
from test_torch_dp_cli import EVAL
from torch_cleanup import tmp_path  # noqa: F401  (removed after each test)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_evaluate_phase_a_over_tp_ranks_equals_one_device(tmp_path, capsys):
    import numpy as np

    one = tev.main([*EVAL, "--output", str(tmp_path / "one")])
    tp = tev.main([*EVAL, "--output", str(tmp_path / "tp"), "--NUM_DEVICES", "2",
                   "--NUM_TP", "2"])
    assert "phase A: data-parallel over {'dp': 1, 'tp': 2} mesh" in capsys.readouterr().out
    assert one["frames"] == tp["frames"] == 8 and one["vote_rounds"] == tp["vote_rounds"]
    want = tev.load_raw(tmp_path / "one" / "raw_errors_10000.npz")
    got = tev.load_raw(tmp_path / "tp" / "raw_errors_10000.npz")
    assert sum(v.size for v in want["degree_error"].values()) == one["instances"] > 0
    for metric, per_class in want.items():
        for c, values in per_class.items():
            np.testing.assert_allclose(got[metric][c], values, rtol=1e-4, atol=1e-4,
                                       err_msg=f"{metric} {c}")


def test_evaluate_tp_layout_falls_back_or_raises(tmp_path, capsys):
    summary = tev.main([*EVAL, "--BATCH_SIZE", "3", "--output", str(tmp_path / "a"),
                        "--NUM_DEVICES", "4", "--NUM_TP", "2"])
    out = capsys.readouterr().out
    assert ("BATCH_SIZE=3 is not divisible by dp=4//NUM_TP(2)=2" in out
            and "data-parallel" not in out and summary["frames"] == 8)
    with pytest.raises(ValueError, match="dp=1 x tp=3 is not the 4 ranks"):
        tev.main([*EVAL, "--output", str(tmp_path / "b"), "--NUM_DEVICES", "4",
                  "--NUM_TP", "3"])
