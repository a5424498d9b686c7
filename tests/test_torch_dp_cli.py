"""The port's data-parallel entry points on the CPU (gloo ranks): the train
CLI with `--device cpu --NUM_DEVICES 2` (one HEAD_TRAINING epoch at 64x64,
3 classes, MAX_INSTANCES 4, MAX_VOTE_POINTS 128, 32 hypotheses, global
batch 4) writes one run dir and ends at the parameters, batch statistics
and optimizer state of `--NUM_DEVICES 1` (golden tolerance, atol 2e-4 /
rtol 1e-4), and so does a resume of that run's last checkpoint (loaded on
rank 0 and replicated) for one more epoch; `--NUM_TP 2` is refused; a
card count below `--NUM_DEVICES` falls back to one device with a
warning; `dryrun_multichip(2)` runs. Phase A of the evaluate CLI over 2
ranks gives the single-device raw errors (rtol/atol 1e-4, the tolerance
of the JAX package's slow `tests/test_eval_dp.py`), and falls back with
the JAX CLI's warning when the ranks do not divide the batch.
"""

import pathlib
import shutil

import numpy as np
import pytest
import torch

from fastposecnn_tpu_torch.cli import evaluate as tev
from fastposecnn_tpu_torch.cli import train as tcli
from fastposecnn_tpu_torch.parallel import dryrun
from torch_cleanup import tmp_path  # noqa: F401  (removed after each test)

TRAIN = ["--preset", "HEAD_TRAINING", "--synthetic", "6", "--IMAGE_HEIGHT", "64",
         "--IMAGE_WIDTH", "64", "--BATCH_SIZE", "4", "--SELECTED_CLASSES", "bg", "bottle",
         "bowl", "--MAX_INSTANCES", "4", "--MAX_VOTE_POINTS", "128",
         "--HV_NUM_OF_HYPOTHESES", "32", "--NUM_WORKERS", "1", "--epochs", "1", "--no_tb",
         "--device", "cpu"]
EVAL = ["--synthetic", "8", "--IMAGE_HEIGHT", "64", "--IMAGE_WIDTH", "96", "--BATCH_SIZE",
        "4", "--MAX_INSTANCES", "4", "--MAX_VOTE_POINTS", "128", "--HV_NUM_OF_HYPOTHESES",
        "64", "--device", "cpu"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def last_checkpoint(run_dir):
    (path,) = (pathlib.Path(run_dir) / "checkpoints" / "last").glob("step_*.pt")
    return torch.load(path, weights_only=False)


def assert_same_state(got, want, step):
    assert (got["step"], got["skipped_updates"]) == (want["step"], want["skipped_updates"]) == (
        step, 0)
    for name, value in want["state_dict"].items():
        np.testing.assert_allclose(got["state_dict"][name].float().numpy(),
                                   value.float().numpy(), atol=2e-4, rtol=1e-4, err_msg=name)
    for part in ("mu", "slow"):
        for name, value in want["opt_state"][part].items():
            np.testing.assert_allclose(got["opt_state"][part][name].numpy(), value.numpy(),
                                       atol=2e-4, rtol=1e-4, err_msg=f"{part} {name}")


@pytest.fixture(scope="module")
def one_process_run(tmp_path_factory):
    """One epoch of the train CLI in this process (`--NUM_DEVICES 1`)."""
    root, threads = tmp_path_factory.mktemp("one"), torch.get_num_threads()
    patch = pytest.MonkeyPatch()
    patch.setenv("LOGS", str(root))
    torch.set_num_threads(1)
    try:
        _, run_dir = tcli.main(["-e", "ONE", *TRAIN, "--NUM_DEVICES", "1"])
    finally:
        patch.undo()
        torch.set_num_threads(threads)
    yield pathlib.Path(run_dir)
    shutil.rmtree(root, ignore_errors=True)


def test_train_cli_over_two_ranks_ends_where_one_process_does(one_process_run, tmp_path,
                                                              monkeypatch, capfd):
    monkeypatch.setenv("LOGS", str(tmp_path))
    state, two_dir = tcli.main(["-e", "TWO", *TRAIN, "--NUM_DEVICES", "2"])
    out = capfd.readouterr().out  # the ranks print to the process's stdout
    assert out.count("epoch 0: val_loss=") == 1  # rank 0 alone prints
    assert len(list(tmp_path.glob("*/*"))) == 1  # one run dir
    assert "data-parallel over 2 ranks (gloo), 2 samples a rank" in (
        pathlib.Path(two_dir) / "run.log").read_text()
    two = last_checkpoint(two_dir)
    assert_same_state(two, last_checkpoint(one_process_run), step=2)
    # the state comes back from rank 0, on the CPU
    sd = state.net.state_dict()
    for name, want in two["state_dict"].items():
        assert torch.equal(sd[name], want), name


def test_train_cli_resumes_over_two_ranks(one_process_run, tmp_path, monkeypatch):
    """A full checkpoint, loaded on rank 0 and replicated, trains on as it
    does in one process."""
    resume = ["--resume", str(one_process_run / "checkpoints" / "last")]
    ends = []
    for n in (1, 2):
        monkeypatch.setenv("LOGS", str(tmp_path / str(n)))
        _, run_dir = tcli.main(["-e", f"RESUME{n}", *TRAIN, *resume, "--NUM_DEVICES", str(n)])
        ends.append(last_checkpoint(run_dir))
        assert f"resumed from {resume[1]} at step 2" in (
            pathlib.Path(run_dir) / "run.log").read_text()
    assert_same_state(ends[1], ends[0], step=4)


def test_train_cli_refuses_tensor_parallelism(tmp_path, monkeypatch):
    monkeypatch.setenv("LOGS", str(tmp_path / "logs"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tcli.main([*TRAIN, "--NUM_DEVICES", "2", "--NUM_TP", "2"])
    assert not (tmp_path / "logs").exists()


def test_fewer_cards_than_ranks_train_on_one(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tcli.data_parallel_ranks(4, torch.device("cuda")) == 1
    assert "training on a single device" in capsys.readouterr().out
    assert tcli.data_parallel_ranks(4, torch.device("cpu")) == 4


def test_dryrun_multichip(capsys):
    dryrun.dryrun_multichip(2)
    assert "dryrun_multichip(2): ok" in capsys.readouterr().out


def test_evaluate_phase_a_over_two_ranks_equals_one_device(tmp_path, capsys):
    one = tev.main([*EVAL, "--output", str(tmp_path / "one")])
    two = tev.main([*EVAL, "--output", str(tmp_path / "two"), "--NUM_DEVICES", "2"])
    assert "phase A: data-parallel over {'dp': 2, 'tp': 1} mesh" in capsys.readouterr().out
    assert one["frames"] == two["frames"] == 8 and one["vote_rounds"] == two["vote_rounds"]
    want = tev.load_raw(tmp_path / "one" / "raw_errors_10000.npz")
    got = tev.load_raw(tmp_path / "two" / "raw_errors_10000.npz")
    assert sum(v.size for v in want["degree_error"].values()) == one["instances"] > 0
    for metric, per_class in want.items():
        for c, values in per_class.items():
            np.testing.assert_allclose(got[metric][c], values, rtol=1e-4, atol=1e-4,
                                       err_msg=f"{metric} {c}")


def test_evaluate_falls_back_when_ranks_do_not_divide_the_batch(tmp_path, capsys):
    summary = tev.main([*EVAL, "--BATCH_SIZE", "3", "--output", str(tmp_path),
                        "--NUM_DEVICES", "2"])
    out = capsys.readouterr().out
    assert "BATCH_SIZE=3 is not divisible by dp=2" in out and "data-parallel" not in out
    assert summary["frames"] == 8
