"""Port parity for the train CLI's staged and folder paths
(`fastposecnn_tpu_torch/cli/train.py` with `train/staged.py`,
`data/bank_pool.py` and `data/nocs.py`), on the CPU at 64x64
(MASK_TRAINING, MAX_INSTANCES 4, MAX_VOTE_POINTS 128, 32 hypotheses): the
non-slow counterparts of the four slow CLI tests of `tests/test_staged.py`
(:54-78, 98-170, 195-228) with their flags and log-line asserts (end to
end, a restage that regenerates, an npz snapshot written mid-run, a bank
pool reused across runs), plus `--device cpu` and the staging workers;
`--train_dir`/`--valid_dir` through the streaming trainer and
`cli/evaluate.py`; `--NUM_DEVICES` above 1 only warned about by the
staged trainer (which trains on one device). The losses of these runs
are only checked finite; the evaluate CLI's folder summary equals the
in-memory one exactly.
"""

import dataclasses
import re
import shutil

import pytest
import torch

from fastposecnn_tpu_torch import config as C
from fastposecnn_tpu_torch.cli import evaluate as tev
from fastposecnn_tpu_torch.cli import train as tcli
from fastposecnn_tpu_torch.data import nocs_writer as twriter
from fastposecnn_tpu_torch.data import synthetic as tsyn
from fastposecnn_tpu_torch.train import checkpoint as tckpt

SMALL = ["--IMAGE_HEIGHT", "64", "--IMAGE_WIDTH", "64", "--BATCH_SIZE", "2",
         "--MAX_INSTANCES", "4", "--MAX_VOTE_POINTS", "128",
         "--HV_NUM_OF_HYPOTHESES", "32", "--no_tb", "--device", "cpu"]


@pytest.fixture(autouse=True)
def one_torch_thread(tmp_path):
    """Small tensors: one intra-op thread each (the suite runs in several
    worker processes at once). Afterwards the test's files go: a full
    checkpoint of the network is about 300 MB."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    shutil.rmtree(tmp_path, ignore_errors=True)


def bank(root, n, seed, cfg):
    return twriter.write_synthetic_nocs(root, n, seed, tsyn.SceneConfig(**cfg))


def run_log(run_dir):
    return (run_dir / "run.log").read_text()


def run_cli(args, monkeypatch, tmp_path):
    monkeypatch.setenv("LOGS", str(tmp_path / "logs"))
    return tcli.main(args + SMALL)


def test_staged_cli_end_to_end(tmp_path, monkeypatch, capsys):
    """Stage, epochs, plateau, checkpoints through the CLI with a staging
    pool of 2 workers; finite losses; the checkpoints load. `--NUM_DEVICES
    2` is warned about, as the JAX CLI does."""
    state, run_dir = run_cli([
        "-e", "STAGED", "--preset", "MASK_TRAINING", "--synthetic", "6",
        "--TRAIN_SIZE", "6", "--VALID_SIZE", "3", "--epochs", "2", "--stage_on_device",
        "--NUM_WORKERS", "2", "--NUM_DEVICES", "2"], monkeypatch, tmp_path)
    assert "--stage_on_device trains on a SINGLE device; --NUM_DEVICES 2 is ignored" in (
        capsys.readouterr().out)
    log = run_log(run_dir)
    assert "staged (device-resident) trainer" in log
    assert "epoch 1: val_loss=" in log
    assert not any("nan" in ln for ln in log.splitlines() if "val_loss" in ln)
    n_train = int(re.search(r"staged (\d+) train \+ \d+ valid samples", log).group(1))
    for name in ("best", "last"):
        assert (run_dir / "checkpoints" / name).exists()
    steps = 2 * (n_train // 2)
    assert state.step == steps and tckpt.latest_step(run_dir / "checkpoints" / "last") == steps
    resumed, _ = run_cli(["-e", "STAGED2", "--preset", "MASK_TRAINING", "--synthetic", "6",
                          "--TRAIN_SIZE", "6", "--VALID_SIZE", "3", "--epochs", "1",
                          "--stage_on_device", "--NUM_WORKERS", "1",
                          "--resume", str(run_dir / "checkpoints" / "last")],
                         monkeypatch, tmp_path)
    assert resumed.step == resumed.opt_state.count == steps + n_train // 2


REGEN = ["--preset", "MASK_TRAINING", "--synthetic", "4", "--TRAIN_SIZE", "4",
         "--VALID_SIZE", "2", "--epochs", "3", "--stage_on_device", "--restage_every", "2",
         "--CKPT_SAVE_FREQUENCY", "100", "--NUM_WORKERS", "1"]


def test_staged_cli_restage_regenerates_fresh_scenes(tmp_path, monkeypatch):
    """--restage_every with --synthetic moves onto a fresh bank (read on the
    background prefetch thread), after the pending best is flushed; the
    staged plateau defaults apply."""
    _, run_dir = run_cli(["-e", "REGEN", *REGEN], monkeypatch, tmp_path)
    log = run_log(run_dir)
    assert "restaged 4 train samples (4 generated) at epoch 2" in log
    assert "background prefetch" in log
    assert "flushed best checkpoint before restage at epoch 2" in log
    hp = C.HParams.load(run_dir / "HPARAM.json")
    assert (hp.PLATEAU_PATIENCE, hp.PLATEAU_FACTOR) == (C.STAGED_PLATEAU_PATIENCE,
                                                        C.STAGED_PLATEAU_FACTOR)


def test_staged_cli_snapshot_npz_written_mid_run(tmp_path, monkeypatch):
    """--snapshot_npz is written by the flush thread during the run and once
    more at the end; it restores into a fresh state with finite weights."""
    snap = tmp_path / "snap.npz"
    _, run_dir = run_cli(["-e", "SNAP", *REGEN, "--snapshot_npz", str(snap)],
                         monkeypatch, tmp_path)
    log = run_log(run_dir)
    assert "durable npz snapshot refreshed" in log
    assert "final durable npz snapshot" in log
    assert snap.exists()
    hp = dataclasses.replace(tckpt.merge_arch_from_any(snap, C.evaluating()),
                             IMAGE_HEIGHT=64, IMAGE_WIDTH=64)
    from fastposecnn_tpu_torch.models import PoseRegressorNet

    net = PoseRegressorNet(hp.num_classes)
    tckpt.load_weights(net, snap, hp)
    assert all(torch.isfinite(v).all() for v in net.state_dict().values()
               if v.is_floating_point())


def test_bank_pool_dir_persists_across_runs(tmp_path, monkeypatch):
    """--bank_pool_dir: a relaunched run adopts the banks already rendered,
    clears an orphaned partial render, and keeps train/valid."""
    pool_dir = tmp_path / "pool"
    args = [*REGEN, "--bank_pool_dir", str(pool_dir)]
    run_cli(["-e", "POOL1"] + args, monkeypatch, tmp_path)

    def whole_banks():
        return {d.name for d in pool_dir.glob("bank_[0-9]*") if not d.name.endswith(".part")}

    first = whole_banks()
    assert (pool_dir / "train" / ".complete").exists()
    assert (pool_dir / "valid" / ".complete").exists()
    (pool_dir / "bank_7.part").mkdir()
    run_cli(["-e", "POOL2"] + args, monkeypatch, tmp_path)
    assert not (pool_dir / "bank_7.part").exists()
    assert first <= whole_banks()
    assert len(sorted((tmp_path / "logs").rglob("run.log"))) == 2


def test_folders_in_streaming_trainer_and_evaluate(tmp_path, monkeypatch):
    """--train_dir/--valid_dir through the streaming trainer, and --valid_dir
    through the evaluate CLI, which gives the summary of the in-memory
    scenes of the same seed."""
    cfg = dict(height=64, width=64, num_classes=7, max_instances=4)
    train_dir, valid_dir = bank(tmp_path / "train", 4, 0, cfg), bank(tmp_path / "v", 3, 7, cfg)
    state, run_dir = run_cli(["-e", "FOLDERS", "--preset", "MASK_TRAINING",
                              "--train_dir", str(train_dir), "--valid_dir", str(valid_dir),
                              "--epochs", "1", "--NUM_WORKERS", "2"], monkeypatch, tmp_path)
    assert re.search(r"epoch 0: val_loss=\d", run_log(run_dir))
    assert "staged (device-resident)" not in run_log(run_dir)
    assert state.step == 2
    ev = ["--IMAGE_HEIGHT", "64", "--IMAGE_WIDTH", "64", "--MAX_INSTANCES", "4",
          "--MAX_VOTE_POINTS", "128", "--HV_NUM_OF_HYPOTHESES", "64", "--device", "cpu",
          "--CHECKPOINT", str(run_dir / "checkpoints" / "last")]
    from_folder = tev.main(ev + ["--valid_dir", str(valid_dir), "--output",
                                 str(tmp_path / "ev_folder")])
    in_memory = tev.main(ev + ["--synthetic", "3", "--synthetic_seed", "7", "--output",
                               str(tmp_path / "ev_memory")])
    assert from_folder["frames"] == in_memory["frames"] == 3
    assert from_folder["instances"] == in_memory["instances"]
    assert from_folder["table_aps_mean"] == in_memory["table_aps_mean"]


@pytest.mark.parametrize("flags", [["--synthetic", "4"], ["--train_dir", "t", "--valid_dir", "v"]])
def test_streaming_trainer_refuses_num_devices(flags, tmp_path, monkeypatch):
    """The streaming trainer trains data-parallel (`test_torch_dp_cli.py`)
    but refuses ranks that do not divide the batch, before it reads or
    writes anything."""
    with pytest.raises(ValueError, match="BATCH_SIZE=2 does not split over --NUM_DEVICES 4"):
        run_cli([*flags, "--NUM_DEVICES", "4", "--epochs", "1"], monkeypatch, tmp_path)
    assert not (tmp_path / "logs").exists()


def test_no_dataset_is_refused(tmp_path, monkeypatch):
    monkeypatch.delenv("NOCS_CAMERA_TRAIN_DATASET", raising=False)
    monkeypatch.delenv("NOCS_CAMERA_VALID_DATASET", raising=False)
    with pytest.raises(SystemExit, match="No dataset"):
        run_cli(["--epochs", "1"], monkeypatch, tmp_path)
    with pytest.raises(SystemExit, match="No dataset"):
        run_cli(["--train_dir", str(tmp_path), "--epochs", "1"], monkeypatch, tmp_path)
