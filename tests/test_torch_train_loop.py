"""Port parity for the epoch loop (`fastposecnn_tpu_torch/train/loop.py`)
and the train CLI (`cli/train.py`).

The loop against the JAX package's `fit` on the same augmented sources,
2 epochs, with the train and eval steps of both replaced by a recording
stub (on the JAX side through monkeypatches of its loop module:
`make_train_step`, `make_eval_step`, its `jax` through a shim whose `jit`
is the identity, and `checkpoint.save_checkpoint`; no JAX step is
compiled): the same batches in the same order, with the same padding and
`sample_valid`; the same real-sample-weighted validation losses, plateau
scales, and checkpoint kinds at the same steps. Then the real port CLI on
the CPU (64x64, 3 classes, MAX_INSTANCES 4, MAX_VOTE_POINTS 128, 32
hypotheses; `--synthetic` writes NOCS folders and reads them back):
MASK_TRAINING for 2 epochs and HEAD_TRAINING for 1, resumes from
`checkpoints/last` and from an npz snapshot, the refused `--NUM_TP`, and
the error without CUDA.
Tolerance: exact (batches, losses, scales, steps).
"""

import dataclasses
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastposecnn_tpu import config as JC
from fastposecnn_tpu.data import loader as jloader
from fastposecnn_tpu.data import nocs as jnocs
from fastposecnn_tpu.data import synthetic as jsyn
from fastposecnn_tpu.data.nocs_writer import write_synthetic_nocs
from fastposecnn_tpu.train import checkpoint as jckpt
from fastposecnn_tpu.train import loop as jloop
from fastposecnn_tpu_torch import config as C
from fastposecnn_tpu_torch.cli import train as tcli
from fastposecnn_tpu_torch.data import loader as tloader
from fastposecnn_tpu_torch.data import nocs as tnocs
from fastposecnn_tpu_torch.data import synthetic as tsyn
from fastposecnn_tpu_torch.train import checkpoint as tckpt
from fastposecnn_tpu_torch.train import loop as tloop
from torch_cleanup import tmp_path  # noqa: F401  (removed after each test)

SMALL = ["--IMAGE_HEIGHT", "64", "--IMAGE_WIDTH", "64", "--BATCH_SIZE", "2",
         "--SELECTED_CLASSES", "bg", "bottle", "bowl", "--MAX_INSTANCES", "4",
         "--MAX_VOTE_POINTS", "128", "--HV_NUM_OF_HYPOTHESES", "32", "--NUM_WORKERS", "2",
         "--no_tb", "--device", "cpu"]



@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small tensors: one intra-op thread each (the suite runs in several
    worker processes at once, and spinning thread pools oversubscribe the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

class Recorder:
    """A stub train and eval step for one package: records each batch (as
    numpy) and returns a step count one higher, and a validation loss that
    depends on the batch and grows with each call (so the plateau scale
    falls at patience 0)."""

    def __init__(self):
        self.train, self.eval, self.saves, self.plateau = [], [], [], []

    @staticmethod
    def arrays(batch):
        out = {k: np.array(batch[k]) for k in ("image", "mask", "sample_valid")}
        out.update({f"agg/{k}": np.array(v) for k, v in batch["agg"].items()})
        return out

    def train_logs(self, batch):
        self.train.append(self.arrays(batch))
        return np.float32(np.asarray(batch["image"], np.float64).mean() / 255.0)

    def eval_loss(self, batch):
        self.eval.append(self.arrays(batch))
        img = np.asarray(batch["image"], np.float64)
        real = np.asarray(batch["sample_valid"]) > 0
        return np.float32(img[real].mean() / 255.0 + len(self.eval))


def sources(tmp_path):
    """The same augmented train (7 scenes) and valid (5 scenes) samples for
    both packages; batch 3 leaves a short last batch in each."""
    cfg = dict(height=64, width=64, num_classes=3, max_instances=4, max_scene_instances=2,
               box_half_extent=(4, 9))
    common = dict(selected_classes=("bg", "bottle", "bowl"), max_instances=4)
    jax_ds, port_ds = [], []
    for split, n, seed, aug in (("train", 7, 0, "train"), ("valid", 5, 1, "valid")):
        root = write_synthetic_nocs(tmp_path / split, n, seed, jsyn.SceneConfig(**cfg))
        jax_ds.append(jnocs.NOCSDataset(root, augmentation=aug, **common))
        port_ds.append(tnocs.SyntheticNOCSSource(n, seed, tsyn.SceneConfig(**cfg),
                                                 augmentation=aug, **common))
    assert [len(d) for d in jax_ds] == [len(d) for d in port_ds] == [7, 5]
    return jax_ds, port_ds


def test_fit_matches_jax_with_stub_steps(tmp_path, monkeypatch):
    jax_ds, port_ds = sources(tmp_path)
    kw = dict(SELECTED_CLASSES=("bg", "bottle", "bowl"), IMAGE_HEIGHT=64, IMAGE_WIDTH=64,
              MAX_INSTANCES=4, BATCH_SIZE=3, PLATEAU_PATIENCE=0, CKPT_SAVE_FREQUENCY=1)
    jhp = dataclasses.replace(JC.mask_training(), **kw)
    thp = C.mask_training(**kw)
    inv_k = np.eye(3)

    # ---- JAX fit, stubbed ----
    jrec = Recorder()

    def jax_train_step(state, db, rng):
        return state._replace(step=state.step + 1), {
            "pose/total_loss": jnp.asarray(jrec.train_logs(db)), "grad/finite": jnp.ones(())}

    def jax_eval_step(state, db, key, bank):
        return {"pose/total_loss": jnp.asarray(jrec.eval_loss(db))}, bank, {}

    real_plateau = jloop.optim.plateau_update

    def jax_plateau(state, metric, **kw_):
        out = real_plateau(state, metric, **kw_)
        jrec.plateau.append((float(metric), float(out.scale)))
        return out

    shim = types.SimpleNamespace(**{k: getattr(jax, k) for k in ("devices", "random",
                                                                  "device_get",
                                                                  "default_backend")},
                                 jit=lambda f: f)
    monkeypatch.setattr(jloop, "jax", shim)
    monkeypatch.setattr(jloop, "make_train_step", lambda *a: jax_train_step)
    monkeypatch.setattr(jloop, "make_eval_step", lambda *a: jax_eval_step)
    monkeypatch.setattr(jloop.optim, "plateau_update", jax_plateau)
    monkeypatch.setattr(jckpt, "save_checkpoint",
                        lambda d, step, state, hp: jrec.saves.append((d.name, int(step))))
    (tmp_path / "jax_run").mkdir()
    jloop.fit(jhp, jloader.PrefetchLoader(jax_ds[0], 3, shuffle=True, num_workers=2),
              jloader.PrefetchLoader(jax_ds[1], 3, shuffle=False, num_workers=2), inv_k,
              run_dir=tmp_path / "jax_run", enable_tb=False, num_epochs=2, visualize_every=0)

    # ---- port fit, stubbed ----
    trec = Recorder()

    def port_train_step(state, batch, seed=0):
        return dataclasses.replace(state, step=state.step + 1), {
            "pose/total_loss": torch.tensor(trec.train_logs(batch)),
            "grad/finite": torch.ones(())}

    def port_eval_step(state, batch, bank, seed=0):
        return {"pose/total_loss": torch.tensor(trec.eval_loss(batch))}, bank, None

    real_tplateau = tloop.optim.plateau_update

    def port_plateau(state, metric, **kw_):
        out = real_tplateau(state, metric, **kw_)
        trec.plateau.append((float(metric), out.scale))
        return out

    monkeypatch.setattr(tloop, "make_train_step", lambda *a: port_train_step)
    monkeypatch.setattr(tloop, "make_eval_step", lambda *a: port_eval_step)
    monkeypatch.setattr(tloop.optim, "plateau_update", port_plateau)
    monkeypatch.setattr(tckpt, "save_checkpoint",
                        lambda d, step, state, hp: trec.saves.append((d.name, int(step))))
    state, run_dir = tloop.fit(
        thp, tloader.PrefetchLoader(port_ds[0], 3, shuffle=True, num_workers=2),
        tloader.PrefetchLoader(port_ds[1], 3, shuffle=False, num_workers=2), inv_k,
        run_dir=tmp_path / "port_run", device="cpu", enable_tb=False, num_epochs=2)

    assert state.step == 6 and len(trec.train) == len(jrec.train) == 6
    assert len(trec.eval) == len(jrec.eval) == 4
    for kind in ("train", "eval"):
        for i, (got, want) in enumerate(zip(getattr(trec, kind), getattr(jrec, kind))):
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, (kind, i, k)
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{kind} {i} {k}")
    assert [b["sample_valid"].tolist() for b in trec.eval] == [[1, 1, 1], [1, 1, 0]] * 2
    assert trec.plateau == jrec.plateau
    assert [s for _, s in trec.plateau] == [1.0, 0.25]
    assert trec.saves == jrec.saves == [("best", 3), ("periodic", 3), ("periodic", 6),
                                        ("last", 6)]
    log = (run_dir / "run.log").read_text()
    assert len(re.findall(r"epoch \d: val_loss=", log)) == 2


def run_cli(args, monkeypatch, tmp_path):
    monkeypatch.setenv("LOGS", str(tmp_path / "logs"))
    return tcli.main(args + SMALL)


def epoch_lines(run_dir):
    return re.findall(r"epoch (\d+): val_loss=(\S+) lr_scale=(\S+) skipped=(\d+)",
                      (run_dir / "run.log").read_text())


@pytest.mark.parametrize("preset,epochs", [("MASK_TRAINING", 2), ("HEAD_TRAINING", 1)])
def test_cli_trains_on_cpu(preset, epochs, tmp_path, monkeypatch):
    state, run_dir = run_cli(["-e", f"T{preset}", "--preset", preset, "--synthetic", "4",
                              "--epochs", str(epochs)], monkeypatch, tmp_path)
    assert C.HParams.load(run_dir / "HPARAM.json").IMAGE_HEIGHT == 64
    lines = epoch_lines(run_dir)
    assert [int(e) for e, *_ in lines] == list(range(epochs))
    assert all(np.isfinite(float(v)) and s == "0" for _, v, _, s in lines)
    steps = epochs * 2  # 4 scenes at batch 2
    assert state.step == steps and state.skipped_updates == 0
    assert tckpt.latest_step(run_dir / "checkpoints" / "last") == steps
    assert tckpt.latest_step(run_dir / "checkpoints" / "best") is not None
    assert (tckpt.latest_step(run_dir / "checkpoints" / "periodic")
            == (steps if epochs >= 2 else None))


def test_cli_resumes_from_last_and_from_npz(tmp_path, monkeypatch):
    base = ["--preset", "MASK_TRAINING", "--synthetic", "4"]
    state, run_dir = run_cli(["-e", "FIRST", *base, "--epochs", "1"], monkeypatch, tmp_path)
    last = run_dir / "checkpoints" / "last"
    assert tckpt.latest_step(last) == 2

    # Full resume: the step count goes on; the optimizer comes back.
    resumed, run2 = run_cli(["-e", "SECOND", *base, "--epochs", "1", "--resume", str(last)],
                            monkeypatch, tmp_path)
    assert resumed.step == 4 and resumed.opt_state.count == 4
    assert tckpt.latest_step(run2 / "checkpoints" / "last") == 4
    assert "resumed from" in (run2 / "run.log").read_text()

    # Weights-only resume from an npz the port wrote: the first step starts
    # from the snapshot's weights with slow weights equal to them and a
    # fresh RAdam count.
    snap = tmp_path / "snap.npz"
    tckpt.save_npz_snapshot(snap, resumed, C.HParams.load(run2 / "HPARAM.json"))
    seen = {}
    real = tloop.make_train_step

    def spying_make_train_step(*a):
        step = real(*a)

        def first(state, batch, seed=0):
            if not seen:
                seen.update(params={n: p.detach().clone()
                                    for n, p in state.net.named_parameters()},
                            slow=dict(state.opt_state.slow), count=state.opt_state.count,
                            step=state.step)
            return step(state, batch, seed=seed)
        return first

    monkeypatch.setattr(tloop, "make_train_step", spying_make_train_step)
    from_npz, _ = run_cli(["-e", "THIRD", *base, "--epochs", "1", "--resume", str(snap)],
                          monkeypatch, tmp_path)
    assert (seen["count"], seen["step"]) == (0, 0)
    want = dict(resumed.net.named_parameters())
    for n, p in seen["params"].items():
        assert torch.equal(p, want[n].detach().half().float()), n
        assert torch.equal(seen["slow"][n], p), n
    assert from_npz.step == 2 and from_npz.opt_state.count == 2


@pytest.mark.parametrize("flags", [
    ["--synthetic", "4", "--NUM_DEVICES", "2", "--NUM_TP", "2"],
    ["--synthetic", "4", "--NUM_DEVICES", "4", "--NUM_TP", "2"],
    ["--train_dir", "d", "--valid_dir", "d", "--NUM_DEVICES", "8", "--NUM_TP", "4"],
    ["--synthetic", "4", "--restage_every", "2", "--NUM_DEVICES", "4", "--NUM_TP", "2"],
])
def test_cli_refuses_unported_flags(flags, tmp_path, monkeypatch):
    """What the port's CLI still lacks: tensor parallelism (ROADMAP.md queue
    A item 13; data-parallel `--NUM_DEVICES` is ported,
    `test_torch_dp_cli.py`). `--NUM_TP` above 1 is refused before anything
    is read or written."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A item 13"):
        run_cli(flags, monkeypatch, tmp_path)
    assert not (tmp_path / "logs").exists()


def test_cli_needs_cuda_or_device_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in SMALL if a not in ("--device", "cpu")]
    monkeypatch.setenv("LOGS", str(tmp_path / "logs"))
    with pytest.raises(RuntimeError, match="--device cpu"):
        tcli.main(["--synthetic", "4", "--epochs", "1", *args])
    assert not (tmp_path / "logs").exists()
