"""Port parity for the device-resident staged trainer
(`fastposecnn_tpu_torch/train/staged.py`); the counterparts of
`tests/test_staged.py:11-52, 80-96, 172-330`.

- Helpers against the JAX package's on the same inputs: the three
  `_val_index_plan` cases, `_gather_batch` (padded slots' GT validity
  zeroed), `stage_dataset` serial, through a pool for one call and through
  a long-lived pool that follows the parent's epoch and repoint, and the
  checksums (`host_checksums` equal to the JAX one on the same trees; the
  port's `device_checksums` equal to it; one flipped bit found in one
  array; three mismatched uploads raise).
- The loop against the JAX `fit_staged`, both packages' train and eval
  steps replaced by one recording stub (the JAX module's `jax` through a
  shim whose `jit` is the identity and whose `lax.scan` is a Python loop;
  orbax saves and npz snapshots recorded, not written): the batches of
  every step and every validation batch, the plateau scale of each epoch,
  the flush schedule (tags and steps), the restage epochs (a regenerated
  bank of another size resampled cyclically), the epoch lines and a fault
  batch's file.
- A kept best still holds its epoch's weights, BatchNorm statistics and
  optimizer state after later epochs change the network in place.
The train CLI's staged and folder paths are in `test_torch_staged_cli.py`.
Tolerance: exact.
"""

import dataclasses
import logging
import re
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastposecnn_tpu import config as JC
from fastposecnn_tpu.data import nocs as jnocs
from fastposecnn_tpu.train import checkpoint as jckpt
from fastposecnn_tpu.train import staged as jstaged
from fastposecnn_tpu_torch import config as C
from fastposecnn_tpu_torch.data import nocs as tnocs
from fastposecnn_tpu_torch.data import nocs_writer as twriter
from fastposecnn_tpu_torch.data import synthetic as tsyn
from fastposecnn_tpu_torch.train import checkpoint as tckpt
from fastposecnn_tpu_torch.train import staged as tstaged
from fastposecnn_tpu_torch.train.task import TrainState

CFG = dict(height=48, width=64, num_classes=3, max_instances=4, max_scene_instances=2,
           box_half_extent=(4, 9))
CLASSES = ("bg", "bottle", "bowl")


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


def bank(root, n, seed, cfg=CFG):
    return twriter.write_synthetic_nocs(root, n, seed, tsyn.SceneConfig(**cfg))


def assert_trees_equal(got, want, what=""):
    assert sorted(got) == sorted(want), what
    for k in want:
        if isinstance(want[k], dict):
            assert_trees_equal(got[k], want[k], f"{what}/{k}")
        else:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.dtype == w.dtype, (what, k, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=f"{what}/{k}")


# -----------------------------------------------------------------------------
# Helpers


@pytest.mark.parametrize("n,b,shape,real", [(8, 4, (2, 4), 8), (5, 4, (2, 4), 5),
                                            (1, 4, (1, 4), 1)])
def test_val_index_plan(n, b, shape, real):
    idx, valid = tstaged._val_index_plan(n, b)
    jidx, jvalid = jstaged._val_index_plan(n, b)
    assert idx.shape == shape and valid.sum() == real
    assert idx.dtype == jidx.dtype and valid.dtype == jvalid.dtype
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(valid, jvalid)
    assert idx.reshape(-1)[n:].tolist() == [0] * (idx.size - n)  # padded slots repeat 0


def test_gather_batch_zeroes_padded_agg_validity():
    """Padded validation slots repeat a real index; their GT validity is
    zeroed, as the JAX function does, on the same arrays."""
    rng = np.random.default_rng(0)
    staged = {"image": rng.integers(0, 256, (3, 4, 4, 3), dtype=np.uint8),
              "mask": rng.integers(0, 3, (3, 4, 4), dtype=np.uint8),
              "agg": {"valid": np.array([[True, True], [True, False], [False, True]]),
                      "xy": rng.standard_normal((3, 2, 2)).astype(np.float32),
                      "instance_masks": rng.integers(0, 2, (3, 2, 4, 4), dtype=np.uint8)}}
    idxs = np.array([0, 0, 2, 1], np.int32)
    sv = np.array([1.0, 0.0, 1.0, 0.0], np.float32)
    got = tstaged._gather_batch(tstaged._to_device(staged, "cpu"),
                                torch.from_numpy(idxs).long(), torch.from_numpy(sv))
    want = jstaged._gather_batch(jax.tree.map(jnp.asarray, staged), jnp.asarray(idxs),
                                 jnp.asarray(sv))
    assert_trees_equal({k: (v.numpy() if isinstance(v, torch.Tensor)
                            else {a: b.numpy() for a, b in v.items()}) for k, v in got.items()},
                       jax.tree.map(np.asarray, want))
    np.testing.assert_array_equal(got["agg"]["valid"].numpy(),
                                  [[True, True], [False, False], [False, True], [False, False]])


@pytest.fixture(scope="module")
def banks(tmp_path_factory):
    root = tmp_path_factory.mktemp("banks")
    return bank(root / "b1", 5, 0), bank(root / "b2", 4, 5)


def test_stage_dataset_serial_and_one_call_pool_match_jax(banks):
    """Wire dtypes kept, `path` dropped; serial and a pool for one call give
    the arrays the JAX `stage_dataset` gives on the same folder."""
    kw = dict(selected_classes=CLASSES, max_instances=4, augmentation="train")
    ds = tnocs.NOCSDataset(banks[0], **kw)
    jds = jnocs.NOCSDataset(banks[0], **kw)
    ds.epoch = jds.epoch = 3
    serial = tstaged.stage_dataset(ds)
    assert "path" not in serial
    assert serial["image"].dtype == serial["mask"].dtype == np.uint8
    assert serial["agg"]["instance_masks"].dtype == np.uint8
    assert_trees_equal(serial, jstaged.stage_dataset(jds), "serial")
    assert_trees_equal(tstaged.stage_dataset(ds, num_workers=2), serial, "one-call pool")


def test_stage_dataset_persistent_pool_tracks_epoch_and_repoint(banks):
    """A long-lived pool started before the parent moves on follows a later
    epoch and a repoint, as serial staging of the parent does."""
    ds = tnocs.NOCSDataset(banks[0], selected_classes=CLASSES, max_instances=4,
                           augmentation="train")
    pool = tstaged.make_stage_pool(ds, 2)
    try:
        ds.epoch = 1
        pooled = tstaged.stage_dataset(ds, pool=pool)
        assert_trees_equal(pooled, tstaged.stage_dataset(ds), "epoch 1")
        ds.repoint(banks[1])
        ds.epoch = 2
        pooled2 = tstaged.stage_dataset(ds, pool=pool)
        assert_trees_equal(pooled2, tstaged.stage_dataset(ds), "repointed, epoch 2")
        assert pooled["image"].shape != pooled2["image"].shape or not np.array_equal(
            pooled["image"], pooled2["image"])
    finally:
        pool.shutdown()


class TestTransferIntegrity:
    def tree(self):
        rng = np.random.default_rng(0)
        return {"image": rng.integers(0, 255, (4, 8, 8, 3), dtype=np.uint8),
                "mask": rng.integers(0, 6, (4, 8, 8), dtype=np.int32),
                "agg": {"xy": rng.standard_normal((4, 2)).astype(np.float32),
                        "z": rng.standard_normal((4,)).astype(np.float64)},
                "flag": np.array([True, False, True, False])}

    def test_checksums_match_after_clean_put(self):
        tree = self.tree()
        want = jstaged.host_checksums(tree)
        np.testing.assert_array_equal(tstaged.host_checksums(tree), want)
        got = tstaged.device_checksums(tstaged._to_device(tree, "cpu")).numpy()
        np.testing.assert_array_equal(got.astype(np.uint64), want)
        out = tstaged.verified_device_put(tree, "test", logging.getLogger("t"), "cpu")
        assert_trees_equal({k: (v.numpy() if isinstance(v, torch.Tensor)
                                else {a: b.numpy() for a, b in v.items()})
                            for k, v in out.items()}, tree)

    def test_checksum_detects_any_corruption(self):
        tree = self.tree()
        want = tstaged.host_checksums(tree)
        bad = {k: (v.copy() if not isinstance(v, dict) else {a: b.copy() for a, b in v.items()})
               for k, v in tree.items()}
        bad["agg"]["xy"].view(np.uint8).reshape(-1)[5] ^= 0x10
        got = tstaged.device_checksums(tstaged._to_device(bad, "cpu")).numpy().astype(np.uint64)
        np.testing.assert_array_equal(got, jstaged.host_checksums(bad))
        assert int((got != want).sum()) == 1  # localized to that array

    def test_verified_put_raises_after_persistent_mismatch(self, monkeypatch, caplog):
        tree = self.tree()
        corrupt = dict(tree, image=tree["image"].copy())
        corrupt["image"][0, 0, 0, 0] ^= 0xFF
        real = tstaged._to_device
        monkeypatch.setattr(tstaged, "_to_device", lambda t, d: real(corrupt, d))
        with caplog.at_level(logging.WARNING, logger="t"):
            with pytest.raises(RuntimeError, match="corrupted 2 times"):
                tstaged.verified_device_put(tree, "test", logging.getLogger("t"), "cpu",
                                            attempts=2)
        assert caplog.text.count("FAILED checksum") == 2


# -----------------------------------------------------------------------------
# The loop against the JAX loop


class Recorder:
    """A stub train and eval step for one package: records each batch, bumps
    the step, and returns a train loss from the batch and a validation loss
    that depends on the batch and on the epoch (`SCHEDULE`), so the best
    moves and the plateau scale falls at patience 1. Train call `FAULT`
    reports non-finite gradients."""

    SCHEDULE = (5.0, 4.0, 4.5, 3.0, 3.5)
    FAULT = 3

    def __init__(self, val_batches):
        self.val_batches = val_batches
        self.train, self.eval, self.saves, self.plateau = [], [], [], []

    @staticmethod
    def arrays(batch):
        out = {k: np.array(batch[k]) for k in ("image", "mask", "sample_valid")}
        out.update({f"agg/{k}": np.array(v) for k, v in batch["agg"].items()})
        return out

    def train_logs(self, batch):
        self.train.append(self.arrays(batch))
        loss = np.float32(np.asarray(batch["image"], np.float64).mean() / 255.0)
        return loss, np.float32(len(self.train) != self.FAULT)

    def eval_loss(self, batch):
        self.eval.append(self.arrays(batch))
        epoch = (len(self.eval) - 1) // self.val_batches
        img = np.asarray(batch["image"], np.float64)
        real = np.asarray(batch["sample_valid"]) > 0
        return np.float32((img[real].mean() if real.any() else 0.0) / 255.0
                          + self.SCHEDULE[epoch])


def py_scan(f, init, xs):
    """`jax.lax.scan` as a Python loop over the leading axis."""
    carry, ys = init, []
    for i in range(len(jax.tree.leaves(xs)[0])):
        carry, y = f(carry, jax.tree.map(lambda a: a[i], xs))
        ys.append(y)
    return carry, jax.tree.map(lambda *a: jnp.stack(a), *ys)


def run_log(run_dir):
    return (run_dir / "run.log").read_text()


def test_fit_staged_matches_jax_with_stub_steps(tmp_path, monkeypatch):
    root = tmp_path / "banks"
    cfg = dict(CFG, height=32, width=32)
    first, second = bank(root / "a", 7, 0, cfg), bank(root / "b", 5, 9, cfg)
    valid_dir = bank(root / "v", 5, 1, cfg)
    kw = dict(SELECTED_CLASSES=CLASSES, IMAGE_HEIGHT=32, IMAGE_WIDTH=32, MAX_INSTANCES=4,
              BATCH_SIZE=2, PLATEAU_PATIENCE=1, CKPT_SAVE_FREQUENCY=2, NUM_WORKERS=1)
    jhp = dataclasses.replace(JC.mask_training(), **kw)
    thp = C.mask_training(**kw)
    common = dict(selected_classes=CLASSES, max_instances=4)

    def datasets(mod):
        train = mod.NOCSDataset(first, augmentation="train", **common)
        valid = mod.NOCSDataset(valid_dir, augmentation="valid", **common)
        return train, valid

    def regen_for(ds):
        return lambda epoch: ds.repoint(second if (epoch // 2) % 2 else first)

    jtrain, jvalid = datasets(jnocs)
    ttrain, tvalid = datasets(tnocs)
    assert len(jtrain) == len(ttrain) == 7 and len(jvalid) == len(tvalid) == 5

    # ---- JAX fit_staged, stubbed ----
    jrec = Recorder(val_batches=3)

    def jax_train_step(state, batch, rng):
        loss, finite = jrec.train_logs(batch)
        return state._replace(step=state.step + 1), {
            "pose/total_loss": jnp.asarray(loss), "grad/finite": jnp.asarray(finite)}

    def jax_eval_step(state, batch, rng, bank_):
        return {"pose/total_loss": jnp.asarray(jrec.eval_loss(batch))}, bank_, {}

    real_jplateau = jstaged.optim.plateau_update

    def jax_plateau(state, metric, **kw_):
        out = real_jplateau(state, metric, **kw_)
        jrec.plateau.append((float(metric), float(out.scale)))
        return out

    lax = {k: getattr(jax.lax, k) for k in dir(jax.lax) if not k.startswith("_")}
    shim = types.SimpleNamespace(**{k: getattr(jax, k) for k in (
        "random", "device_put", "device_get", "tree", "default_backend")},
        jit=lambda f: f, lax=types.SimpleNamespace(**dict(lax, scan=py_scan)))
    monkeypatch.setattr(jstaged, "jax", shim)
    monkeypatch.setattr(jstaged, "make_train_step", lambda *a: jax_train_step)
    monkeypatch.setattr(jstaged, "make_eval_step", lambda *a: jax_eval_step)
    monkeypatch.setattr(jstaged.optim, "plateau_update", jax_plateau)
    monkeypatch.setattr(jckpt, "save_checkpoint",
                        lambda d, step, state, hp: jrec.saves.append((d.name, int(step))))
    monkeypatch.setattr(jckpt, "save_npz_snapshot",
                        lambda path, state, hp: jrec.saves.append(("npz", int(state.step))))
    jrun = tmp_path / "jax_run"
    jrun.mkdir()
    jstaged.fit_staged(jhp, jtrain, jvalid, np.eye(3), run_dir=jrun, enable_tb=False,
                       num_epochs=5, restage_every=2, regen_fn=regen_for(jtrain),
                       snapshot_npz=str(tmp_path / "j.npz"), snapshot_every_s=0.0)

    # ---- port fit_staged, stubbed ----
    trec = Recorder(val_batches=3)

    def port_train_step(state, batch, seed=0):
        loss, finite = trec.train_logs(batch)
        return dataclasses.replace(state, step=state.step + 1), {
            "pose/total_loss": torch.tensor(loss), "grad/finite": torch.tensor(finite)}

    def port_eval_step(state, batch, bank_, seed=0):
        return {"pose/total_loss": torch.tensor(trec.eval_loss(batch))}, bank_, None

    real_tplateau = tstaged.optim.plateau_update

    def port_plateau(state, metric, **kw_):
        out = real_tplateau(state, metric, **kw_)
        trec.plateau.append((float(metric), out.scale))
        return out

    monkeypatch.setattr(tstaged, "make_train_step", lambda *a: port_train_step)
    monkeypatch.setattr(tstaged, "make_eval_step", lambda *a: port_eval_step)
    monkeypatch.setattr(tstaged, "upcast_batch", lambda batch, device: batch)  # raw wire
    monkeypatch.setattr(tstaged.optim, "plateau_update", port_plateau)
    monkeypatch.setattr(tckpt, "save_checkpoint",
                        lambda d, step, state, hp: trec.saves.append((d.name, int(step))))
    monkeypatch.setattr(tckpt, "save_npz_snapshot",
                        lambda path, state, hp: trec.saves.append(("npz", int(state.step))))
    state, trun = tstaged.fit_staged(
        thp, ttrain, tvalid, np.eye(3), run_dir=tmp_path / "port_run", device="cpu",
        enable_tb=False, num_epochs=5, restage_every=2, regen_fn=regen_for(ttrain),
        snapshot_npz=str(tmp_path / "t.npz"), snapshot_every_s=0.0)

    assert state.step == 15 and len(trec.train) == len(jrec.train) == 15  # 3 a epoch
    assert len(trec.eval) == len(jrec.eval) == 15
    for kind in ("train", "eval"):
        for i, (got, want) in enumerate(zip(getattr(trec, kind), getattr(jrec, kind))):
            assert_trees_equal(got, want, f"{kind} {i}")
    assert [b["sample_valid"].tolist() for b in trec.eval[:3]] == [[1, 1], [1, 1], [1, 0]]
    assert trec.plateau == jrec.plateau
    assert trec.saves == jrec.saves
    assert [t for t, _ in trec.saves].count("periodic") == 3  # epochs 0, 1, 3
    tlog, jlog = run_log(trun), run_log(jrun)
    restage = r"restaged (\d+) train samples \((\d+) generated\) at epoch (\d+)"
    assert re.findall(restage, tlog) == re.findall(restage, jlog) == [
        ("7", "5", "2"), ("7", "7", "4")]
    flushed = r"flushed best checkpoint before restage at epoch (\d+)"
    assert re.findall(flushed, tlog) == re.findall(flushed, jlog)
    epoch_line = r"epoch (\d+): val_loss=(\S+) lr_scale=(\S+) skipped=(\d+)"
    assert re.findall(epoch_line, tlog) == re.findall(epoch_line, jlog)
    assert len(re.findall(epoch_line, tlog)) == 5
    tfault, jfault = (sorted(r.glob("fault_batch_step*.npz")) for r in (trun, jrun))
    assert [f.name for f in tfault] == [f.name for f in jfault] == [
        f"fault_batch_step{Recorder.FAULT}.npz"]
    with np.load(tfault[0]) as a, np.load(jfault[0]) as b:
        assert_trees_equal(dict(a), dict(b), "fault batch")


# -----------------------------------------------------------------------------
# A kept best is a clone


def test_kept_best_holds_its_epochs_weights(tmp_path, monkeypatch):
    """The port's network is updated in place, so a best kept at epoch 0 and
    written after later epochs (by the flush before a restage, and at the
    end) must be a clone: it still holds epoch 0's parameters, BatchNorm
    statistics and optimizer state. The stub step adds 1 to every
    parameter, running mean and first moment, in place."""
    cfg = dict(CFG, height=32, width=32)
    train_dir, valid_dir = bank(tmp_path / "t", 4, 0, cfg), bank(tmp_path / "v", 2, 1, cfg)
    hp = C.mask_training(SELECTED_CLASSES=CLASSES, IMAGE_HEIGHT=32, IMAGE_WIDTH=32,
                         MAX_INSTANCES=4, BATCH_SIZE=2, NUM_WORKERS=1,
                         CKPT_SAVE_FREQUENCY=100)
    losses = iter([1.0, 2.0])  # the best is epoch 0's

    def train_step(state, batch, seed=0):
        with torch.no_grad():
            for p in state.net.parameters():
                p.add_(1.0)
            for name, b in state.net.named_buffers():
                if name.endswith("running_mean"):
                    b.add_(1.0)
            for m in state.opt_state.mu.values():
                m.add_(1.0)
        return dataclasses.replace(state, step=state.step + 1), {
            "pose/total_loss": torch.tensor(0.5), "grad/finite": torch.tensor(1.0)}

    def eval_step(state, batch, bank_, seed=0):
        return {"pose/total_loss": torch.tensor(next(losses))}, bank_, None

    first_state = {}
    real_create = tstaged.create_train_state

    def create(net, optimizer):
        st = real_create(net, optimizer)
        first_state.update(params={n: p.detach().clone() for n, p in net.named_parameters()},
                           buffers={n: b.clone() for n, b in net.named_buffers()})
        return st

    monkeypatch.setattr(tstaged, "create_train_state", create)
    monkeypatch.setattr(tstaged, "make_train_step", lambda *a: train_step)
    monkeypatch.setattr(tstaged, "make_eval_step", lambda *a: eval_step)
    ttrain = tnocs.NOCSDataset(train_dir, selected_classes=CLASSES, max_instances=4)
    tvalid = tnocs.NOCSDataset(valid_dir, selected_classes=CLASSES, max_instances=4)
    snap = tmp_path / "best.npz"
    state, run_dir = tstaged.fit_staged(hp, ttrain, tvalid, np.eye(3), run_dir=tmp_path / "run",
                                        device="cpu", enable_tb=False, num_epochs=2,
                                        restage_every=1, snapshot_npz=str(snap))
    steps_a_epoch = len(ttrain) // 2
    assert "flushed best checkpoint before restage at epoch 1" in run_log(run_dir)
    best = torch.load(run_dir / "checkpoints" / "best" / f"step_{steps_a_epoch:08d}.pt",
                      weights_only=True)
    assert best["step"] == steps_a_epoch and state.step == 2 * steps_a_epoch
    sd = best["state_dict"]

    def plus_ones(t, k):  # the stub's k in-place additions of 1
        t = t.clone()
        for _ in range(k):
            t += 1.0
        return t

    for n, p in first_state["params"].items():
        assert torch.equal(sd[n], plus_ones(p, steps_a_epoch)), n
        assert torch.equal(dict(state.net.named_parameters())[n].detach(),
                           plus_ones(p, 2 * steps_a_epoch)), n
    for n, b in first_state["buffers"].items():
        if n.endswith("running_mean"):
            assert torch.equal(sd[n], plus_ones(b, steps_a_epoch)), n
    assert all(torch.equal(m, torch.full_like(m, float(steps_a_epoch)))
               for m in best["opt_state"]["mu"].values())
    # the final snapshot is the run's true best, not the last state
    net_hp = tckpt.merge_arch_from_any(snap, hp)
    snap_state = TrainState(net=type(state.net)(net_hp.num_classes), opt_state=None)
    tckpt.load_npz_snapshot(snap, snap_state, net_hp)
    for n, p in snap_state.net.named_parameters():
        assert torch.equal(p.detach(),
                           plus_ones(first_state["params"][n], steps_a_epoch).half().float())
