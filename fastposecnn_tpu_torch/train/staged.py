"""The device-resident staged trainer (counterpart of the JAX package's
`train/staged.py`, `fit_staged` and its helpers).

The whole augmented training set is staged in the card's memory once a
restage, as uint8 wire arrays, its upload checked by per-array byte sums
(`verified_device_put`); each batch is gathered on the card from a host
permutation (`index_select`), ImageNet-normalised there
(`data.loader.upcast_batch`) and fed to the ordinary train step
(`train/task.py`), whose logs stay on the card until one fetch an epoch
together with the validation logs and the pose metric bank. The steps'
own host reads stay as in the streaming loop (`train/loop.py`): whether
the gradients were finite, K1's error flag, and one a vote round.

Semantics, as in the JAX trainer:
  - the permutation comes from `default_rng(42)`, one an epoch, and the
    last short train batch is dropped; validation pads its last batch
    with `sample_valid` 0 slots that repeat index 0, their GT validity
    zeroed (`_gather_batch`), and its loss is weighted by real samples;
    without a validation set the train loss stands in;
  - `restage_every=K` re-stages the training set (fresh augmentation
    draws keyed on (aug_seed, epoch, index); with `regen_fn`, a fresh
    scene bank first) every K epochs, read on a background thread during
    the K epochs before it is used; a split whose sample count changed is
    resampled cyclically to the first one's;
  - a step whose fetched `grad/finite` is 0 has its batch rebuilt from the
    host copy and the permutation and saved as `fault_batch_step<n>.npz`;
  - checkpoints are written on one FIFO thread: `periodic` at epoch 0,
    every CKPT_SAVE_FREQUENCY epochs or after 600 s; the pending `best`
    with them and before each restage; an npz snapshot of the best (at
    most every `snapshot_every_s`); at the end `best`, `last` and the
    snapshot of the run's true best.

What differs from JAX: a JAX state is immutable, so keeping the best is a
free reference; the port's `TrainState` shares one network that the
optimizer updates in place. So every state kept or handed to the flush
thread is a clone on the card (parameters, BatchNorm buffers, optimizer
state), and the thread copies it to the host only after a CUDA event
recorded behind the clone. The staging workers are spawned processes
(they import numpy and this package's data modules, and never touch
CUDA), started once, before any flush thread, as the JAX trainer forks
its pool once.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import multiprocessing
import pathlib
import threading
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Optional

import numpy as np
import torch

from fastposecnn_tpu_torch import metrics as M
from fastposecnn_tpu_torch.config import HParams, pipeline_config_from
from fastposecnn_tpu_torch.data.loader import (
    _init_worker,
    _worker_get,
    _worker_stage_get,
    upcast_batch,
)
from fastposecnn_tpu_torch.data.nocs import collate
from fastposecnn_tpu_torch.device import resolve_device
from fastposecnn_tpu_torch.train import checkpoint as ckpt
from fastposecnn_tpu_torch.train import optim
from fastposecnn_tpu_torch.train.loop import (
    TRAIN_SEED,
    _file_logger,
    fetch_logs,
    initial_network,
    make_run_dir,
)
from fastposecnn_tpu_torch.train.task import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from fastposecnn_tpu_torch.utils.tb import RunLogger

FLUSH_EVERY_S = 600.0
SHUFFLE_SEED = 42
TRAIN_MEAN_KEYS = ("quaternion/loss_quat", "xy/loss_xy", "z/loss_z", "scales/loss_scales",
                   "mask/loss_ce", "pose/num_matched", "quaternion/loss_dense",
                   "xy/loss_dense", "z/loss_dense", "scales/loss_dense")


# -----------------------------------------------------------------------------
# Trees of arrays: dicts (keys sorted, as jax.tree.leaves orders them) and leaves


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _float32s(logs, key) -> np.ndarray:
    return np.asarray([lg[key] for lg in logs], np.float32)


def tree_nbytes(tree) -> int:
    return sum(int(np.asarray(x).nbytes) for x in _leaves(tree))


# -----------------------------------------------------------------------------
# Verified upload


def host_checksums(tree) -> np.ndarray:
    """Per-leaf byte sum mod 2^32 of a tree of numpy arrays, as uint64."""
    return np.array([np.asarray(x).view(np.uint8).sum(dtype=np.uint64) & np.uint64(0xFFFFFFFF)
                     for x in _leaves(tree)], np.uint64)


def device_checksums(tree) -> torch.Tensor:
    """`host_checksums` of a tree of tensors, computed where they lie: each
    leaf's bytes (bool as uint8) summed in int64 and masked to 32 bits, as a
    JAX uint32 sum wraps. One int64 tensor of the leaves' sums."""
    sums = []
    for x in _leaves(tree):
        b = x.reshape(-1)
        b = b.to(torch.uint8) if b.dtype == torch.bool else b.contiguous().view(torch.uint8)
        sums.append(b.sum(dtype=torch.int64))
    return torch.stack(sums) & 0xFFFFFFFF


def _to_device(host_tree, device):
    return _map(lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device), host_tree)


def verified_device_put(host_tree, what: str, log, device, attempts: int = 3):
    """Copy a tree of numpy arrays to `device` and hold the copy's per-array
    byte sums against the host's; retry, and raise after `attempts`
    mismatches in a row rather than train on corrupted data."""
    want = host_checksums(host_tree)
    for attempt in range(1, attempts + 1):
        dev = _to_device(host_tree, device)
        got = device_checksums(dev).cpu().numpy().astype(np.uint64)
        if np.array_equal(got, want):
            if attempt > 1:
                log.warning("staged %s upload verified on retry %d", what, attempt)
            else:
                log.info("staged %s upload verified: %d arrays, %.1f MB, byte sums equal",
                         what, len(want), tree_nbytes(host_tree) / 1e6)
            return dev
        log.warning("staged %s upload FAILED checksum (attempt %d/%d): %d/%d arrays "
                    "corrupted in transfer; retrying", what, attempt, attempts,
                    int((got != want).sum()), len(want))
        del dev
    raise RuntimeError(f"staged {what} upload corrupted {attempts} times in a row: the "
                       "device or the transfer is unhealthy; refusing to train on it")


# -----------------------------------------------------------------------------
# Staging on the host


def make_stage_pool(ds, num_workers: int) -> ProcessPoolExecutor:
    """`num_workers` spawned processes holding a copy of `ds`."""
    return ProcessPoolExecutor(num_workers, mp_context=multiprocessing.get_context("spawn"),
                               initializer=_init_worker, initargs=(ds,))


def stage_dataset(ds, num_workers: int = 1, pool: Optional[ProcessPoolExecutor] = None
                  ) -> Optional[dict]:
    """Every sample of `ds`, collated into stacked host arrays in their wire
    dtypes (uint8 image, mask and instance masks), `path` dropped; None if
    every sample was rejected. Samples are keyed on (aug_seed, epoch,
    index), so how they are spread over workers changes nothing; set
    `ds.epoch` before the call. `pool` (from `make_stage_pool`) is a
    long-lived pool: each task carries (index, epoch, dataset_dir), so its
    workers follow the parent's epoch and repoints. Without one,
    `num_workers > 1` starts a pool for this call alone."""
    if pool is not None:
        tasks = [(i, getattr(ds, "epoch", None), getattr(ds, "dataset_dir", None))
                 for i in range(len(ds))]
        samples = list(pool.map(_worker_stage_get, tasks,
                                chunksize=max(1, len(ds) // (pool._max_workers * 8))))
    elif num_workers > 1:
        with make_stage_pool(ds, num_workers) as transient:
            samples = list(transient.map(_worker_get, range(len(ds)),
                                         chunksize=max(1, len(ds) // (num_workers * 8))))
    else:
        samples = [ds[i] for i in range(len(ds))]
    batch = collate(samples)
    if batch is None:
        return None
    batch.pop("path", None)
    return batch


# -----------------------------------------------------------------------------
# Batches on the card


def _gather_batch(staged, idxs: torch.Tensor, sample_valid: torch.Tensor) -> dict:
    """The batch of staged samples `idxs`, gathered where they lie. Padded
    validation slots repeat a real index; `sample_valid` masks their
    pixel-wise losses, and their GT validity is zeroed here, or the matched
    losses and the metric bank would count the repeated sample again."""
    agg = {k: v.index_select(0, idxs) for k, v in staged["agg"].items()}
    agg["valid"] = agg["valid"] & (sample_valid > 0.5)[:, None]
    return {"image": staged["image"].index_select(0, idxs),
            "mask": staged["mask"].index_select(0, idxs),
            "agg": agg, "sample_valid": sample_valid}


def _val_index_plan(n: int, batch_size: int):
    """Validation indices padded to whole batches: padded slots repeat index
    0 with sample_valid 0. Returns ([nb, B] int32, [nb, B] float32)."""
    nb = max(1, -(-n // batch_size))
    idxs = np.zeros((nb * batch_size,), np.int32)
    idxs[:n] = np.arange(n, dtype=np.int32)
    valid = np.zeros((nb * batch_size,), np.float32)
    valid[:n] = 1.0
    return idxs.reshape(nb, batch_size), valid.reshape(nb, batch_size)


# -----------------------------------------------------------------------------
# States kept past the step that made them


def clone_state(state: TrainState) -> TrainState:
    """A copy of `state` on its device that later steps do not change: the
    network (parameters and BatchNorm buffers) and the optimizer's tensors."""
    o = state.opt_state

    def cloned(d):
        return {k: v.detach().clone() for k, v in d.items()}

    opt = dataclasses.replace(o, mu=cloned(o.mu), nu=cloned(o.nu), slow=cloned(o.slow))
    return TrainState(copy.deepcopy(state.net), opt, state.step, state.skipped_updates)


def _ready_event(device: torch.device):
    """A CUDA event recorded on the current stream (None on the CPU)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record()
    return event


class _Flusher:
    """Checkpoint writes on one thread at a time, in order: a new flush
    joins the one before it first. A job's state is a clone, copied to the
    host once `ready` (the event recorded behind the clones) has passed."""

    def __init__(self, ckpt_dir: pathlib.Path, hp: HParams, snapshot_npz: Optional[str],
                 snapshot_every_s: float, log):
        self.ckpt_dir, self.hp, self.log = ckpt_dir, hp, log
        self.snapshot_npz, self.snapshot_every_s = snapshot_npz, snapshot_every_s
        self.last_snapshot_t = -math.inf
        self.thread: Optional[threading.Thread] = None

    def submit(self, jobs, ready) -> None:
        prev = self.thread

        def work():
            if prev is not None:
                prev.join()
            if ready is not None:
                ready.synchronize()
            for tag, step, st in jobs:
                try:
                    ckpt.save_checkpoint(self.ckpt_dir / tag, step, st, self.hp)
                    if (self.snapshot_npz and tag == "best" and time.perf_counter()
                            - self.last_snapshot_t > self.snapshot_every_s):
                        ckpt.save_npz_snapshot(self.snapshot_npz, st, self.hp)
                        self.last_snapshot_t = time.perf_counter()
                        self.log.info("durable npz snapshot refreshed (step %d): %s",
                                      step, self.snapshot_npz)
                except Exception:  # noqa: BLE001 — a failed flush must not stop training
                    self.log.exception("async checkpoint flush (%s) failed", tag)

        self.thread = threading.Thread(target=work, daemon=True)
        self.thread.start()

    def join(self) -> None:
        if self.thread is not None:
            self.thread.join()


# -----------------------------------------------------------------------------
# The trainer


def fit_staged(hp: HParams, train_ds, valid_ds, inv_intrinsics,
               run_dir: Optional[pathlib.Path] = None, device=None, enable_tb: bool = True,
               num_epochs: Optional[int] = None, resume_from: Optional[str] = None,
               restage_every: int = 0, regen_fn=None, log_cb=None,
               snapshot_npz: Optional[str] = None, snapshot_every_s: float = 600.0):
    """Train `num_epochs` (default `hp.NUM_EPOCHS`) staged epochs on `device`
    (CUDA unless "cpu" is given), from seeded random weights or
    `resume_from`. `regen_fn(epoch)`, called before each restage but the
    first, may repoint `train_ds` at a fresh bank; `log_cb(epoch, val_loss,
    pose metrics)` follows each epoch line. Returns (final TrainState,
    run_dir)."""
    device = resolve_device(device)
    if resume_from:
        hp = ckpt.merge_arch_from_any(resume_from, hp)
    run_dir = pathlib.Path(run_dir) if run_dir else make_run_dir(hp)
    run_dir.mkdir(parents=True, exist_ok=True)
    hp.save(run_dir / "HPARAM.json")
    logger = RunLogger(run_dir, enabled=enable_tb)
    flog, handler = _file_logger(run_dir)
    stage_pool, flusher, prefetch = None, None, None
    try:
        flog.info("hparams: %s", hp.to_json().replace("\n", " "))
        flog.info("staged (device-resident) trainer")
        net = initial_network(hp, device, flog)
        pcfg = pipeline_config_from(hp)
        optimizer = make_optimizer(hp, net)
        state = create_train_state(net, optimizer)
        if resume_from:
            state, hp = ckpt.load_any_checkpoint(resume_from, state, hp, optimizer=optimizer)
            flog.info("resumed from %s at step %d", resume_from, state.step)
        train_step = make_train_step(net, optimizer, hp, pcfg, inv_intrinsics, device)
        eval_step = make_eval_step(net, hp, pcfg, inv_intrinsics, device)
        batch_size = hp.BATCH_SIZE

        # The workers start once, here, before any flush thread exists; every
        # restage ships (epoch, bank folder) to them.
        if hp.NUM_WORKERS > 1:
            stage_pool = make_stage_pool(train_ds, hp.NUM_WORKERS)

        def stage_host(split_epoch: int) -> dict:
            if regen_fn is not None and split_epoch:
                regen_fn(split_epoch)  # fresh scene geometry, not only fresh draws
            train_ds.epoch = split_epoch
            host = stage_dataset(train_ds, pool=stage_pool)
            if host is None:
                raise SystemExit("staged trainer: empty training dataset")
            return host

        def put(host_tree, what):
            return verified_device_put(host_tree, what, flog, device)

        t0 = time.perf_counter()
        host_valid = stage_dataset(valid_ds, num_workers=hp.NUM_WORKERS)
        host_train = stage_host(0)
        dev_train = put(host_train, "train")
        dev_valid = put(host_valid, "valid") if host_valid else None
        n_train = host_train["image"].shape[0]
        n_valid = host_valid["image"].shape[0] if host_valid else 0
        flog.info("staged %d train + %d valid samples (%.1f MB wire) in %.1f s",
                  n_train, n_valid, (tree_nbytes(host_train) + tree_nbytes(host_valid or {}))
                  / 1e6, time.perf_counter() - t0)
        if n_train < batch_size:
            raise SystemExit(f"staged trainer: TRAIN_SIZE ({n_train}) < BATCH_SIZE "
                             f"({batch_size}): nothing to train on after drop-last")

        if n_valid:
            val_idx, val_valid = _val_index_plan(n_valid, batch_size)
            val_idx_dev = torch.from_numpy(val_idx).long().to(device)
            val_valid_dev = torch.from_numpy(val_valid).to(device)
        nb_train = n_train // batch_size
        full_valid = torch.ones((batch_size,), dtype=torch.float32, device=device)

        plateau = optim.plateau_init()
        best_val = math.inf
        best_state, best_step = None, 0
        best_ref, best_ref_step = None, 0
        last_flush_t = time.perf_counter()
        shuffle_rng = np.random.default_rng(SHUFFLE_SEED)
        flusher = _Flusher(run_dir / "checkpoints", hp, snapshot_npz, snapshot_every_s, flog)
        total_epochs = num_epochs or hp.NUM_EPOCHS

        # The next restage's host read (bank rotation, decode, augmentation,
        # collate) runs on a thread during the epochs before it is used; it
        # touches train_ds and the worker pool only, never CUDA.
        prefetch_box: dict = {}

        def prefetch_async(split_epoch: int) -> threading.Thread:
            def work():
                t = time.perf_counter()
                try:
                    prefetch_box["host"] = stage_host(split_epoch)
                    prefetch_box["seconds"] = time.perf_counter() - t
                except BaseException as exc:  # noqa: BLE001 — reported at the join
                    prefetch_box["error"] = exc

            prefetch_box.clear()
            thread = threading.Thread(target=work, daemon=True)
            thread.start()
            return thread

        if restage_every and restage_every < total_epochs:
            prefetch = prefetch_async(restage_every)

        for epoch in range(total_epochs):
            if restage_every and epoch and epoch % restage_every == 0:
                # The pending best goes to disk before the restage pause.
                if best_state is not None:
                    flusher.submit([("best", best_step, best_state)], _ready_event(device))
                    best_state = None
                    last_flush_t = time.perf_counter()
                    flog.info("flushed best checkpoint before restage at epoch %d", epoch)
                restage_t0 = time.perf_counter()
                bg_s = 0.0
                host_train = None
                if prefetch is not None:
                    prefetch.join()
                    prefetch = None
                    host_train = prefetch_box.pop("host", None)
                    bg_s = prefetch_box.pop("seconds", 0.0)
                    if host_train is None:
                        flog.warning("background restage prefetch failed (%r); restaging "
                                     "synchronously", prefetch_box.pop("error", None))
                if host_train is None:
                    host_train = stage_host(epoch)
                # The staged sample count stays the first one's: a regenerated
                # bank may reject a different number of scenes.
                n_new = host_train["image"].shape[0]
                if n_new != n_train:
                    idx = np.resize(np.arange(n_new), n_train)
                    host_train = _map(lambda a: a[idx], host_train)
                dev_train = None
                dev_train = put(host_train, "train")
                flog.info("restaged %d train samples (%d generated) at epoch %d in %.1f s "
                          "(background prefetch %.1f s)", n_train, n_new, epoch,
                          time.perf_counter() - restage_t0, bg_s)
                if epoch + restage_every < total_epochs:
                    prefetch = prefetch_async(epoch + restage_every)

            # ---- train: batches gathered on the card, logs kept there ----
            epoch_t0 = time.perf_counter()
            host_step0 = state.step
            perm = shuffle_rng.permutation(n_train)[:nb_train * batch_size]
            perm = perm.astype(np.int32).reshape(nb_train, batch_size)
            perm_dev = torch.from_numpy(perm).long().to(device)
            step_logs = []
            for i in range(nb_train):
                batch = upcast_batch(_gather_batch(dev_train, perm_dev[i], full_valid), device)
                state, logs = train_step(state, batch, seed=TRAIN_SEED)
                step_logs.append(logs)

            # ---- validate ----
            bank = M.init_pose_metric_bank(device)
            val_logs = []
            for b in range(val_idx.shape[0] if n_valid else 0):
                batch = upcast_batch(_gather_batch(dev_valid, val_idx_dev[b], val_valid_dev[b]),
                                     device)
                logs, bank, _ = eval_step(state, batch, bank, seed=epoch)
                val_logs.append(logs)

            # ---- one fetch for the epoch: train and valid logs, metric bank ----
            pose = ({f"pose/{k}": v for k, v in M.compute_pose_metric_bank(bank).items()}
                    if n_valid else {})
            fetched = fetch_logs(step_logs + val_logs + [pose])
            step_h, val_h, pose_vals = (fetched[:nb_train], fetched[nb_train:-1],
                                        fetched[-1])
            dt = time.perf_counter() - epoch_t0

            for i, lg in enumerate(step_h):
                step_i = host_step0 + i + 1
                logger.log_metrics("train", lg, step_i)
                if lg.get("grad/finite", 1.0) < 1.0:
                    path = run_dir / f"fault_batch_step{step_i}.npz"
                    np.savez_compressed(
                        path, image=host_train["image"][perm[i]],
                        mask=host_train["mask"][perm[i]],
                        **{f"agg_{k}": v[perm[i]] for k, v in host_train["agg"].items()})
                    flog.warning("non-finite gradients at step %d; batch saved to %s",
                                 step_i, path)
            host_step = host_step0 + nb_train
            logger.log_metrics("train", {"throughput/images_per_s": nb_train * batch_size
                                         / max(dt, 1e-9), "optim/lr_scale": plateau.scale},
                               host_step, accumulate=False)
            logger.log_epoch_average("train", epoch)

            if n_valid:
                for lg in val_h:
                    logger.log_metrics("valid", lg, host_step)
                logger.log_metrics("valid", pose_vals, host_step, accumulate=False)
                logger.log_epoch_average("valid", epoch)
                # In float32, as the JAX trainer averages its fetched logs.
                val_loss = float(np.average(_float32s(val_h, "pose/total_loss"),
                                            weights=val_valid.sum(axis=1)))
            else:
                val_loss = float(np.mean(_float32s(step_h, "pose/total_loss")))

            plateau = optim.plateau_update(plateau, val_loss, patience=hp.PLATEAU_PATIENCE,
                                           factor=hp.PLATEAU_FACTOR,
                                           min_scale=hp.PLATEAU_MIN_SCALE)
            state = dataclasses.replace(
                state, opt_state=optim.set_lr_scale(state.opt_state, plateau.scale))

            # ---- checkpoints: clones on the card, written on the flush thread ----
            if val_loss < best_val:
                best_val = val_loss
                best_state, best_step = clone_state(state), state.step
                best_ref, best_ref_step = best_state, best_step  # the run's true best
            if (epoch == 0 or (epoch + 1) % hp.CKPT_SAVE_FREQUENCY == 0
                    or time.perf_counter() - last_flush_t > FLUSH_EVERY_S):
                last_flush_t = time.perf_counter()
                jobs = [("periodic", host_step, clone_state(state))]
                # At epoch 0 the periodic state is the best: it rides a later flush.
                if best_state is not None and epoch > 0:
                    jobs.append(("best", best_step, best_state))
                    best_state = None
                flusher.submit(jobs, _ready_event(device))

            train_means = {
                ("d_" + k.split("/")[0] if k.endswith("loss_dense") else k.split("/")[-1]):
                    float(np.mean(_float32s(step_h, k)))
                for k in TRAIN_MEAN_KEYS if k in step_h[0]}
            msg = (f"epoch {epoch}: val_loss={val_loss:.4f} lr_scale={plateau.scale:.4f} "
                   f"skipped={state.skipped_updates} epoch_s={dt:.1f} "
                   + " ".join(f"t_{k}={v:.3f}" for k, v in train_means.items()) + " "
                   + " ".join(f"{k.split('/')[-1]}={v:.2f}" for k, v in pose_vals.items()))
            print(msg, flush=True)
            flog.info(msg)
            if log_cb is not None:
                log_cb(epoch, val_loss, pose_vals)

        if stage_pool is not None:
            stage_pool.shutdown()
            stage_pool = None
        flusher.join()
        ckpt_dir = run_dir / "checkpoints"
        if best_state is not None:
            ckpt.save_checkpoint(ckpt_dir / "best", best_step, best_state, hp)
        ckpt.save_checkpoint(ckpt_dir / "last", state.step, state, hp)
        if snapshot_npz and best_ref is not None:
            ckpt.save_npz_snapshot(snapshot_npz, best_ref, hp)
            flog.info("final durable npz snapshot (step %d): %s", best_ref_step, snapshot_npz)
        logger.log_hparams(dataclasses.asdict(hp), {"best_val_loss": best_val})
        return state, run_dir
    finally:
        if prefetch is not None:
            prefetch.join()
        if stage_pool is not None:
            stage_pool.shutdown(cancel_futures=True)
        if flusher is not None:
            flusher.join()
        logger.close()
        flog.removeHandler(handler)
        handler.close()
