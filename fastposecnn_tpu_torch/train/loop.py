"""The epoch loop: training, validation, the plateau scale, logs and
checkpoints (counterpart of the JAX package's `train/loop.py`, its `fit` at
:157-354; the reference's FPC/train.py:237-333 and callbacks).

Each epoch trains on every batch of the train loader (a short last batch
padded, `data.loader.pad_batch`), with the train step's logs kept on the
device and fetched 16 steps at a time; a step with non-finite gradients
saves its batch as `fault_batch_step<n>.npz`. Then it logs images a second
and the plateau scale, validates (the pose metric bank, and the validation
loss weighted by real samples), steps the plateau schedule into the
optimizer, and checkpoints: `best` on the validation loss, `periodic` every
`CKPT_SAVE_FREQUENCY` epochs, `last` at the end (`train.checkpoint`). The
train and eval steps compute in `device.full_float32()`; `COMPUTE_DTYPE` is
not honoured (the JAX loop takes bfloat16 only on a TPU).

Not ported: the per-epoch visualisations (they need matplotlib and PIL)
and the data-parallel mesh.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import math
import os
import pathlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from fastposecnn_tpu_torch import metrics as M
from fastposecnn_tpu_torch.config import HParams, pipeline_config_from
from fastposecnn_tpu_torch.data.loader import pad_batch
from fastposecnn_tpu_torch.device import resolve_device
from fastposecnn_tpu_torch.models import PoseRegressorNet
from fastposecnn_tpu_torch.models.weights import init_random_
from fastposecnn_tpu_torch.train import checkpoint as ckpt
from fastposecnn_tpu_torch.train import optim
from fastposecnn_tpu_torch.train.task import (
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from fastposecnn_tpu_torch.utils.tb import RunLogger

LOG_EVERY = 16
TRAIN_SEED = 42  # the JAX loop's jax.random.key(42)
INIT_SEED = 0


def make_run_dir(hp: HParams, base: Optional[str] = None) -> pathlib.Path:
    """$LOGS/yy-mm-dd/HH-MM-EXPERIMENT-MODEL-DATASET-encoder-weights/
    (FPC/train.py:237-248)."""
    base = pathlib.Path(base or os.getenv("LOGS", "logs"))
    now = datetime.datetime.now()
    run = base / now.strftime("%y-%m-%d") / (
        f"{now.strftime('%H-%M')}-{hp.EXPERIMENT_NAME}-{hp.MODEL}-"
        f"{hp.DATASET_NAME}-{hp.ENCODER}-{hp.ENCODER_WEIGHTS}")
    run.mkdir(parents=True, exist_ok=True)
    return run


def fetch_logs(logs: List[Dict[str, torch.Tensor]]) -> List[Dict[str, float]]:
    """Scalar logs as floats, with one device-to-host copy for all of them
    (a read of each would wait on the device once a value)."""
    flat = [(i, k, v) for i, d in enumerate(logs) for k, v in d.items()]
    on_dev = [v for _, _, v in flat if v.device.type != "cpu"]
    fetched = iter(torch.stack([v.float().reshape(()) for v in on_dev]).cpu().tolist()
                   if on_dev else [])
    out: List[Dict[str, float]] = [{} for _ in logs]
    for i, k, v in flat:
        out[i][k] = next(fetched) if v.device.type != "cpu" else float(v)
    return out


def _file_logger(run_dir: pathlib.Path):
    """The 'fastposecnn_tpu_torch' logger writing to run_dir/run.log, with no
    propagation (the console gets the epoch lines from print)."""
    flog = logging.getLogger("fastposecnn_tpu_torch")
    flog.setLevel(logging.INFO)
    fh = logging.FileHandler(run_dir / "run.log")
    fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
    flog.addHandler(fh)
    flog.propagate = False
    return flog, fh


def _save_fault_batch(run_dir, step, batch, flog):
    """The batch of a step whose gradients were not finite, for replay."""
    path = run_dir / f"fault_batch_step{step}.npz"
    np.savez_compressed(path, image=batch["image"], mask=batch["mask"],
                        **{f"agg_{k}": v for k, v in batch["agg"].items()})
    flog.warning("non-finite gradients at step %d; batch saved to %s", step, path)


def fit(hp: HParams, train_loader, valid_loader, inv_intrinsics,
        run_dir: Optional[pathlib.Path] = None, device=None, enable_tb: bool = True,
        num_epochs: Optional[int] = None, resume_from: Optional[str] = None):
    """Train `num_epochs` (default `hp.NUM_EPOCHS`) epochs on `device` (CUDA
    unless "cpu" is given), from seeded random weights or `resume_from` (a
    full checkpoint, with its optimizer; or the weights of an npz snapshot or
    a reference torch checkpoint, the optimizer re-derived from them).
    Returns (final TrainState, run_dir)."""
    device = resolve_device(device)
    if resume_from:
        hp = ckpt.merge_arch_from_any(resume_from, hp)
    run_dir = pathlib.Path(run_dir) if run_dir else make_run_dir(hp)
    run_dir.mkdir(parents=True, exist_ok=True)
    hp.save(run_dir / "HPARAM.json")  # FPC/train.py:277-278
    logger = RunLogger(run_dir, enabled=enable_tb)
    flog, handler = _file_logger(run_dir)
    try:
        flog.info("hparams: %s", hp.to_json().replace("\n", " "))
        net = PoseRegressorNet(hp.num_classes, z_bias_init=hp.HEAD_Z_BIAS_INIT,
                               scales_bias_init=hp.HEAD_SCALES_BIAS_INIT)
        net = init_random_(net, INIT_SEED).to(device)
        pcfg = pipeline_config_from(hp)
        optimizer = make_optimizer(hp, net)
        state = create_train_state(net, optimizer)
        if resume_from:
            state, hp = ckpt.load_any_checkpoint(resume_from, state, hp, optimizer=optimizer)
            flog.info("resumed from %s at step %d", resume_from, state.step)
        train_step = make_train_step(net, optimizer, hp, pcfg, inv_intrinsics, device)
        eval_step = make_eval_step(net, hp, pcfg, inv_intrinsics, device)

        plateau = optim.plateau_init()
        best_val = math.inf
        ckpt_dir = run_dir / "checkpoints"
        for epoch in range(num_epochs or hp.NUM_EPOCHS):
            # ---- train ----
            epoch_t0 = time.perf_counter()
            n_images, host_step = 0, state.step
            pending, recent = [], {}

            def flush(buffered):
                for (step_i, _), logs in zip(buffered, fetch_logs([lg for _, lg in buffered])):
                    logger.log_metrics("train", logs, step_i)
                    if logs.get("grad/finite", 1.0) < 1.0 and step_i in recent:
                        _save_fault_batch(run_dir, step_i, recent[step_i], flog)
                recent.clear()

            for batch in train_loader:
                if batch is None:  # every sample rejected
                    continue
                batch, n_real = pad_batch(batch, hp.BATCH_SIZE)
                state, logs = train_step(state, batch, seed=TRAIN_SEED)
                host_step += 1
                n_images += n_real
                pending.append((host_step, logs))
                recent[host_step] = batch
                if len(pending) >= LOG_EVERY:
                    flush(pending)
                    pending = []
            flush(pending)
            dt = time.perf_counter() - epoch_t0
            logger.log_metrics("train", {"throughput/images_per_s": n_images / max(dt, 1e-9),
                                         "optim/lr_scale": plateau.scale},
                               host_step, accumulate=False)
            logger.log_epoch_average("train", epoch)

            # ---- validate ----
            bank = M.init_pose_metric_bank(device)
            pending_val, val_weights = [], []
            for batch in valid_loader:
                if batch is None:
                    continue
                batch, n_real = pad_batch(batch, hp.BATCH_SIZE)
                val_weights.append(n_real)
                logs, bank, _ = eval_step(state, batch, bank, seed=epoch)
                pending_val.append(logs)
            val_logs = fetch_logs(pending_val)
            for lg in val_logs:
                logger.log_metrics("valid", lg, host_step)
            pose_vals = {f"pose/{k}": float(v)
                         for k, v in M.compute_pose_metric_bank(bank).items()}
            logger.log_metrics("valid", pose_vals, host_step, accumulate=False)
            logger.log_epoch_average("valid", epoch)
            # Weighted by real samples: a short last batch counts its samples.
            val_loss = (float(np.average([lg["pose/total_loss"] for lg in val_logs],
                                         weights=val_weights))
                        if val_logs else math.inf)

            # ---- plateau LR (pose_regressor.py:417-438) ----
            plateau = optim.plateau_update(plateau, val_loss, patience=hp.PLATEAU_PATIENCE,
                                           factor=hp.PLATEAU_FACTOR,
                                           min_scale=hp.PLATEAU_MIN_SCALE)
            state = dataclasses.replace(
                state, opt_state=optim.set_lr_scale(state.opt_state, plateau.scale))

            # ---- checkpoints ----
            if val_loss < best_val:
                best_val = val_loss
                ckpt.save_checkpoint(ckpt_dir / "best", state.step, state, hp)
            if (epoch + 1) % hp.CKPT_SAVE_FREQUENCY == 0:
                ckpt.save_checkpoint(ckpt_dir / "periodic", state.step, state, hp)
            msg = (f"epoch {epoch}: val_loss={val_loss:.4f} "
                   f"lr_scale={plateau.scale:.4f} skipped={state.skipped_updates} "
                   + " ".join(f"{k.split('/')[-1]}={v:.2f}" for k, v in pose_vals.items()))
            print(msg, flush=True)
            flog.info(msg)

        ckpt.save_checkpoint(ckpt_dir / "last", state.step, state, hp)
        logger.log_hparams(dataclasses.asdict(hp), {"best_val_loss": best_val})
        return state, run_dir
    finally:
        logger.close()
        flog.removeHandler(handler)
        handler.close()
