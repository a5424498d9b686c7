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

Data parallel (`parallel.mesh`): inside a process group each rank passes
its rows of every padded global batch (the loaders are sharded by rank,
`data.loader.PrefetchLoader(shard=...)`) and the steps are the global
batch's, so every log, the validation loss, the plateau schedule and the
metric bank are the same on every rank. Rank 0 alone writes the run dir,
`HPARAM.json`, `run.log`, TensorBoard, checkpoints and fault batches (the
global batch, gathered); a resume loads on rank 0 and `replicate`s. A
`BATCH_SIZE` that the ranks do not divide raises before the first step. A
global batch with no real sample is skipped by every rank.

Each epoch (`visualize_every`), the first validation batch's first
samples are drawn as figures (`log_epoch_visualizations`: masks, voted
centres, poses; the JAX loop's, FPC/callbacks.py:262-523) into TensorBoard
and `visualizations/epoch<E>_s<i>.png` (written by `data/png.py`), by rank
0 from its rows. They need matplotlib and cv2: without them the loop says
so once and trains without figures; as in the JAX loop, a failure to draw
is reported (printed, and logged with its traceback in run.log) and never
stops training.
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
from fastposecnn_tpu_torch.data.loader import empty_batch, pad_batch
from fastposecnn_tpu_torch.device import resolve_device
from fastposecnn_tpu_torch.models import network_from_hparams
from fastposecnn_tpu_torch.models.weights import init_random_
from fastposecnn_tpu_torch.parallel import mesh
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


def _quiet_logger():
    """A logger for the ranks other than 0, which write nothing."""
    flog = logging.getLogger("fastposecnn_tpu_torch.rank")
    flog.propagate = False
    handler = logging.NullHandler()
    flog.addHandler(handler)
    return flog, handler


def _rank_batch(batch, hp: HParams, device):
    """This rank's batch padded to its rows of `BATCH_SIZE`, and the real
    samples of the global batch (0: every rank skips it; without a group,
    a None batch)."""
    ranks = mesh.world_size()
    if batch is None:
        if ranks == 1:
            return None, 0
        batch = empty_batch(hp.IMAGE_HEIGHT, hp.IMAGE_WIDTH, hp.MAX_INSTANCES)
    batch, n_real = pad_batch(batch, hp.BATCH_SIZE // ranks)
    if ranks > 1:
        n_real = int(mesh.global_sum(torch.full((), float(n_real), device=device)))
    return (batch if n_real else None), n_real


def _global_batch(batch):
    """The ranks' batches, gathered and concatenated in rank order."""
    if mesh.world_size() == 1:
        return batch
    parts = mesh.all_gather_object(batch)
    return {"image": np.concatenate([b["image"] for b in parts]),
            "mask": np.concatenate([b["mask"] for b in parts]),
            "agg": {k: np.concatenate([b["agg"][k] for b in parts]) for k in batch["agg"]}}


def _save_fault_batch(run_dir, step, batch, flog):
    """The batch of a step whose gradients were not finite, for replay."""
    path = run_dir / f"fault_batch_step{step}.npz"
    np.savez_compressed(path, image=batch["image"], mask=batch["mask"],
                        **{f"agg_{k}": v for k, v in batch["agg"].items()})
    flog.warning("non-finite gradients at step %d; batch saved to %s", step, path)


def log_epoch_visualizations(logger: RunLogger, out, batch, hp: HParams, epoch: int,
                             run_dir: pathlib.Path, num_samples: int = 3) -> None:
    """Figures of the first `num_samples` samples of a validation batch
    (numpy, as the loader gives it) and the eval step's pipeline output
    `out`: the image, the GT and predicted masks, the voted centres against
    the GT ones and the GT and predicted poses, into TensorBoard and
    `run_dir/visualizations/epoch<E>_s<i>.png` (FPC/callbacks.py:262-523;
    the JAX package's `train/loop.py:94-150`)."""
    from fastposecnn_tpu_torch import constants
    from fastposecnn_tpu_torch.data.png import encode_png
    from fastposecnn_tpu_torch.utils import visualize as vz

    intr = constants.scaled_intrinsics(hp.DATASET_NAME, hp.IMAGE_HEIGHT, hp.IMAGE_WIDTH)
    pred_mask = out["categorical"]["mask"].cpu().numpy()
    agg = out.get("aggregated")
    agg = None if agg is None else {k: v.cpu().numpy() for k, v in agg.items()
                                    if k in ("xy", "valid", "RT", "scales")}
    viz_dir = run_dir / "visualizations"
    viz_dir.mkdir(exist_ok=True)
    for i in range(min(num_samples, batch["image"].shape[0])):
        img = vz.denormalize_image(np.asarray(batch["image"][i]))
        panels = {"rgb": img,
                  "gt_mask": vz.colorize_mask(np.asarray(batch["mask"][i]), hp.num_classes),
                  "pred_mask": vz.colorize_mask(pred_mask[i], hp.num_classes)}
        if agg is not None and "xy" in agg:
            panels["hough"] = vz.visualize_hypothesis(
                img, agg["xy"][i], agg["valid"][i],
                gt_centers=np.asarray(batch["agg"]["xy"][i]))
        if agg is not None and "RT" in agg:
            panels["pose"] = vz.compare_pose_performance(
                img, np.asarray(batch["agg"]["RT"][i]), np.asarray(batch["agg"]["scales"][i]),
                agg["RT"][i], agg["scales"][i],
                np.asarray(batch["agg"]["valid"][i]) & agg["valid"][i], intr)
        arr = vz.figure_to_array(vz.make_summary_figure(**panels))
        logger.log_image("valid", f"epoch_viz/sample_{i}", arr / 255.0, epoch)
        encode_png(viz_dir / f"epoch{epoch}_s{i}.png", np.ascontiguousarray(arr))


def _visualizations_available(flog) -> bool:
    """Whether the packages the per-epoch figures need import; if not, says
    so once (printed and in run.log)."""
    from fastposecnn_tpu_torch.utils.optional import need, pyplot

    try:
        pyplot("the per-epoch visualisations")
        need("cv2", "the per-epoch visualisations")
    except ImportError as e:
        print(f"visualizations off: {e}", flush=True)
        flog.warning("visualizations off: %s", e)
        return False
    return True


def fit(hp: HParams, train_loader, valid_loader, inv_intrinsics,
        run_dir: Optional[pathlib.Path] = None, device=None, enable_tb: bool = True,
        num_epochs: Optional[int] = None, resume_from: Optional[str] = None,
        visualize_every: int = 1):
    """Train `num_epochs` (default `hp.NUM_EPOCHS`) epochs on `device` (CUDA
    unless "cpu" is given), from seeded random weights or `resume_from` (a
    full checkpoint, with its optimizer; or the weights of an npz snapshot or
    a reference torch checkpoint, the optimizer re-derived from them), with
    the per-epoch visualisations every `visualize_every` epochs (0: none).
    Returns (final TrainState, run_dir)."""
    device = resolve_device(device)
    ranks, lead = mesh.world_size(), mesh.rank() == 0
    if hp.BATCH_SIZE % ranks:
        raise ValueError(f"BATCH_SIZE={hp.BATCH_SIZE} does not split over {ranks} "
                         "data-parallel ranks")
    if resume_from:
        hp = ckpt.merge_arch_from_any(resume_from, hp)
    if lead:
        run_dir = pathlib.Path(run_dir) if run_dir else make_run_dir(hp)
        run_dir.mkdir(parents=True, exist_ok=True)
        hp.save(run_dir / "HPARAM.json")  # FPC/train.py:277-278
    run_dir = pathlib.Path(mesh.broadcast_object(str(run_dir) if lead else None))
    logger = RunLogger(run_dir, enabled=enable_tb and lead)
    flog, handler = _file_logger(run_dir) if lead else _quiet_logger()
    try:
        flog.info("hparams: %s", hp.to_json().replace("\n", " "))
        if ranks > 1:
            flog.info("data-parallel over %d ranks (%s), %d samples a rank", ranks,
                      mesh.backend(), hp.BATCH_SIZE // ranks)
        net = network_from_hparams(hp)
        net = init_random_(net, INIT_SEED).to(device)
        pcfg = pipeline_config_from(hp)
        optimizer = make_optimizer(hp, net)
        state = create_train_state(net, optimizer)
        if resume_from and lead:
            state, hp = ckpt.load_any_checkpoint(resume_from, state, hp, optimizer=optimizer)
            flog.info("resumed from %s at step %d", resume_from, state.step)
        state = mesh.replicate(state)
        hp = mesh.broadcast_object(hp)
        train_step = make_train_step(net, optimizer, hp, pcfg, inv_intrinsics, device)
        eval_step = make_eval_step(net, hp, pcfg, inv_intrinsics, device)

        if visualize_every and lead and not _visualizations_available(flog):
            visualize_every = 0
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
                        fault = _global_batch(recent[step_i])  # every rank takes part
                        if lead:
                            _save_fault_batch(run_dir, step_i, fault, flog)
                recent.clear()

            for batch in train_loader:
                batch, n_real = _rank_batch(batch, hp, device)
                if batch is None:  # every sample rejected
                    continue
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
            visualize = lead and visualize_every and epoch % visualize_every == 0
            for batch in valid_loader:
                batch, n_real = _rank_batch(batch, hp, device)
                if batch is None:
                    continue
                val_weights.append(n_real)
                logs, bank, out = eval_step(state, batch, bank, seed=epoch)
                pending_val.append(logs)
                if visualize:
                    visualize = False
                    try:
                        log_epoch_visualizations(logger, out, batch, hp, epoch, run_dir)
                    except Exception as e:  # drawing never stops training
                        print(f"visualization failed: {e}", flush=True)
                        flog.exception("visualization failed at epoch %d", epoch)
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

            # ---- checkpoints (rank 0) ----
            if val_loss < best_val:
                best_val = val_loss
                if lead:
                    ckpt.save_checkpoint(ckpt_dir / "best", state.step, state, hp)
            if (epoch + 1) % hp.CKPT_SAVE_FREQUENCY == 0 and lead:
                ckpt.save_checkpoint(ckpt_dir / "periodic", state.step, state, hp)
            msg = (f"epoch {epoch}: val_loss={val_loss:.4f} "
                   f"lr_scale={plateau.scale:.4f} skipped={state.skipped_updates} "
                   + " ".join(f"{k.split('/')[-1]}={v:.2f}" for k, v in pose_vals.items()))
            if lead:
                print(msg, flush=True)
            flog.info(msg)

        if lead:
            ckpt.save_checkpoint(ckpt_dir / "last", state.step, state, hp)
        logger.log_hparams(dataclasses.asdict(hp), {"best_val_loss": best_val})
        return state, run_dir
    finally:
        logger.close()
        flog.removeHandler(handler)
        handler.close()
