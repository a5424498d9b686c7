"""Training CLI (counterpart of the JAX package's `cli/train.py`), on CUDA
unless `--device cpu` is given.

    python -m fastposecnn_tpu_torch.cli.train -e NAME --preset HEAD_TRAINING \
        (--synthetic N | --train_dir D --valid_dir D) --epochs 2 [--no_tb]
        [--stage_on_device [--restage_every K] [--snapshot_npz F]
         [--bank_pool_dir D]] [--resume checkpoints/last|snap.npz]
        [--no_augment] [--device cpu] [--NUM_DEVICES N] [--HPARAM value ...]

Every `HParams` field is a `--FIELD` flag (FPC/train.py:102-112). The data
are NOCS folders (`data.nocs.NOCSDataset`, PNGs decoded without an image
package): `--train_dir`/`--valid_dir`, else the NOCS_{CAMERA,REAL}_
{TRAIN,VALID}_DATASET variables (FPC/.env:1-27), or `--synthetic N`, which
writes N synthetic scenes from seed 0 (train) and max(2, N // 4) from seed
1 (valid) as NOCS folders, under `--bank_pool_dir` (a bank there with its
`.complete` marker is reused) or under a temporary directory removed at
the end of the run. The train split takes the train augmentation (through
the native operators, `native/augment.cpp`), the valid split the
noise-only one.

The streaming trainer (`train/loop.py`) reads batches through
`PrefetchLoader`; `--stage_on_device` runs the device-resident staged
trainer (`train/staged.py`), and with `--restage_every K` and
`--synthetic` it re-stages every K epochs onto the next bank of a rotating
pool (`data/bank_pool.py`) that a background renderer fills, with the
staged plateau defaults (`config.staged_plateau_defaults`) unless
--PLATEAU_PATIENCE/--PLATEAU_FACTOR are given. Pretrained ImageNet encoder
weights are not in the repo: training starts from seeded random weights or
from `--resume`.

`--NUM_DEVICES N` trains the streaming trainer data-parallel over N ranks
(`parallel.mesh.launch`): one a card over NCCL, or, with `--device cpu`,
N gloo processes. Each rank loads its rows of every global batch of
`BATCH_SIZE` (which N must divide); rank 0 writes the run dir. With fewer
cards than N it trains on one and says so, as the JAX loop builds no mesh
then. The staged trainer uses one device and only warns about
`--NUM_DEVICES`. `--NUM_TP` above 1 (tensor parallelism) is refused.
"""

from __future__ import annotations

import argparse
import logging
import os
import pathlib
import shutil
import tempfile

import numpy as np
import torch

from fastposecnn_tpu_torch import config as C
from fastposecnn_tpu_torch import constants
from fastposecnn_tpu_torch.device import resolve_device
from fastposecnn_tpu_torch.parallel import mesh


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-e", "--experiment", default="TESTING")
    parser.add_argument("--preset", default="HEAD_TRAINING", choices=sorted(C.PRESETS))
    parser.add_argument("--train_dir", default=None, help="a NOCS training folder")
    parser.add_argument("--valid_dir", default=None, help="a NOCS validation folder")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="write N synthetic scenes as NOCS folders and train on them")
    parser.add_argument("--synthetic_pose_cues", action="store_true",
                        help="render pose-informative cues (projected size and "
                             "orientation shading)")
    parser.add_argument("--synthetic_cue_boost", action="store_true",
                        help="with --synthetic_pose_cues: stronger orientation cues")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--no_tb", action="store_true")
    parser.add_argument("--resume", default=None,
                        help="a checkpoint directory of this package (optimizer "
                             "included), an npz snapshot or a reference torch "
                             "checkpoint (weights only)")
    parser.add_argument("--no_augment", action="store_true",
                        help="disable the per-split augmentation pipelines")
    parser.add_argument("--stage_on_device", action="store_true",
                        help="device-resident trainer: stage the whole dataset in the "
                             "card's memory and gather each batch there "
                             "(train/staged.py)")
    parser.add_argument("--restage_every", type=int, default=0,
                        help="with --stage_on_device: re-stage the (augmented) training "
                             "set every K epochs")
    parser.add_argument("--snapshot_npz", default=None,
                        help="with --stage_on_device: an npz weight snapshot of the best "
                             "state, refreshed on the best-flush cadence (at most every "
                             "10 min) and written once more at the end")
    parser.add_argument("--bank_pool_dir", default=None,
                        help="with --synthetic: a persistent directory for the banks "
                             "and the rotating pool; a relaunched run reuses the banks "
                             "rendered there (with the same scene config)")
    parser.add_argument("--device", default=None, help="'cuda' (the default) or 'cpu'")
    C.add_cli_overrides(parser, C.HParams())
    return parser


def dataset_dirs(hp, args):
    """(train, valid) folders from the flags, else the NOCS_* variables."""
    name = hp.DATASET_NAME
    return (args.train_dir or os.getenv(f"NOCS_{name}_TRAIN_DATASET"),
            args.valid_dir or os.getenv(f"NOCS_{name}_VALID_DATASET"))


def render_if_empty(d: pathlib.Path, n: int, seed: int, scfg) -> pathlib.Path:
    """`d`, rendered with `n` synthetic scenes of `seed` unless it already
    holds a whole bank (its `.complete` marker); a torn bank is discarded."""
    from fastposecnn_tpu_torch.data.nocs_writer import write_synthetic_nocs

    if d.exists() and any(d.iterdir()):
        if (d / ".complete").exists():
            return d
        logging.getLogger("fastposecnn_tpu_torch").warning(
            "discarding incomplete scene bank %s (no .complete marker: torn render?)", d)
        shutil.rmtree(d)
    write_synthetic_nocs(d, n, seed, scfg)
    return d


def synthetic_banks(hp, args):
    """(root, train folder, valid folder) of `--synthetic N`: N scenes of seed
    0 and max(2, N // 4) of seed 1, under `--bank_pool_dir` or a new
    temporary directory."""
    from fastposecnn_tpu_torch.data.synthetic import SceneConfig

    if args.bank_pool_dir:
        root = pathlib.Path(args.bank_pool_dir)
        root.mkdir(parents=True, exist_ok=True)
    else:
        root = pathlib.Path(tempfile.mkdtemp(prefix="fpcnn_synth_"))
    scfg = SceneConfig(height=hp.IMAGE_HEIGHT, width=hp.IMAGE_WIDTH,
                       num_classes=hp.num_classes, max_instances=hp.MAX_INSTANCES,
                       render_pose_cues=args.synthetic_pose_cues,
                       cue_boost=args.synthetic_cue_boost)
    train_dir = render_if_empty(root / "train", args.synthetic, 0, scfg)
    valid_dir = render_if_empty(root / "valid", max(2, args.synthetic // 4), 1, scfg)
    return root, train_dir, valid_dir


def datasets(hp, args, train_dir, valid_dir):
    """(train, valid) folder datasets with their splits' augmentation."""
    from fastposecnn_tpu_torch.data.nocs import NOCSDataset

    common = dict(dataset_name=hp.DATASET_NAME, selected_classes=hp.SELECTED_CLASSES,
                  max_instances=hp.MAX_INSTANCES)
    train = NOCSDataset(train_dir, max_size=hp.TRAIN_SIZE,
                        augmentation=None if args.no_augment else "train", **common)
    valid = NOCSDataset(valid_dir, max_size=hp.VALID_SIZE,
                        augmentation=None if args.no_augment else "valid", **common)
    return train, valid


def data_parallel_ranks(requested: int, device) -> int:
    """The ranks `--NUM_DEVICES` gets: as many as asked on the CPU (gloo
    processes) or one a card; with fewer cards than asked, one (a warning
    says so, as the JAX loop trains without a mesh then)."""
    if requested <= 1:
        return 1
    if device.type == "cuda" and torch.cuda.device_count() < requested:
        print(f"WARNING: --NUM_DEVICES={requested} requested but only "
              f"{torch.cuda.device_count()} card(s) visible; training on a single "
              "device.", flush=True)
        return 1
    return requested


def _streaming_rank(hp, args, train_dir, valid_dir, inv_k, device, built=None):
    """The streaming trainer on this rank (the datasets `built`, else read
    from the folders): its rows of every global batch. Returns (final
    TrainState, run dir); inside a process group, rank 0's state moved to
    the CPU and None on the other ranks."""
    from fastposecnn_tpu_torch.data.loader import PrefetchLoader
    from fastposecnn_tpu_torch.train.loop import fit

    train_ds, valid_ds = built or datasets(hp, args, train_dir, valid_dir)
    device = mesh.use_rank_device(device)
    shard = (mesh.rank(), mesh.world_size())
    train_loader = PrefetchLoader(train_ds, hp.BATCH_SIZE, shuffle=not hp.DETERMINISTIC,
                                  num_workers=hp.NUM_WORKERS, shard=shard)
    valid_loader = PrefetchLoader(valid_ds, hp.BATCH_SIZE, shuffle=False,
                                  num_workers=hp.NUM_WORKERS, shard=shard)
    state, run_dir = fit(hp, train_loader, valid_loader, inv_k, device=device,
                         enable_tb=not args.no_tb, num_epochs=args.epochs,
                         resume_from=args.resume)
    if mesh.active():
        state = _on_cpu(state) if mesh.rank() == 0 else None
    return state, run_dir


def _on_cpu(state):
    """A train state with its network and optimizer tensors on the CPU (to
    leave its rank's process)."""
    import dataclasses

    opt = state.opt_state
    return dataclasses.replace(state, net=state.net.cpu(), opt_state=dataclasses.replace(
        opt, **{f.name: {k: t.cpu() for k, t in getattr(opt, f.name).items()}
                for f in dataclasses.fields(opt) if isinstance(getattr(opt, f.name), dict)}))


def main(argv=None):
    """Parse, build the datasets, and train with `train.loop.fit` or, with
    --stage_on_device, `train.staged.fit_staged`. Returns (final TrainState,
    run dir)."""
    args = build_parser().parse_args(argv)
    hp = C.PRESETS[args.preset](EXPERIMENT_NAME=args.experiment)
    hp = C.apply_cli_overrides(hp, args)
    if args.stage_on_device and args.restage_every:
        hp = C.staged_plateau_defaults(hp, patience_explicit=args.PLATEAU_PATIENCE is not None,
                                       factor_explicit=args.PLATEAU_FACTOR is not None)
    if hp.NUM_TP > 1:
        raise NotImplementedError(
            f"--NUM_TP {hp.NUM_TP}: tensor parallelism is not ported "
            "(ROADMAP.md queue A item 13); the port trains data-parallel only")
    device = resolve_device(args.device)
    ranks = 1 if args.stage_on_device else data_parallel_ranks(hp.NUM_DEVICES, device)
    if hp.BATCH_SIZE % ranks:
        raise ValueError(f"BATCH_SIZE={hp.BATCH_SIZE} does not split over --NUM_DEVICES "
                         f"{ranks} ranks")
    if hp.DETERMINISTIC:  # FPC/train.py:125-137
        np.random.seed(125)

    train_dir, valid_dir = dataset_dirs(hp, args)
    bank_pool = None
    if args.synthetic:
        from fastposecnn_tpu_torch.data.bank_pool import BankPool

        root, train_dir, valid_dir = synthetic_banks(hp, args)
        # Each restage moves onto the next bank of a pool that a background
        # renderer keeps filling from seeds 2, 3, ... (train is 0, valid 1):
        # fresh scene geometry, so a fixed bank cannot be memorised.
        bank_pool = BankPool(root, scene_count=args.synthetic, height=hp.IMAGE_HEIGHT,
                             width=hp.IMAGE_WIDTH, num_classes=hp.num_classes,
                             max_instances=hp.MAX_INSTANCES,
                             pose_cues=args.synthetic_pose_cues,
                             cue_boost=args.synthetic_cue_boost, initial=[train_dir])
    if not train_dir or not valid_dir:
        raise SystemExit("No dataset: set the NOCS_*_DATASET variables, pass "
                         "--train_dir/--valid_dir, or use --synthetic N")

    train_ds, valid_ds = datasets(hp, args, train_dir, valid_dir)
    inv_k = np.linalg.inv(constants.scaled_intrinsics(hp.DATASET_NAME, hp.IMAGE_HEIGHT,
                                                       hp.IMAGE_WIDTH))
    try:
        if args.stage_on_device:
            from fastposecnn_tpu_torch.train.staged import fit_staged

            if hp.NUM_DEVICES > 1:
                print(f"WARNING: --stage_on_device trains on a SINGLE device; "
                      f"--NUM_DEVICES {hp.NUM_DEVICES} is ignored.", flush=True)
            regen = None
            if bank_pool is not None and args.restage_every:
                bank_pool.launch()  # fill the pool during staging and epoch 0

                def regen(epoch: int) -> None:
                    train_ds.repoint(bank_pool.rotate())
            state, run_dir = fit_staged(
                hp, train_ds, valid_ds, inv_k, device=device, enable_tb=not args.no_tb,
                num_epochs=args.epochs, resume_from=args.resume,
                restage_every=args.restage_every, regen_fn=regen,
                snapshot_npz=args.snapshot_npz)
        else:
            if ranks > 1:
                state, run_dir = mesh.launch(
                    _streaming_rank, ranks, (hp, args, train_dir, valid_dir, inv_k, device),
                    backend=mesh.default_backend(device),
                    threads=mesh.cpu_threads(ranks, device))[0]
            else:
                state, run_dir = _streaming_rank(hp, args, train_dir, valid_dir, inv_k,
                                                 device, (train_ds, valid_ds))
    finally:
        # Also after a failed fit: the in-flight render would go on using the
        # host's CPU and the pool's disk.
        if bank_pool is not None:
            bank_pool.shutdown()
            if not args.bank_pool_dir:
                shutil.rmtree(bank_pool.root, ignore_errors=True)
    print(f"run dir: {run_dir}", flush=True)
    return state, run_dir


if __name__ == "__main__":
    main()
