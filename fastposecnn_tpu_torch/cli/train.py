"""Training CLI (counterpart of the JAX package's `cli/train.py`), on CUDA
unless `--device cpu` is given.

    python -m fastposecnn_tpu_torch.cli.train -e NAME --preset HEAD_TRAINING \
        --synthetic 12 --epochs 2 [--no_tb] [--resume checkpoints/last|snap.npz]
        [--no_augment] [--device cpu] [--HPARAM value ...]

Every `HParams` field is a `--FIELD` flag (FPC/train.py:102-112).
`--synthetic N` trains on N in-memory synthetic scenes from seed 0 with the
train augmentation, and validates on max(2, N // 4) scenes from seed 1 with
the validation augmentation: the samples the JAX CLI writes as NOCS folders
and reads back. The augmentation runs the native operators
(`native/augment.cpp`, built with g++ at first use). Pretrained ImageNet
encoder weights are not in the repo: training starts from seeded random
weights or from `--resume`.

Not ported, and refused: reading NOCS folders (`--train_dir`,
`--valid_dir`, the NOCS_*_DATASET variables; ROADMAP.md item 14) and the
device-resident staged trainer (`--stage_on_device`, `--restage_every`,
`--snapshot_npz`, `--bank_pool_dir`; ROADMAP.md item 12).
"""

from __future__ import annotations

import argparse

import numpy as np

from fastposecnn_tpu_torch import config as C
from fastposecnn_tpu_torch import constants
from fastposecnn_tpu_torch.device import resolve_device

STAGED_FLAGS = ("stage_on_device", "restage_every", "snapshot_npz", "bank_pool_dir")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-e", "--experiment", default="TESTING")
    parser.add_argument("--preset", default="HEAD_TRAINING", choices=sorted(C.PRESETS))
    parser.add_argument("--train_dir", default=None, help="not ported: use --synthetic")
    parser.add_argument("--valid_dir", default=None, help="not ported: use --synthetic")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="train on N in-memory synthetic scenes")
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
    parser.add_argument("--stage_on_device", action="store_true", help="not ported")
    parser.add_argument("--restage_every", type=int, default=0, help="not ported")
    parser.add_argument("--snapshot_npz", default=None, help="not ported")
    parser.add_argument("--bank_pool_dir", default=None, help="not ported")
    parser.add_argument("--device", default=None, help="'cuda' (the default) or 'cpu'")
    C.add_cli_overrides(parser, C.HParams())
    return parser


def refuse_unported(args) -> None:
    staged = [f"--{f}" for f in STAGED_FLAGS if getattr(args, f)]
    if staged:
        raise NotImplementedError(
            f"{', '.join(staged)}: the device-resident staged trainer is not ported "
            "(ROADMAP.md queue A item 12)")
    if args.train_dir or args.valid_dir or not args.synthetic:
        raise NotImplementedError(
            "reading NOCS folders from disk (--train_dir, --valid_dir, NOCS_*_DATASET) "
            "is not ported (ROADMAP.md queue A item 14): pass --synthetic N")


def synthetic_sources(hp, args):
    """(train, valid) in-memory sources: N scenes from seed 0 with the train
    augmentation, max(2, N // 4) from seed 1 with the validation one."""
    from fastposecnn_tpu_torch.data.nocs import SyntheticNOCSSource
    from fastposecnn_tpu_torch.data.synthetic import SceneConfig

    scfg = SceneConfig(height=hp.IMAGE_HEIGHT, width=hp.IMAGE_WIDTH,
                       num_classes=hp.num_classes, max_instances=hp.MAX_INSTANCES,
                       render_pose_cues=args.synthetic_pose_cues,
                       cue_boost=args.synthetic_cue_boost)
    common = dict(dataset_name=hp.DATASET_NAME, selected_classes=hp.SELECTED_CLASSES,
                  max_instances=hp.MAX_INSTANCES)
    train = SyntheticNOCSSource(args.synthetic, 0, scfg, max_size=hp.TRAIN_SIZE,
                                augmentation=None if args.no_augment else "train", **common)
    valid = SyntheticNOCSSource(max(2, args.synthetic // 4), 1, scfg, max_size=hp.VALID_SIZE,
                                augmentation=None if args.no_augment else "valid", **common)
    return train, valid


def main(argv=None):
    """Parse, build the sources and loaders, and `train.loop.fit`. Returns
    (final TrainState, run dir)."""
    args = build_parser().parse_args(argv)
    refuse_unported(args)
    hp = C.PRESETS[args.preset](EXPERIMENT_NAME=args.experiment)
    hp = C.apply_cli_overrides(hp, args)
    device = resolve_device(args.device)
    if hp.DETERMINISTIC:  # FPC/train.py:125-137
        np.random.seed(125)

    from fastposecnn_tpu_torch.data.loader import PrefetchLoader
    from fastposecnn_tpu_torch.train.loop import fit

    train_ds, valid_ds = synthetic_sources(hp, args)
    train_loader = PrefetchLoader(train_ds, hp.BATCH_SIZE, shuffle=not hp.DETERMINISTIC,
                                  num_workers=hp.NUM_WORKERS)
    valid_loader = PrefetchLoader(valid_ds, hp.BATCH_SIZE, shuffle=False,
                                  num_workers=hp.NUM_WORKERS)
    inv_k = np.linalg.inv(constants.scaled_intrinsics(hp.DATASET_NAME, hp.IMAGE_HEIGHT,
                                                       hp.IMAGE_WIDTH))
    state, run_dir = fit(hp, train_loader, valid_loader, inv_k, device=device,
                         enable_tb=not args.no_tb, num_epochs=args.epochs,
                         resume_from=args.resume)
    print(f"run dir: {run_dir}", flush=True)
    return state, run_dir


if __name__ == "__main__":
    main()
