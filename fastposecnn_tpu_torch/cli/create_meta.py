"""Offline data preparation: a raw NOCS tree -> `*_meta+.json` beside each
colour image (counterpart of the JAX package's `cli/create_meta.py`; the
reference's create_meta+.py CLI).

    python -m fastposecnn_tpu_torch.cli.create_meta --root RAW_DIR \
        [--DATASET_NAME CAMERA|REAL] [--obj_models_dir OBJ_MODELS] [--overwrite]

Like the JAX CLI it computes on the host, in float64 numpy
(`data/meta_plus.py`), so it has no `--device`: no GPU is used. The root
defaults to the environment variable NOCS_<DATASET_NAME>_RAW and the
object-model library to NOCS_OBJ_MODELS.
"""

from __future__ import annotations

import argparse
import os
import pathlib

from fastposecnn_tpu_torch import constants
from fastposecnn_tpu_torch.data.meta_plus import create_meta_plus_dataset


def main(argv=None) -> int:
    """Write the meta+ files; returns how many were written."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--DATASET_NAME", default="CAMERA", choices=["CAMERA", "REAL"])
    parser.add_argument("--root", default=None,
                        help="raw dataset root (default: env NOCS_<NAME>_RAW)")
    parser.add_argument("--obj_models_dir", default=None,
                        help="NOCS obj_models library for bbox scales "
                             "(default: env NOCS_OBJ_MODELS)")
    parser.add_argument("--overwrite", action="store_true")
    args = parser.parse_args(argv)

    root = args.root or os.getenv(f"NOCS_{args.DATASET_NAME}_RAW")
    if not root or not pathlib.Path(root).exists():
        raise SystemExit("raw dataset root not found; pass --root")
    n = create_meta_plus_dataset(
        root, constants.INTRINSICS[args.DATASET_NAME], overwrite=args.overwrite,
        obj_models_dir=args.obj_models_dir or os.getenv("NOCS_OBJ_MODELS"),
        dataset_name=args.DATASET_NAME)
    print(f"wrote {n} meta+ files under {root}")
    return n


if __name__ == "__main__":
    main()
