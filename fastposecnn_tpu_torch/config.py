"""Hyperparameters, the EVALUATING and INFERENCE presets, the --FIELD
command-line overrides and `pipeline_config_from`: a copy of the JAX
package's `config.py` (`HParams`, `evaluating()` at :235-247, `inference()`
at :250-269, `add_cli_overrides`/`apply_cli_overrides` at :280+,
`merge_from_checkpoint`, `pipeline_config_from` at :356-376), cut to the
fields the port reads.

A checkpoint's hparams JSON may hold fields this copy lacks; `from_json`
drops them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional, Tuple

from fastposecnn_tpu_torch.constants import CAMERA_CLASSES

# Architecture-defining fields restored from a checkpoint.
ARCH_FIELDS = (
    "MODEL",
    "BACKBONE_ARCH",
    "ENCODER",
    "ENCODER_WEIGHTS",
    "SELECTED_CLASSES",
)


@dataclasses.dataclass
class HParams:
    CHECKPOINT: Optional[str] = None

    MODEL: str = "PoseRegressor"
    DATASET_NAME: str = "CAMERA"
    SELECTED_CLASSES: Tuple[str, ...] = CAMERA_CLASSES

    BATCH_SIZE: int = 3
    TRAIN_SIZE: Optional[int] = 100
    VALID_SIZE: Optional[int] = 20

    BACKBONE_ARCH: str = "FPN"
    ENCODER: str = "resnet18"
    ENCODER_WEIGHTS: Optional[str] = "imagenet"

    HV_NUM_OF_HYPOTHESES: int = 128
    HV_ADAPTIVE: bool = True
    HV_IMPLEMENTATION: str = "ransac"
    HV_REFINE: str = "dense"

    MAX_INSTANCES: int = 16
    MAX_VOTE_POINTS: int = 1024
    IMAGE_HEIGHT: int = 480
    IMAGE_WIDTH: int = 640

    @property
    def num_classes(self) -> int:
        return len(self.SELECTED_CLASSES)

    @classmethod
    def from_json(cls, text: str) -> "HParams":
        d = json.loads(text)
        d["SELECTED_CLASSES"] = tuple(d["SELECTED_CLASSES"])
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def evaluating(**overrides) -> HParams:
    """Evaluation preset: the adaptive 1000-hypothesis vote."""
    base = dict(
        TRAIN_SIZE=1,
        VALID_SIZE=10_000,
        HV_NUM_OF_HYPOTHESES=1000,
    )
    base.update(overrides)
    return dataclasses.replace(HParams(), **base)


def inference(**overrides) -> HParams:
    """Real-time inference preset: one fixed 4096-hypothesis vote."""
    base = dict(
        HV_NUM_OF_HYPOTHESES=4096,
        HV_ADAPTIVE=False,
        BATCH_SIZE=1,
        VALID_SIZE=100,
        TRAIN_SIZE=1,
    )
    base.update(overrides)
    return dataclasses.replace(HParams(), **base)


def add_cli_overrides(parser: argparse.ArgumentParser, hp: HParams) -> None:
    """Turn every HParams field into a --FIELD flag with inferred type."""
    for f in dataclasses.fields(hp):
        default = getattr(hp, f.name)
        if isinstance(default, bool):
            parser.add_argument(
                f"--{f.name}",
                type=lambda s: s.lower() in ("1", "true", "yes"),
                default=None,
            )
        elif isinstance(default, tuple):
            parser.add_argument(f"--{f.name}", nargs="+", default=None)
        elif isinstance(default, int):
            parser.add_argument(f"--{f.name}", type=int, default=None)
        elif isinstance(default, float):
            parser.add_argument(f"--{f.name}", type=float, default=None)
        else:
            parser.add_argument(f"--{f.name}", type=str, default=None)


def apply_cli_overrides(hp: HParams, args: argparse.Namespace) -> HParams:
    updates = {}
    for f in dataclasses.fields(hp):
        val = getattr(args, f.name, None)
        if val is not None:
            if isinstance(getattr(hp, f.name), tuple):
                val = tuple(val)
            updates[f.name] = val
    return dataclasses.replace(hp, **updates)


def merge_from_checkpoint(hp: HParams, ckpt_hp: HParams) -> HParams:
    """Restore only the architecture-defining fields from a checkpoint's
    hparams."""
    updates = {k: getattr(ckpt_hp, k) for k in ARCH_FIELDS}
    return dataclasses.replace(hp, **updates)


def pipeline_config_from(hp: HParams, impl: Optional[str] = None):
    from fastposecnn_tpu_torch.pipeline import PipelineConfig

    return PipelineConfig(
        max_instances=hp.MAX_INSTANCES,
        max_points=hp.MAX_VOTE_POINTS,
        hv_num_hypotheses=hp.HV_NUM_OF_HYPOTHESES,
        hv_adaptive=hp.HV_ADAPTIVE,
        hv_implementation=hp.HV_IMPLEMENTATION,
        hv_refine=hp.HV_REFINE,
        impl=impl,
    )
