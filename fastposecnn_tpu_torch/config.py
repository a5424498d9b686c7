"""Hyperparameters, the presets (DEFAULT, MASK_TRAINING, HEAD_TRAINING,
EVALUATING, INFERENCE), the --FIELD command-line overrides and
`pipeline_config_from`: a copy of the JAX package's `config.py` (`HParams`
at :35-180, the presets at :196-269, `add_cli_overrides`/
`apply_cli_overrides` at :280+, `staged_plateau_defaults` at :318-336,
`merge_from_checkpoint`, `pipeline_config_from` at :356-376).

`COMPUTE_DTYPE` is kept for the JSON round trip: the JAX trainer honours
"bfloat16" only on a TPU (`train/loop.py:195-196`), and the port computes
in float32 whatever it says. A checkpoint's hparams JSON may hold fields
this copy lacks; `from_json` drops them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
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
    EXPERIMENT_NAME: str = "TESTING"
    DEBUG: bool = False
    DETERMINISTIC: bool = False
    RUNTIME_TIMING: bool = False

    CHECKPOINT: Optional[str] = None

    MODEL: str = "PoseRegressor"
    DATASET_NAME: str = "CAMERA"
    SELECTED_CLASSES: Tuple[str, ...] = CAMERA_CLASSES
    CKPT_SAVE_FREQUENCY: int = 2

    BATCH_SIZE: int = 3
    NUM_WORKERS: int = 4
    NUM_DEVICES: int = 1
    NUM_TP: int = 1
    TRAIN_SIZE: Optional[int] = 100
    VALID_SIZE: Optional[int] = 20

    # Optimization: RAdam + Lookahead, global-norm clip, plateau scale
    # (train/optim.py).
    WEIGHT_DECAY: float = 0.0003
    LEARNING_RATE: float = 0.0001 / 10
    ENCODER_LEARNING_RATE: float = 0.00005 / 10
    NUM_EPOCHS: int = 50
    GRADIENT_CLIP_VAL: float = 0.15
    PLATEAU_PATIENCE: int = 2
    PLATEAU_FACTOR: float = 0.25
    PLATEAU_MIN_SCALE: float = 1e-4

    # Loss weights and kinds (losses.py, train/task.py).
    MASK_WEIGHT: float = 5.0
    QUAT_WEIGHT: float = 0.1
    XY_WEIGHT: float = 0.01
    Z_WEIGHT: float = 0.1
    SCALES_WEIGHT: float = 0.1
    XYLOSS_TYPE: str = "L1"
    ZLOSS_TYPE: str = "L1"
    SCALESLOSS_TYPE: str = "L1"

    # Dense per-pixel supervision over the GT instance masks
    # (`losses.dense_supervision`); 0.0 turns a term off. Voting passes no
    # gradient, so DENSE_XY_WEIGHT is the only gradient path into the xy
    # vote field (HEAD_TRAINING sets it to 1).
    DENSE_QUAT_WEIGHT: float = 0.0
    DENSE_XY_WEIGHT: float = 0.0
    DENSE_Z_WEIGHT: float = 0.0
    DENSE_SCALES_WEIGHT: float = 0.0
    # Dense quaternion target of symmetric instances: "swing" (twist
    # removed), "full" (raw canonical) or "exclude" (no dense term).
    DENSE_SYM_QUAT_MODE: str = "swing"

    # Constant bias of the z and scales heads at initialisation (0.0: zero
    # bias, as the reference).
    HEAD_Z_BIAS_INIT: float = 0.0
    HEAD_SCALES_BIAS_INIT: float = 0.0

    # Freezing: a frozen module's parameters take no update.
    FREEZE_ENCODER: bool = False
    FREEZE_MASK_TRAINING: bool = False
    FREEZE_ROTATION_TRAINING: bool = False
    FREEZE_TRANSLATION_TRAINING: bool = False
    FREEZE_SCALES_TRAINING: bool = False

    # Stage gates of the pipeline and of the matched losses.
    PERFORM_AGGREGATION: bool = True
    PERFORM_HOUGH_VOTING: bool = True
    PERFORM_RT_CALCULATION: bool = True
    PERFORM_MATCHING: bool = True

    BACKBONE_ARCH: str = "FPN"
    ENCODER: str = "resnet18"
    ENCODER_WEIGHTS: Optional[str] = "imagenet"

    HV_NUM_OF_HYPOTHESES: int = 128
    HV_ADAPTIVE: bool = True
    HV_IMPLEMENTATION: str = "ransac"
    HV_REFINE: str = "dense"
    HV_HYPOTHESIS_IN_MASK_MULTIPLIER: int = 3
    PRUN_METHOD: str = "iqr"
    PRUN_OUTLIER_DROP: bool = False
    PRUN_OUTLIER_REPLACEMENT_STYLE: str = "median"
    PRUN_ZSCORE_THRESHOLD: float = 1.0
    IQR_MULTIPLIER: float = 1.5

    MAX_INSTANCES: int = 16
    MAX_VOTE_POINTS: int = 1024
    IMAGE_HEIGHT: int = 480
    IMAGE_WIDTH: int = 640
    # Kept for the JSON round trip; the port computes in float32.
    COMPUTE_DTYPE: str = "bfloat16"

    @property
    def num_classes(self) -> int:
        return len(self.SELECTED_CLASSES)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["SELECTED_CLASSES"] = list(self.SELECTED_CLASSES)
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "HParams":
        d = json.loads(text)
        d["SELECTED_CLASSES"] = tuple(d["SELECTED_CLASSES"])
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def save(self, path) -> None:
        pathlib.Path(path).write_text(self.to_json())

    @classmethod
    def load(cls, path) -> "HParams":
        return cls.from_json(pathlib.Path(path).read_text())


_ALL_STAGES = dict(
    PERFORM_AGGREGATION=True,
    PERFORM_HOUGH_VOTING=True,
    PERFORM_RT_CALCULATION=True,
    PERFORM_MATCHING=True,
)


def _preset(base: dict, overrides: dict) -> HParams:
    return dataclasses.replace(HParams(), **{**base, **overrides})


def default_pose_hparam(**overrides) -> HParams:
    return _preset({}, overrides)


def mask_training(**overrides) -> HParams:
    """Stage 1: the mask only; the other heads frozen, no instance stages."""
    return _preset(dict(
        FREEZE_ENCODER=False,
        FREEZE_MASK_TRAINING=False,
        FREEZE_ROTATION_TRAINING=True,
        FREEZE_TRANSLATION_TRAINING=True,
        FREEZE_SCALES_TRAINING=True,
        PERFORM_AGGREGATION=False,
        PERFORM_HOUGH_VOTING=False,
        PERFORM_RT_CALCULATION=False,
        PERFORM_MATCHING=False,
    ), overrides)


def head_training(**overrides) -> HParams:
    """Stage 2: every stage on, and the dense xy supervision (the only
    gradient path into the xy vote field)."""
    return _preset(dict(_ALL_STAGES, DENSE_XY_WEIGHT=1.0), overrides)


def evaluating(**overrides) -> HParams:
    """Evaluation preset: the adaptive 1000-hypothesis vote."""
    return _preset(dict(_ALL_STAGES, TRAIN_SIZE=1, VALID_SIZE=10_000,
                        HV_NUM_OF_HYPOTHESES=1000), overrides)


def inference(**overrides) -> HParams:
    """Real-time inference preset: one fixed 4096-hypothesis vote."""
    return _preset(dict(_ALL_STAGES, HV_NUM_OF_HYPOTHESES=4096,
                        HV_ADAPTIVE=False, BATCH_SIZE=1, VALID_SIZE=100,
                        TRAIN_SIZE=1, RUNTIME_TIMING=True), overrides)


PRESETS = {
    "DEFAULT": default_pose_hparam,
    "MASK_TRAINING": mask_training,
    "HEAD_TRAINING": head_training,
    "EVALUATING": evaluating,
    "INFERENCE": inference,
}


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


# Staged-mode plateau defaults (the JAX package's `config.py:306-336`). The
# reference's patience 2 / factor 0.25 assumes an epoch is a full pass over
# the real dataset; a staged epoch over a small restaged bank is far cheaper
# and its validation loss is noisy at restage boundaries. Replayed over the
# recorded demo traces (evidence/rot_demo/DEMO_S{1,2}.csv), the reference
# defaults reach the 1e-4 floor by epoch 74 of stage 2 while the rotation
# error still fell; the longest run without improvement during real learning
# is 31 epochs. Patience 50 clears it; factor 0.5 keeps a decay that noise
# set off recoverable (tests/test_torch_plateau_staged.py).
STAGED_PLATEAU_PATIENCE = 50
STAGED_PLATEAU_FACTOR = 0.5


def staged_plateau_defaults(hp: HParams, patience_explicit: bool,
                            factor_explicit: bool) -> HParams:
    """The staged plateau defaults in place of those the user did not set
    (the train CLI calls it for --stage_on_device with --restage_every);
    explicit --PLATEAU_PATIENCE/--PLATEAU_FACTOR flags always win."""
    updates = {}
    if not patience_explicit:
        updates["PLATEAU_PATIENCE"] = STAGED_PLATEAU_PATIENCE
    if not factor_explicit:
        updates["PLATEAU_FACTOR"] = STAGED_PLATEAU_FACTOR
    return dataclasses.replace(hp, **updates) if updates else hp


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
        perform_aggregation=hp.PERFORM_AGGREGATION,
        perform_hough_voting=hp.PERFORM_HOUGH_VOTING,
        perform_rt_calculation=hp.PERFORM_RT_CALCULATION,
        max_instances=hp.MAX_INSTANCES,
        max_points=hp.MAX_VOTE_POINTS,
        hv_num_hypotheses=hp.HV_NUM_OF_HYPOTHESES,
        hv_adaptive=hp.HV_ADAPTIVE,
        hv_implementation=hp.HV_IMPLEMENTATION,
        hv_refine=hp.HV_REFINE,
        prun_method=None if hp.PRUN_METHOD in (None, "none") else hp.PRUN_METHOD,
        prun_outlier_drop=hp.PRUN_OUTLIER_DROP,
        prun_replacement=hp.PRUN_OUTLIER_REPLACEMENT_STYLE,
        prun_zscore_threshold=hp.PRUN_ZSCORE_THRESHOLD,
        iqr_multiplier=hp.IQR_MULTIPLIER,
        hv_in_mask_multiplier=float(hp.HV_HYPOTHESIS_IN_MASK_MULTIPLIER),
        impl=impl,
    )
