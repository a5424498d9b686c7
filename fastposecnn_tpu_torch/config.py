"""The hyperparameters the inference path reads, the INFERENCE preset and
`pipeline_config_from`: a copy of the JAX package's `config.py`
(`HParams`, `inference()` at :250-269, `pipeline_config_from` at :356-376),
cut to the fields the port uses.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from fastposecnn_tpu_torch.constants import CAMERA_CLASSES


@dataclasses.dataclass
class HParams:
    DATASET_NAME: str = "CAMERA"
    SELECTED_CLASSES: Tuple[str, ...] = CAMERA_CLASSES

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


def inference(**overrides) -> HParams:
    """Real-time inference preset: one fixed 4096-hypothesis vote."""
    base = dict(
        HV_NUM_OF_HYPOTHESES=4096,
        HV_ADAPTIVE=False,
    )
    base.update(overrides)
    return dataclasses.replace(HParams(), **base)


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
