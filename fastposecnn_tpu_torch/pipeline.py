"""Post-network stages: logits -> categorical -> instances -> voted centres
-> R/T (counterpart of the JAX package's `pipeline.py:24-144`).

`ransac` voting is ported with both samplers (`bbox`, `cdf`), both RANSAC
schedules (single shot, and the adaptive loop of the EVALUATING preset) and
both refinements (`dense`, `sampled`). `hv_implementation="soft"` is not
ported and raises `NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from fastposecnn_tpu_torch import geometry
from fastposecnn_tpu_torch.ops.aggregation import aggregate_instances
from fastposecnn_tpu_torch.ops.class_compress import class_compress
from fastposecnn_tpu_torch.ops.voting import VoteDraws, hough_vote


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    max_instances: int = 16
    max_points: int = 1024
    hv_num_hypotheses: int = 128
    hv_inlier_thresh: float = 0.999
    hv_confidence: float = 0.99
    hv_max_iter: int = 20
    hv_adaptive: bool = True
    hv_sampler: str = "bbox"  # 'bbox' (one gather round) or 'cdf' (exact)
    hv_refine: str = "dense"  # 'dense' all-pixel LSQ | 'sampled'
    hv_implementation: str = "ransac"
    # None: kernels on CUDA tensors, plain versions on CPU tensors;
    # "reference": plain versions on either device.
    impl: Optional[str] = None

    def check_ported(self) -> None:
        ported = {
            "hv_sampler": (self.hv_sampler, ("bbox", "cdf")),
            "hv_refine": (self.hv_refine, ("dense", "sampled")),
            "hv_implementation": (self.hv_implementation, ("ransac",)),
        }
        for name, (got, values) in ported.items():
            if got not in values:
                raise NotImplementedError(
                    f"{name}={got!r} is not ported; only {values} are")


def stage_class_compress(logits: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    return class_compress(logits)


def stage_aggregate(categorical: Dict[str, Any],
                    config: PipelineConfig) -> Dict[str, Any]:
    return aggregate_instances(categorical, config.max_instances,
                               impl=config.impl)


def stage_hough_voting(aggregated: Dict[str, Any], config: PipelineConfig,
                       draws: Optional[VoteDraws] = None,
                       generator: Optional[torch.Generator] = None,
                       cpu_generator: Optional[torch.Generator] = None):
    return hough_vote(
        aggregated, max_points=config.max_points,
        round_hyp_num=config.hv_num_hypotheses,
        inlier_thresh=config.hv_inlier_thresh, draws=draws,
        generator=generator, cpu_generator=cpu_generator, impl=config.impl,
        adaptive=config.hv_adaptive, confidence=config.hv_confidence,
        max_iter=config.hv_max_iter, sampler=config.hv_sampler,
        refine=config.hv_refine,
    )


def stage_rt_calculation(aggregated: Dict[str, Any],
                         inv_intrinsics: torch.Tensor) -> Dict[str, Any]:
    R, T, RT = geometry.batch_get_RT(
        aggregated["quaternion"], aggregated["xy"],
        aggregated["z"][..., None], inv_intrinsics,
    )
    return dict(aggregated, R=R, T=T, RT=RT)


def run_pipeline(logits: Dict[str, torch.Tensor], config: PipelineConfig,
                 inv_intrinsics: torch.Tensor,
                 draws: Optional[VoteDraws] = None,
                 generator: Optional[torch.Generator] = None,
                 cpu_generator: Optional[torch.Generator] = None
                 ) -> Dict[str, Any]:
    """Compose the post-network stages. Returns {'logits', 'categorical',
    'aggregated'}."""
    config.check_ported()
    categorical = stage_class_compress(logits)
    aggregated = stage_aggregate(categorical, config)
    aggregated = stage_hough_voting(aggregated, config, draws, generator,
                                    cpu_generator)
    aggregated = stage_rt_calculation(aggregated, inv_intrinsics)
    return {"logits": logits, "categorical": categorical,
            "aggregated": aggregated}
