"""Hand-written CUDA kernels for Hopper and their launch counters.

Each wrapper adds one to its counter, the tracer's `launch/<kernel>`
(`utils.timer`), where it launches its kernel, and nowhere else, so a run
can show that its main path went through the kernels. The wrappers live
beside their plain PyTorch versions, in `ops/connected_components.py`
(cc_label), `ops/voting.py` (vote_count), `probes/vote_variants.py`
(vote_expanded_mm and vote_expanded_bcast, the probe of K2's formulation,
on no main path) and `train/optim.py` (optim_stats and optim_update, K3's
gradient statistics and update: one of each a train step on CUDA, K3a
alone on a step whose gradients are not finite). cc_label and vote_count
are also the CUDA implementations of the custom ops `fastposecnn::cc_label`
and `fastposecnn::vote_count`, so a loaded exported program counts its
launches too.
"""

from __future__ import annotations

from typing import Dict

from fastposecnn_tpu_torch.utils import timer

KERNELS = ("cc_label", "vote_count", "vote_expanded_mm", "vote_expanded_bcast",
           "optim_stats", "optim_update")


def count_launch(name: str) -> None:
    if name not in KERNELS:
        raise KeyError(name)
    timer.count("launch/" + name)


def launch_counts() -> Dict[str, int]:
    """Each kernel's launches since the last reset."""
    totals = timer.totals()
    return {k: totals.get("launch/" + k, 0) for k in KERNELS}


def reset_launch_counts() -> None:
    timer.reset_totals("launch/")
