"""Hand-written CUDA kernels for Hopper and their launch counters.

Each wrapper adds one to its counter where it launches its kernel, and
nowhere else, so a run can show that its main path went through the
kernels. The wrappers live beside their plain PyTorch versions, in
`ops/connected_components.py` (cc_label), `ops/voting.py` (vote_count) and
`probes/vote_variants.py` (vote_expanded_mm and vote_expanded_bcast, the
probe of K2's formulation, on no main path).
"""

from __future__ import annotations

from typing import Dict

KERNELS = ("cc_label", "vote_count", "vote_expanded_mm", "vote_expanded_bcast")
_launches: Dict[str, int] = {k: 0 for k in KERNELS}


def count_launch(name: str) -> None:
    _launches[name] += 1


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0
