"""Write synthetic scenes to disk in the NOCS layout (counterpart of the JAX
package's `data/nocs_writer.py`, the same files for the same seed).

Each scene becomes `XXXX_color.png` (uint8 RGB), `XXXX_mask.png` (instance
ids 1..n, 255 as background), `XXXX_depth.png` (uint16 z in mm, 0 as
background) and `XXXX_meta+.json` ({instance_dict, scales, RTs,
norm_factors, quaternions}), four scenes a subdirectory, and a `.complete`
marker once every scene is written: the file family of the reference's
offline preparation (FPC/tools/create_meta+.py:694-696). The arrays are
`data/nocs.py::_scene_record`'s; the PNGs are written by `data/png.py`
(filter 0, zlib level 1), with no image package.

`python -m fastposecnn_tpu_torch.data.nocs_writer --out D --num N --seed S`
renders one bank; the scene-bank pool (`data/bank_pool.py`) runs it as a
subprocess. It imports numpy and this package's data modules, never torch.
"""

from __future__ import annotations

import json
import pathlib
from typing import Optional

import numpy as np

from fastposecnn_tpu_torch.data.nocs import _scene_record
from fastposecnn_tpu_torch.data.png import encode_png
from fastposecnn_tpu_torch.data.synthetic import SceneConfig, generate_scene


def write_synthetic_nocs(root, num_samples: int = 8, seed: int = 0,
                         scene_cfg: Optional[SceneConfig] = None,
                         subdir_every: int = 4) -> pathlib.Path:
    """`num_samples` scenes of one `default_rng(seed)` stream under `root`;
    returns `root`."""
    root = pathlib.Path(root)
    cfg = scene_cfg or SceneConfig()
    rng = np.random.default_rng(seed)
    for i in range(num_samples):
        d = root / f"{i // subdir_every:05d}"
        d.mkdir(parents=True, exist_ok=True)
        prefix = d / f"{i % subdir_every:04d}"
        rec = _scene_record(generate_scene(rng, cfg))
        encode_png(f"{prefix}_color.png", rec["color"], compress_level=1)
        encode_png(f"{prefix}_mask.png", rec["mask"], compress_level=1)
        encode_png(f"{prefix}_depth.png", rec["depth"], compress_level=1)
        meta = {k: v.tolist() if isinstance(v, np.ndarray) else v
                for k, v in rec["meta"].items()}
        pathlib.Path(f"{prefix}_meta+.json").write_text(json.dumps(meta))
    # A killed render leaves scenes but no marker, so a reuse check can tell a
    # whole bank from a torn one; the dataset scans only *_color.png.
    (root / ".complete").touch()
    return root


def _main(argv=None) -> None:
    """Render one synthetic NOCS scene bank (the scene-bank pool's renderer)."""
    import argparse

    p = argparse.ArgumentParser(description=_main.__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--num", type=int, required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--num_classes", type=int, default=7)
    p.add_argument("--max_instances", type=int, default=8)
    p.add_argument("--pose_cues", action="store_true")
    p.add_argument("--cue_boost", action="store_true")
    a = p.parse_args(argv)
    cfg = SceneConfig(height=a.height, width=a.width, num_classes=a.num_classes,
                      max_instances=a.max_instances, render_pose_cues=a.pose_cues,
                      cue_boost=a.cue_boost)
    write_synthetic_nocs(a.out, a.num, a.seed, cfg)


if __name__ == "__main__":
    _main()
