"""Masks that cross the CC kernel's tile edges, for holding the kernel
(`fastposecnn_tpu_torch/kernels/cc_label.cu`, 32x32 tiles) against its plain
version and the port against the JAX package: test fixtures, which
`chip_smoke.py` also reads. `test_torch_ops.py` checks that TILE below is
the kernel's.

Each mask is a numpy bool [H, W] array and works at any size; at a width or
height that is no multiple of 32 the last tiles are ragged.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

TILE = 32  # the tile side of `cc_label.cu`


def spiral(h: int, w: int) -> np.ndarray:
    """A one-pixel-wide square spiral from the top-left corner inwards, its
    arms one pixel apart: one component, a chain of runs that crosses every
    tile edge many times."""
    m = np.zeros((h + 2, w + 2), bool)  # a frame of background around it
    r, c, dr, dc = 1, 1, 0, 1
    m[r, c] = True
    turns = 0
    while turns < 2:
        nr, nc = r + dr, c + dc
        # The next pixel may touch no painted pixel but the current one.
        inside = 1 <= nr <= h and 1 <= nc <= w
        touching = m[nr - 1:nr + 2, nc].sum() + m[nr, nc - 1:nc + 2].sum()
        if inside and not m[nr, nc] and touching == 1:
            r, c, turns = nr, nc, 0
            m[r, c] = True
        else:
            dr, dc, turns = dc, -dr, turns + 1
    return m[1:-1, 1:-1]


def corner_diagonals(h: int, w: int, k: int = 3) -> np.ndarray:
    """At each inner tile corner two k x k squares that touch only at the
    corner, diagonally (top-left and bottom-right, or top-right and
    bottom-left, alternating): two components a corner in 4-connectivity."""
    m = np.zeros((h, w), bool)
    for y in range(TILE, h, TILE):
        for x in range(TILE, w, TILE):
            if (y // TILE + x // TILE) % 2 == 0:
                m[y - k:y, x - k:x] = True
                m[y:y + k, x:x + k] = True
            else:
                m[y - k:y, x:x + k] = True
                m[y:y + k, x - k:x] = True
    return m


def edge_lattice(h: int, w: int) -> np.ndarray:
    """The rows and columns on either side of every inner tile edge (31/32,
    63/64, ...): one component made of border pixels alone."""
    m = np.zeros((h, w), bool)
    for e in range(TILE, h, TILE):
        m[e - 1:e + 1] = True
    for e in range(TILE, w, TILE):
        m[:, e - 1:e + 1] = True
    return m


def edge_columns(h: int, w: int) -> np.ndarray:
    """A vertical one-pixel line in the first column and one in the last:
    two components (one if the image is one pixel wide)."""
    m = np.zeros((h, w), bool)
    m[:, 0] = True
    m[:, -1] = True
    return m


def pixel_per_tile(h: int, w: int) -> np.ndarray:
    """One pixel in each tile, at a place that moves from tile to tile (on
    its edges too): one component a tile."""
    m = np.zeros((h, w), bool)
    for ty in range(-(-h // TILE)):
        for tx in range(-(-w // TILE)):
            r = min(ty * TILE + (7 * ty + 3 * tx) % TILE, h - 1)
            c = min(tx * TILE + (5 * tx + 11 * ty) % TILE, w - 1)
            m[r, c] = True
    return m


def tile_edge_masks(h: int, w: int) -> Dict[str, np.ndarray]:
    return {"spiral": spiral(h, w), "corner_diagonals": corner_diagonals(h, w),
            "edge_lattice": edge_lattice(h, w), "edge_columns": edge_columns(h, w),
            "pixel_per_tile": pixel_per_tile(h, w)}
