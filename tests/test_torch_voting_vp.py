"""Port parity for vanishing-point voting (`fastposecnn_tpu_torch/ops/voting_vp.py`)
against the JAX package's `ops/voting_vp.py`, with JAX's point pairs
injected (`jax.random.randint(key, (M, H, 2), 0, P)`, as its
`_sample_pairs` draws them).

Exact: the inlier counts, against JAX run op by op (`jax.disable_jit()`:
compiled XLA:CPU contracts the multiply-adds near the threshold, ROADMAP.md
C4) on the same hypotheses, P spanning several chunks of 512; the count and
the winner of `ransac_vanishing_points`. Golden tolerance (atol 2e-4,
rtol 1e-4): the hypotheses and the unit points. The JAX package's own
cases (`tests/test_voting_vp.py`) run through the port too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastposecnn_tpu.ops import voting_vp as JV
from fastposecnn_tpu_torch.ops import voting_vp as TV
from test_voting_vp import grid_points, parallel_field

ATOL, RTOL = 2e-4, 1e-4


def t(a):
    return torch.from_numpy(np.array(a))


def jax_pairs(key, m, h, p):
    return t(jax.random.randint(key, (m, h, 2), 0, p))


def converging(seed, m=3, p=1300, noise=0.05):
    """Points on a 48x48 grid whose directions point at a per-slot centre,
    with noise; the last slot's field is parallel (a point at infinity)."""
    rng = np.random.default_rng(seed)
    pts = np.floor(rng.uniform(0, 48, (m, p, 2))).astype(np.float32)
    centre = rng.uniform(10, 38, (m, 1, 2)).astype(np.float32)
    d = centre - pts + rng.normal(0, noise, (m, p, 2)).astype(np.float32)
    d[-1] = np.asarray([3.0, 4.0]) + rng.normal(0, noise, (p, 2))
    dirs = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    pvalid = rng.random((m, p)) > 0.1
    return pts, dirs, pvalid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vote_counts_exact_against_jax_op_by_op(seed):
    pts, dirs, pvalid = converging(seed)
    hyps = np.asarray(JV.generate_hypotheses_vp(jax.random.key(seed), jnp.asarray(pts),
                                                jnp.asarray(dirs), 200))
    rng = np.random.default_rng(seed + 10)
    hyps = np.concatenate([hyps, rng.normal(size=(3, 40, 3)).astype(np.float32) * 30], 1)
    for thresh in (0.999, 0.99):
        with jax.disable_jit():
            want = np.asarray(JV.vote_counts_vp(jnp.asarray(hyps), jnp.asarray(pts),
                                                jnp.asarray(dirs),
                                                jnp.asarray(pvalid, jnp.float32), thresh))
        got = TV.vote_counts_vp(t(hyps), t(pts), t(dirs), t(pvalid), thresh)
        np.testing.assert_array_equal(got.numpy(), want)
        assert want.max() > 100


@pytest.mark.parametrize("seed", [0, 1])
def test_hypotheses_match_jax(seed):
    pts, dirs, _ = converging(seed, p=300)
    key = jax.random.key(seed)
    want = np.asarray(JV.generate_hypotheses_vp(key, jnp.asarray(pts), jnp.asarray(dirs), 256))
    got = TV.generate_hypotheses_vp(t(pts), t(dirs), jax_pairs(key, 3, 256, 300)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert (np.abs(want).sum(-1) == 0).any() and (np.abs(want).sum(-1) > 0).any()


@pytest.mark.parametrize("seed", [0, 3])
def test_ransac_vanishing_points_matches_jax(seed):
    pts, dirs, pvalid = converging(seed)
    active = np.asarray([True, False, True])
    key = jax.random.key(seed)
    with jax.disable_jit():
        want_best, want_counts = JV.ransac_vanishing_points(
            key, jnp.asarray(pts), jnp.asarray(dirs), jnp.asarray(active), num_hypotheses=256,
            pt_valid=jnp.asarray(pvalid))
    best, counts = TV.ransac_vanishing_points(t(pts), t(dirs), t(active),
                                              jax_pairs(key, 3, 256, pts.shape[1]),
                                              pt_valid=t(pvalid))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    np.testing.assert_allclose(best.numpy(), np.asarray(want_best), atol=ATOL, rtol=RTOL)
    assert not best[1].any() and counts[1] == 0
    np.testing.assert_allclose(torch.linalg.vector_norm(best[active], dim=-1).numpy(), 1.0,
                               rtol=1e-6)


# The JAX package's cases (tests/test_voting_vp.py), through the port.


def test_parallel_rays_meet_at_infinity():
    h = w = 8
    pts = grid_points(h, w)[None]
    dirs = parallel_field(h, w, (3.0, 4.0)).reshape(1, -1, 2)
    hyps = TV.generate_hypotheses_vp(t(pts), t(dirs),
                                     jax_pairs(jax.random.key(0), 1, 64, h * w)).numpy()[0]
    nonzero = hyps[np.abs(hyps).sum(-1) > 1e-4]
    assert len(nonzero) > 0
    hn = nonzero / np.linalg.norm(nonzero, axis=-1, keepdims=True)
    np.testing.assert_allclose(hn[:, 2], 0.0, atol=1e-5)
    np.testing.assert_allclose(hn[:, 0] * 0.8 - hn[:, 1] * 0.6, 0.0, atol=1e-4)


def test_finite_intersection_matches_2d_center():
    h = w = 24
    center = (11.0, 8.0)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    dx, dy = center[0] - xs, center[1] - ys
    n = np.sqrt(dx * dx + dy * dy)
    n[n == 0] = 1.0
    dirs = np.stack([dx / n, dy / n], -1).astype(np.float32).reshape(1, -1, 2)
    pts = grid_points(h, w)[None]
    best, counts = TV.ransac_vanishing_points(
        t(pts), t(dirs), torch.tensor([True]), jax_pairs(jax.random.key(1), 1, 128, h * w))
    b = best[0].numpy()
    assert abs(b[2]) > 1e-6
    np.testing.assert_allclose(b[:2] / b[2], center, atol=0.1)
    assert float(counts[0]) > 0.8 * pts.shape[1]


def test_vote_counts_brute_force():
    """A direct per-element transcription of the reference kernel
    (`voting_for_hypothesis_vanishing_point_kernel`, cu:268-309)."""
    rng = np.random.default_rng(0)
    m, p, hn = 2, 48, 8
    pts = rng.uniform(0, 16, size=(m, p, 2)).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, size=(m, p))
    dirs = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    hyps = rng.normal(size=(m, hn, 3)).astype(np.float32)
    pv = (rng.random((m, p)) > 0.2).astype(np.float32)
    thresh = 0.999
    ref = np.zeros((m, hn))
    for mi in range(m):
        for hi in range(hn):
            hx, hy, hz = hyps[mi, hi]
            for ti in range(p):
                cx, cy = pts[mi, ti]
                ddx, ddy = dirs[mi, ti]
                diff_x, diff_y = hx - cx * hz, hy - cy * hz
                n1, n2 = np.sqrt(ddx ** 2 + ddy ** 2), np.sqrt(diff_x ** 2 + diff_y ** 2)
                if n1 < 1e-6 or n2 < 1e-6 or diff_x * ddx < 0 or diff_y * ddy < 0:
                    continue
                if abs((ddx * diff_x + ddy * diff_y) / (n1 * n2)) > thresh:
                    ref[mi, hi] += pv[mi, ti]
    got = TV.vote_counts_vp(t(hyps), t(pts), t(dirs), t(pv), thresh).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_inconsistent_pairs_zeroed_and_consistent_pair_survives():
    s = 1.0 / np.sqrt(2.0)
    pts = torch.tensor([[[0.0, 0.0], [10.0, 0.0]]])
    away = torch.tensor([[[-s, -s], [-s, s]]], dtype=torch.float32)
    hyps = TV.generate_hypotheses_vp(pts, away, jax_pairs(jax.random.key(0), 1, 8, 2)).numpy()[0]
    assert hyps[np.abs(hyps).sum(-1) > 1e-4].shape[0] == 0
    toward = torch.tensor([[[s, s], [-s, s]]], dtype=torch.float32)
    hyps = TV.generate_hypotheses_vp(pts, toward, jax_pairs(jax.random.key(0), 1, 16, 2)).numpy()[0]
    keep = hyps[np.abs(hyps).sum(-1) > 1e-4]
    assert keep.shape[0] > 0
    np.testing.assert_allclose(keep[:, :2] / keep[:, 2:3], [[5.0, 5.0]] * len(keep), atol=1e-4)
