"""Port parity: inlier counting (kernel K2's plain version), the single-shot
RANSAC step, `hough_vote` with injected draws and `_solve_sym2x2`, in
`fastposecnn_tpu_torch` (CPU) against the JAX package on the same seeded
numpy inputs. JAX's random draws are made in this process with the same key
splits as the JAX code and handed to the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastposecnn_tpu.ops import voting as jv
from fastposecnn_tpu.ops.aggregation import aggregate_instances as jax_aggregate
from fastposecnn_tpu.ops.class_compress import class_compress as jax_compress
from fastposecnn_tpu_torch.ops import voting as tv

ATOL, RTOL = 2e-4, 1e-4


def vote_inputs(rng, m, h, p, inactive=(), integer=False):
    """Seeded vote inputs. `integer` puts points and hypotheses on a small
    integer grid, so many hypotheses coincide and their counts tie."""
    if integer:
        pts = rng.integers(0, 12, size=(m, p, 2)).astype(np.float32)
        hyps = rng.integers(0, 12, size=(m, h, 2)).astype(np.float32)
    else:
        pts = rng.uniform(0, 32, size=(m, p, 2)).astype(np.float32)
        hyps = rng.uniform(0, 32, size=(m, h, 2)).astype(np.float32)
    dirs = rng.normal(size=(m, p, 2)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs[:, ::7] = 0.0  # zero directions never vote
    pvalid = (rng.random((m, p)) > 0.1).astype(np.float32)
    active = np.ones(m, bool)
    active[list(inactive)] = False
    pvalid *= active[:, None]
    return hyps, pts, dirs.astype(np.float32), pvalid, active


@pytest.mark.parametrize(
    "m,h,p,inactive,integer",
    [
        (3, 64, 256, (), False),          # no padding
        (10, 130, 200, (3, 8, 9), False),  # padded M, H and P; inactive slots
        (9, 128, 1100, (0,), True),       # P beyond one 1024 tile; ties
    ],
)
def test_vote_counts_reference_matches_jax(m, h, p, inactive, integer):
    rng = np.random.default_rng(m * 1000 + h)
    hyps, pts, dirs, pvalid, active = vote_inputs(rng, m, h, p, inactive, integer)
    got = tv.vote_counts_reference(*map(torch.from_numpy, (hyps, pts, dirs, pvalid)),
                                   0.999, active=torch.from_numpy(active)).numpy()
    j = [jnp.asarray(x, jnp.float32) for x in (hyps, pts, dirs, pvalid)]
    want_jnp = np.asarray(jv.vote_counts_jnp(*j, 0.999))
    want_pallas = np.asarray(jv.vote_counts_pallas(
        *j, 0.999, interpret=True, active=jnp.asarray(active)))
    np.testing.assert_array_equal(got, want_jnp)
    np.testing.assert_array_equal(got, want_pallas)
    assert got.max() > 0
    assert not got[list(inactive)].any()
    if integer:  # the tie case really has ties at the winner
        assert (got == got.max(axis=1, keepdims=True)).sum(axis=1).max() > 1


@pytest.mark.parametrize(
    "m,h,p,inactive",
    [
        (3, 1, 200, (1,)),         # one hypothesis
        (3, 50, 1, (1,)),          # one point
        (2, 33, 31, ()),           # H and P below one warp split of the CUDA kernel
        (7, 129, 2048, (2, 5)),    # H one past a block; P two whole tiles
        (4, 256, 512, (0, 1, 2, 3)),  # no slot active
    ],
)
def test_vote_counts_reference_matches_jax_at_edges(m, h, p, inactive):
    """The plain version equals JAX at the shapes where the CUDA kernel's
    partition has edges; unlike the test above, a case may have no votes."""
    rng = np.random.default_rng(m * 1000 + h + p)
    hyps, pts, dirs, pvalid, active = vote_inputs(rng, m, h, p, inactive)
    # Point 0 gets a direction again, with up to 4 hypotheses on its ray, so
    # that the one-point and one-hypothesis cases vote too.
    dirs[:, 0] = [0.6, 0.8]
    pvalid[:, 0] = active
    k = min(h, 4)
    hyps[:, :k] = pts[:, :1] + np.arange(1, k + 1, dtype=np.float32)[:, None] * dirs[:, :1]
    got = tv.vote_counts_reference(*map(torch.from_numpy, (hyps, pts, dirs, pvalid)),
                                   0.999, active=torch.from_numpy(active)).numpy()
    j = [jnp.asarray(x, jnp.float32) for x in (hyps, pts, dirs, pvalid)]
    np.testing.assert_array_equal(got, np.asarray(jv.vote_counts_jnp(*j, 0.999)))
    np.testing.assert_array_equal(got, np.asarray(jv.vote_counts_pallas(
        *j, 0.999, interpret=True, active=jnp.asarray(active))))
    assert got.shape == (m, h)
    assert not got[list(inactive)].any()
    assert (got[active, 0] >= 1).all()


def test_vote_counts_dispatch_on_cpu():
    rng = np.random.default_rng(5)
    args = [torch.from_numpy(x) for x in vote_inputs(rng, 2, 16, 32)[:4]]
    assert torch.equal(tv.vote_counts(*args, 0.999),
                       tv.vote_counts_reference(*args, 0.999))
    with pytest.raises(ValueError):
        tv.vote_counts(*args, 0.999, impl="triton")
    with pytest.raises(ValueError):  # the kernel's wrapper never takes a CPU tensor
        tv.vote_counts_cuda(*args, 0.999)


def test_ransac_single_shot_matches_jax():
    """Rolled hypotheses, counts, first-max argmax (with ties) and ratios."""
    rng = np.random.default_rng(7)
    m, p, num_hyp = 4, 64, 160
    pts = rng.integers(0, 10, size=(m, p, 2)).astype(np.float32)
    dirs = rng.normal(size=(m, p, 2)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    npts = np.array([50.0, 3.0, 64.0, 20.0], np.float32)  # slot 1 < min_num
    active = np.array([True, True, True, False])
    pt_valid = rng.random((m, p)) > 0.2
    key = jax.random.key(11)
    c_j, r_j, h_j = jv.ransac_vote_centers(
        key, jnp.asarray(pts), jnp.asarray(dirs), jnp.asarray(npts),
        jnp.asarray(active), round_hyp_num=num_hyp, pt_valid=jnp.asarray(pt_valid),
        adaptive=False, use_pallas=False, refine="none")
    shifts = jax.random.randint(key, (-(-num_hyp // p),), 1, p)
    c_t, r_t, h_t = tv.ransac_vote_centers(
        torch.from_numpy(pts), torch.from_numpy(dirs), torch.from_numpy(npts),
        torch.from_numpy(active), torch.from_numpy(pt_valid),
        [int(s) for s in np.asarray(shifts)], num_hyp)
    np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_j))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    assert not c_t[1].any() and not c_t[3].any()


def _voting_agg(seed, b=1, h=48, w=64, n=4):
    """Aggregated data of blocky instances whose noisy xy field points at
    known centres, made by the JAX package and handed to both sides as the
    same arrays (so `hough_vote` alone is compared)."""
    rng = np.random.default_rng(seed)
    c = 4
    cls = np.zeros((b, h, w), int)
    cls[:, 6:26, 6:30] = 1
    cls[:, 24:44, 36:60] = 2
    cls[:, 30:40, 8:20] = 3
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    xy = np.zeros((b, h, w, 2 * (c - 1)), np.float32)
    for k, (cx, cy) in enumerate([(17.5, 15.0), (47.0, 33.5), (14.5, 35.0)]):
        dx, dy = cx - xs, cy - ys
        nrm = np.sqrt(dx * dx + dy * dy)
        xy[..., 2 * k] = dx / nrm + rng.normal(scale=0.05, size=(b, h, w))
        xy[..., 2 * k + 1] = dy / nrm + rng.normal(scale=0.05, size=(b, h, w))
    logits = {
        "mask": np.where(np.arange(c) == cls[..., None], 5.0, 0.0).astype(np.float32),
        "quaternion": rng.normal(size=(b, h, w, 4 * (c - 1))).astype(np.float32),
        "xy": xy,
        "z": (rng.normal(size=(b, h, w, c - 1)) + 6.0).astype(np.float32),
        "scales": rng.normal(size=(b, h, w, 3 * (c - 1))).astype(np.float32),
    }
    agg_j = jax_aggregate(jax_compress({k: jnp.asarray(v, jnp.float32)
                                        for k, v in logits.items()}),
                          max_instances=n, use_pallas=False)
    agg_t = {k: torch.from_numpy(np.array(v)) for k, v in agg_j.items()}
    return agg_j, agg_t


def jax_draws(key, b, n, max_points, num_hyp):
    """The draws `hough_vote` makes from `key` (ops/voting.py:746, :153-155,
    :265), as a port `VoteDraws`."""
    k_sample, k_vote = jax.random.split(key)
    kx, ky = jax.random.split(k_sample)
    ux = jax.random.uniform(kx, (b, n, max_points), dtype=jnp.float32)
    uy = jax.random.uniform(ky, (b, n, max_points), dtype=jnp.float32)
    shifts = jax.random.randint(k_vote, (max(1, -(-num_hyp // max_points)),),
                                1, max_points)
    return tv.VoteDraws(torch.from_numpy(np.array(ux)),
                        torch.from_numpy(np.array(uy)),
                        tuple(int(s) for s in np.asarray(shifts)))


def test_hough_vote_with_injected_draws_matches_jax():
    agg_j, agg_t = _voting_agg(seed=2)
    b, n = agg_t["valid"].shape
    key = jax.random.key(4)
    max_points, num_hyp = 128, 256
    want = jv.hough_vote(key, agg_j, max_points=max_points, round_hyp_num=num_hyp,
                         adaptive=False, use_pallas=False, refine="dense")
    got = tv.hough_vote(agg_t, max_points=max_points, round_hyp_num=num_hyp,
                        draws=jax_draws(key, b, n, max_points, num_hyp))
    np.testing.assert_array_equal(got["hypothesis"].numpy(),
                                  np.asarray(want["hypothesis"]))
    np.testing.assert_array_equal(got["win_ratio"].numpy(),
                                  np.asarray(want["win_ratio"]))
    np.testing.assert_allclose(got["xy"].numpy(), np.asarray(want["xy"]),
                               atol=ATOL, rtol=RTOL)
    assert agg_t["valid"].sum() == 3
    assert (got["win_ratio"][agg_t["valid"]] > 0.3).all()


def test_hough_vote_needs_draws_or_generators():
    _, agg_t = _voting_agg(seed=2)
    with pytest.raises(ValueError):
        tv.hough_vote(agg_t, max_points=32, round_hyp_num=32)
    out = tv.hough_vote(agg_t, max_points=32, round_hyp_num=64,
                        generator=torch.Generator().manual_seed(0),
                        cpu_generator=torch.Generator().manual_seed(0))
    assert out["xy"].shape == (1, 4, 2) and torch.isfinite(out["xy"]).all()


@pytest.mark.parametrize("num_hyp,p", [(128, 1024), (300, 128), (256, 128)])
def test_rolled_hypotheses_match_jax_and_are_contiguous(num_hyp, p):
    """A hypothesis count that is not a multiple of P is a slice of the last
    rolled chunk; the port hands K2 a contiguous tensor all the same."""
    rng = np.random.default_rng(num_hyp + p)
    _, pts, dirs, _, _ = vote_inputs(rng, 4, 8, p)
    key = jax.random.key(num_hyp)
    shifts = jax.random.randint(key, (max(1, -(-num_hyp // p)),), 1, p)
    want = jv.generate_hypotheses_rolled(key, jnp.asarray(pts), jnp.asarray(dirs),
                                         num_hyp)
    got = tv.generate_hypotheses_rolled(torch.from_numpy(pts), torch.from_numpy(dirs),
                                        num_hyp, [int(s) for s in np.asarray(shifts)])
    assert got.shape == (4, num_hyp, 2) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_solve_sym2x2_matches_jax():
    rng = np.random.default_rng(9)
    a = rng.normal(size=(6, 2, 3)).astype(np.float32)
    ATA = a @ a.transpose(0, 2, 1)  # regular PSD
    u = rng.normal(size=(3, 2)).astype(np.float32)
    ATA[3:] = 2.5 * u[:, :, None] * u[:, None, :]  # rank 1: singular branch
    ATA[5] = 0.0  # all-zero system
    ATb = rng.normal(size=(6, 2)).astype(np.float32)
    got = tv._solve_sym2x2(torch.from_numpy(ATA), torch.from_numpy(ATb)).numpy()
    want = np.asarray(jv._solve_sym2x2(jnp.asarray(ATA), jnp.asarray(ATb)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[5], 0.0)
