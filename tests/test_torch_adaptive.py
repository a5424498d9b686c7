"""Port parity for the EVALUATING preset's voting: the adaptive RANSAC loop,
its exit test, random-pair hypotheses, the inverse-CDF sampler and the
sampled-point refinement of `fastposecnn_tpu_torch` (CPU) against the JAX
package on the same seeded numpy inputs. JAX's random draws are made here
with the JAX code's key splits (`ops/voting.py:683-684`, :746, :88, :153)
and handed to the port.

Tolerances: rounds, hypotheses, counts, win ratios, sampled points and
winners before refinement are exactly equal to JAX run op by op
(`jax.disable_jit()`); refined centres within atol 2e-4 / rtol 1e-4.
Compiled, XLA:CPU fuses the hypothesis arithmetic and contracts
a*b + c*d into fused multiply-adds, so its hypotheses move by ulps (and
more where two rays are nearly parallel); against compiled JAX the rounds
and win ratios are equal and hypotheses and centres within atol 0.05 px.
The port, like JAX op by op, rounds every operation.
"""

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


def jax_round_pairs(k_vote, m, p, num_hyp, max_iter):
    """The pair indices of every round the JAX loop could run, [R, M, H, 2]."""
    k, pairs = k_vote, []
    for _ in range(max_iter):
        k, k_hyp = jax.random.split(k)
        pairs.append(np.asarray(jax.random.randint(k_hyp, (m, num_hyp, 2), 0, p)))
    return torch.from_numpy(np.stack(pairs))


def slots(seed, m=6, p=128):
    """Vote slots of graded difficulty: directions at a centre with more and
    more of them random (so slots converge after different rounds), one slot
    under `min_num` pixels and one inactive slot."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform(20, 40, size=(m, 1, 2))
    pts = np.floor(centre + rng.uniform(-15, 15, size=(m, p, 2))).astype(np.float32)
    d = centre - pts + rng.normal(scale=0.3, size=(m, p, 2))
    rand = rng.random((m, p)) < np.linspace(0.2, 0.97, m)[:, None]
    d[rand] = rng.normal(size=(int(rand.sum()), 2))
    dirs = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    npts = np.full(m, 200.0, np.float32)
    npts[1] = 4.0  # below min_num
    active = np.ones(m, bool)
    active[2] = False
    pt_valid = rng.random((m, p)) > 0.1
    return pts, dirs, npts, active, pt_valid


def test_exit_test_agrees_with_jax_on_every_reachable_ratio():
    """A win ratio is count / valid points, so with P <= 1024 it takes one of
    the ~319k values c/d (c <= d <= 1024). For each of them, after 0..20
    rounds of 128 or 1000 hypotheses, the port's float32 test decides as
    JAX's (`round_cond`, jitted as in the while loop). An ulp of difference
    in the power would move a slot's exit by one round."""
    d = np.concatenate([np.full(k + 1, k) for k in range(1, 1025)]).astype(np.float32)
    c = np.concatenate([np.arange(k + 1) for k in range(1, 1025)]).astype(np.float32)
    ratios = np.unique(c / d)
    jax_conf = jax.jit(lambda r, n: 1.0 - (1.0 - r ** 2) ** n > 0.99)
    checked = 0
    for h in (128, 1000):
        for rounds in range(21):
            hyp_num = np.full_like(ratios, np.float32(rounds * h))
            want = np.asarray(jax_conf(ratios, hyp_num))
            got = tv.slot_confident(torch.from_numpy(ratios), rounds, h, 0.99).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"H={h} rounds={rounds}")
            checked += want.size
            if rounds == 1:  # the boundary is crossed inside the range
                assert want.any() and not want.all()
    assert checked > 12_000_000


def _jax_adaptive(pts, dirs, npts, active, pt_valid, k_vote, num_hyp, max_iter,
                  use_pallas=False, refine="none"):
    return jv.ransac_vote_centers(
        k_vote, jnp.asarray(pts), jnp.asarray(dirs), jnp.asarray(npts),
        jnp.asarray(active), round_hyp_num=num_hyp, max_iter=max_iter,
        pt_valid=jnp.asarray(pt_valid), adaptive=True, use_pallas=use_pallas,
        interpret=use_pallas, refine=refine)


def _rounds_of(last_hyps, pts, dirs, pairs):
    """The JAX loop does not return its round count: its last cloud pins
    it, since every round's cloud differs from every other's."""
    dist = [float(np.abs(tv.generate_hypotheses(pts, dirs, pr).numpy()
                         - np.asarray(last_hyps)).max()) for pr in pairs]
    best = int(np.argmin(dist))
    assert sorted(dist)[1] > 1.0, dist  # no other round's cloud comes close
    return best + 1 if dist[best] < 1.0 else 0


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "pallas_interpret"])
@pytest.mark.parametrize("max_iter", [20, 3], ids=["early_exit", "max_iter"])
def test_adaptive_ransac_matches_jax(use_pallas, max_iter):
    pts, dirs, npts, active, pt_valid = slots(seed=1)
    m, p, _ = pts.shape
    num_hyp = 128
    k_vote = jax.random.key(3)
    with jax.disable_jit():
        c_j, r_j, h_j = _jax_adaptive(pts, dirs, npts, active, pt_valid, k_vote,
                                      num_hyp, max_iter, use_pallas)
    pairs = jax_round_pairs(k_vote, m, p, num_hyp, max_iter)
    t = [torch.from_numpy(x) for x in (pts, dirs, npts, active, pt_valid)]
    c_t, r_t, h_t, rounds = tv.ransac_vote_centers_adaptive(
        *t, num_hyp, max_iter=max_iter, pairs=pairs)

    assert _rounds_of(h_j, t[0], t[1], pairs) == rounds
    np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_j))
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    if max_iter == 20:
        assert 3 < rounds < 20, rounds  # slots converged after different rounds
    else:
        assert rounds == 3
    assert not c_t[1].any() and not c_t[2].any() and r_t[2] == 0


def test_adaptive_ransac_matches_compiled_jax():
    pts, dirs, npts, active, pt_valid = slots(seed=1)
    m, p, _ = pts.shape
    k_vote = jax.random.key(3)
    c_j, r_j, h_j = _jax_adaptive(pts, dirs, npts, active, pt_valid, k_vote, 128, 20)
    pairs = jax_round_pairs(k_vote, m, p, 128, 20)
    t = [torch.from_numpy(x) for x in (pts, dirs, npts, active, pt_valid)]
    c_t, r_t, h_t, rounds = tv.ransac_vote_centers_adaptive(*t, 128, pairs=pairs)
    assert _rounds_of(h_j, t[0], t[1], pairs) == rounds
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=0.05)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=0.05)


def test_adaptive_ransac_runs_no_round_without_active_slots():
    pts, dirs, npts, _, pt_valid = slots(seed=2)
    t = [torch.from_numpy(x) for x in (pts, dirs, npts)]
    c, r, h, rounds = tv.ransac_vote_centers_adaptive(
        *t, torch.zeros(len(npts), dtype=torch.bool), torch.from_numpy(pt_valid),
        64, generator=torch.Generator().manual_seed(0))
    assert rounds == 0 and not h.any() and not r.any() and not c.any()
    with pytest.raises(ValueError):  # neither injected pairs nor a generator
        tv.ransac_vote_centers_adaptive(*t, torch.ones(len(npts), dtype=torch.bool),
                                        torch.from_numpy(pt_valid), 64)


def test_sampled_refinement_matches_jax():
    pts, dirs, npts, active, pt_valid = slots(seed=4)
    m, p, _ = pts.shape
    k_vote = jax.random.key(5)
    with jax.disable_jit():
        c_j, r_j, _ = _jax_adaptive(pts, dirs, npts, active, pt_valid, k_vote, 64,
                                    20, refine="sampled")
    t = [torch.from_numpy(x) for x in (pts, dirs, npts, active, pt_valid)]
    c_t, r_t, _, _ = tv.ransac_vote_centers_adaptive(
        *t, 64, pairs=jax_round_pairs(k_vote, m, p, 64, 20), refine="sampled")
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=ATOL, rtol=RTOL)

    # refine_centers alone, on winners off the centre and with invalid points.
    win = (pts[:, :2].mean(axis=1) + 0.7).astype(np.float32)
    pv = (pt_valid & active[:, None]).astype(np.float32)
    want = jv.refine_centers(jnp.asarray(win), jnp.asarray(pts), jnp.asarray(dirs),
                             jnp.asarray(pv), 0.999)
    got = tv.refine_centers(torch.from_numpy(win), t[0], t[1], torch.from_numpy(pv),
                            0.999)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_cdf_sampler_matches_jax():
    """Points, directions, counts and validity exactly equal, empty slots
    included. Under this suite's x64 setting JAX draws float64 uniforms
    (`ops/voting.py:88` names no dtype); the port takes them as they are."""
    rng = np.random.default_rng(6)
    b, n, h, w, p = 2, 3, 24, 32, 96
    masks = (rng.random((b, n, h, w)) > 0.7).astype(np.float32)
    masks[0, 2] = 0.0
    masks[1, 0] = 0.0
    masks[1, 0, 5, 7] = 1.0  # a one-pixel instance
    field = rng.normal(size=(b, h, w, 2)).astype(np.float32)
    key = jax.random.key(8)
    want = jv.sample_mask_points(key, jnp.asarray(masks), jnp.asarray(field), p)
    u = np.asarray(jax.random.uniform(key, (b, n, p)))
    got = tv.sample_mask_points(torch.from_numpy(u), torch.from_numpy(masks),
                                torch.from_numpy(field))
    for g, w_, name in zip(got, want, ("pts", "dirs", "npts", "pt_valid")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_), err_msg=name)
    assert (got[0][1, 0] == torch.tensor([7.0, 5.0])).all()


def _agg(seed, h=48, w=64, n=4):
    """Aggregated data of three blocky instances whose noisy xy field points
    at known centres (made by the JAX package, handed to both sides)."""
    rng = np.random.default_rng(seed)
    c = 4
    cls = np.zeros((1, h, w), int)
    cls[:, 6:26, 6:30] = 1
    cls[:, 24:44, 36:60] = 2
    cls[:, 30:40, 8:20] = 3
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    xy = np.zeros((1, h, w, 2 * (c - 1)), np.float32)
    for k, (cx, cy) in enumerate([(17.5, 15.0), (47.0, 33.5), (14.5, 35.0)]):
        dx, dy = cx - xs, cy - ys
        nrm = np.sqrt(dx * dx + dy * dy)
        xy[..., 2 * k] = dx / nrm + rng.normal(scale=0.3, size=(1, h, w))
        xy[..., 2 * k + 1] = dy / nrm + rng.normal(scale=0.3, size=(1, h, w))
    logits = {
        "mask": np.where(np.arange(c) == cls[..., None], 5.0, 0.0).astype(np.float32),
        "quaternion": rng.normal(size=(1, h, w, 4 * (c - 1))).astype(np.float32),
        "xy": xy,
        "z": (rng.normal(size=(1, h, w, c - 1)) + 6.0).astype(np.float32),
        "scales": rng.normal(size=(1, h, w, 3 * (c - 1))).astype(np.float32),
    }
    agg_j = jax_aggregate(jax_compress({k: jnp.asarray(v, jnp.float32)
                                        for k, v in logits.items()}),
                          max_instances=n, use_pallas=False)
    return agg_j, {k: torch.from_numpy(np.array(v)) for k, v in agg_j.items()}


def jax_adaptive_draws(key, b, n, p, num_hyp, max_iter, sampler):
    """Every draw JAX `hough_vote(adaptive=True)` makes from `key`."""
    k_sample, k_vote = jax.random.split(key)
    if sampler == "bbox":
        kx, ky = jax.random.split(k_sample)
        draws = tv.VoteDraws(
            ux=torch.from_numpy(np.array(jax.random.uniform(kx, (b, n, p), dtype=jnp.float32))),
            uy=torch.from_numpy(np.array(jax.random.uniform(ky, (b, n, p), dtype=jnp.float32))))
    else:
        draws = tv.VoteDraws(u=torch.from_numpy(np.array(jax.random.uniform(k_sample, (b, n, p)))))
    draws.pairs = jax_round_pairs(k_vote, b * n, p, num_hyp, max_iter)
    return draws


@pytest.mark.parametrize("sampler,refine", [("bbox", "dense"), ("cdf", "sampled"),
                                            ("bbox", "sampled")])
def test_hough_vote_adaptive_matches_jax(sampler, refine):
    agg_j, agg_t = _agg(seed=2)
    b, n = agg_t["valid"].shape
    key = jax.random.key(4)
    p, num_hyp = 128, 64
    with jax.disable_jit():
        want = jv.hough_vote(key, agg_j, max_points=p, round_hyp_num=num_hyp,
                             adaptive=True, sampler=sampler, use_pallas=False,
                             refine=refine)
    got = tv.hough_vote(agg_t, max_points=p, round_hyp_num=num_hyp, adaptive=True,
                        sampler=sampler, refine=refine,
                        draws=jax_adaptive_draws(key, b, n, p, num_hyp, 20, sampler))
    np.testing.assert_array_equal(got["hypothesis"].numpy(),
                                  np.asarray(want["hypothesis"]))
    np.testing.assert_array_equal(got["win_ratio"].numpy(),
                                  np.asarray(want["win_ratio"]))
    np.testing.assert_allclose(got["xy"].numpy(), np.asarray(want["xy"]),
                               atol=ATOL, rtol=RTOL)
    assert got["vote_rounds"] >= 1
    assert (got["win_ratio"][agg_t["valid"]] > 0.05).all()
