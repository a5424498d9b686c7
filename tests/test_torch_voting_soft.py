"""Port parity for soft Hough voting (`fastposecnn_tpu_torch/ops/voting_soft.py`)
against the JAX package's `ops/voting_soft.py`, with JAX's random draws
injected (the cdf sampler's uniforms and the hypotheses' point pairs, split
from the key as the JAX code splits it).

Exact: the z-score and IQR outlier masks, the keep masks and the weights'
layout (where the in-mask multiplier applies); against JAX run op by op
the hypothesis weights within two float32 ulps (the same counts, the last
division rounded apart). Golden tolerance (atol 2e-4, rtol 1e-4): the
pruned hypotheses (a mean replacement sums in another order), the
weights against compiled JAX, the centres and the pipeline's outputs.
The JAX package's own cases (`tests/test_voting_soft.py`) run through the
port too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastposecnn_tpu import config as JC
from fastposecnn_tpu.data.synthetic import SceneConfig, generate_scene, perfect_logits
from fastposecnn_tpu.ops import voting_soft as JS
from fastposecnn_tpu.pipeline import PipelineConfig as JaxPipelineConfig
from fastposecnn_tpu.pipeline import run_pipeline as jax_run_pipeline
from fastposecnn_tpu_torch import config as C
from fastposecnn_tpu_torch.ops import voting_soft as TS
from fastposecnn_tpu_torch.ops.voting import VoteDraws
from fastposecnn_tpu_torch.pipeline import PipelineConfig, run_pipeline
from test_voting import make_instance

ATOL, RTOL = 2e-4, 1e-4


def t(a):
    return torch.from_numpy(np.array(a))


def hyp_cloud(seed, m=4, h=128):
    """Hypotheses around a centre with outliers in both tails and ties."""
    rng = np.random.default_rng(seed)
    hyps = rng.normal(20.0, 3.0, size=(m, h, 2)).astype(np.float32)
    hyps[:, : h // 10] += rng.choice([-40.0, 60.0], size=(m, h // 10, 1)).astype(np.float32)
    hyps[:, -3:] = hyps[:, :3]  # repeated values
    return hyps


def soft_draws(key, b, n, p, h):
    """The draws of JAX `soft_hough_vote` with `key` (`ops/voting_soft.py:207`,
    the cdf sampler's uniforms and `_sample_pairs`' indices), as a port
    `VoteDraws`."""
    k_sample, k_vote = jax.random.split(key)
    u = jax.random.uniform(k_sample, (b, n, p))
    pairs = jax.random.randint(k_vote, (b * n, h, 2), 0, p)
    return VoteDraws(u=t(u), pairs=t(pairs)[None])


# -- pruning ----------------------------------------------------------------


@pytest.mark.parametrize("h", [16, 17, 128, 129])
def test_outlier_masks_exact(h):
    for seed in range(3):
        hyps = hyp_cloud(seed, h=h)
        for jfn, tfn, arg in ((JS.zscore_outliers, TS.zscore_outliers, 1.0),
                              (JS.iqr_outliers, TS.iqr_outliers, 1.5),
                              (JS.zscore_outliers, TS.zscore_outliers, 0.3),
                              (JS.iqr_outliers, TS.iqr_outliers, 0.5)):
            want = np.asarray(jfn(jnp.asarray(hyps), arg))
            got = tfn(t(hyps), arg).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"{tfn.__name__} h={h}")
            assert 0 < want.sum() < want.size


@pytest.mark.parametrize("h", [64, 65])
@pytest.mark.parametrize("replacement", ["mean", "median"])
@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("method", ["iqr", "z-score", None, "none"])
def test_prune_matches_jax(method, drop, replacement, h):
    hyps = hyp_cloud(h + 7, h=h)
    want, wkeep = JS.prune_hypotheses(jnp.asarray(hyps), method, drop, replacement, 1.0, 1.5)
    got, keep = TS.prune_hypotheses(t(hyps), method, drop, replacement, 1.0, 1.5)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(wkeep))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    if method in (None, "none") or drop:
        assert torch.equal(got, t(hyps))
    with pytest.raises(RuntimeError):
        TS.prune_hypotheses(t(hyps), "mad", drop, replacement)
    if not drop and method not in (None, "none"):
        with pytest.raises(RuntimeError):
            TS.prune_hypotheses(t(hyps), method, False, "mode")


def test_median_is_numpys_not_torchs():
    """An even count takes the mean of the two middle values, as
    `jnp.median`; `torch.median` would take the lower one."""
    x = np.asarray([[[1.0, 5.0], [4.0, 2.0], [3.0, 8.0], [10.0, 6.0]]], np.float32)
    np.testing.assert_array_equal(TS._median(t(x), 1).numpy(), np.median(x, axis=1))
    np.testing.assert_array_equal(TS._median(t(x), 1).numpy(),
                                  np.asarray(jnp.median(jnp.asarray(x), axis=1)))
    assert not torch.equal(TS._median(t(x), 1), torch.median(t(x), 1).values)
    odd = x[:, :3]
    np.testing.assert_array_equal(TS._median(t(odd), 1).numpy(), np.median(odd, axis=1))


# The JAX package's cases (tests/test_voting_soft.py:15-52), through the port.


def test_zscore_flags_positive_tail():
    h = np.zeros((1, 16, 2), np.float32)
    h[0, :, 0] = np.linspace(-1, 1, 16)
    h[0, 5] = [30.0, 30.0]
    out = TS.zscore_outliers(t(h), 1.0).numpy()
    assert out[0, 5] and out[0].sum() <= 3
    h[0, 5] = [-30.0, -30.0]  # the negative tail stays (a reference quirk)
    assert not TS.zscore_outliers(t(h), 1.0).numpy()[0, 5]


def test_iqr_flags_both_tails():
    h = np.zeros((1, 17, 2), np.float32)
    h[0, :, 0] = np.linspace(0, 1, 17)
    h[0, :, 1] = np.linspace(0, 1, 17)
    h[0, 3] = [80.0, 80.0]
    h[0, 9] = [-90.0, -90.0]
    out = TS.iqr_outliers(t(h), 1.5).numpy()
    assert out[0, 3] and out[0, 9]


def test_replacement_median_and_drop_mode():
    h = np.zeros((1, 5, 2), np.float32)
    h[0, :, 0] = [1, 2, 3, 4, 100]
    h[0, :, 1] = [1, 2, 3, 4, 100]
    pruned, keep = TS.prune_hypotheses(t(h), "iqr", drop=False, replacement="median",
                                       iqr_multiplier=1.5)
    assert bool(keep.all())
    np.testing.assert_allclose(pruned[0, 4].numpy(), [3.0, 3.0])
    _, keep = TS.prune_hypotheses(t(h), "iqr", drop=True)
    assert not bool(keep[0, 4])


# -- weights and centres ----------------------------------------------------


def weight_inputs(seed, m=4, h=96, p=600):
    """Hypotheses, integer points (some hypotheses' floors equal one point,
    some two) and unit directions; P spans three chunks of 256."""
    rng = np.random.default_rng(seed)
    hyps = rng.uniform(0, 40, (m, h, 2)).astype(np.float32)
    pts = np.floor(rng.uniform(0, 40, (m, p, 2))).astype(np.float32)
    pts[:, :20] = np.floor(hyps[:, :20])  # one hit each
    pts[:, 20:30] = np.floor(hyps[:, :10])  # a second hit: no multiplier
    ang = rng.uniform(0, 2 * np.pi, (m, p))
    dirs = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    pvalid = rng.random((m, p)) > 0.2
    pvalid[:, :30] = True
    return hyps, pts, dirs, pvalid


@pytest.mark.parametrize("seed", [0, 1])
def test_hypothesis_weights_match_jax(seed):
    hyps, pts, dirs, pvalid = weight_inputs(seed)
    args = [jnp.asarray(a) for a in (hyps, pts, dirs, pvalid)]
    with jax.disable_jit():
        op_by_op = np.asarray(JS.hypothesis_weights(*args, in_mask_multiplier=3.0))
    compiled = np.asarray(JS.hypothesis_weights(*args, in_mask_multiplier=3.0))
    got = TS.hypothesis_weights(*map(t, (hyps, pts, dirs, pvalid)), in_mask_multiplier=3.0)
    # The same integer counts and totals: only the last division's rounding
    # differs (XLA divides by a broadcast total as a product with its
    # reciprocal), by at most two float32 ulps.
    np.testing.assert_allclose(got.numpy(), op_by_op, rtol=2.5e-7, atol=0)
    np.testing.assert_allclose(got.numpy(), compiled, atol=ATOL, rtol=RTOL)
    # the layout: x3 where exactly one valid point lies on the floor
    hits = ((np.floor(hyps)[:, :, None] == pts[:, None]).all(-1) & pvalid[:, None]).sum(-1)
    factor = np.where(hits == 1, 3.0, 1.0)
    assert (hits == 1).any() and (hits >= 2).any() and (hits == 0).any()
    flat = TS.hypothesis_weights(*map(t, (hyps, pts, dirs, pvalid)), in_mask_multiplier=1.0)
    nz = flat.numpy() > 0
    scale = np.where(nz, got.numpy() / np.where(nz, flat.numpy(), 1) / factor, np.nan)
    per_slot = np.nanmean(scale, axis=1, keepdims=True)
    np.testing.assert_allclose(scale[nz], np.broadcast_to(per_slot, scale.shape)[nz], rtol=1e-5)


@pytest.mark.parametrize("kwargs", [
    {}, dict(prun_method="z-score", prun_drop=True),
    dict(prun_method=None), dict(prun_replacement="mean", in_mask_multiplier=2.0),
])
def test_soft_vote_centers_match_jax(kwargs):
    """Centres of noisy fields from random pairs (JAX's key made into the
    port's pairs); an inactive slot's centre is zero."""
    rng = np.random.default_rng(5)
    m, p, h = 5, 300, 64
    centre = rng.uniform(10, 30, (m, 1, 2)).astype(np.float32)
    pts = np.floor(rng.uniform(0, 40, (m, p, 2))).astype(np.float32)
    d = centre - pts + rng.normal(0, 0.5, (m, p, 2)).astype(np.float32)
    dirs = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    active = np.asarray([True, True, False, True, True])
    pt_valid = rng.random((m, p)) > 0.1
    key = jax.random.key(4)
    want = JS.soft_vote_centers(key, jnp.asarray(pts), jnp.asarray(dirs), jnp.asarray(active),
                                num_hypotheses=h, pt_valid=jnp.asarray(pt_valid), **kwargs)
    pairs = t(jax.random.randint(key, (m, h, 2), 0, p))
    got = TS.soft_vote_centers(t(pts), t(dirs), t(active), pairs, pt_valid=t(pt_valid),
                               **kwargs)
    for g, w, what in zip(got, want, ("centres", "hypotheses", "pruned")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL, err_msg=what)
    assert not got[0][2].any()


def test_soft_vote_passes_no_gradient():
    rng = np.random.default_rng(6)
    pts = t(np.floor(rng.uniform(0, 20, (2, 64, 2))).astype(np.float32))
    dirs = torch.nn.functional.normalize(t(rng.normal(size=(2, 64, 2)).astype(np.float32)),
                                         dim=-1).requires_grad_()
    pairs = torch.randint(0, 64, (2, 32, 2), generator=torch.Generator().manual_seed(0))
    centers, hyps, pruned = TS.soft_vote_centers(pts, dirs, torch.tensor([True, True]), pairs)
    assert not centers.requires_grad and not hyps.requires_grad


def test_soft_hough_vote_recovers_center():
    """The JAX package's case (`tests/test_voting_soft.py:56-67`) with its
    draws: the same centre and hypotheses; the centre within 0.3 px."""
    center = (11.0, 8.0)
    mask, field = make_instance(center=center)
    key = jax.random.key(0)
    want = JS.soft_hough_vote(key, {"instance_masks": jnp.asarray(mask)[None, None],
                                    "valid": jnp.asarray([[True]]),
                                    "xy_dense": jnp.asarray(field)[None]},
                              max_points=256, num_hypotheses=64)
    agg = {"instance_masks": t(mask)[None, None], "valid": torch.tensor([[True]]),
           "xy_dense": t(field)[None]}
    got = TS.soft_hough_vote(agg, 256, 64, draws=soft_draws(key, 1, 1, 256, 64))
    for k in ("xy", "hypothesis", "pruned_hypothesis"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, rtol=RTOL,
                                   err_msg=k)
    np.testing.assert_allclose(got["xy"][0, 0].numpy(), center, atol=0.3)
    assert got["hypothesis"].shape == (1, 1, 64, 2)
    # without draws, a generator on the data's device makes them
    again = TS.soft_hough_vote(agg, 256, 64, generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(again["xy"][0, 0].numpy(), center, atol=0.3)
    with pytest.raises(ValueError, match="draws"):
        TS.soft_hough_vote(agg, 256, 64)


@pytest.mark.parametrize("seed", [2, 5])
def test_pipeline_with_soft_voting_matches_jax(seed):
    """The JAX package's pipeline case (`tests/test_voting_soft.py:70-99`):
    perfect logits of a synthetic scene, `hv_implementation="soft"`, 256
    points and 64 hypotheses, through both pipelines with JAX's draws. The
    same instances; centres, depths and R/T at the golden tolerance; every
    GT centre has a voted centre within 1.5 px."""
    rng = np.random.default_rng(seed)
    cfg = SceneConfig()
    scene = generate_scene(rng, cfg)
    logits = perfect_logits(scene, cfg.num_classes)
    inv_k = np.linalg.inv(scene["intrinsics"]).astype(np.float32)
    key = jax.random.key(0)
    want = jax_run_pipeline({k: jnp.asarray(v) for k, v in logits.items()}, key,
                            JaxPipelineConfig(max_instances=cfg.max_instances, max_points=256,
                                              hv_num_hypotheses=64, hv_implementation="soft",
                                              use_pallas=False), jnp.asarray(inv_k))["aggregated"]
    draws = soft_draws(key, 1, cfg.max_instances, 256, 64)
    got = run_pipeline({k: t(v.transpose(0, 3, 1, 2)) for k, v in logits.items()},
                       PipelineConfig(max_instances=cfg.max_instances, max_points=256,
                                      hv_num_hypotheses=64, hv_implementation="soft"),
                       t(inv_k), draws=draws)["aggregated"]
    for k in ("valid", "class_ids"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ("xy", "z", "RT", "hypothesis", "pruned_hypothesis"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, rtol=RTOL,
                                   err_msg=k)
    assert "vote_rounds" not in got and "win_ratio" not in got
    valid = got["valid"][0].numpy()
    pred = got["xy"][0].numpy()[valid]
    gt = scene["agg"]
    for k in range(int(gt["valid"].sum())):
        assert np.linalg.norm(pred - gt["xy"][k], axis=-1).min() < 1.5, k


@pytest.mark.parametrize("updates", [
    {}, dict(PRUN_METHOD="none"), dict(PRUN_METHOD="z-score", PRUN_OUTLIER_DROP=True,
                                       PRUN_ZSCORE_THRESHOLD=2.0),
    dict(PRUN_OUTLIER_REPLACEMENT_STYLE="mean", IQR_MULTIPLIER=3.0,
         HV_HYPOTHESIS_IN_MASK_MULTIPLIER=5, HV_IMPLEMENTATION="soft"),
])
def test_pipeline_config_from_fills_prun_fields(updates):
    """`pipeline_config_from` fills the soft-voting fields as the JAX one
    (`config.py:369-374`), "none" as None."""
    want = JC.pipeline_config_from(dataclasses.replace(JC.evaluating(), **updates))
    got = C.pipeline_config_from(dataclasses.replace(C.evaluating(), **updates))
    for f in ("hv_implementation", "prun_method", "prun_outlier_drop", "prun_replacement",
              "prun_zscore_threshold", "iqr_multiplier", "hv_in_mask_multiplier"):
        assert getattr(got, f) == getattr(want, f), f
    assert isinstance(got.hv_in_mask_multiplier, float)
    got.check_ported()
