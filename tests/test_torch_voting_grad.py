"""Voting is gradient-opaque in the port, as in the JAX package (the
counterpart of `tests/test_voting.py::test_voting_is_gradient_opaque`).

A HEAD_TRAINING forward from seeded logits (the perfect fields of a
synthetic scene plus noise): class compression, aggregation, adaptive RANSAC
with JAX's draws, dense refinement, RT, matching against the scene's GT and
the four matched losses. The matched XY loss gives no gradient into the xy
logits, in JAX and in the port; the quaternion, z and scales losses give the
port the gradients JAX gives, at the golden tolerance (atol 2e-4, rtol
1e-4). Both sides run op by op on the CPU (JAX un-jitted), so the voted
centres agree to the same tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from fastposecnn_tpu import losses as JL
from fastposecnn_tpu.data.synthetic import SceneConfig, generate_scene, perfect_logits
from fastposecnn_tpu.ops import voting as JV
from fastposecnn_tpu.ops.matching import gather_matched as j_gather, match_instances as j_match
from fastposecnn_tpu.pipeline import PipelineConfig as JConfig, run_pipeline as j_pipeline
from fastposecnn_tpu_torch import losses as TL
from fastposecnn_tpu_torch.ops import voting as TV
from fastposecnn_tpu_torch.ops.matching import gather_matched, match_instances
from fastposecnn_tpu_torch.pipeline import PipelineConfig, run_pipeline

ATOL, RTOL = 2e-4, 1e-4
H = W = 64
N, P, HYP, ITERS = 4, 128, 32, 20
FIELDS = ("quaternion", "xy", "z", "scales")
KEYS = ("quaternion", "scales", "z", "xy", "T", "R", "RT")


def scene_inputs(seed=0):
    cfg = SceneConfig(height=H, width=W, num_classes=3, max_instances=N,
                      max_scene_instances=2, box_half_extent=(6, 12))
    scene = generate_scene(np.random.default_rng(seed), cfg)
    rng = np.random.default_rng(seed + 1)
    logits = {}
    for k, v in perfect_logits(scene, cfg.num_classes).items():
        v = np.asarray(v, np.float32)  # [1, H, W, C]
        if k != "mask":
            v = v + rng.normal(scale=0.2, size=v.shape).astype(np.float32)
        logits[k] = v
    gt = {k: np.asarray(v)[None] for k, v in scene["agg"].items()}
    intr = np.eye(3)
    intr[0, 0] = intr[1, 1] = 60.0
    intr[0, 2], intr[1, 2] = W / 2, H / 2
    return logits, gt, np.linalg.inv(intr).astype(np.float32)


def jax_draws(key, b, n):
    k_sample, k_vote = jax.random.split(key)
    kx, ky = jax.random.split(k_sample)
    ux = jax.random.uniform(kx, (b, n, P), dtype=jnp.float32)
    uy = jax.random.uniform(ky, (b, n, P), dtype=jnp.float32)
    k, pairs = k_vote, []
    for _ in range(ITERS):
        k, k_hyp = jax.random.split(k)
        pairs.append(np.asarray(jax.random.randint(k_hyp, (b * n, HYP, 2), 0, P)))
    return TV.VoteDraws(ux=torch.from_numpy(np.array(ux)), uy=torch.from_numpy(np.array(uy)),
                        pairs=torch.from_numpy(np.stack(pairs)))


def matched_losses(L, matched):
    return {"quaternion": L.quaternion_loss(matched)[0], "xy": L.xy_loss(matched)[0],
            "z": L.z_loss(matched)[0], "scales": L.scales_loss(matched)[0]}


def test_matched_losses_pass_no_gradient_through_voting():
    logits, gt, inv_k = scene_inputs()
    key = jax.random.key(7)
    jcfg = JConfig(max_instances=N, max_points=P, hv_num_hypotheses=HYP, use_pallas=False)
    jgt = {k: jnp.asarray(v) for k, v in gt.items()}

    def jax_losses(fields):
        out = j_pipeline({"mask": jnp.asarray(logits["mask"]), **fields}, key, jcfg,
                         jnp.asarray(inv_k))
        agg = out["aggregated"]
        matched = j_gather(agg, jgt, j_match(agg, jgt), keys=KEYS)
        return matched_losses(JL, matched), agg["xy"]

    jfields = {k: jnp.asarray(logits[k]) for k in FIELDS}
    jvals, jxy = jax_losses(jfields)

    tfields = {k: torch.from_numpy(np.ascontiguousarray(logits[k].transpose(0, 3, 1, 2)))
               .requires_grad_(True) for k in FIELDS}
    cfg = PipelineConfig(max_instances=N, max_points=P, hv_num_hypotheses=HYP)
    out = run_pipeline({"mask": torch.from_numpy(logits["mask"].transpose(0, 3, 1, 2)),
                        **tfields}, cfg, torch.from_numpy(inv_k),
                       draws=jax_draws(key, 1, N))
    agg = out["aggregated"]
    tgt = {k: torch.from_numpy(v) for k, v in gt.items()}
    matched = gather_matched(agg, tgt, match_instances(agg, tgt), keys=KEYS)
    assert int(matched["valid"].sum()) >= 2  # the losses see real matches
    np.testing.assert_allclose(agg["xy"].detach().numpy(), np.asarray(jxy), atol=ATOL, rtol=RTOL)
    tvals = matched_losses(TL, matched)

    for name in FIELDS:
        np.testing.assert_allclose(float(tvals[name].detach()), float(jvals[name]), atol=ATOL,
                                   rtol=RTOL, err_msg=name)
        jgrads = jax.grad(lambda f: jax_losses(f)[0][name])(jfields)
        if tvals[name].requires_grad:
            tgrads = dict(zip(FIELDS, torch.autograd.grad(
                tvals[name], list(tfields.values()), retain_graph=True, allow_unused=True)))
        else:  # no path from any field at all
            tgrads = dict.fromkeys(FIELDS)
        for field in FIELDS:
            g = tgrads[field]
            g = np.zeros(logits[field].shape, np.float32) if g is None \
                else g.numpy().transpose(0, 2, 3, 1)
            np.testing.assert_allclose(g, np.asarray(jgrads[field]), atol=ATOL, rtol=RTOL,
                                       err_msg=f"d {name} / d {field}")
        if name == "xy":
            # The matched XY loss reaches no field, in either package.
            for field in FIELDS:
                assert tgrads[field] is None or not tgrads[field].any()
                assert not np.asarray(jgrads[field]).any()
        else:
            assert tgrads[name] is not None and tgrads[name].abs().sum() > 0


def test_refinements_and_ransac_detach_their_inputs():
    """Each voting function, called with inputs that require gradients,
    returns centres that carry none (JAX: `ops/voting.py:529-535`, :573,
    :660-661)."""
    rng = np.random.default_rng(3)
    m, p = 3, 64
    pts = torch.from_numpy(rng.integers(0, 30, size=(m, p, 2)).astype(np.float32))
    d = rng.normal(size=(m, p, 2)).astype(np.float32)
    dirs = torch.from_numpy(d / np.linalg.norm(d, axis=-1, keepdims=True)).requires_grad_(True)
    pvalid = torch.ones((m, p))
    win = torch.full((m, 2), 15.0, requires_grad=True)
    assert not TV.refine_centers(win, pts, dirs, pvalid, 0.999).requires_grad
    masks = torch.zeros((1, 2, 16, 16))
    masks[0, 0, 2:8, 2:8] = masks[0, 1, 9:14, 9:14] = 1.0
    field = torch.randn((1, 16, 16, 2), requires_grad=True)
    assert not TV.refine_centers_dense(win[None, :2], masks, field, 0.999).requires_grad
    agg = {"instance_masks": masks, "valid": torch.ones((1, 2), dtype=torch.bool),
           "xy_dense": field, "cc_labels": torch.zeros((1, 16, 16), dtype=torch.int32),
           "cc_roots": torch.zeros((1, 2), dtype=torch.int32)}
    gen = torch.Generator().manual_seed(0)
    for adaptive in (False, True):
        for refine in ("dense", "sampled"):
            out = TV.hough_vote(agg, max_points=32, round_hyp_num=16, generator=gen,
                                cpu_generator=gen, adaptive=adaptive, refine=refine,
                                sampler="cdf")
            assert not out["xy"].requires_grad and not out["hypothesis"].requires_grad
    # the JAX refinements are opaque as well
    jfield = jnp.asarray(field.detach().numpy())
    g = jax.grad(lambda f: JV.refine_centers_dense(
        jnp.full((1, 2, 2), 5.0), jnp.asarray(masks.numpy()), f, 0.999).sum())(jfield)
    assert not np.asarray(g).any()
