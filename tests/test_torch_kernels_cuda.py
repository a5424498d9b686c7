"""The port's CUDA kernels against their plain PyTorch versions on a GPU.

Marked `cuda`; each test skips without a GPU. This file imports neither JAX
nor the JAX package, so it also runs on a GPU machine without JAX:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch
from cc_masks import tile_edge_masks

from fastposecnn_tpu_torch import kernels
from fastposecnn_tpu_torch.ops.connected_components import (
    label_components,
    label_components_cuda,
    label_components_deferred,
)
from fastposecnn_tpu_torch.ops.voting import vote_counts, vote_counts_reference
from fastposecnn_tpu_torch.pipeline import PipelineConfig, run_pipeline
from fastposecnn_tpu_torch.probes import vote_variants as V

pytestmark = pytest.mark.cuda
_NO_LAUNCHES = {k: 0 for k in kernels.KERNELS}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _masks():
    rng = np.random.default_rng(0)
    snake = np.zeros((1, 16, 16), bool)
    snake[0, ::2, :] = True
    snake[0, 1::4, -1] = True
    snake[0, 3::4, 0] = True
    blob = np.zeros((1, 48, 128), bool)
    blob[0, 4:44, 8:120] = True
    comb = np.zeros((1, 40, 96), bool)
    comb[0, :, ::2] = True
    comb[0, -1] = True
    return {
        "random": rng.random((2, 32, 64)) > 0.55,
        # Widths that are no multiple of a 32-pixel warp: runs cross warps
        # and rows share warps.
        "random_odd_width": rng.random((3, 37, 101)) > 0.5,
        "long_runs_odd_width": rng.random((2, 20, 333)) > 0.03,
        "comb": comb,
        "blob": blob,
        "snake": snake,
        "empty": np.zeros((1, 8, 8), bool),
        "full": np.ones((1, 8, 8), bool),
        # A batch of 8 at the held-out shape's height and a ragged width.
        "random_b8": rng.random((8, 224, 330)) > np.linspace(0.2, 0.8, 8)[:, None, None],
        # Masks that cross the kernel's 32x32 tile edges, at 64x96 and at a
        # ragged 37x101.
        **{f"{name}_{h}x{w}": m[None] for h, w in ((64, 96), (37, 101))
           for name, m in tile_edge_masks(h, w).items()},
    }


@pytest.mark.parametrize("name", sorted(_masks()))
def test_cc_kernel_matches_reference(cuda_device, name):
    fg = torch.from_numpy(_masks()[name]).to(cuda_device)
    before = kernels.launch_counts()["cc_label"]
    got = label_components(fg)
    want = label_components(fg, impl="reference")
    torch.cuda.synchronize()
    assert kernels.launch_counts()["cc_label"] == before + 1
    assert torch.equal(got, want)


def test_cc_kernel_defers_its_flag(cuda_device):
    """The op hands its flag back unread (and clear on a good mask); the
    wrapper refuses a flag of the wrong type or device."""
    fg = torch.from_numpy(_masks()["random"]).to(cuda_device)
    got, err = label_components_deferred(fg)
    assert torch.equal(got, label_components(fg, impl="reference"))
    assert err.is_cuda and err.dtype == torch.int32 and int(err.item()) == 0
    with pytest.raises(ValueError):
        label_components_cuda(fg, err=torch.zeros(1, dtype=torch.int64, device=cuda_device))
    with pytest.raises(ValueError):
        label_components_cuda(fg, err=torch.zeros(1, dtype=torch.int32))


def _vote_active(m, h, p):
    """Slot 1 inactive; at the evaluation shape 15 slots drawn at random (not
    a prefix), and at 4x256x512 no slot at all."""
    if (m, h, p) == (64, 1000, 1024):
        active = np.zeros(m, bool)
        active[np.random.default_rng(64).choice(m, 15, replace=False)] = True
        return active
    if (m, h, p) == (4, 256, 512):
        return np.zeros(m, bool)
    return np.arange(m) != 1


@pytest.mark.parametrize("m,h,p", [
    (16, 4096, 1024), (5, 1000, 777),
    # the edges of K2's partition: evaluation slots that are no prefix, one
    # hypothesis and one point, H and P below one warp split, H one past a
    # block of hypotheses and P beyond one or two 1024-point tiles, no
    # active slot
    (64, 1000, 1024), (3, 1, 1), (2, 33, 31), (7, 129, 2048), (9, 1921, 2100),
    (4, 256, 512)])
def test_vote_kernel_matches_reference(cuda_device, m, h, p):
    rng = np.random.default_rng(m)
    pts = rng.uniform(0, 32, size=(m, p, 2)).astype(np.float32)
    hyps = rng.uniform(0, 32, size=(m, h, 2)).astype(np.float32)
    dirs = rng.normal(size=(m, p, 2)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    active = _vote_active(m, h, p)
    pvalid = ((rng.random((m, p)) > 0.1) & active[:, None]).astype(np.float32)
    args = [torch.from_numpy(x).to(cuda_device) for x in (hyps, pts, dirs, pvalid)]
    act = torch.from_numpy(active).to(cuda_device)
    got = vote_counts(*args, 0.999, active=act)
    want = vote_counts(*args, 0.999, active=act, impl="reference")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert not got[~act].any()


def test_wrappers_reject_bad_tensors(cuda_device):
    from fastposecnn_tpu_torch.ops.voting import vote_counts_cuda

    hyps = torch.zeros(2, 8, 2, device=cuda_device)
    pts = torch.zeros(2, 4, 2, device=cuda_device)
    with pytest.raises(ValueError):
        vote_counts_cuda(hyps.double(), pts, pts, torch.zeros(2, 4, device=cuda_device), 0.999)
    with pytest.raises(ValueError):
        vote_counts_cuda(hyps, pts[:, :3], pts, torch.zeros(2, 4, device=cuda_device), 0.999)


@pytest.mark.parametrize("case", list(V.EDGE_CASES))
def test_probe_kernels_match_reference(cuda_device, case):
    """P2 (broadcasts, CUDA cores) exactly equal to its plain version; P1
    (3xTF32 on the tensor cores) inside the rounding band derived for it, at
    the script's and the evaluated shape and at the edges of their tiles:
    one hypothesis and one point, ragged under a tile, past a tile, H one
    past a 64-row tile, M = 1, a slot with no valid point, valid counts that
    are no multiple of a tile."""
    m = V.EDGE_CASES[case][0]
    args = [torch.from_numpy(a).to(cuda_device) for a in V.edge_inputs(case, seed=m)]
    kernels.reset_launch_counts()
    p1 = V.vote_counts_expanded_mm(*args)
    p2 = V.vote_counts_expanded_bcast(*args)
    assert kernels.launch_counts() == {**_NO_LAUNCHES, "vote_expanded_mm": 1,
                                       "vote_expanded_bcast": 1}
    assert torch.equal(p2, V.vote_counts_expanded_bcast_reference(*args))
    lo, hi = V.expanded_vote_band(*args, c=V.BAND_C_3XTF32)
    assert bool(((lo <= p1) & (p1 <= hi)).all())


@pytest.mark.parametrize("name", ["mm", "bcast"])
def test_probe_wrappers_reject_bad_tensors(cuda_device, name):
    cuda = getattr(V, f"vote_counts_expanded_{name}_cuda")
    hyps, pts, dirs, pv = [torch.from_numpy(a).to(cuda_device)
                           for a in V.make_inputs(2, 8, 4, seed=0)]
    with pytest.raises(ValueError):
        cuda(hyps, pts.cpu(), dirs, pv)
    with pytest.raises(ValueError):
        cuda(hyps.double(), pts, dirs, pv)
    with pytest.raises(ValueError):
        cuda(hyps, pts[:, :3].contiguous(), dirs, pv)
    with pytest.raises(ValueError):
        cuda(hyps, pts, dirs, pv[:, :3].contiguous())


def _disc_logits(dev, h=96, w=128, num_classes=3, noise=0.0):
    """NCHW logits with two discs of classes 1 and 2 whose xy fields point
    at their centres (plus Gaussian `noise` on the field)."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    rng = np.random.default_rng(1)
    cm1 = num_classes - 1
    mask = np.full((num_classes, h, w), -10.0, np.float32)
    mask[0] = 10.0
    xy = np.zeros((2 * cm1, h, w), np.float32)
    quat = np.zeros((4 * cm1, h, w), np.float32)
    z = np.zeros((cm1, h, w), np.float32)
    for cls, cx, cy, r in [(1, 30.5, 40.25, 18), (2, 90.25, 50.5, 22)]:
        inside = (xs - cx) ** 2 + (ys - cy) ** 2 <= r * r
        k = cls - 1
        mask[0][inside], mask[cls][inside] = -10.0, 10.0
        dx, dy = cx - xs, cy - ys
        nrm = np.sqrt(dx * dx + dy * dy)
        xy[2 * k][inside] = (dx / nrm + noise * rng.normal(size=(h, w)))[inside]
        xy[2 * k + 1][inside] = (dy / nrm + noise * rng.normal(size=(h, w)))[inside]
        quat[4 * k, inside] = 1.0
        z[k][inside] = np.log(800.0)
    logits = {"mask": mask, "quaternion": quat, "xy": xy, "z": z,
              "scales": np.zeros((3 * cm1, h, w), np.float32)}
    return {k: torch.from_numpy(v)[None].to(dev) for k, v in logits.items()}


@pytest.mark.parametrize("num_hyp,max_points", [(128, 1024), (300, 128), (4096, 1024)])
def test_pipeline_kernels_match_reference(cuda_device, num_hyp, max_points):
    """run_pipeline through both kernels equals its plain run, also at
    hypothesis counts that are not a multiple of the point count."""
    logits = _disc_logits(cuda_device)
    cfg = PipelineConfig(max_points=max_points, hv_num_hypotheses=num_hyp,
                         hv_adaptive=False)
    inv_K = torch.eye(3, device=cuda_device)

    def run(impl):
        gens = dict(generator=torch.Generator(cuda_device).manual_seed(0),
                    cpu_generator=torch.Generator().manual_seed(0))
        return run_pipeline(logits, dataclasses.replace(cfg, impl=impl), inv_K,
                            **gens)["aggregated"]

    kernels.reset_launch_counts()
    got = run(None)
    assert kernels.launch_counts() == {**_NO_LAUNCHES, "cc_label": 1, "vote_count": 1}
    want = run("reference")
    for key in ("cc_labels", "class_ids", "hypothesis", "win_ratio"):
        assert torch.equal(got[key], want[key]), key
    for key in ("xy", "z", "RT"):
        torch.testing.assert_close(got[key], want[key], atol=2e-4, rtol=1e-4)
    assert got["class_ids"][0, :2].tolist() == [1, 2]


@pytest.mark.parametrize("sampler,refine", [("bbox", "dense"), ("cdf", "sampled")])
def test_adaptive_pipeline_kernels_match_reference(cuda_device, sampler, refine):
    """The EVALUATING preset's adaptive vote (1000 hypotheses a round, 1024
    points) through both kernels equals its plain run round for round, on
    a noisy field that needs several rounds."""
    logits = _disc_logits(cuda_device, noise=2.0)
    cfg = PipelineConfig(max_points=1024, hv_num_hypotheses=1000, hv_adaptive=True,
                         hv_sampler=sampler, hv_refine=refine)
    inv_K = torch.eye(3, device=cuda_device)

    def run(impl):
        gens = dict(generator=torch.Generator(cuda_device).manual_seed(0),
                    cpu_generator=torch.Generator().manual_seed(0))
        return run_pipeline(logits, dataclasses.replace(cfg, impl=impl), inv_K,
                            **gens)["aggregated"]

    kernels.reset_launch_counts()
    got = run(None)
    rounds = got["vote_rounds"]
    assert kernels.launch_counts() == {**_NO_LAUNCHES, "cc_label": 1, "vote_count": rounds}
    want = run("reference")
    assert 1 < rounds == want["vote_rounds"]
    for key in ("cc_labels", "class_ids", "hypothesis", "win_ratio"):
        assert torch.equal(got[key], want[key]), key
    for key in ("xy", "z", "RT"):
        torch.testing.assert_close(got[key], want[key], atol=2e-4, rtol=1e-4)


def test_custom_ops_launch_the_kernels(cuda_device):
    """`fastposecnn::cc_label` and `fastposecnn::vote_count` on CUDA tensors
    launch K1 and K2 (counted once each) and equal the plain versions."""
    rng = np.random.default_rng(5)
    fg = torch.from_numpy(_masks()["random_odd_width"]).to(cuda_device)
    m, h, p = 5, 100, 300
    hyps, pts = (torch.from_numpy(rng.uniform(0, 32, size=(m, n, 2)).astype(np.float32))
                 .to(cuda_device) for n in (h, p))
    dirs = torch.nn.functional.normalize(torch.randn(m, p, 2), dim=-1).to(cuda_device)
    pvalid = (torch.rand(m, p) > 0.1).float().to(cuda_device)
    active = torch.tensor([True, False, True, True, False], device=cuda_device)
    before = kernels.launch_counts()
    labels, err = torch.ops.fastposecnn.cc_label(fg)
    counts = torch.ops.fastposecnn.vote_count(hyps, pts, dirs, pvalid, active, 0.999)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["cc_label"] == before["cc_label"] + 1
    assert after["vote_count"] == before["vote_count"] + 1
    assert int(err.item()) == 0 and err.device == fg.device
    assert torch.equal(labels, label_components(fg, impl="reference"))
    assert torch.equal(counts, vote_counts_reference(hyps, pts, dirs, pvalid, 0.999, active))


@pytest.mark.parametrize("adaptive", [True, False], ids=["adaptive", "single_shot"])
def test_exported_pipeline_launches_the_kernels(cuda_device, tmp_path, adaptive):
    """A pipeline exported on the card (64x64, 3 classes, 4 slots, 64
    points, 16 hypotheses) and loaded back launches K1 once and K2 once a
    vote round, and equals the eager pipeline on the same draws (mask and
    class ids exactly, xy, z and RT at the golden tolerance)."""
    from fastposecnn_tpu_torch.device import full_float32
    from fastposecnn_tpu_torch.models import PoseRegressorNet
    from fastposecnn_tpu_torch.models.weights import init_random_
    from fastposecnn_tpu_torch.utils.export import export_forward, load_exported, make_draws

    net = init_random_(PoseRegressorNet(num_classes=3), 0).to(cuda_device).eval()
    pcfg = PipelineConfig(max_instances=4, max_points=64, hv_num_hypotheses=16,
                          hv_adaptive=adaptive)
    inv_k = np.linalg.inv(np.asarray([[60.0, 0, 32], [0, 60, 32], [0, 0, 1]]))
    draws = make_draws(pcfg, 1, 0, cuda_device)
    x = torch.randn((1, 3, 64, 64), generator=torch.Generator().manual_seed(1)).to(cuda_device)
    fn = load_exported(export_forward(net, tmp_path / "p.pt2", image_shape=(1, 3, 64, 64),
                                      pipeline_config=pcfg, inv_intrinsics=inv_k, draws=draws))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    got = fn(x)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    with torch.no_grad(), full_float32():
        out = run_pipeline(net(x), pcfg, torch.as_tensor(inv_k, dtype=torch.float32,
                                                         device=cuda_device), draws=draws)
    agg = out["aggregated"]
    assert launches["cc_label"] == 1 and launches["vote_count"] == agg["vote_rounds"]
    assert torch.equal(got[0], out["categorical"]["mask"])
    assert torch.equal(got[1], agg["class_ids"])
    for g, w in zip(got[2:], (agg["xy"], agg["z"], agg["RT"])):
        torch.testing.assert_close(g, w, atol=2e-4, rtol=1e-4)


# -----------------------------------------------------------------------------
# K3: the optimizer's gradient statistics and update (`kernels/optim.cu`)


def _k3_setup(encoder, dev, seed=0):
    """FastPoseCNN's parameters with `encoder` on the card (seeded normal
    values) and the MASK_TRAINING optimizer over them: three decoders and
    their heads frozen, the encoder at ENCODER_LEARNING_RATE / LEARNING_RATE."""
    from fastposecnn_tpu_torch import config as C
    from fastposecnn_tpu_torch.models import network_from_hparams
    from fastposecnn_tpu_torch.train import optim as O

    hp = C.mask_training(ENCODER=encoder)
    shapes = {n: p.shape for n, p in network_from_hparams(hp).named_parameters()}
    gen = torch.Generator(dev).manual_seed(seed)
    params = {n: torch.randn(s, generator=gen, device=dev) * 0.05 for n, s in shapes.items()}
    opt = O.Optimizer(hp, list(shapes))
    assert 0.0 in opt.freeze and any(r not in (0.0, 1.0) for r in opt.ratio)
    return opt, params, gen


def _bits_differ(a, b) -> int:
    return int((a.view(torch.int32) != b.view(torch.int32)).sum())


@pytest.mark.parametrize("encoder", ["resnet18", "resnet50"])
def test_optim_update_bit_equal_to_plain_chain(cuda_device, encoder):
    """K3b against the foreach chain given K3a's clip norm, over steps 1-8
    (un-rectified through 5, the Lookahead sync at 5, rectified from 6), the
    clip on and off in turn, the plateau scale 0.25, frozen modules, the
    encoder ratio and one parameter without a gradient: parameters, moments
    and slow weights bit-equal after every step, one launch of each kernel
    a step."""
    from fastposecnn_tpu_torch.train import optim as O

    opt, p_k, gen = _k3_setup(encoder, cuda_device)
    p_r = {n: t.clone() for n, t in p_k.items()}
    st_k = O.set_lr_scale(opt.init(p_k), 0.25)
    st_r = O.set_lr_scale(opt.init(p_r), 0.25)
    missing = opt.names[3]
    clipped = []
    for step in range(1, 9):
        scale = 1.0 if step % 2 else 1e-6
        grads = {n: None if n == missing else
                 torch.randn(t.shape, generator=gen, device=cuda_device) * scale
                 for n, t in p_k.items()}
        before = kernels.launch_counts()
        stats = opt.grad_stats(grads, st_k, p_k)
        updates, st_k = opt.update(grads, st_k, p_k, clip_norm=stats.clip_norm)
        O.apply_updates(p_k, updates)
        after = kernels.launch_counts()
        plain, st_r = opt.plain_update(grads, st_r, p_r, clip_norm=stats.clip_norm)
        O.apply_updates(p_r, plain)
        torch.cuda.synchronize()
        assert after["optim_stats"] - before["optim_stats"] == 1
        assert after["optim_update"] - before["optim_update"] == 1
        clipped.append(bool(stats.clip_norm >= opt.clip))
        assert (st_k.count, st_k.lookahead_step) == (st_r.count, st_r.lookahead_step) == (step,
                                                                                          step)
        for field, got, want in (("param", p_k, p_r), ("mu", st_k.mu, st_r.mu),
                                 ("nu", st_k.nu, st_r.nu), ("slow", st_k.slow, st_r.slow)):
            bad = {n: _bits_differ(got[n], want[n]) for n in opt.names}
            bad = {n: k for n, k in bad.items() if k}
            assert not bad, (step, field, dict(list(bad.items())[:5]))
    assert clipped == [True, False] * 4
    assert [O.radam_scalars(c)["rectified"] for c in range(1, 9)] == [False] * 5 + [True] * 3
    assert torch.equal(st_k.mu[missing], torch.zeros_like(st_k.mu[missing]))


def test_optim_grad_stats(cuda_device):
    """K3a's per-tensor sums within 1e-6 of a float64 sum; a parameter
    without a gradient reads as zeros; the logged and clip norms; the count
    of non-finite elements with one NaN, one +inf and one -inf in the last
    tensor (the logged norm is then inf: +-inf reads FLT_MAX)."""
    from fastposecnn_tpu_torch.train import optim as O

    opt, params, gen = _k3_setup("resnet50", cuda_device, seed=1)
    state = opt.init(params)
    grads = {n: torch.randn(t.shape, generator=gen, device=cuda_device) * 10.0 ** (k % 5 - 2)
             for k, (n, t) in enumerate(params.items())}
    grads[opt.names[5]] = None
    stats = opt.grad_stats(grads, state, params)
    want = torch.stack([torch.zeros((), dtype=torch.float64, device=cuda_device) if g is None
                        else (g.double() ** 2).sum() for g in grads.values()])
    rel = ((stats.sums.double() - want).abs() / want.clamp_min(1e-300)).max()
    assert float(rel) < 1e-6, float(rel)
    assert float(stats.sums[5]) == 0.0
    live = torch.tensor(opt.freeze, dtype=torch.float64, device=cuda_device) != 0
    for got, sq in ((stats.norm, want.sum()), (stats.clip_norm, want[live].sum())):
        assert abs(float(got) / float(sq.sqrt()) - 1) < 1e-6
    assert bool(stats.finite) and int(stats.nonfinite) == 0

    listed = [grads[n] for n in opt.names]
    plain = O.grad_stats_plain(listed, opt.freeze, [False] * len(listed), cuda_device)
    for got, want in ((stats.norm, plain.norm), (stats.clip_norm, plain.clip_norm)):
        assert abs(float(got) / float(want) - 1) < 1e-6

    last = grads[opt.names[-1]].view(-1)
    last[:3] = torch.tensor([float("nan"), float("inf"), float("-inf")], device=cuda_device)
    bad = opt.grad_stats(grads, state, params)
    assert not bool(bad.finite) and int(bad.nonfinite) == 3
    assert float(bad.norm) == float("inf") and float(bad.sums[-1]) == float("inf")
    plain = O.grad_stats_plain(listed, opt.freeze, [False] * len(listed), cuda_device)
    assert (bool(plain.finite), int(plain.nonfinite)) == (False, 3)
    for got, want in ((bad.norm, plain.norm), (bad.clip_norm, plain.clip_norm)):
        assert float(got) == float(want) or abs(float(got) / float(want) - 1) < 1e-6


def test_optim_grad_stats_sharded_split(cuda_device, monkeypatch):
    """With tp-sharded tensors K3a's logged and clip norms add the sharded
    tensors' squares over the tp group and the others once, as the plain
    version does: a group of two ranks with equal slices is stood in for by
    a `mesh.global_sum` that doubles, on both sides."""
    from fastposecnn_tpu_torch.train import optim as O

    opt, params, gen = _k3_setup("resnet18", cuda_device, seed=2)
    state = opt.init(params)
    grads = [torch.randn(params[n].shape, generator=gen, device=cuda_device)
             for n in opt.names]
    sharded = [k % 3 == 0 for k in range(len(opt.names))]
    groups = {"params": [params[n] for n in opt.names],
              "mu": [state.mu[n] for n in opt.names], "nu": [state.nu[n] for n in opt.names],
              "slow": [state.slow[n] for n in opt.names]}
    table = O.K3Table(opt, groups, sharded, key=None)
    table.upload_grads(grads)
    monkeypatch.setattr(O.mesh, "global_sum", lambda t, over: t * 2)
    got = O.grad_stats_cuda(table)
    want = O.grad_stats_plain(grads, opt.freeze, sharded, cuda_device)
    one = O.grad_stats_plain(grads, opt.freeze, [False] * len(grads), cuda_device)
    for g, w, o in ((got.norm, want.norm, one.norm),
                    (got.clip_norm, want.clip_norm, one.clip_norm)):
        assert abs(float(g) / float(w) - 1) < 1e-6 and float(w) > float(o) * 1.01


def test_optim_update_needs_clip_norm(cuda_device):
    """On CUDA the update takes the clip norm of `grad_stats`; it raises
    without it."""
    from fastposecnn_tpu_torch.train import optim as O

    opt, params, gen = _k3_setup("resnet18", cuda_device, seed=3)
    grads = {n: torch.randn(t.shape, generator=gen, device=cuda_device)
             for n, t in params.items()}
    with pytest.raises(ValueError, match="clip norm"):
        opt.update(grads, opt.init(params), params)


def _k3_train_steps(dev, steps, nan_at=None):
    """`steps` MASK_TRAINING steps of a random 3-class network at 64x64,
    batch 2, on the card; with `nan_at` a NaN in one weight's gradient at
    that step. Returns the states after each step (host copies of the
    parameters, buffers and optimizer tensors) and the launches a step."""
    from fastposecnn_tpu_torch import config as C
    from fastposecnn_tpu_torch.data.synthetic import SceneConfig, make_batch
    from fastposecnn_tpu_torch.models import PoseRegressorNet
    from fastposecnn_tpu_torch.models.weights import init_random_
    from fastposecnn_tpu_torch.train import task

    hp = C.mask_training(IMAGE_HEIGHT=64, IMAGE_WIDTH=64, BATCH_SIZE=2, MAX_INSTANCES=4,
                         SELECTED_CLASSES=("bg", "bottle", "bowl"))
    net = init_random_(PoseRegressorNet(hp.num_classes), 0).to(dev)
    opt = task.make_optimizer(hp, net)
    state = task.create_train_state(net, opt)
    inv_k = np.linalg.inv(np.array([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]]))
    step = task.make_train_step(net, opt, hp, C.pipeline_config_from(hp), inv_k, dev)
    batch = make_batch(np.random.default_rng(0), SceneConfig(
        height=64, width=64, num_classes=3, max_instances=4, max_scene_instances=2,
        box_half_extent=(6, 14)), 2)
    weight = net.segmentation_head[0].weight
    seen, launches = [], []
    for i in range(steps):
        hook = weight.register_hook(lambda g: g.index_fill(
            0, torch.tensor([0], device=g.device), float("nan"))) if i == nan_at else None
        before = kernels.launch_counts()
        state, logs = step(state, batch, seed=5)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        if hook is not None:
            hook.remove()
        launches.append((after["optim_stats"] - before["optim_stats"],
                         after["optim_update"] - before["optim_update"]))
        o = state.opt_state
        seen.append({**{f"net/{k}": v.detach().cpu().clone()
                        for k, v in net.state_dict().items()},
                     **{f"{f}/{k}": v.cpu().clone() for f in ("mu", "nu", "slow")
                        for k, v in getattr(o, f).items()},
                     "finite": float(logs["grad/finite"]), "skipped": state.skipped_updates})
    return seen, launches


def test_optim_skipped_step_changes_nothing(cuda_device):
    """A step whose gradients hold a NaN launches K3a alone and leaves the
    parameters, moments and slow weights bit-unchanged."""
    seen, launches = _k3_train_steps(cuda_device, 3, nan_at=1)
    assert launches == [(1, 1), (1, 0), (1, 1)]
    assert [s["finite"] for s in seen] == [1.0, 0.0, 1.0]
    assert seen[1]["skipped"] == 1
    for k, v in seen[0].items():
        if k.startswith(("net/", "mu/", "nu/", "slow/")) and "running_" not in k \
                and "num_batches" not in k:
            assert torch.equal(v, seen[1][k]), k


def test_optim_train_steps_reproducible(cuda_device):
    """Two runs of six train steps on the card (the Lookahead sync at 5, the
    rectified update at 6) are bit-equal, one launch of each kernel a
    step."""
    a, la = _k3_train_steps(cuda_device, 6)
    b, lb = _k3_train_steps(cuda_device, 6)
    assert la == lb == [(1, 1)] * 6
    for sa, sb in zip(a, b):
        for k, v in sa.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, sb[k]), k
    assert not torch.equal(a[0]["net/segmentation_head.0.weight"],
                           a[-1]["net/segmentation_head.0.weight"])
