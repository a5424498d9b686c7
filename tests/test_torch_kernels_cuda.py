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
    new_error_flag,
)
from fastposecnn_tpu_torch.ops.voting import vote_counts
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
    """Given a flag, the wrapper leaves it unread (and clear on a good
    mask); a flag of the wrong type or device is refused."""
    fg = torch.from_numpy(_masks()["random"]).to(cuda_device)
    err = new_error_flag(fg)
    got = label_components(fg, err=err)
    assert torch.equal(got, label_components(fg, impl="reference"))
    assert int(err.item()) == 0
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
