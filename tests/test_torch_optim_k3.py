"""What surrounds kernel K3 (`kernels/optim.cu`, `train/optim.py`), on the
CPU: the table and chunk map it reads, the checks of its tensors, the plain
gradient statistics against the per-parameter code they replaced (NaN and
+-inf gradients, parameters without a gradient, frozen modules, tp-sharded
flags), and whole CPU train steps whose logs, parameters and optimizer
state are bit-equal to those of that code. The kernels themselves run in
`tests/test_torch_kernels_cuda.py` on a card.
"""

import copy

import numpy as np
import pytest
import torch

from fastposecnn_tpu_torch import config as C
from fastposecnn_tpu_torch.data.synthetic import SceneConfig, make_batch
from fastposecnn_tpu_torch.models import PoseRegressorNet
from fastposecnn_tpu_torch.models.weights import init_random_
from fastposecnn_tpu_torch.parallel import mesh
from fastposecnn_tpu_torch.train import optim as O
from fastposecnn_tpu_torch.train import task


@pytest.mark.parametrize("numels,chunk", [
    ([1], 4), ([4], 4), ([5], 4), ([0, 3, 9, 0], 4), ([16384, 16385, 1], O.CHUNK),
    ([2_359_296, 512, 512, 1], O.CHUNK),
])
def test_chunk_map(numels, chunk):
    """Each tensor's chunks are consecutive, cover its elements with at most
    `chunk` each, and an empty tensor still has one."""
    first, owner = O.chunk_map(numels, chunk)
    assert first.dtype == owner.dtype == np.int64
    assert first[0] == 0 and len(first) == len(numels) + 1 and first[-1] == len(owner)
    for i, n in enumerate(numels):
        c = first[i + 1] - first[i]
        assert c == max(1, -(-n // chunk)), i
        assert (owner[first[i]:first[i + 1]] == i).all()
        assert (c - 1) * chunk < max(n, 1) <= c * chunk


def test_build_table_layout():
    n_el = [5, 0, 9]
    ptrs = [[0x7F0000000000 + 256 * k + i for i in range(3)] for k in range(4)]
    freeze, ratio, sharded = [1.0, 0.0, 1.0], [0.5, 0.0, 1.0], [False, True, False]
    words, mult = O.build_table(ptrs, n_el, freeze, ratio, sharded, chunk=4)
    first, owner = O.chunk_map(n_el, 4)
    n = 3
    assert words.dtype == np.int64 and mult.dtype == np.float32
    assert len(words) == 6 * n + 1 + len(owner)
    for k in range(4):
        assert words[k * n:(k + 1) * n].tolist() == ptrs[k]
    assert words[4 * n:5 * n].tolist() == n_el
    assert words[5 * n:6 * n + 1].tolist() == first.tolist()
    assert words[6 * n + 1:].tolist() == owner.tolist()
    assert mult.tolist() == freeze + ratio + [0.0, 1.0, 0.0]
    # addresses at and above 2**63 survive as their bits
    high, _ = O.build_table([[2 ** 64 - 8]] * 4, [1], [1.0], [1.0], [False])
    assert high[:4].view(np.uint64).tolist() == [2 ** 64 - 8] * 4
    with pytest.raises(ValueError):
        O.build_table(ptrs[:3], n_el, freeze, ratio, sharded)
    with pytest.raises(ValueError):
        O.build_table(ptrs, n_el, freeze[:2], ratio, sharded)


@pytest.mark.parametrize("bad", ["float64", "strided", "numel", "device"])
def test_k3_tensor_checks_refuse(bad):
    good = [torch.zeros(4, 3), torch.zeros(7)]
    ts = list(good)
    if bad == "float64":
        ts[1] = torch.zeros(7, dtype=torch.float64)
    elif bad == "strided":
        ts[0] = torch.zeros(3, 4).t()
    elif bad == "numel":
        ts[1] = torch.zeros(8)
    else:
        ts[1] = torch.zeros(7, device="meta")
    O.check_k3_tensors({"params": good}, [12, 7], torch.device("cpu"))
    with pytest.raises(ValueError, match=r"K3: params\[\d\]"):
        O.check_k3_tensors({"params": ts}, [12, 7], torch.device("cpu"))


def test_k3_table_refuses_cpu_tensors():
    hp = C.mask_training()
    opt = O.Optimizer(hp, ["encoder.w", "mask_decoder.b"])
    params = {"encoder.w": torch.zeros(3), "mask_decoder.b": torch.zeros(2)}
    with pytest.raises(ValueError, match="CUDA"):
        opt.k3_table(opt.init(params), params)


# -----------------------------------------------------------------------------
# The plain gradient statistics against the code they replaced


def old_global_norm(tensors, sharded=()):
    """`train/optim.py::global_norm` as it was."""
    if not any(sharded):
        return torch.sqrt(sum((t * t).sum() for t in tensors))
    own = [(t * t).sum() for t, s in zip(tensors, sharded, strict=True) if s]
    rest = [(t * t).sum() for t, s in zip(tensors, sharded) if not s]
    return torch.sqrt(sum(rest) + mesh.global_sum(sum(own), over="tp"))


def old_stats(grads, params, freeze, sharded):
    """The step's finite test and logged norm, and the clip's norm inside the
    update, as the per-parameter code computed them."""
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
    safe = [torch.nan_to_num(g) for g in grads]
    clip = old_global_norm(torch._foreach_mul(safe, freeze), sharded)
    return finite, old_global_norm(safe, sharded), clip


def _grads(case):
    rng = np.random.default_rng(7)
    shapes = [(8, 3, 3, 3), (8,), (16, 8, 1, 1), (16,), (5, 16, 3, 3), (5,)]
    grads = [torch.from_numpy((rng.normal(size=s) * 10.0 ** rng.integers(-3, 2))
                              .astype(np.float32)) for s in shapes]
    params = [torch.zeros(s) for s in shapes]
    freeze, sharded = [1.0] * 6, [False] * 6
    want_bad = 0
    if case in ("nan", "inf", "neg_inf", "all"):
        for value in {"nan": [np.nan], "inf": [np.inf], "neg_inf": [-np.inf],
                      "all": [np.nan, np.inf, -np.inf]}[case]:
            grads[-1].view(-1)[want_bad + 1] = value
            want_bad += 1
    if case in ("missing", "all"):
        grads[1] = None
    if case in ("frozen", "all"):
        freeze = [1.0, 1.0, 0.0, 0.0, 1.0, 1.0]
        grads[2].view(-1)[0] = np.inf  # a frozen tensor's inf counts, but not in the clip
        want_bad += 1
    if case in ("sharded", "all"):
        sharded = [False, False, True, False, True, False]
    return grads, params, freeze, sharded, want_bad


@pytest.mark.parametrize("case", ["finite", "nan", "inf", "neg_inf", "missing", "frozen",
                                  "sharded", "all"])
def test_plain_grad_stats_match_per_parameter_code(case):
    """Bit-equal flag and norms (outside a process group the tp sum is the
    identity, on both sides), the exact count and each tensor's sum."""
    grads, params, freeze, sharded, want_bad = _grads(case)
    got = O.grad_stats_plain(grads, freeze, sharded, torch.device("cpu"))
    finite, norm, clip = old_stats(grads, params, freeze, sharded)
    assert torch.equal(got.finite, finite) and bool(finite) == (want_bad == 0)
    assert int(got.nonfinite) == want_bad
    assert torch.equal(got.norm, norm), (got.norm, norm)
    assert torch.equal(got.clip_norm, clip), (got.clip_norm, clip)
    for i, g in enumerate(grads):
        want = 0.0 if g is None else float((torch.nan_to_num(g) ** 2).sum())
        assert float(got.sums[i]) == want, i
    if case in ("inf", "neg_inf", "all"):
        assert not torch.isfinite(norm)  # a +-inf reads FLT_MAX, whose square is inf


def test_grad_stats_dispatch_on_cpu():
    """`Optimizer.grad_stats` on CPU tensors is the plain version, with the
    optimizer's freeze multipliers: the clip's norm leaves the frozen
    modules out, the logged norm does not; a missing gradient reads as
    zeros. With every module frozen the clip's norm is 0."""
    hp = C.mask_training()
    names = ["encoder.a", "rotation_decoder.b", "segmentation_head.c"]
    opt = O.Optimizer(hp, names)
    params = {n: torch.zeros(3) for n in names}
    grads = {n: torch.full((3,), float(k + 1)) for k, n in enumerate(names)}
    grads["segmentation_head.c"] = None
    stats = opt.grad_stats(grads, opt.init(params), params)
    assert opt.freeze == [1.0, 0.0, 1.0]
    assert torch.equal(stats.norm, torch.sqrt(torch.tensor(3.0 + 12.0)))
    assert torch.equal(stats.clip_norm, torch.sqrt(torch.tensor(3.0)))
    assert bool(stats.finite) and int(stats.nonfinite) == 0
    frozen = O.Optimizer(C.mask_training(FREEZE_ENCODER=True, FREEZE_MASK_TRAINING=True), names)
    assert float(frozen.grad_stats(grads, opt.init(params), params).clip_norm) == 0.0


# -----------------------------------------------------------------------------
# Whole CPU steps


SIZES = dict(IMAGE_HEIGHT=32, IMAGE_WIDTH=32, SELECTED_CLASSES=("bg", "bottle", "bowl"),
             MAX_INSTANCES=4, MAX_VOTE_POINTS=128, HV_NUM_OF_HYPOTHESES=32, BATCH_SIZE=2)


def _old_optimizer(opt):
    """`opt` with `grad_stats` and `update` as the per-parameter code ran
    them: the finite test, the logged norm and the clip's norm computed one
    op a tensor in the old order, and the update computing its clip norm
    itself."""
    old = copy.copy(opt)

    def grad_stats(grads, state, params):
        gs = [grads[n] for n in opt.names]
        ps = [params[n] for n in opt.names]
        sharded = [False] * len(ps)
        finite, norm, clip = old_stats(gs, ps, opt.freeze, sharded)
        return O.GradStats(finite=finite, norm=norm, clip_norm=clip, nonfinite=None, sums=None)

    def update(grads, state, params, clip_norm=None):
        grads = {n: torch.nan_to_num(torch.zeros_like(params[n]) if g is None else g)
                 for n, g in grads.items()}
        return O.Optimizer.plain_update(opt, grads, state, params)

    old.grad_stats, old.update = grad_stats, update
    return old


@pytest.mark.parametrize("preset", ["mask_training", "head_training"])
def test_cpu_steps_unchanged(preset):
    """Three steps (the second with a NaN gradient, so skipped) through the
    step as it is and through the per-parameter code: bit-equal logs,
    parameters, BatchNorm statistics and optimizer state."""
    hp = getattr(C, preset)(**SIZES)
    batch = make_batch(np.random.default_rng(0), SceneConfig(
        height=32, width=32, num_classes=3, max_instances=4, max_scene_instances=2,
        box_half_extent=(4, 9)), 2)
    inv_k = np.linalg.inv(np.array([[60.0, 0, 16], [0, 60.0, 16], [0, 0, 1]]))
    runs = []
    for old in (False, True):
        net = init_random_(PoseRegressorNet(hp.num_classes), 0)
        opt = task.make_optimizer(hp, net)
        state = task.create_train_state(net, opt)
        step = task.make_train_step(net, _old_optimizer(opt) if old else opt, hp,
                                    C.pipeline_config_from(hp), inv_k, "cpu")
        weight = net.segmentation_head[0].weight
        logs = []
        for i in range(3):
            hook = weight.register_hook(lambda g: g.index_fill(0, torch.tensor([0]), torch.nan)) \
                if i == 1 else None
            state, lg = step(state, batch, seed=3)
            if hook is not None:
                hook.remove()
            logs.append(lg)
        runs.append((state, logs))
    (new, new_logs), (old, old_logs) = runs
    assert (new.step, new.skipped_updates) == (old.step, old.skipped_updates) == (3, 1)
    for a, b in zip(new_logs, old_logs):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert float(new_logs[1]["grad/finite"]) == 0.0
    for (n, a), b in zip(new.net.state_dict().items(), old.net.state_dict().values()):
        assert torch.equal(a, b), n
    no, oo = new.opt_state, old.opt_state
    assert (no.count, no.lookahead_step, no.hyper_count) == (oo.count, oo.lookahead_step,
                                                              oo.hyper_count) == (2, 2, 2)
    for field in ("mu", "nu", "slow"):
        for n, a in getattr(no, field).items():
            assert torch.equal(a, getattr(oo, field)[n]), (field, n)
