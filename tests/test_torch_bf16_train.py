"""The bfloat16 train step of the port against the JAX package's, and the
rule that picks the compute dtype (`device.compute_dtype`), on the CPU
(64x64, 3 classes, batch 2, HEAD_TRAINING at `tests/test_train.py::
tiny_setup`'s sizes; `tests/torch_train_helpers.py`).

One JAX `TrainState` is carried across. JAX's HEAD_TRAINING step runs with
its network at `dtype=jnp.bfloat16`, compiled with XLA's excess precision
off (`xla_allow_excess_precision=False`), so that every value is rounded
where flax's modules put the casts; the port's step runs with
`PoseRegressorNet(dtype=torch.bfloat16)` and, as the float32 reference,
with the float32 network (the step `tests/test_torch_train_step_head.py`
holds to JAX's float32 step at the golden tolerance), on the same batch,
dropout masks and vote draws.

Two bf16 programs that differ by any float32 rounding drift apart through a
deep network to about bf16's own distance from float32
(`tests/test_torch_bf16_network.py`, where the network is held stage by
stage, forward and backward), and a gradient carries that drift of every
pixel. So the step is held where the drift leaves room: the gradients (the
first moments, 0.1 x the clipped gradients, in L2 over every tensor), the
parameter updates and the BatchNorm statistics each within 0.8 x the
float32 step's distance from JAX's bf16 step (measured: 0.55, 0.72 and
0.34), so that a step that ran in float32 (1 x by construction) fails;
every convolution of the step's forward returns bf16; the logs that
neither the CC instances of the predicted mask nor
the matching reach (the mask losses, the dense pose terms) within bf16's
unit roundoff (2^-8, relative) of JAX's bf16 step. The
matched terms (quaternion, xy, z, scales, and the total that sums them)
follow which pixels the argmax of the bf16 logits puts in each instance,
so they are printed and held finite, with the same number matched. Every
distance is printed beside the float32 step's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastposecnn_tpu import config as JC
from fastposecnn_tpu.train.task import make_train_step
from fastposecnn_tpu_torch import config as TC
from fastposecnn_tpu_torch.cli import train as tcli
from fastposecnn_tpu_torch.device import compute_dtype
from fastposecnn_tpu_torch.models import PoseRegressorNet, network_from_hparams
from fastposecnn_tpu_torch.models.conv import Conv2d
from fastposecnn_tpu_torch.models.weights import from_jax_train_state
from fastposecnn_tpu_torch.parallel import mesh
from fastposecnn_tpu_torch.train import checkpoint as ckpt
from fastposecnn_tpu_torch.train import task as TT
import torch_dp_ranks as R
from torch_cleanup import tmp_path  # noqa: F401  (removed after each test)
from torch_train_helpers import dropout_keep, setup, step_keys, vote_draws

BF16 = torch.bfloat16
NO_EXCESS = {"xla_allow_excess_precision": False}
SMALL = ["--IMAGE_HEIGHT", "64", "--IMAGE_WIDTH", "64", "--BATCH_SIZE", "2",
         "--SELECTED_CLASSES", "bg", "bottle", "bowl", "--MAX_INSTANCES", "4",
         "--MAX_VOTE_POINTS", "128", "--HV_NUM_OF_HYPOTHESES", "32", "--NUM_WORKERS", "2",
         "--no_tb", "--device", "cpu"]


def rel_l2(a, b):
    a = np.concatenate([np.ravel(np.asarray(x, np.float64)) for x in a])
    b = np.concatenate([np.ravel(np.asarray(x, np.float64)) for x in b])
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# The logs neither the predicted mask's instances nor the matching reach.
# (The gradients' global norm carries their drift: it is held with them.)
VOTE_FREE_LOGS = ("mask/loss_cce", "mask/loss_ce", "mask/loss_focal", "mask/task_total_loss",
                  "pose/dense_total")
BF16_UNIT_ROUNDOFF = 2.0 ** -8
# The share of the float32 step's distance from JAX's bf16 step that the
# port's bf16 step may lie from it, in gradients, updates and statistics.
STEP_SHARE = 0.8


@pytest.fixture(scope="module")
def bf16_step():
    j, t = setup(JC.head_training, jit_init=True)
    hp = j["hp"]
    rng = jax.random.key(1)
    k_drop, k_pipe = step_keys(rng, 0)
    keep = dropout_keep(j, k_drop)  # the masks do not depend on the dtype
    draws = vote_draws(k_pipe, 2, hp.MAX_INSTANCES, hp.MAX_VOTE_POINTS, hp.HV_NUM_OF_HYPOTHESES)
    args = (j["state"], j["batch"], rng)
    step16 = jax.jit(make_train_step(j["net"].clone(dtype=jnp.bfloat16), j["opt"], hp,
                                     j["pcfg"], j["inv_k"]))
    jstate, jlogs = step16.lower(*args).compile(compiler_options=NO_EXCESS)(*args)
    jax.block_until_ready(jlogs)

    thp = t["hp"]
    before = {k: v.clone() for k, v in t["state"].net.state_dict().items()}
    port, conv_outputs = {}, {}
    for name, dtype in (("bf16", BF16), ("f32", torch.float32)):
        net = PoseRegressorNet(thp.num_classes, dtype=dtype)
        sd, opt_state, step, skipped = from_jax_train_state(j["state"])
        net.load_state_dict(sd)
        opt = TT.make_optimizer(thp, net)
        seen = conv_outputs.setdefault(name, [])
        hooks = [m.register_forward_hook(lambda m, args, out: seen.append(out.dtype))
                 for m in net.modules() if isinstance(m, Conv2d)]
        port[name] = TT.make_train_step(net, opt, thp, t["pcfg"], j["inv_k"], "cpu")(
            TT.TrainState(net, opt_state, step, skipped), j["batch"], dropout_keep=keep,
            draws=draws)
        for hook in hooks:
            hook.remove()
    return dict(jstate=jstate, jlogs=jlogs, port=port, before=before, hp=thp,
                conv_outputs=conv_outputs)


def _tensors(sd, opt, before):
    names = sorted(opt.mu)
    return dict(gradients=[opt.mu[n] for n in names],
                updates=[sd[n] - before[n] for n in names],
                statistics=[sd[k] for k in sorted(sd)
                            if k.endswith(("running_mean", "running_var"))])


def test_bf16_step_matches_jax(bf16_step):
    r = bf16_step
    tstate, tlogs = r["port"]["bf16"]
    flogs = r["port"]["f32"][1]
    assert float(tlogs["grad/finite"]) == 1.0 and tstate.skipped_updates == 0
    convs = sum(isinstance(m, Conv2d) for m in tstate.net.modules())
    assert r["conv_outputs"] == {"bf16": [BF16] * convs, "f32": [torch.float32] * convs}
    for p in tstate.net.parameters():
        assert p.dtype == torch.float32 and (p.grad is None or p.grad.dtype == torch.float32)
    o = tstate.opt_state
    assert all(v.dtype == torch.float32 for part in (o.mu, o.nu, o.slow) for v in part.values())

    sd, opt, _, _ = from_jax_train_state(r["jstate"])
    want = _tensors(sd, opt, r["before"])
    got = {name: _tensors(st.net.state_dict(), st.opt_state, r["before"])
           for name, (st, _) in r["port"].items()}
    for part in want:
        d_port = rel_l2(got["bf16"][part], want[part])
        d_f32 = rel_l2(got["f32"][part], want[part])
        print(f"{part}: port bf16-vs-jax bf16 {d_port:.3e}, f32-vs-jax bf16 {d_f32:.3e} "
              f"({d_port / d_f32:.3f})")
        assert d_port <= STEP_SHARE * d_f32, (part, d_port, d_f32)

    jlogs = {k: float(v) for k, v in r["jlogs"].items()}
    for name, w in sorted(jlogs.items()):
        port, f32 = float(tlogs[name]), float(flogs[name])
        rel = abs(port - w) / max(abs(w), 1e-30)
        print(f"log {name}: port bf16 {port:.7g}, jax bf16 {w:.7g} (relative {rel:.3e}), "
              f"f32 {f32:.7g}")
        assert np.isfinite(port), name
        if name in VOTE_FREE_LOGS:
            assert rel <= BF16_UNIT_ROUNDOFF, (name, rel)
    assert float(tlogs["pose/num_matched"]) == jlogs["pose/num_matched"] > 0


@pytest.mark.parametrize("setting,device,want", [
    ("bfloat16", "cuda", torch.bfloat16), ("bfloat16", "cpu", torch.float32),
    ("float32", "cuda", torch.float32), ("float32", "cpu", torch.float32)])
def test_compute_dtype_rule(setting, device, want):
    """bf16 exactly when COMPUTE_DTYPE is "bfloat16" and the device is CUDA
    (a `torch.device` only: nothing runs on it); any other string gives
    float32, as in JAX. The network of that dtype computes every
    convolution in it."""
    hp = TC.head_training(COMPUTE_DTYPE=setting)
    assert compute_dtype(hp, torch.device(device)) == want
    assert compute_dtype(hp, device) == want
    assert compute_dtype(dataclasses.replace(hp, COMPUTE_DTYPE="bf16"), device) == torch.float32
    net = network_from_hparams(hp, compute_dtype(hp, device))
    assert {m.compute_dtype for m in net.modules() if isinstance(m, Conv2d)} == {want}
    assert net.dtype == want


def test_cpu_train_cli_logs_float32(tmp_path, monkeypatch):
    """On the CPU the trainer computes float32 under the default
    COMPUTE_DTYPE ("bfloat16"), as JAX's does off its accelerator."""
    monkeypatch.setenv("LOGS", str(tmp_path / "logs"))
    assert TC.HParams().COMPUTE_DTYPE == "bfloat16"
    _, run_dir = tcli.main(["-e", "BF16", "--preset", "MASK_TRAINING", "--synthetic", "4",
                         "--epochs", "1", *SMALL])
    log = (run_dir / "run.log").read_text()
    assert "network compute dtype: float32 (COMPUTE_DTYPE=bfloat16 on cpu)" in log


def test_tp_conv_bf16_matches_one_process():
    """`TPConv2d` at tp 2 over two gloo ranks, the convolution in bf16
    (its slice, the gather and the bias in bf16), against one process's
    bf16 `Conv2d`: the output bit-equal, the weight and bias gradients
    too; the input gradient (each rank's bf16 partial sum, all-reduced in
    the input's float32) within bf16 rounding of the one-process one."""
    rng = np.random.default_rng(11)
    f = np.float32
    weight = rng.normal(size=(16, 8, 3, 3)).astype(f)
    bias = rng.normal(size=16).astype(f)
    x = rng.normal(size=(2, 8, 9, 10)).astype(f)
    cot = rng.normal(size=(2, 16, 5, 5)).astype(f)
    conv = (weight, bias, x, cot, 2, 1)
    full = Conv2d(8, 16, 3, stride=2, padding=1, compute_dtype=BF16)
    with torch.no_grad():
        full.weight.copy_(torch.from_numpy(weight))
        full.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = full(xt)
    assert y.dtype == BF16
    (y.float() * torch.from_numpy(cot)).sum().backward()
    ranks = mesh.launch(R.tp_conv_bf16, 2, (conv,), backend="gloo", threads=1,
                        deadline_s=300.0, layout=mesh.make_mesh(2, tp=2))
    for rank in ranks:
        assert rank["dtype"] == "torch.bfloat16" and rank["local"] == (8, 8, 3, 3)
        equal = np.array_equal(rank["y"], y.detach().float().numpy())
        print(f"rank {rank['coords']}: output bit-equal {equal}")
        assert equal
        np.testing.assert_array_equal(rank["dw"], full.weight.grad.numpy())
        np.testing.assert_array_equal(rank["db"], full.bias.grad.numpy())
        d = rel_l2([rank["dx"]], [xt.grad.numpy()])
        print(f"rank {rank['coords']}: input gradient relative L2 {d:.3e}")
        assert d <= 2.0 ** -8


def _save_and_resume(tmp_path, state, hp, into_dtype):
    d = tmp_path / f"to_{str(into_dtype)[6:]}"
    ckpt.save_checkpoint(d, state.step, state, hp)
    net = PoseRegressorNet(hp.num_classes, dtype=into_dtype)
    opt = TT.make_optimizer(hp, net)
    fresh = TT.create_train_state(net, opt)
    return ckpt.load_any_checkpoint(d, fresh, hp, optimizer=opt)[0]


def test_checkpoints_cross_between_bf16_and_f32(tmp_path, bf16_step):
    """The bf16 step's state written and resumed by an f32 network, and that
    f32 state written and resumed by a bf16 one: identical keys, dtypes and
    values, moments and counts included."""
    hp = bf16_step["hp"]
    bf16_state = bf16_step["port"]["bf16"][0]
    f32_state = _save_and_resume(tmp_path, bf16_state, hp, torch.float32)
    again = _save_and_resume(tmp_path, f32_state, hp, BF16)
    assert f32_state.net.dtype == torch.float32 and again.net.dtype == BF16
    for got in (f32_state, again):
        a, b = got.net.state_dict(), bf16_state.net.state_dict()
        assert list(a) == list(b)
        for k in b:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        for part in ("mu", "nu", "slow"):
            ga, gb = getattr(got.opt_state, part), getattr(bf16_state.opt_state, part)
            assert ga.keys() == gb.keys()
            assert all(ga[k].dtype == torch.float32 and torch.equal(ga[k], gb[k]) for k in gb)
        o, w = got.opt_state, bf16_state.opt_state
        assert (o.count, o.lookahead_step, o.hyper_count, got.step) == (
            w.count, w.lookahead_step, w.hyper_count, bf16_state.step)
