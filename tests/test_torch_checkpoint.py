"""Port parity for checkpoints (`fastposecnn_tpu_torch/train/checkpoint.py`)
and the reference's torch weights (`models/weights.py`).

- npz snapshots both ways: what the port writes, the JAX package's
  `load_npz_snapshot` reads, and the reverse; exact after the float16
  cast, the stem kernel stored as (7, 7, 4, 64) with a zero alpha channel.
- A Lightning-style `.ckpt` of `models/torch_ref.py::TorchPoseRegressor`
  with seeded weights: the port's state_dict equals `from_jax_params` of
  JAX's `load_full_checkpoint` exactly; logits at the golden tolerance
  (atol 2e-4, rtol 1e-4); the arch from `hyper_parameters` (a dict or an
  `argparse.Namespace`).
- The port's full checkpoints round-trip exactly and keep the newest 5.
- The counterparts of `tests/test_ckpt_snapshot.py`: the arch travels, a
  mismatch raises, and the slow weights equal the loaded parameters only
  when the optimizer is re-derived.
- Orbax directories are refused; the head bias inits equal JAX's.
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastposecnn_tpu import config as JC
from fastposecnn_tpu.models import PoseRegressorNet as JaxNet
from fastposecnn_tpu.models.torch_ref import TorchPoseRegressor
from fastposecnn_tpu.models.weights import load_full_checkpoint
from fastposecnn_tpu.train import checkpoint as jckpt
from fastposecnn_tpu.train import optim as JO
from fastposecnn_tpu.train.task import create_train_state as jax_train_state
from fastposecnn_tpu_torch import config as C
from fastposecnn_tpu_torch.cli import evaluate as tevaluate
from fastposecnn_tpu_torch.models import PoseRegressorNet
from fastposecnn_tpu_torch.models.weights import (
    convert_reference_state_dict,
    from_jax_params,
    init_random_,
    load_state_dict_file,
)
from fastposecnn_tpu_torch.train import checkpoint as ckpt
from fastposecnn_tpu_torch.train import task as T
from torch_cleanup import tmp_path  # noqa: F401  (removed after each test)

ATOL, RTOL = 2e-4, 1e-4
CLASSES = ("bg", "bottle", "bowl")



@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small tensors: one intra-op thread each (the suite runs in several
    worker processes at once, and spinning thread pools oversubscribe the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def port_hp(**kw):
    return C.head_training(SELECTED_CLASSES=CLASSES, IMAGE_HEIGHT=64, IMAGE_WIDTH=64, **kw)


def port_state(hp, seed=0):
    net = init_random_(PoseRegressorNet(hp.num_classes), seed)
    with torch.no_grad():  # non-trivial BatchNorm statistics
        g = torch.Generator().manual_seed(seed + 100)
        for name, buf in net.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.randn(buf.shape, generator=g))
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
    opt = T.make_optimizer(hp, net)
    return T.create_train_state(net, opt), opt


@pytest.fixture(scope="module")
def jax_side():
    hp = dataclasses.replace(JC.head_training(), SELECTED_CLASSES=CLASSES,
                             IMAGE_HEIGHT=64, IMAGE_WIDTH=64)
    net = JaxNet(num_classes=hp.num_classes)
    opt = JO.make_optimizer(hp)
    return hp, net, opt, jax_train_state(net, opt, jax.random.key(3), hp)


def f16(tree):
    return jax.tree.map(lambda a: np.asarray(a).astype(np.float16).astype(np.float32), tree)


def assert_sd_equal(got, want, skip_batches_tracked=True):
    assert sorted(got) == sorted(want)
    for k in want:
        if skip_batches_tracked and k.endswith("num_batches_tracked"):
            continue
        assert torch.equal(got[k], want[k]), k


# -- npz snapshots, both ways --------------------------------------------------


def test_port_snapshot_reads_in_jax(tmp_path, jax_side):
    jhp, _, _, jstate = jax_side
    hp = port_hp()
    state, _ = port_state(hp)
    path = tmp_path / "port.npz"
    ckpt.save_npz_snapshot(path, state, hp)
    with np.load(path) as z:
        stem = z["params/encoder/conv1/kernel"]
        assert stem.shape == (7, 7, 4, 64) and stem.dtype == np.float16
        assert not stem[:, :, 3].any()
        keys = set(z.files)
    jax_path = tmp_path / "jax.npz"
    jckpt.save_npz_snapshot(jax_path, jstate, jhp)
    with np.load(jax_path) as z:
        assert keys == set(z.files)

    restored, hp2 = jckpt.load_npz_snapshot(path, jstate, jhp)
    assert hp2.SELECTED_CLASSES == CLASSES
    got = from_jax_params({"params": jax.device_get(restored.params),
                           "batch_stats": jax.device_get(restored.batch_stats)})
    want = {k: v.half().float() for k, v in state.net.state_dict().items()}
    assert_sd_equal(got, want)


def test_jax_snapshot_reads_in_port(tmp_path, jax_side):
    jhp, _, _, jstate = jax_side
    path = tmp_path / "jax.npz"
    jckpt.save_npz_snapshot(path, jstate, jhp)
    state, _ = port_state(port_hp(), seed=5)
    restored, hp2 = ckpt.load_npz_snapshot(path, state, C.evaluating())
    assert hp2.SELECTED_CLASSES == CLASSES
    want = from_jax_params({"params": f16(jstate.params), "batch_stats": f16(jstate.batch_stats)})
    assert_sd_equal(restored.net.state_dict(), want, skip_batches_tracked=False)


# -- reference torch checkpoints ------------------------------------------------


def reference_ckpt(path, hyper_parameters, seed=1):
    torch.manual_seed(seed)
    tmodel = TorchPoseRegressor(classes=len(CLASSES)).eval()
    with torch.no_grad():
        for name, buf in tmodel.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0.0, 0.1)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 1.5)
    torch.save({"state_dict": {f"model.{k}": v for k, v in tmodel.state_dict().items()},
                "hyper_parameters": hyper_parameters}, path)
    return tmodel


ARCH = dict(MODEL="PoseRegressor", BACKBONE_ARCH="FPN", ENCODER="resnet18",
            ENCODER_WEIGHTS="imagenet", SELECTED_CLASSES=list(CLASSES))


@pytest.mark.parametrize("hyper", ["dict", "namespace"])
def test_reference_ckpt_matches_jax_conversion(tmp_path, jax_side, hyper):
    _, jnet, _, jstate = jax_side
    path = tmp_path / "epoch=9.ckpt"
    hp_in = ARCH if hyper == "dict" else argparse.Namespace(**ARCH)
    tmodel = reference_ckpt(path, hp_in)
    assert ckpt.is_torch_checkpoint(path)
    hp = ckpt.merge_arch_from_any(path, C.inference())
    assert hp.SELECTED_CLASSES == CLASSES

    net = PoseRegressorNet(hp.num_classes)
    hp = ckpt.load_weights(net, path, hp)
    jvars = load_full_checkpoint(
        {"params": jstate.params, "batch_stats": jstate.batch_stats},
        {k: v.numpy() for k, v in load_state_dict_file(path).items()})
    assert_sd_equal(net.state_dict(), from_jax_params(jvars))

    x = np.random.default_rng(0).normal(size=(1, 3, 64, 64)).astype(np.float32)
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x))
        ref = tmodel(torch.from_numpy(x))
    jout = jnet.apply(jvars, jnp.asarray(x.transpose(0, 2, 3, 1)), train=False)
    for key in ("mask", "quaternion", "xy", "z", "scales"):
        np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(), atol=ATOL, rtol=RTOL,
                                   err_msg=key)
        np.testing.assert_allclose(got[key].numpy(),
                                   np.asarray(jout[key]).transpose(0, 3, 1, 2),
                                   atol=ATOL, rtol=RTOL, err_msg=key)


def test_reference_ckpt_missing_extra_and_shape_raise(tmp_path):
    torch.manual_seed(0)
    sd = TorchPoseRegressor(classes=len(CLASSES)).state_dict()
    net = PoseRegressorNet(len(CLASSES))
    convert_reference_state_dict(sd, net)
    with pytest.raises(KeyError, match="missing"):
        convert_reference_state_dict({k: v for k, v in sd.items() if "layer4" not in k}, net)
    with pytest.raises(KeyError, match="extra"):
        convert_reference_state_dict({**sd, "encoder.fc.weight": torch.zeros(3)}, net)
    with pytest.raises(ValueError, match="shape"):
        convert_reference_state_dict(sd, PoseRegressorNet(4))


def test_evaluate_cli_network_loads_reference_ckpt(tmp_path):
    path = tmp_path / "ref.pth"
    tmodel = reference_ckpt(path, ARCH)
    hp = dataclasses.replace(C.evaluating(), CHECKPOINT=str(path))
    net, hp = tevaluate.build_network(hp, "cpu")
    assert hp.SELECTED_CLASSES == CLASSES
    assert_sd_equal(net.state_dict(), tmodel.state_dict(), skip_batches_tracked=False)


# -- the port's full checkpoints ------------------------------------------------


def test_full_checkpoint_round_trip(tmp_path):
    hp = port_hp()
    state, opt = port_state(hp)
    g = torch.Generator().manual_seed(4)
    rand = {n: torch.randn(p.shape, generator=g) for n, p in state.net.named_parameters()}
    o = dataclasses.replace(state.opt_state, mu=rand,
                            nu={n: v.abs() for n, v in rand.items()}, count=7,
                            slow={n: v * 2 for n, v in rand.items()}, lookahead_step=7,
                            lr_scale=0.25, hyper_count=7)
    state = T.TrainState(state.net, o, step=7, skipped_updates=1)
    d = tmp_path / "checkpoints" / "last"
    for step in range(1, 8):
        ckpt.save_checkpoint(d, step, state, hp)
    assert sorted(p.name for p in d.iterdir()) == [f"step_{s:08d}.pt" for s in range(3, 8)]
    assert ckpt.latest_step(d) == 7 and ckpt.latest_step(tmp_path / "none") is None
    assert ckpt.merge_arch_from_any(d, C.evaluating()).SELECTED_CLASSES == CLASSES

    fresh, fresh_opt = port_state(port_hp(), seed=9)
    restored, hp2 = ckpt.load_any_checkpoint(d, fresh, C.evaluating(), optimizer=fresh_opt)
    assert hp2.SELECTED_CLASSES == CLASSES
    assert (restored.step, restored.skipped_updates) == (7, 1)
    assert_sd_equal(restored.net.state_dict(), state.net.state_dict(), skip_batches_tracked=False)
    ro = restored.opt_state
    assert (ro.count, ro.lookahead_step, ro.lr_scale, ro.hyper_count) == (7, 7, 0.25, 7)
    for field in ("mu", "nu", "slow"):
        assert_sd_equal(getattr(ro, field), getattr(o, field), skip_batches_tracked=False)
    older, _ = ckpt.load_checkpoint(d, port_state(port_hp())[0], hp, step=5)
    assert older.step == 7  # the payload's step: every file here holds step 7's state


# -- counterparts of tests/test_ckpt_snapshot.py ---------------------------------


def test_snapshot_round_trip_params_and_batch_stats(tmp_path):
    hp = port_hp()
    state, _ = port_state(hp)
    path = tmp_path / "snap.npz"
    ckpt.save_npz_snapshot(path, state, hp)
    fresh, _ = port_state(hp, seed=9)
    restored, _ = ckpt.load_npz_snapshot(path, fresh, hp)
    for k, v in state.net.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        got = restored.net.state_dict()[k]
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, v, rtol=2e-3, atol=2e-4)
        assert torch.equal(got, v.half().float()), k


def test_snapshot_arch_travels_and_dispatch(tmp_path):
    hp = port_hp()
    state, _ = port_state(hp)
    path = tmp_path / "snap.npz"
    ckpt.save_npz_snapshot(path, state, hp)
    merged = ckpt.merge_arch_from_any(path, dataclasses.replace(C.evaluating(),
                                                                ENCODER="resnet34"))
    assert merged.ENCODER == hp.ENCODER and merged.SELECTED_CLASSES == CLASSES
    fresh, _ = port_state(hp, seed=9)
    restored, _ = ckpt.load_any_checkpoint(path, fresh, hp)
    w = "encoder.conv1.weight"
    assert torch.equal(restored.net.state_dict()[w], state.net.state_dict()[w].half().float())


def test_snapshot_arch_mismatch_raises(tmp_path):
    hp = port_hp()
    state, _ = port_state(hp)
    path = tmp_path / "snap.npz"
    ckpt.save_npz_snapshot(path, state, hp)
    hp4 = dataclasses.replace(hp, SELECTED_CLASSES=("bg", "bottle", "bowl", "camera"))
    fresh4, _ = port_state(hp4)
    with pytest.raises((KeyError, ValueError)):
        ckpt.load_npz_snapshot(path, fresh4, hp4)


def _shifted_snapshot(tmp_path, kind):
    """A snapshot (npz or reference torch file) whose params differ from
    any fresh init by +1."""
    hp = port_hp()
    state, _ = port_state(hp)
    with torch.no_grad():
        for p in state.net.parameters():
            p.add_(1.0)
    if kind == "npz":
        path = tmp_path / "snap.npz"
        ckpt.save_npz_snapshot(path, state, hp)
    else:
        path = tmp_path / "snap.ckpt"
        torch.save({"state_dict": {f"model.{k}": v for k, v in state.net.state_dict().items()},
                    "hyper_parameters": ARCH}, path)
    return path, hp


@pytest.mark.parametrize("kind", ["npz", "torch"])
def test_lookahead_slow_weights_match_loaded_params(tmp_path, kind):
    path, hp = _shifted_snapshot(tmp_path, kind)
    fresh, opt = port_state(hp, seed=9)
    restored, _ = ckpt.load_any_checkpoint(path, fresh, hp, optimizer=opt)
    o = restored.opt_state
    assert (o.count, o.lookahead_step, o.lr_scale) == (0, 0, 1.0)
    for n, p in restored.net.named_parameters():
        assert torch.equal(o.slow[n], p), n
        assert not o.mu[n].any() and not o.nu[n].any()


@pytest.mark.parametrize("kind", ["npz", "torch"])
def test_without_optimizer_slow_weights_stay_stale(tmp_path, kind):
    """Why the optimizer argument matters: the template's slow weights."""
    path, hp = _shifted_snapshot(tmp_path, kind)
    fresh, _ = port_state(hp, seed=9)
    restored, _ = ckpt.load_any_checkpoint(path, fresh, hp)
    assert any(not torch.allclose(restored.opt_state.slow[n], p, atol=1e-3)
               for n, p in restored.net.named_parameters())


# -- refusals and the head bias inits -------------------------------------------


def test_orbax_directory_refused(tmp_path, jax_side):
    jhp, _, _, jstate = jax_side
    jckpt.save_checkpoint(tmp_path / "orbax", 3, jstate, jhp)
    state, opt = port_state(port_hp())
    with pytest.raises(NotImplementedError, match="Orbax checkpoint directories are JAX-only"):
        ckpt.load_any_checkpoint(tmp_path / "orbax", state, port_hp(), optimizer=opt)
    with pytest.raises(NotImplementedError, match="save_npz_snapshot"):
        ckpt.merge_arch_from_any(tmp_path / "orbax", port_hp())


@pytest.mark.parametrize("z_bias,scales_bias", [(0.0, 0.0), (7.0, 0.3), (6.5, 0.0)])
def test_head_bias_inits_match_jax(z_bias, scales_bias):
    jnet = JaxNet(num_classes=3, z_bias_init=z_bias, scales_bias_init=scales_bias)
    params = jnet.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False)["params"]
    net = init_random_(PoseRegressorNet(3, z_bias_init=z_bias, scales_bias_init=scales_bias), 0)
    for torch_head, jax_head in (("translation_head", "translation_head"),
                                 ("scales_head", "scales_head"),
                                 ("rotation_head", "rotation_head"),
                                 ("segmentation_head", "mask_head")):
        np.testing.assert_array_equal(getattr(net, torch_head)[0].bias.detach().numpy(),
                                      np.asarray(params[jax_head]["conv"]["bias"]))
