"""Every entry point of the port builds the network `hp.ENCODER` names and
votes with `hp.HV_IMPLEMENTATION`, on the CPU at the tests' small sizes:
the train CLI (streaming and staged) with `--ENCODER resnet34`, the
evaluate and inference CLIs with `--ENCODER resnet34 --HV_IMPLEMENTATION
soft`, `InferenceServer` with hparams overrides and with a checkpoint's
architecture fields, and a HEAD_TRAINING train step with soft voting.

The encoder built is checked by its structure (resnet34's layer3 holds 6
basic blocks) and the weights written by their keys and shapes, exactly,
against the JAX package's `PoseRegressorNet(encoder_name=...)` init.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastposecnn_tpu.models import PoseRegressorNet as JaxNet
from fastposecnn_tpu_torch import config as C
from fastposecnn_tpu_torch.cli import evaluate as tev
from fastposecnn_tpu_torch.cli import inference as tinf
from fastposecnn_tpu_torch.cli import train as tcli
from fastposecnn_tpu_torch.models import PoseRegressorNet
from fastposecnn_tpu_torch.models.resnet import BasicBlock, BottleneckBlock
from fastposecnn_tpu_torch.models.weights import init_random_, to_jax_flat
from fastposecnn_tpu_torch.ops import voting, voting_soft
from fastposecnn_tpu_torch.serve import InferenceServer
from fastposecnn_tpu_torch.train import checkpoint as tckpt
from torch_cleanup import tmp_path  # noqa: F401  (removed after each test)

CLASSES = ("bg", "bottle", "bowl")
TRAIN = ["--IMAGE_HEIGHT", "64", "--IMAGE_WIDTH", "64", "--BATCH_SIZE", "2",
         "--SELECTED_CLASSES", *CLASSES, "--MAX_INSTANCES", "4", "--MAX_VOTE_POINTS", "128",
         "--HV_NUM_OF_HYPOTHESES", "32", "--NUM_WORKERS", "1", "--no_tb", "--device", "cpu"]
EVAL = ["--synthetic", "3", "--IMAGE_HEIGHT", "64", "--IMAGE_WIDTH", "96",
        "--MAX_INSTANCES", "4", "--MAX_VOTE_POINTS", "128", "--HV_NUM_OF_HYPOTHESES", "64",
        "--BATCH_SIZE", "2"]


@pytest.fixture(autouse=True)
def one_torch_thread(tmp_path):
    """One intra-op thread (the suite runs in several worker processes);
    afterwards the test's files go (a full checkpoint is large)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    shutil.rmtree(tmp_path, ignore_errors=True)


def jax_layout(encoder, classes=3):
    """{key: shape} of the JAX package's npz layout for `encoder`."""
    v = JaxNet(num_classes=classes, encoder_name=encoder).init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3), jnp.float32))
    out = {}

    def walk(tree, prefix):
        for k, a in tree.items():
            walk(a, f"{prefix}/{k}") if isinstance(a, dict) else out.update(
                {f"{prefix}/{k}": tuple(np.shape(a))})

    walk(jax.tree.map(np.asarray, dict(v["params"])), "params")
    walk(jax.tree.map(np.asarray, dict(v["batch_stats"])), "batch_stats")
    return out


def npz_layout(path):
    with np.load(path) as z:
        return {k: z[k].shape for k in z.files if not k.startswith("__")}


def assert_resnet34(net):
    enc = net.encoder
    assert [len(getattr(enc, f"layer{i}")) for i in range(1, 5)] == [3, 4, 6, 3]
    assert all(isinstance(b, BasicBlock) for b in enc.layer3)


def test_train_cli_builds_and_saves_resnet34(tmp_path, monkeypatch):
    """`cli.train --ENCODER resnet34` trains a resnet34 (not a resnet18
    that its HPARAM.json would misname), its npz snapshot has the JAX
    layout of a resnet34, and a resume rebuilds the checkpoint's encoder
    whatever `--ENCODER` says."""
    monkeypatch.setenv("LOGS", str(tmp_path / "logs"))
    state, run_dir = tcli.main(["-e", "R34", "--preset", "MASK_TRAINING", "--synthetic", "4",
                                "--epochs", "1", "--ENCODER", "resnet34", *TRAIN])
    assert_resnet34(state.net)
    hp = C.HParams.load(run_dir / "HPARAM.json")
    assert hp.ENCODER == "resnet34" and state.step == 2
    want = jax_layout("resnet34")
    assert {k: a.shape for k, a in to_jax_flat(state.net.state_dict()).items()} == want
    snap = tmp_path / "r34.npz"
    tckpt.save_npz_snapshot(snap, state, hp)
    assert npz_layout(snap) == want
    resumed, _ = tcli.main(["-e", "R34B", "--preset", "MASK_TRAINING", "--synthetic", "4",
                            "--epochs", "1", "--ENCODER", "resnet18", "--resume",
                            str(run_dir / "checkpoints" / "last"), *TRAIN])
    assert_resnet34(resumed.net) and resumed.step == 4
    with pytest.raises(ValueError, match="unknown encoder"):
        tcli.main(["-e", "BAD", "--preset", "MASK_TRAINING", "--synthetic", "4",
                   "--epochs", "1", "--ENCODER", "resnet101", *TRAIN])


def test_staged_cli_builds_resnet50(tmp_path, monkeypatch):
    """The staged trainer builds resnet50 from `--ENCODER` and its
    `--snapshot_npz` has the JAX layout of a resnet50."""
    monkeypatch.setenv("LOGS", str(tmp_path / "logs"))
    snap = tmp_path / "r50.npz"
    state, run_dir = tcli.main(["-e", "R50", "--preset", "MASK_TRAINING", "--synthetic", "4",
                                "--TRAIN_SIZE", "4", "--VALID_SIZE", "2", "--epochs", "1",
                                "--stage_on_device", "--snapshot_npz", str(snap),
                                "--ENCODER", "resnet50", *TRAIN])
    assert "staged (device-resident) trainer" in (run_dir / "run.log").read_text()
    assert all(isinstance(b, BottleneckBlock) for b in state.net.encoder.layer3)
    assert len(state.net.encoder.layer3) == 6
    assert npz_layout(snap) == jax_layout("resnet50")


def counting(monkeypatch, module, name):
    calls = []
    original = getattr(module, name)

    def wrapper(*args, **kwargs):
        calls.append(1)
        return original(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapper)
    return calls


def test_evaluate_and_inference_clis_with_resnet34_and_soft(tmp_path, monkeypatch, capsys):
    """Both CLIs build resnet34 and vote softly: the soft vote runs, the
    RANSAC count never does; without `--device cpu` they still need CUDA."""
    import fastposecnn_tpu_torch.pipeline as P

    soft = counting(monkeypatch, P, "soft_hough_vote")
    ransac = counting(monkeypatch, voting, "vote_counts")
    built = []
    real_build = tev.build_network

    def spy(hp, device):
        net, hp = real_build(hp, device)
        built.append(net)
        return net, hp

    monkeypatch.setattr(tev, "build_network", spy)
    monkeypatch.setattr(tinf, "build_network", spy)
    flags = ["--ENCODER", "resnet34", "--HV_IMPLEMENTATION", "soft", "--PRUN_METHOD",
             "z-score"]
    summary = tev.main(EVAL + flags + ["--device", "cpu", "--output", str(tmp_path / "e")])
    assert summary["frames"] == 3 and summary["vote_rounds"] == [None, None]
    assert "3D-IoU AP@0.25=" in capsys.readouterr().out
    assert len(soft) == 2 and not ransac
    summary = tinf.main(EVAL[:6] + flags + ["--stage_timing", "--device", "cpu"])
    assert summary["frames"] == 3 and len(soft) == 2 + 3 * 2 and not ransac
    assert len(built) == 2
    for net in built:
        assert_resnet34(net)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tev.main(EVAL + flags + ["--output", str(tmp_path / "f")])
    with pytest.raises(RuntimeError, match="CUDA"):
        tinf.main(EVAL[:6] + flags)


def small_inference(monkeypatch):
    hp = C.inference(IMAGE_HEIGHT=64, IMAGE_WIDTH=96, MAX_VOTE_POINTS=128,
                     HV_NUM_OF_HYPOTHESES=256, SELECTED_CLASSES=CLASSES)
    monkeypatch.setattr(C, "inference", lambda: hp)


def test_server_takes_encoder_and_voting_from_overrides_and_checkpoint(tmp_path, monkeypatch):
    """`InferenceServer` keeps the INFERENCE preset, applies hparams
    overrides (the JAX inference CLI's `--ENCODER`, `--HV_IMPLEMENTATION`,
    `--PRUN_*`) and then a checkpoint's arch fields, which win."""
    small_inference(monkeypatch)
    image = torch.from_numpy(
        np.random.default_rng(0).normal(size=(1, 3, 64, 96)).astype(np.float32))
    soft = counting(monkeypatch, voting_soft, "soft_vote_centers")
    server = InferenceServer(device="cpu", seed=2, ENCODER="resnet50", HV_IMPLEMENTATION="soft",
                             PRUN_METHOD="none")
    assert len(server.net.encoder.layer3) == 6 and server.net.encoder.out_channels[-1] == 2048
    assert server.config.hv_implementation == "soft" and server.config.prun_method is None
    mask, class_ids, xy, z, RT = server(image)
    assert len(soft) == 1 and xy.shape == (1, 16, 2)
    assert all(bool(torch.isfinite(a).all()) for a in (xy, z, RT))
    default = InferenceServer(device="cpu")
    assert default.hp == C.inference() and len(default.net.encoder.layer3) == 2

    # A resnet34 snapshot: its ENCODER wins over the override, its weights load.
    hp = dataclasses.replace(C.inference(), ENCODER="resnet34")
    net = init_random_(PoseRegressorNet(3, encoder_name="resnet34"), 5)
    snap = tmp_path / "r34.npz"
    from fastposecnn_tpu_torch.train.task import TrainState

    tckpt.save_npz_snapshot(snap, TrainState(net, None), hp)
    loaded = InferenceServer(snap, device="cpu", ENCODER="resnet18")
    assert loaded.hp.ENCODER == "resnet34"
    assert_resnet34(loaded.net)
    want = net.state_dict()
    for k, v in loaded.net.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k].half().float()), k
    with pytest.raises(TypeError):
        InferenceServer(device="cpu", NOT_A_FIELD=1)


def test_soft_head_training_step_goes_through_the_pipeline(monkeypatch):
    """A HEAD_TRAINING step with `HV_IMPLEMENTATION="soft"` and resnet34
    votes through `run_pipeline`'s soft stage (no RANSAC count), trains
    with finite logs, and its matched losses are computed."""
    from fastposecnn_tpu_torch.data.synthetic import SceneConfig, make_batch
    from fastposecnn_tpu_torch.models import network_from_hparams
    from fastposecnn_tpu_torch.train import task as T

    hp = C.head_training(IMAGE_HEIGHT=64, IMAGE_WIDTH=64, SELECTED_CLASSES=CLASSES,
                         MAX_INSTANCES=4, MAX_VOTE_POINTS=128, HV_NUM_OF_HYPOTHESES=32,
                         BATCH_SIZE=2, HV_IMPLEMENTATION="soft", ENCODER="resnet34")
    net = init_random_(network_from_hparams(hp), 0)
    assert_resnet34(net)
    opt = T.make_optimizer(hp, net)
    inv_k = np.linalg.inv(np.asarray([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]]))
    batch = make_batch(np.random.default_rng(0),
                       SceneConfig(height=64, width=64, num_classes=3, max_instances=4,
                                   max_scene_instances=2, box_half_extent=(4, 9)), 2)
    step = T.make_train_step(net, opt, hp, C.pipeline_config_from(hp), inv_k, "cpu")
    soft = counting(monkeypatch, voting_soft, "soft_vote_centers")
    ransac = counting(monkeypatch, voting, "vote_counts")
    state, logs = step(T.create_train_state(net, opt), batch, seed=1)
    assert soft == [1] and not ransac
    assert state.step == 1 and state.skipped_updates == 0
    assert "pose/vote_rounds" not in logs and "xy/loss_xy" in logs
    assert all(bool(torch.isfinite(v).all()) for v in logs.values())
