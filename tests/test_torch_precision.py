"""The port's entry points compute in full float32, as the JAX package does:
the served frame, the evaluate CLI and the inference CLI run the network
with TF32 off for cuDNN and for CUDA matrix products (and cuDNN's
algorithms chosen by timing, which its float32 heuristics need, under a
`cudnn.deterministic` value whose algorithm cache entries the caller's own
calls did not make), and `full_float32()` gives the caller's flags back
afterwards, also after an exception.

On the CPU the flags change no arithmetic; what is checked is that the
entry points set them around the network, where on the card cuDNN reads
them."""

import itertools

import numpy as np
import pytest
import torch

from fastposecnn_tpu_torch import config as C
from fastposecnn_tpu_torch.cli import evaluate as tev
from fastposecnn_tpu_torch.cli import inference as tinf
from fastposecnn_tpu_torch.device import full_float32
from fastposecnn_tpu_torch.models import PoseRegressorNet
from fastposecnn_tpu_torch.serve import InferenceServer

SMALL = ["--synthetic", "2", "--IMAGE_HEIGHT", "64", "--IMAGE_WIDTH", "96",
         "--MAX_INSTANCES", "4", "--MAX_VOTE_POINTS", "128"]


# (cuDNN TF32, matmul TF32, cuDNN benchmark, cuDNN deterministic) as the
# network sees them in full float32, and as a caller with TF32 on leaves them.
FLOAT32 = (False, False, True, True)
CALLER = (True, True, False, False)


def _flags():
    return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic)


def _set_flags(cudnn, matmul, benchmark, deterministic):
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.benchmark = benchmark
    torch.backends.cudnn.deterministic = deterministic


@pytest.fixture
def tf32_on():
    """Both TF32 flags on and cuDNN's benchmark and deterministic flags off
    around the test (torch's defaults but for the matmul flag), and the
    process's own flags put back after it."""
    saved = _flags()
    _set_flags(*CALLER)
    yield
    _set_flags(*saved)


@pytest.fixture
def forward_flags(monkeypatch):
    """Record the four flags at every call of the network."""
    seen = []
    forward = PoseRegressorNet.forward

    def recording(self, x):
        seen.append(_flags())
        return forward(self, x)

    monkeypatch.setattr(PoseRegressorNet, "forward", recording)
    return seen


def test_served_frame_runs_the_network_in_float32(tf32_on, forward_flags, monkeypatch):
    hp = C.inference(IMAGE_HEIGHT=64, IMAGE_WIDTH=96, MAX_VOTE_POINTS=128,
                     HV_NUM_OF_HYPOTHESES=256,
                     SELECTED_CLASSES=("bg", "bottle", "bowl"))
    monkeypatch.setattr(C, "inference", lambda: hp)
    server = InferenceServer(device="cpu", seed=1)
    image = torch.from_numpy(
        np.random.default_rng(0).normal(size=(1, 3, 64, 96)).astype(np.float32))
    server(image)
    assert forward_flags == [FLOAT32]
    assert _flags() == CALLER


def test_evaluate_cli_runs_the_network_in_float32(tf32_on, forward_flags, tmp_path):
    summary = tev.main(SMALL + ["--HV_NUM_OF_HYPOTHESES", "64", "--BATCH_SIZE", "2",
                                "--device", "cpu", "--output", str(tmp_path)])
    assert summary["frames"] == 2
    assert forward_flags and set(forward_flags) == {FLOAT32}
    assert _flags() == CALLER


def test_inference_cli_runs_the_network_in_float32(tf32_on, forward_flags):
    summary = tinf.main(SMALL + ["--HV_NUM_OF_HYPOTHESES", "256", "--stage_timing",
                                 "--device", "cpu"])
    assert summary["frames"] == 2
    # One forward for the frame and one for the stage-by-stage pass, a frame.
    assert forward_flags == [FLOAT32] * 4
    assert _flags() == CALLER


@pytest.mark.parametrize("flags", list(itertools.product([False, True], repeat=4)))
def test_full_float32_restores_the_callers_flags(flags):
    # After a caller in float32 (cuDNN TF32 off) the body's deterministic
    # flag is the opposite of the caller's: PyTorch's algorithm cache keys
    # that flag and TF32, so the body never reuses an entry the caller's
    # heuristics made.
    inside = FLOAT32 if flags[0] else (False, False, True, not flags[3])
    saved = _flags()
    try:
        _set_flags(*flags)
        with full_float32():
            assert _flags() == inside
        assert _flags() == flags
        with pytest.raises(ZeroDivisionError):
            with full_float32():
                assert _flags() == inside
                1 / 0
        assert _flags() == flags
    finally:
        _set_flags(*saved)
