"""The CC kernel's error flag is read once, at the end of each entry point.

On a CUDA device `aggregate_instances` makes the flag, the kernel sets it
when a device loop passes its step bound, and `run_pipeline` hands it back
unread as `aggregated["cc_error"]`; the served frame, phase A of the
evaluate CLI and the inference CLI read it after everything is enqueued
and raise if it is set. On the CPU the plain version sets no flag and the
key holds None. Here a stubbed aggregation stage hands the entry points a
set flag, as the kernel would."""

import numpy as np
import pytest
import torch

from fastposecnn_tpu_torch import config as C
from fastposecnn_tpu_torch import pipeline as P
from fastposecnn_tpu_torch.cli import evaluate as tev
from fastposecnn_tpu_torch.cli import inference as tinf
from fastposecnn_tpu_torch.ops.aggregation import aggregate_instances
from fastposecnn_tpu_torch.ops.class_compress import class_compress
from fastposecnn_tpu_torch.ops.connected_components import (
    label_components,
    label_components_reference,
    new_error_flag,
    raise_on_error_flag,
)
from fastposecnn_tpu_torch.serve import InferenceServer

SMALL = ["--synthetic", "2", "--IMAGE_HEIGHT", "64", "--IMAGE_WIDTH", "96",
         "--MAX_INSTANCES", "4", "--MAX_VOTE_POINTS", "128", "--device", "cpu"]
FLAG_MESSAGE = "cc_label: a device loop passed its step bound"


@pytest.fixture
def small_server(monkeypatch):
    hp = C.inference(IMAGE_HEIGHT=64, IMAGE_WIDTH=96, MAX_VOTE_POINTS=128,
                     HV_NUM_OF_HYPOTHESES=256,
                     SELECTED_CLASSES=("bg", "bottle", "bowl"))
    monkeypatch.setattr(C, "inference", lambda: hp)
    server = InferenceServer(device="cpu", seed=1)
    image = torch.from_numpy(
        np.random.default_rng(0).normal(size=(1, 3, 64, 96)).astype(np.float32))
    return server, image


@pytest.fixture
def flagged_stage(monkeypatch):
    """Make the aggregation stage hand back a set flag on the calls whose
    numbers (from 0) are in the returned set; it is empty to begin with."""
    flagged, calls = set(), []
    stage = P.stage_aggregate

    def stub(categorical, config):
        out = stage(categorical, config)
        if len(calls) in flagged:
            out["cc_error"] = torch.ones(1, dtype=torch.int32)
        calls.append(len(calls))
        return out

    monkeypatch.setattr(P, "stage_aggregate", stub)
    return flagged


def test_label_components_takes_no_flag_on_cpu():
    fg = torch.from_numpy(np.random.default_rng(2).random((2, 20, 40)) > 0.5)
    assert new_error_flag(fg) is None
    assert torch.equal(label_components(fg), label_components_reference(fg))
    raise_on_error_flag(None)


def test_raise_on_error_flag_reads_the_flag():
    raise_on_error_flag(torch.zeros(1, dtype=torch.int32))
    with pytest.raises(RuntimeError, match=FLAG_MESSAGE):
        raise_on_error_flag(torch.ones(1, dtype=torch.int32))


def test_aggregate_and_pipeline_carry_no_flag_on_cpu(small_server):
    server, image = small_server
    with torch.inference_mode():
        logits = server.net(image)
        agg = aggregate_instances(class_compress(logits), server.config.max_instances)
        out = P.run_pipeline(logits, server.config, server.inv_K,
                             generator=server.generator,
                             cpu_generator=server.cpu_generator)
    assert "cc_error" in agg and agg["cc_error"] is None
    assert out["aggregated"]["cc_error"] is None
    answer, cc_error = server.enqueue(image)
    assert cc_error is None and len(answer) == 5


def test_served_frame_raises_on_a_set_flag(small_server, flagged_stage):
    server, image = small_server
    server(image)
    flagged_stage.add(1)
    _, cc_error = server.enqueue(image)  # enqueueing reads nothing
    assert int(cc_error.item()) == 1
    flagged_stage.add(2)
    with pytest.raises(RuntimeError, match=FLAG_MESSAGE):
        server(image)


def test_evaluate_phase_a_raises_on_a_set_flag(flagged_stage, tmp_path):
    flagged_stage.add(0)
    with pytest.raises(RuntimeError, match=FLAG_MESSAGE):
        tev.main(SMALL + ["--HV_NUM_OF_HYPOTHESES", "64", "--BATCH_SIZE", "2",
                          "--output", str(tmp_path)])
    assert not list(tmp_path.glob("raw_errors_*.npz"))


@pytest.mark.parametrize("flagged_call", [0, 1], ids=["forward", "stage_timing"])
def test_inference_cli_raises_on_a_set_flag(flagged_stage, flagged_call):
    flagged_stage.add(flagged_call)
    with pytest.raises(RuntimeError, match=FLAG_MESSAGE):
        tinf.main(SMALL + ["--HV_NUM_OF_HYPOTHESES", "256", "--stage_timing"])
