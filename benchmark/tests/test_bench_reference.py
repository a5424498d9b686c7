"""The plain reference against the port, on the CPU at 64x96 (frame) and
64x64 (steps) with 3 classes: the port computes in float32 there and runs
its kernels' plain versions, so the two agree to float32 rounding."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from conftest import BENCH, SMALL, small, small_run


def test_frame_matches_port():
    from fastposecnn_tpu_torch.ops.voting import VoteDraws as PortDraws
    from fastposecnn_tpu_torch.serve import InferenceServer
    from reference import stages
    from reference.constants import scaled_intrinsics
    from reference.nets import from_config
    from reference.step import serve_frame
    from weights import make_weights

    cfg = dict(json.loads((BENCH / "configs" / "fastposecnn-r18.json").read_text()),
               **small("r18-serve")["config"])
    tr = SMALL["serve"]["traffic"]
    h, w, n, p = cfg["image_height"], cfg["image_width"], tr["max_instances"], tr["max_points"]
    sd = make_weights(cfg, 7, "cpu")
    gen = torch.Generator().manual_seed(3)
    image = torch.randn((1, 3, h, w), generator=gen)
    ux, uy = torch.rand((1, n, p), generator=gen), torch.rand((1, n, p), generator=gen)
    shifts = (5, 17)
    server = InferenceServer(weights=sd, device="cpu", SELECTED_CLASSES=("bg", "bottle", "bowl"),
                             IMAGE_HEIGHT=h, IMAGE_WIDTH=w, MAX_INSTANCES=n, MAX_VOTE_POINTS=p,
                             HV_NUM_OF_HYPOTHESES=tr["hypotheses"])
    mask, class_ids, xy, z, RT = server(image, draws=PortDraws(ux=ux, uy=uy, shifts=shifts))
    ref = from_config(cfg)
    ref.load_state_dict(sd)
    inv_k = torch.tensor(np.linalg.inv(scaled_intrinsics("CAMERA", h, w)), dtype=torch.float32)
    cfg_s = {"aggregation": True, "voting": True, "rt": True, "max_instances": n,
             "max_points": p, "hypotheses": tr["hypotheses"], "adaptive": False}
    out = serve_frame(ref, image, cfg_s, inv_k, stages.VoteDraws(ux=ux, uy=uy, shifts=shifts))
    agg = out["aggregated"]
    assert torch.equal(mask, out["categorical"]["mask"])
    assert torch.equal(class_ids, agg["class_ids"])
    torch.testing.assert_close(xy, agg["xy"], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(z, agg["z"], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(RT, agg["RT"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("workload", ["r18-serve", "r18-train-head", "r50-train-mask"])
def test_cell_matches_reference(workload):
    """The harness's whole check, the port against the reference: every
    number far inside its limit, the exact ones 0."""
    result = small_run(workload)
    assert result["correct"], result["checks"]
    for name, c in result["checks"].items():
        assert c["value"] <= (1e-3 * c["limit"] if c["limit"] else 0.0), (name, c)


@pytest.mark.cuda
def test_cell_on_the_card(cuda_device):
    """The serve cell at the small size on the card: the kernels against
    the reference's plain versions."""
    result = small_run("r18-serve", 9, cuda_device)
    assert result["correct"], result["checks"]
