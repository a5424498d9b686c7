"""The yardstick's arithmetic against hand counts."""

from __future__ import annotations

import pytest
import torch
import torch.nn as nn

import counts


class TwoLayers(nn.Module):
    def __init__(self):
        super().__init__()
        self.first = nn.Conv2d(3, 8, 3, padding=1)
        self.second = nn.Conv2d(8, 4, 1, stride=2)

    def forward(self, x):
        return self.second(torch.relu(self.first(x)))


def test_two_layer_net_by_hand():
    f1 = 2 * 8 * 16 * 16 * 3 * 3 * 3  # 2 Cout Hout Wout Cin kh kw
    f2 = 2 * 4 * 8 * 8 * 8 * 1 * 1
    got = counts.conv_flops(TwoLayers(), (3, 16, 16), trained=["first", "second"])
    assert got == {"forward": f1 + f2, "backward": f1 + 2 * f2, "convolutions": 2}
    frozen = counts.conv_flops(TwoLayers(), (3, 16, 16), trained=["second"])
    assert frozen["backward"] == 2 * f2


@pytest.mark.parametrize("config,gflop,convs", [("fastposecnn-r18", 100.1570304, 68),
                                                ("fastposecnn-r50", 142.1524992, 101)])
def test_published_network_at_480x640(config, gflop, convs):
    import json

    from conftest import BENCH
    from reference.nets import from_config

    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    with torch.device("meta"):
        net = from_config(cfg)
    got = counts.conv_flops(net, (3, 480, 640))
    assert got["convolutions"] == convs
    assert got["forward"] == pytest.approx(gflop * 1e9, rel=1e-9)


def test_kernel_bounds():
    assert counts.k1_bound_s(480 * 640) == pytest.approx(480 * 640 * 5 / 3.35e12)
    # K2 at 16 slots x 4096 hypotheses, one active slot of 1024 valid points:
    # bound by its operations.
    cells = 1024 * 4096
    nbytes = 4 * (16 * 4096 * 2 + 2 * 16 * 1024 * 2 + 16 * 1024 + 16 + 16 * 4096)
    assert counts.k2_bound_s(cells, nbytes) == pytest.approx(cells * 11 / 33.5e12)
    pvalid = torch.ones(16, 1024)
    active = torch.zeros(16, dtype=torch.int32)
    active[3] = 1
    assert int(counts.k2_cells(pvalid, active, 4096)) == cells
