"""The tensor-parallel convolution (`parallel/tp.py::TPConv2d`) on the
card: two gloo ranks laid out (dp 1, tp 2) share `cuda:0` (NCCL refuses two
ranks of one communicator on one device), each holding half of a
convolution's output channels, against the whole convolution on the card
(output, input gradient all-reduced over the tp group, gathered weight
gradient, bias gradient; atol 1e-4, rtol 1e-4 in float32 with TF32 off).
Marked `cuda`; skips without a GPU. Imports neither JAX nor the JAX
package, so it runs on a GPU machine without JAX:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tp_cuda.py
"""

import numpy as np
import pytest
import torch

import torch_dp_ranks as R
from fastposecnn_tpu_torch.device import full_float32
from fastposecnn_tpu_torch.parallel import mesh

pytestmark = pytest.mark.cuda

# (weight shape, bias, stride, padding, input shape): a layer2-like 3x3
# convolution with stride 2 and an FPN-like 1x1 lateral with a bias.
CONVS = {"3x3_stride2": ((128, 64, 3, 3), False, 2, 1, (2, 64, 60, 80)),
         "1x1_bias": ((256, 128, 1, 1), True, 1, 0, (2, 128, 30, 40))}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(CONVS))
def test_tp_conv_on_the_card_matches_the_whole_conv(cuda_device, name):
    shape, bias, stride, padding, x_shape = CONVS[name]
    rng = np.random.default_rng(len(name))
    f = np.float32
    weight = (rng.normal(size=shape) / np.sqrt(np.prod(shape[1:]))).astype(f)
    b = rng.normal(size=shape[0]).astype(f) if bias else None
    x = rng.normal(size=x_shape).astype(f)
    w = torch.from_numpy(weight).to(cuda_device).requires_grad_(True)
    bt = None if b is None else torch.from_numpy(b).to(cuda_device).requires_grad_(True)
    xt = torch.from_numpy(x).to(cuda_device).requires_grad_(True)
    with full_float32():
        y = torch.nn.functional.conv2d(xt, w, bt, stride=stride, padding=padding)
        cot = torch.from_numpy(rng.normal(size=tuple(y.shape)).astype(f)).to(cuda_device)
        (y * cot).sum().backward()
    want = dict(y=y, dx=xt.grad, dw=w.grad, db=None if bt is None else bt.grad)
    conv = (weight, b, x, cot.cpu().numpy(), stride, padding)
    ranks = mesh.launch(R.tp_conv, 2, (conv, "cuda:0"), backend="gloo", deadline_s=300.0,
                        layout=mesh.make_mesh(2, tp=2))
    for r in ranks:
        assert r["device"] == "cuda:0" and r["local"] == (shape[0] // 2, *shape[1:])
        for key, value in want.items():
            if value is None:
                assert r[key] is None
                continue
            np.testing.assert_allclose(r[key], value.detach().cpu().numpy(), atol=1e-4,
                                       rtol=1e-4, err_msg=f"{name} {key}")
