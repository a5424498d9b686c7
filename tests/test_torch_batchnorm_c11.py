"""One train-mode BatchNorm formula in the port (ROADMAP.md C11): one
process normalizes and updates its running statistics with the code path
that a process group runs, flax's fast variance E[x^2] - E[x]^2 clamped
at 0, with the all-reduce skipped. Held: one process against a one-rank
gloo group, bit for bit (output, gradients, running statistics), and both
against flax's `nn.BatchNorm` at the golden tolerance (atol 2e-4, rtol
1e-4)."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dp_ranks as R
from fastposecnn_tpu_torch.parallel import mesh

ATOL, RTOL = 2e-4, 1e-4


@pytest.fixture(autouse=True)
def _no_group():
    assert not mesh.active()


def flax_batch_norm(x_nchw, weight, bias, cotangent_nchw):
    """flax's train-mode BatchNorm (momentum 0.9, eps 1e-5) from zero mean
    and unit variance statistics, in the port's layout: (output, input
    gradient, weight and bias gradients, running mean and variance)."""
    x = jnp.asarray(x_nchw.transpose(0, 2, 3, 1))
    ct = jnp.asarray(cotangent_nchw.transpose(0, 2, 3, 1))
    c = x.shape[-1]
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    stats = {"mean": jnp.zeros(c), "var": jnp.ones(c)}

    def f(params, x):
        y, mut = bn.apply({"params": params, "batch_stats": stats}, x, mutable=["batch_stats"])
        return jnp.sum(y * ct), (y, mut["batch_stats"])

    params = {"scale": jnp.asarray(weight), "bias": jnp.asarray(bias)}
    (_, (y, new)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(params, x)
    nchw = (0, 3, 1, 2)
    return dict(y=np.asarray(y).transpose(nchw), dx=np.asarray(gx).transpose(nchw),
                dw=np.asarray(gp["scale"]), db=np.asarray(gp["bias"]),
                running_mean=np.asarray(new["mean"]), running_var=np.asarray(new["var"]))


@pytest.mark.parametrize("offset", [1.5, 6.0])
def test_one_process_uses_the_group_formula(offset):
    rng = np.random.default_rng(int(offset))
    x = rng.normal(offset, 2.0, size=(4, 8, 5, 6)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    b = rng.normal(size=8).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    one = R.batch_norm(x, w, b, cot)  # this process: no group
    (group,) = mesh.launch(R.batch_norm, 1, (x, w, b, cot), backend="gloo", threads=1,
                           deadline_s=120.0)
    want = flax_batch_norm(x, w, b, cot)
    for key in ("y", "dx", "dw", "db", "running_mean", "running_var"):
        np.testing.assert_array_equal(one[key], group[key], err_msg=key)
        np.testing.assert_allclose(one[key], want[key], atol=ATOL, rtol=RTOL, err_msg=key)
