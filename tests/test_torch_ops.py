"""Port parity: class compression, connected components, instance
extraction and aggregation in `fastposecnn_tpu_torch` (CPU, plain versions)
against the JAX package on the same seeded numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

from fastposecnn_tpu.ops.aggregation import aggregate_instances as jax_aggregate
from fastposecnn_tpu.ops.class_compress import class_compress as jax_compress
from fastposecnn_tpu.ops.connected_components import (
    extract_instances as jax_extract,
    label_components as jax_label,
    label_components_pallas,
)
from fastposecnn_tpu_torch.ops.aggregation import aggregate_instances
from fastposecnn_tpu_torch.ops.class_compress import class_compress
from fastposecnn_tpu_torch.ops.connected_components import (
    extract_instances,
    label_components,
    label_components_cuda,
    label_components_reference,
)

# The repo's golden tolerance (tests/test_weights.py:137).
ATOL, RTOL = 2e-4, 1e-4


def random_logits(rng, b=2, h=16, w=24, c=4, ties=False):
    """NHWC float32 logits in the JAX package's flat class-major layout."""
    logits = {
        "mask": rng.normal(size=(b, h, w, c)).astype(np.float32),
        "quaternion": rng.normal(size=(b, h, w, 4 * (c - 1))).astype(np.float32),
        "xy": rng.normal(size=(b, h, w, 2 * (c - 1))).astype(np.float32),
        "z": rng.normal(size=(b, h, w, c - 1)).astype(np.float32),
        "scales": rng.normal(size=(b, h, w, 3 * (c - 1))).astype(np.float32),
    }
    if ties:
        # Whole-number logits: many pixels with equal maxima across classes.
        logits["mask"] = rng.integers(0, 3, size=(b, h, w, c)).astype(np.float32)
    return logits


def to_torch_nchw(logits):
    return {k: torch.from_numpy(np.ascontiguousarray(v.transpose(0, 3, 1, 2)))
            for k, v in logits.items()}


@pytest.mark.parametrize("ties", [False, True])
def test_class_compress_matches_jax(ties):
    rng = np.random.default_rng(1)
    logits = random_logits(rng, ties=ties)
    want = jax_compress({k: jnp.asarray(v, jnp.float32) for k, v in logits.items()})
    got = class_compress(to_torch_nchw(logits))
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    for key in ("quaternion", "xy", "z", "scales"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=ATOL, rtol=RTOL, err_msg=key)


def _snake(h=16, w=16):
    fg = np.zeros((1, h, w), bool)
    fg[0, ::2, :] = True
    for i in range(0, h, 4):
        fg[0, i + 1, -1] = True
    for i in range(2, h, 4):
        fg[0, i + 1, 0] = True
    return fg


def _cc_masks():
    """The masks of the JAX package's Pallas CC tests (tests/test_ops.py)."""
    rng = np.random.default_rng(0)
    blob = np.zeros((1, 48, 128), bool)
    blob[0, 4:44, 8:120] = True
    return {
        "random": rng.random((2, 32, 64)) > 0.55,
        "blob": blob,
        "snake": _snake(),
        "empty": np.zeros((1, 8, 8), bool),
        "full": np.ones((1, 8, 8), bool),
    }


@pytest.mark.parametrize("name", sorted(_cc_masks()))
def test_cc_reference_matches_jax(name):
    fg = _cc_masks()[name]
    got = label_components_reference(torch.from_numpy(fg)).numpy()
    scan = np.asarray(jax_label(jnp.asarray(fg), use_pallas=False))
    pallas = np.asarray(label_components_pallas(jnp.asarray(fg), interpret=True))
    np.testing.assert_array_equal(got, scan)
    np.testing.assert_array_equal(got, pallas)
    # Same partition as scipy, and every label is its component's first pixel.
    for b in range(fg.shape[0]):
        ref, n = scipy.ndimage.label(fg[b])
        assert len(np.unique(got[b][fg[b]])) == n
        flat = got[b].reshape(-1)
        idx = np.flatnonzero(flat >= 0)
        for lab in np.unique(flat[idx]):
            assert idx[flat[idx] == lab].min() == lab


def test_cc_dispatch_uses_reference_on_cpu():
    fg = torch.from_numpy(_cc_masks()["random"])
    np.testing.assert_array_equal(label_components(fg).numpy(),
                                  label_components_reference(fg).numpy())
    np.testing.assert_array_equal(label_components(fg, impl="reference").numpy(),
                                  label_components_reference(fg).numpy())
    with pytest.raises(ValueError):
        label_components(fg, impl="pallas")
    with pytest.raises(ValueError):  # the kernel's wrapper never takes a CPU tensor
        label_components_cuda(fg)


def _many_components(h=128, w=128):
    """More than 16 components: 30 equal 4x4 squares (tied areas) plus a few
    larger blobs, so the strided area ranking decides which are kept."""
    fg = np.zeros((1, h, w), bool)
    for r in range(6):
        for c in range(5):
            y, x = 4 + 12 * r, 4 + 12 * c
            fg[0, y:y + 4, x:x + 4] = True
    fg[0, 80:100, 10:40] = True
    fg[0, 80:90, 60:70] = True
    fg[0, 100:120, 90:125] = True
    fg[0, 5:9, 100:104] = True
    return fg


@pytest.mark.parametrize("max_instances", [16, 64])
def test_extract_instances_matches_jax(max_instances):
    fg = _many_components()
    labels = label_components_reference(torch.from_numpy(fg))
    masks, valid, roots = extract_instances(labels, max_instances)
    jm, jv, jr = jax_extract(jnp.asarray(labels.numpy()), max_instances,
                             return_roots=True)
    np.testing.assert_array_equal(roots.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(masks.numpy(), np.asarray(jm))
    if max_instances == 16:
        assert valid.all()  # more components than slots


def _categorical(rng, b=2, h=32, w=48, c=4):
    """Class-compressed data with blocky masks (several instances per image,
    some touching components of different classes)."""
    logits = random_logits(rng, b, h, w, c)
    coarse = rng.integers(0, c, size=(b, h // 8, w // 8))
    cls = np.kron(coarse, np.ones((8, 8), int))
    logits["mask"] = np.where(np.arange(c) == cls[..., None], 5.0, 0.0).astype(np.float32)
    logits["z"] = (logits["z"] + 6.0).astype(np.float32)
    return logits


def test_aggregate_instances_matches_jax():
    rng = np.random.default_rng(3)
    logits = _categorical(rng)
    cat_j = jax_compress({k: jnp.asarray(v, jnp.float32) for k, v in logits.items()})
    want = jax_aggregate(cat_j, max_instances=8, use_pallas=False)
    got = aggregate_instances(class_compress(to_torch_nchw(logits)), 8)
    for key in ("valid", "class_ids", "cc_labels", "cc_roots", "cat_mask"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    assert got["valid"].any()
    for key in ("instance_masks", "quaternion", "scales", "z", "xy_dense"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=ATOL, rtol=RTOL, err_msg=key)
