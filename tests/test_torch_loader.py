"""Port parity for the training data path: `PrefetchLoader`
(`fastposecnn_tpu_torch/data/loader.py`) against the JAX package's, and the
augmented in-memory synthetic samples against the JAX route that writes
NOCS folders and reads them back (`write_synthetic_nocs` -> `NOCSDataset`
with `augmentation`).

Tolerance: exact everywhere (batch order, padding-free batches, every
sample field).
"""

import threading
import time

import numpy as np
import pytest

from fastposecnn_tpu.data import loader as jloader
from fastposecnn_tpu.data import nocs as jnocs
from fastposecnn_tpu.data import synthetic as jsyn
from fastposecnn_tpu.data.nocs_writer import write_synthetic_nocs
from fastposecnn_tpu_torch.data import loader as tloader
from fastposecnn_tpu_torch.data import nocs as tnocs
from fastposecnn_tpu_torch.data import synthetic as tsyn

BACKENDS = pytest.mark.parametrize("backend", ["thread", "process"])


class FakeDataset:
    """Sample i is an image filled with i (and the epoch it was read in);
    indices in `reject` give None."""

    def __init__(self, n, reject=(), fail_at=None):
        self.n, self.reject, self.fail_at = n, set(reject), fail_at
        self.epoch = 0

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise ValueError(f"sample {i} is broken")
        if i in self.reject:
            return None
        return {"path": f"s{i}", "image": np.full((4, 4, 3), i, np.float32),
                "mask": np.full((4, 4), self.epoch, np.int32),
                "agg": {"class_ids": np.full((2,), i, np.int32),
                        "valid": np.zeros((2,), bool)}}


def batches(loader, epochs):
    out = []
    for _ in range(epochs):
        out.append([None if b is None else b for b in loader])
    return out


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for e, (ge, we) in enumerate(zip(got, want)):
        assert len(ge) == len(we), f"epoch {e}"
        for g, w in zip(ge, we):
            if w is None:
                assert g is None
                continue
            assert g["path"] == w["path"]
            np.testing.assert_array_equal(g["image"], w["image"])
            np.testing.assert_array_equal(g["mask"], w["mask"])
            for k in w["agg"]:
                np.testing.assert_array_equal(g["agg"][k], w["agg"][k])


@BACKENDS
@pytest.mark.parametrize("kw", [
    dict(n=7, batch_size=3, shuffle=False),
    dict(n=16, batch_size=4, shuffle=True, seed=1),
    dict(n=11, batch_size=3, shuffle=True, seed=5, drop_last=True),
    dict(n=6, batch_size=3, shuffle=False, reject={0, 1, 2}),  # an all-rejected batch
], ids=["in_order", "shuffled", "drop_last", "all_rejected"])
def test_batch_order_matches_jax(backend, kw):
    """Two epochs of the same dataset through both loaders: the same
    batches in the same order (the permutation from seed + epoch), the same
    short or dropped last batch, None for an all-rejected batch, and the
    dataset's epoch set before each epoch's workers read."""
    kw = dict(kw)
    n, reject = kw.pop("n"), kw.pop("reject", ())
    want = batches(jloader.PrefetchLoader(FakeDataset(n, reject), num_workers=2, **kw), 2)
    got_loader = tloader.PrefetchLoader(FakeDataset(n, reject), num_workers=2,
                                        backend=backend, **kw)
    got = batches(got_loader, 2)
    assert_batches_equal(got, want)
    assert got_loader.epoch == 2 and len(got_loader) == len(got[0])
    assert [int(b["mask"].max()) for b in got[1] if b is not None][0] == 1
    if kw.get("shuffle"):
        assert [b["path"] for b in got[0]] != [b["path"] for b in got[1]]
    if reject:
        assert got[0][0] is None


@BACKENDS
def test_worker_error_reaches_consumer(backend):
    loader = tloader.PrefetchLoader(FakeDataset(9, fail_at=4), batch_size=3, shuffle=False,
                                    num_workers=2, backend=backend)
    seen = []
    with pytest.raises(ValueError, match="sample 4 is broken"):
        for b in loader:
            seen.append(b["path"])
    assert seen == [["s0", "s1", "s2"]]
    assert loader.epoch == 0  # an epoch that failed does not count


@BACKENDS
def test_abandoned_iteration_ends(backend):
    """A consumer that stops after one batch of many: closing the iterator
    stops the producer and reaps its pool well inside a timeout."""
    before = threading.active_count()
    loader = tloader.PrefetchLoader(FakeDataset(200), batch_size=2, shuffle=False,
                                    num_workers=2, prefetch=1, backend=backend)
    it = iter(loader)
    next(it)
    t0 = time.perf_counter()
    it.close()
    assert time.perf_counter() - t0 < 10.0
    deadline = time.perf_counter() + 10.0
    while threading.active_count() > before and time.perf_counter() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
    assert loader.epoch == 0


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
@pytest.mark.parametrize("epoch", [0, 1])
@pytest.mark.parametrize("augmentation", ["train", "valid"])
def test_augmented_source_matches_nocs_dataset(tmp_path, augmentation, epoch, native):
    """The in-memory source with augmentation, at an epoch, against the JAX
    reader of the same scenes written to disk: image, mask, depth and every
    GT field bit-equal (the draws from default_rng((aug_seed, epoch, i)),
    the compose, the rint requantization)."""
    n_scenes, seed = 6, 3
    cfg = dict(height=64, width=96, num_classes=7, max_instances=6,
               render_pose_cues=True, max_scene_instances=3)
    root = write_synthetic_nocs(tmp_path / "scenes", n_scenes, seed, jsyn.SceneConfig(**cfg))
    want = jnocs.NOCSDataset(root, max_instances=6, augmentation=augmentation, aug_seed=1)
    got = tnocs.SyntheticNOCSSource(n_scenes, seed, tsyn.SceneConfig(**cfg), max_instances=6,
                                    augmentation=augmentation, aug_seed=1,
                                    native_augment=native)
    want.epoch = got.epoch = epoch
    plain = tnocs.SyntheticNOCSSource(n_scenes, seed, tsyn.SceneConfig(**cfg), max_instances=6)
    assert len(got) == len(want) > 3
    changed = 0
    for i in range(len(want)):
        s_want, s_got = want[i], got[i]
        assert s_got["path"] in s_want["path"]
        assert s_got["image"].dtype == np.uint8
        for k in ("image", "mask", "depth"):
            np.testing.assert_array_equal(s_got[k], s_want[k], err_msg=f"{i} {k}")
        for k in s_want["agg"]:
            assert s_got["agg"][k].dtype == s_want["agg"][k].dtype, k
            np.testing.assert_array_equal(s_got["agg"][k], s_want["agg"][k],
                                          err_msg=f"{i} agg/{k}")
        changed += not np.array_equal(s_got["image"], plain[i]["image"])
    assert changed > 0  # aug_seed 1 draws the validation noise at both epochs


def test_epoch_changes_the_draws():
    cfg = tsyn.SceneConfig(height=64, width=96, max_scene_instances=2)
    src = tnocs.SyntheticNOCSSource(4, 0, cfg, augmentation="train")
    a = [src[i]["image"] for i in range(4)]
    assert all(np.array_equal(x, src[i]["image"]) for i, x in enumerate(a))
    src.epoch = 1
    assert any(not np.array_equal(x, src[i]["image"]) for i, x in enumerate(a))
    with pytest.raises(ValueError):
        tnocs.SyntheticNOCSSource(1, 0, cfg, augmentation="test")
