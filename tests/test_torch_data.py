"""Port parity for the evaluation data path: the copied scene generator, the
in-memory synthetic source against the JAX route that writes PNG folders
and reads them back (`write_synthetic_nocs` -> `NOCSDataset`), `collate`,
the padding of a short batch and the upcast of the uint8 wire batch.

Tolerances: scenes, samples, batches and the upcast image exactly equal;
`perfect_logits(loss_targets=True)` quaternions within atol 2e-4 / rtol
1e-4 (they pass through float32 canonicalization on each side).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastposecnn_tpu.data import nocs as jnocs
from fastposecnn_tpu.data import synthetic as jsyn
from fastposecnn_tpu.data.nocs_writer import write_synthetic_nocs
from fastposecnn_tpu.train.loop import _pad_batch
from fastposecnn_tpu.train.task import upcast_batch as jax_upcast_batch
from fastposecnn_tpu_torch.data import loader as tload
from fastposecnn_tpu_torch.data import nocs as tnocs
from fastposecnn_tpu_torch.data import synthetic as tsyn


def assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert list(got) == list(want), path
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("pose_cues", [False, True])
def test_scene_generator_copy_matches_jax(pose_cues):
    for seed in (0, 5):
        kw = dict(height=64, width=96, max_instances=6, render_pose_cues=pose_cues)
        want = jsyn.generate_scene(np.random.default_rng(seed), jsyn.SceneConfig(**kw))
        got = tsyn.generate_scene(np.random.default_rng(seed), tsyn.SceneConfig(**kw))
        assert_tree_equal(got, want)
        assert want["agg"]["valid"].any()
    np.testing.assert_array_equal(
        tsyn.perfect_logits(got, 7)["xy"], jsyn.perfect_logits(want, 7)["xy"])
    lt_got = tsyn.perfect_logits(got, 7, loss_targets=True)["quaternion"]
    lt_want = jsyn.perfect_logits(want, 7, loss_targets=True)["quaternion"]
    np.testing.assert_allclose(lt_got, lt_want, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("pose_cues,classes,max_size", [
    (False, None, None),
    (True, None, 5),
    (False, ("bg", "bottle", "bowl", "camera"), None),  # unselected classes drop
])
def test_in_memory_source_matches_nocs_dataset(tmp_path, pose_cues, classes, max_size):
    n_scenes, seed = 7, 11
    cfg = dict(height=64, width=96, num_classes=7, max_instances=8,
               render_pose_cues=pose_cues, max_scene_instances=3)
    root = write_synthetic_nocs(tmp_path / "valid", n_scenes, seed, jsyn.SceneConfig(**cfg))
    want = jnocs.NOCSDataset(root, selected_classes=classes, max_size=max_size,
                             max_instances=8)
    got = tnocs.SyntheticNOCSSource(n_scenes, seed, tsyn.SceneConfig(**cfg),
                                    selected_classes=classes, max_size=max_size,
                                    max_instances=8)
    assert len(got) == len(want) > 2
    if max_size:
        assert len(got) == max_size
    for i in range(len(want)):
        s_want, s_got = want[i], got[i]
        assert s_got["path"] in s_want["path"]
        s_want.pop("path"), s_got.pop("path")
        assert_tree_equal(s_got, s_want, f"sample {i}")
    if classes:
        n_kept = sum(int(want[i]["agg"]["valid"].sum()) for i in range(len(want)))
        n_all = sum(len(r["meta"]["instance_dict"]) for r in got.records)
        assert n_kept < n_all  # some instances were of unselected classes


def test_rejected_sample_and_collate(tmp_path):
    """A sample whose stored RT puts the object behind the camera (z <= 0)
    comes out as None on both sides; `collate` drops it."""
    cfg = jsyn.SceneConfig(height=64, width=96, max_instances=4)
    root = write_synthetic_nocs(tmp_path / "valid", 3, 2, cfg)
    behind = np.eye(4)
    behind[2, 3] = 5.0  # inv(RT)[2, 3] = -5: z = -5000 mm
    meta_fp = sorted(root.rglob("*_meta+.json"))[1]
    meta = json.loads(meta_fp.read_text())
    meta["RTs"][0] = behind.tolist()
    meta_fp.write_text(json.dumps(meta))
    want = jnocs.NOCSDataset(root, max_instances=4)
    got = tnocs.SyntheticNOCSSource(3, 2, tsyn.SceneConfig(height=64, width=96,
                                                           max_instances=4),
                                    max_instances=4)
    got.records[1]["meta"]["RTs"][0] = behind
    assert want[1] is None and got[1] is None
    b_want = jnocs.collate([want[i] for i in range(3)])
    b_got = tnocs.collate([got[i] for i in range(3)])
    assert len(b_got["path"]) == len(b_want["path"]) == 2
    b_want.pop("path"), b_got.pop("path")
    assert_tree_equal(b_got, b_want)
    assert tnocs.collate([None]) is None


def test_batches_pad_and_upcast_match_jax():
    src = tnocs.SyntheticNOCSSource(5, 3, tsyn.SceneConfig(height=64, width=96,
                                                           max_instances=4),
                                    max_instances=4)
    batches = list(tload.iterate_batches(src, 2))
    assert [b["image"].shape[0] for b in batches] == [2, 2, 1]
    short = {k: v for k, v in batches[-1].items() if k != "path"}
    got, n = tload.pad_batch(short, 2)
    want, n_want = _pad_batch(short, 2)
    assert n == n_want == 1
    assert_tree_equal(got, want)
    db = tload.upcast_batch(got, "cpu")
    dj = jax_upcast_batch({k: (jnp.asarray(v) if k != "agg" else
                               {a: jnp.asarray(x) for a, x in v.items()})
                           for k, v in want.items()})
    np.testing.assert_array_equal(db["image"].numpy(),
                                  np.asarray(dj["image"]).transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(db["mask"].numpy(), np.asarray(dj["mask"]))
    np.testing.assert_array_equal(db["agg"]["instance_masks"].numpy(),
                                  np.asarray(dj["agg"]["instance_masks"]))
    assert db["image"].dtype == torch.float32 and db["mask"].dtype == torch.int32
    assert not db["agg"]["valid"][1].any() and db["sample_valid"].tolist() == [1.0, 0.0]
