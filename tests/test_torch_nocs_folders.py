"""Port parity for NOCS folders: the writer (`fastposecnn_tpu_torch/data/
nocs_writer.py`) and the folder dataset (`data/nocs.py::NOCSDataset`),
against the JAX package's writer and `NOCSDataset` on the same folders;
the counterparts of `tests/test_data.py:11-190`.

- The JAX writer's folder read by both datasets, and the port writer's
  folder read by the JAX dataset (its PIL path), give bit-equal samples,
  without and with augmentation at two epochs; the two writers' meta files
  are equal byte for byte.
- The in-memory `SyntheticNOCSSource` equals the folder round trip of the
  same seed, without and with augmentation.
- The scan (breadth-first, sorted, `max_size`, scenes without a selected
  class skipped), the `.complete` marker, the GT geometry, the reduced
  resolution, collate, class filtering, augmentation by epoch, warps, the
  validation noise, the mask's background and a CAMERA 3-channel mask,
  and a missing depth file.
Tolerance: exact.
"""

import pathlib

import numpy as np
import pytest
from PIL import Image

from fastposecnn_tpu.data import nocs as jnocs
from fastposecnn_tpu.data import nocs_writer as jwriter
from fastposecnn_tpu.data import synthetic as jsyn
from fastposecnn_tpu_torch.data import nocs as tnocs
from fastposecnn_tpu_torch.data import nocs_writer as twriter
from fastposecnn_tpu_torch.data import synthetic as tsyn
from fastposecnn_tpu_torch.data.augment import AugmentConfig
from fastposecnn_tpu_torch.data.loader import PrefetchLoader

CFG = dict(height=48, width=64, num_classes=7, max_instances=6, render_pose_cues=True,
           max_scene_instances=3)


def assert_samples_equal(got, want, what=""):
    if want is None:
        assert got is None, what
        return
    for k in ("image", "mask", "depth"):
        assert got[k].dtype == want[k].dtype, (what, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")
    assert sorted(got["agg"]) == sorted(want["agg"])
    for k in want["agg"]:
        assert got["agg"][k].dtype == want["agg"][k].dtype, (what, k)
        np.testing.assert_array_equal(got["agg"][k], want["agg"][k], err_msg=f"{what} agg/{k}")


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """The same 6 scenes of seed 3 written by each package's writer."""
    root = tmp_path_factory.mktemp("nocs")
    jax_dir = jwriter.write_synthetic_nocs(root / "jax", 6, 3, jsyn.SceneConfig(**CFG))
    port_dir = twriter.write_synthetic_nocs(root / "port", 6, 3, tsyn.SceneConfig(**CFG))
    return pathlib.Path(jax_dir), pathlib.Path(port_dir)


def test_writers_write_the_same_scenes(folders):
    jax_dir, port_dir = folders
    names = sorted(p.relative_to(jax_dir) for p in jax_dir.rglob("*"))
    assert names == sorted(p.relative_to(port_dir) for p in port_dir.rglob("*"))
    assert any(str(n) == ".complete" for n in names)
    for rel in names:
        a, b = jax_dir / rel, port_dir / rel
        if rel.name.endswith(".json"):
            assert a.read_text() == b.read_text(), rel
        elif rel.suffix == ".png":
            np.testing.assert_array_equal(np.asarray(Image.open(b)), np.asarray(Image.open(a)))
            assert Image.open(b).mode == Image.open(a).mode


@pytest.mark.parametrize("augmentation,epoch", [(None, 0), ("train", 0), ("train", 1),
                                                ("valid", 0), ("valid", 2)])
def test_datasets_agree_both_ways(folders, augmentation, epoch):
    """JAX folder -> port dataset, port folder -> JAX dataset (PIL decode),
    JAX folder -> JAX dataset (its native decode), and the in-memory source:
    every sample bit-equal."""
    jax_dir, port_dir = folders
    kw = dict(max_instances=6, augmentation=augmentation, aug_seed=1)
    want = jnocs.NOCSDataset(jax_dir, **kw)
    readers = {
        "port reads JAX folder": tnocs.NOCSDataset(jax_dir, **kw),
        "port reads JAX folder (numpy paths)": tnocs.NOCSDataset(jax_dir, native=False, **kw),
        "JAX (PIL) reads port folder": jnocs.NOCSDataset(port_dir, use_native=False, **kw),
        "port reads port folder": tnocs.NOCSDataset(port_dir, **kw),
        "in-memory source": tnocs.SyntheticNOCSSource(6, 3, tsyn.SceneConfig(**CFG), **kw),
    }
    want.epoch = epoch
    for r in readers.values():
        r.epoch = epoch
    assert len(want) == 6
    for name, r in readers.items():
        assert len(r) == len(want), name
        for i in range(len(want)):
            s_want = want[i]
            s_got = r[i]
            assert_samples_equal(s_got, s_want, f"{name} {i}")
            if s_want is not None and name != "in-memory source":
                assert pathlib.Path(s_got["path"]).name == pathlib.Path(s_want["path"]).name


def test_scan_order_max_size_and_class_skips(tmp_path):
    """Breadth-first with sorted children; `max_size` keeps the first found;
    a scene with no selected-class instance is skipped; the `.complete`
    marker and other files are not samples."""
    root = twriter.write_synthetic_nocs(tmp_path / "ds", 9, 5, tsyn.SceneConfig(**CFG))
    nested = root / "00000" / "deeper"
    nested.mkdir()
    twriter.write_synthetic_nocs(nested, 2, 6, tsyn.SceneConfig(**CFG))
    (root / "notes.txt").write_text("x")
    for kw in ({}, {"max_size": 5}, {"selected_classes": ("bg", "bottle")}):
        got = tnocs.NOCSDataset(root, max_instances=6, **kw)
        want = jnocs.NOCSDataset(root, max_instances=6, **kw)
        assert [str(p) for p in got.images_fps] == [str(p) for p in want.images_fps], kw
    full = tnocs.NOCSDataset(root, max_instances=6)
    assert len(full) == 11 and "deeper" in str(full.images_fps[-1])
    assert len(tnocs.NOCSDataset(root, max_instances=6, max_size=5)) == 5
    sub = tnocs.NOCSDataset(root, selected_classes=("bg", "bottle"), max_instances=6)
    assert len(sub) < len(full)
    for i in range(len(sub)):
        s = sub[i]
        n = int(s["agg"]["valid"].sum())
        assert n >= 1 and (s["agg"]["class_ids"][:n] == 1).all()


def test_repoint_rescans(tmp_path):
    a = twriter.write_synthetic_nocs(tmp_path / "a", 3, 1, tsyn.SceneConfig(**CFG))
    b = twriter.write_synthetic_nocs(tmp_path / "b", 5, 2, tsyn.SceneConfig(**CFG))
    ds = tnocs.NOCSDataset(a, max_instances=6)
    jds = jnocs.NOCSDataset(a, max_instances=6)
    ds.repoint(b)
    jds.repoint(b)
    assert ds.dataset_dir == b and len(ds) == len(jds) == 5
    for i in range(len(ds)):
        assert_samples_equal(ds[i], jds[i], f"repointed {i}")


def test_marker_geometry_and_collate(tmp_path):
    """`test_data.py` TestNOCSRoundtrip: the marker, the class mask against
    the instance masks, unit quaternions, z > 0, z and T from the stored
    RTs, collate's shapes and None handling."""
    root = twriter.write_synthetic_nocs(tmp_path, num_samples=4, seed=7,
                                        scene_cfg=tsyn.SceneConfig(height=60, width=80))
    assert (root / ".complete").exists()
    ds = tnocs.CAMERADataset(root, max_instances=8)
    assert len(ds) == 4 and ds.dataset_name == "CAMERA"
    s = ds[1]
    assert s["image"].shape == (60, 80, 3) and s["image"].dtype == np.uint8
    assert s["mask"].shape == (60, 80)
    agg = s["agg"]
    n = int(agg["valid"].sum())
    assert n >= 1
    for k in range(n):
        region = agg["instance_masks"][k] > 0
        assert (s["mask"][region] == agg["class_ids"][k]).all()
        inv = np.linalg.inv(agg["RT"][k])
        np.testing.assert_allclose(inv[2, 3] * 1000.0, agg["z"][k], rtol=1e-4)
        np.testing.assert_allclose(agg["T"][k][2] * 1000, agg["z"][k], rtol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(agg["quaternion"][:n], axis=-1), 1.0, atol=1e-5)
    assert (agg["z"][:n] > 0).all()
    batch = tnocs.collate([ds[i] for i in range(4)])
    assert batch["image"].shape == (4, 60, 80, 3)
    assert batch["agg"]["instance_masks"].shape == (4, 8, 60, 80)
    assert len(batch["path"]) == 4
    assert tnocs.collate([None, None]) is None


def test_gt_xy_in_image_frame_at_reduced_resolution(tmp_path):
    """The projected-centre GT lands on its instance at 224x320 (intrinsics
    scaled to the loaded resolution), as in the JAX test."""
    cfg = tsyn.SceneConfig(height=224, width=320, render_pose_cues=True, max_instances=8)
    root = twriter.write_synthetic_nocs(tmp_path, num_samples=2, seed=3, scene_cfg=cfg)
    ds = tnocs.CAMERADataset(root, max_instances=8)
    jds = jnocs.CAMERADataset(root, max_instances=8)
    checked = 0
    for i in range(2):
        s = ds[i]
        assert_samples_equal(s, jds[i], f"224x320 {i}")
        agg = s["agg"]
        for k in range(int(agg["valid"].sum())):
            ys, xs = np.nonzero(agg["instance_masks"][k])
            centroid = np.array([xs.mean(), ys.mean()])
            assert np.linalg.norm(agg["xy"][k] - centroid) < 25.0
            checked += 1
    assert checked >= 2


def test_augmentation_by_epoch_warps_and_validation_noise(tmp_path):
    """`test_data.py` TestAugmentationWiring on the port's folder dataset:
    train draws reproducible within an epoch and new across epochs, the
    photometric part leaves the GT alone, a forced perspective warp moves
    the class mask and the instance masks together, and validation adds
    noise only; each against the JAX dataset on the same folder."""
    root = twriter.write_synthetic_nocs(tmp_path, num_samples=2,
                                        scene_cfg=tsyn.SceneConfig(height=60, width=80))
    plain = tnocs.CAMERADataset(root, max_instances=8)
    photo = tnocs.CAMERADataset(root, max_instances=8, augmentation="train",
                                aug_cfg=AugmentConfig(perspective_p=0.0))
    e0, e0_again = photo[0]["image"], photo[0]["image"]
    photo.epoch = 1
    e1 = photo[0]["image"]
    assert not np.array_equal(e0, plain[0]["image"])
    np.testing.assert_array_equal(e0, e0_again)
    assert not np.array_equal(e0, e1)
    np.testing.assert_array_equal(photo[0]["mask"], plain[0]["mask"])

    from fastposecnn_tpu.data.augment import AugmentConfig as JAugmentConfig

    warp = tnocs.CAMERADataset(root, max_instances=8, augmentation="train",
                               aug_cfg=AugmentConfig(perspective_p=1.0))
    jwarp = jnocs.CAMERADataset(root, max_instances=8, augmentation="train",
                                aug_cfg=JAugmentConfig(perspective_p=1.0))
    a = warp[0]
    assert_samples_equal(a, jwarp[0], "warped")
    assert not np.array_equal(a["mask"], plain[0]["mask"])
    rebuilt = np.zeros_like(a["mask"])
    for k in range(int(a["agg"]["valid"].sum())):
        rebuilt[a["agg"]["instance_masks"][k] > 0] = a["agg"]["class_ids"][k]
    np.testing.assert_array_equal(rebuilt, a["mask"])

    noisy = tnocs.CAMERADataset(root, max_instances=8, augmentation="valid",
                                aug_cfg=AugmentConfig(noise_p=1.0))
    jnoisy = jnocs.CAMERADataset(root, max_instances=8, augmentation="valid",
                                 aug_cfg=JAugmentConfig(noise_p=1.0))
    delta = noisy[0]["image"].astype(np.int16) - plain[0]["image"]
    assert 0 < np.abs(delta).max() < 0.4 * 255
    np.testing.assert_array_equal(noisy[0]["mask"], plain[0]["mask"])
    assert_samples_equal(noisy[0], jnoisy[0], "valid noise")
    loader = PrefetchLoader(noisy, 2, shuffle=False, num_workers=1)
    first = [b["image"].copy() for b in loader if b is not None]
    second = [b["image"].copy() for b in loader if b is not None]
    assert noisy.epoch == 1 and not np.array_equal(first[0], second[0])


def test_mask_background_camera_rgb_mask_and_missing_depth(tmp_path):
    """A CAMERA mask stored as 3 channels keeps channel 0, 255 is
    background, and a scene without a depth file gets zeros: as the JAX
    reader does."""
    root = twriter.write_synthetic_nocs(tmp_path, num_samples=4, seed=4,
                                        scene_cfg=tsyn.SceneConfig(height=40, width=56))
    fps = tnocs.CAMERADataset(root, max_instances=8).images_fps
    assert len(fps) >= 2
    mask_fp = pathlib.Path(str(fps[0]).replace("_color.png", "_mask.png"))
    m = np.asarray(Image.open(mask_fp))
    assert (m == 255).any()
    Image.fromarray(np.stack([m, m // 2, np.zeros_like(m)], -1)).save(mask_fp)
    pathlib.Path(str(fps[1]).replace("_color.png", "_depth.png")).unlink()
    ds = tnocs.CAMERADataset(root, max_instances=8)
    jds = jnocs.CAMERADataset(root, max_instances=8)
    for i in range(len(ds)):
        assert_samples_equal(ds[i], jds[i], f"edited {i}")
    assert not ds[1]["depth"].any() and ds[0]["depth"].any()
    assert ds[0]["mask"][m == 255].max() == 0


def test_writer_cli_renders_a_bank(tmp_path):
    """`python -m fastposecnn_tpu_torch.data.nocs_writer`, the pool's
    renderer, writes the bank `write_synthetic_nocs` writes."""
    twriter._main(["--out", str(tmp_path / "cli"), "--num", "3", "--seed", "4",
                   "--height", "40", "--width", "56", "--max_instances", "4"])
    direct = twriter.write_synthetic_nocs(tmp_path / "direct", 3, 4, tsyn.SceneConfig(
        height=40, width=56, num_classes=7, max_instances=4))
    a = tnocs.NOCSDataset(tmp_path / "cli", max_instances=4)
    b = tnocs.NOCSDataset(direct, max_instances=4)
    assert len(a) == len(b) >= 1 and (tmp_path / "cli" / ".complete").exists()
    for i in range(len(a)):
        assert_samples_equal(a[i], b[i], f"cli {i}")
