"""The port's dataset preparation (`data/meta_plus.py`,
`cli/create_meta.py`) against the JAX package's, on the same inputs:
counterparts of the eight tests of `tests/test_meta_plus.py`, and the CLI.

Both packages run on one raw NOCS tree written by the test with PIL (the
JAX package reads it with PIL, the port with its own `data/png.py`). The
meta+ JSON must be exactly equal in its integer fields (the instance ids
and classes) and within the golden tolerance (atol 2e-4, rtol 1e-4) in
its float fields; the port's `NOCSDataset` reads the result.
"""

import json

import numpy as np
import pytest
import scipy.spatial.transform as sst
from PIL import Image
from test_meta_plus import render_instance
from torch_cleanup import tmp_path  # noqa: F401

from fastposecnn_tpu import constants as jconst
from fastposecnn_tpu.cli import create_meta as jcli
from fastposecnn_tpu.data import meta_plus as J
from fastposecnn_tpu_torch import constants
from fastposecnn_tpu_torch.cli import create_meta as tcli
from fastposecnn_tpu_torch.data import meta_plus as T
from fastposecnn_tpu_torch.data.nocs import CAMERADataset

ATOL, RTOL = 2e-4, 1e-4


def small_intrinsics():
    K = constants.INTRINSICS["CAMERA"].copy()
    K[0] *= 160 / 640
    K[1] *= 120 / 480
    return K


def write_raw_frame(d, name, K, euler, scale, meta_line, box=(200, 150, 400, 330),
                    seed=0):
    """One raw NOCS frame of one rendered instance, written with PIL as in
    `tests/test_meta_plus.py`."""
    R = sst.Rotation.from_euler("xyz", euler, degrees=True).as_matrix()
    coord, depth, mask, t = render_instance(K, R, scale, h=480, w=640, box=box)
    d.mkdir(parents=True, exist_ok=True)
    color = (np.random.default_rng(seed).random((480, 640, 3)) * 255).astype(np.uint8)
    Image.fromarray(color).save(d / f"{name}_color.png")
    Image.fromarray(np.where(mask, 1, 255).astype(np.uint8)).save(d / f"{name}_mask.png")
    Image.fromarray((coord * 255).astype(np.uint8)).save(d / f"{name}_coord.png")
    Image.fromarray(depth).save(d / f"{name}_depth.png")
    (d / f"{name}_meta.txt").write_text(meta_line)
    return R, t


def assert_meta_equal(got, want):
    assert got["instance_dict"] == want["instance_dict"]
    assert sorted(got) == sorted(want)
    for key in ("scales", "RTs", "norm_factors", "quaternions"):
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want[key]),
                                   atol=ATOL, rtol=RTOL, err_msg=key)


def test_umeyama_recovers_similarity():
    rng = np.random.default_rng(0)
    src = rng.normal(size=(200, 3))
    R = sst.Rotation.random(random_state=0).as_matrix()
    s, t = 0.37, np.array([0.2, -0.5, 1.4])
    dst = s * src @ R.T + t
    got, want = T.umeyama(src, dst), J.umeyama(src, dst)
    for g, w, truth in zip(got, want, (s, R, t)):
        np.testing.assert_allclose(g, w, atol=1e-12)
        np.testing.assert_allclose(g, truth, atol=1e-9)


def test_align_instance_recovers_known_pose():
    K = small_intrinsics()
    R = sst.Rotation.from_euler("xyz", [20, -35, 50], degrees=True).as_matrix()
    coord, depth, mask, t = render_instance(K, R, 0.6)
    assert mask.sum() > 200
    s2, RT = T.align_instance(coord, depth, mask, K)
    s_j, RT_j = J.align_instance(coord, depth, mask, K)
    np.testing.assert_allclose(s2, s_j, atol=1e-12)
    np.testing.assert_allclose(RT, RT_j, atol=1e-10)
    np.testing.assert_allclose(s2, 0.6, rtol=0.02)
    inv_RT = np.linalg.inv(RT)
    np.testing.assert_allclose(inv_RT[:3, :3] / s2, R, atol=0.02)
    np.testing.assert_allclose(inv_RT[:3, 3], t, atol=0.01)
    assert T.align_instance(coord, depth, np.zeros_like(mask), K) is None


def test_quat_consistency():
    K = small_intrinsics()
    R = sst.Rotation.from_euler("zyx", [10, 40, -25], degrees=True).as_matrix()
    coord, depth, mask, _t = render_instance(K, R, 0.6)
    _, RT = T.align_instance(coord, depth, mask, K)
    quat, T_, factor = T.rt_to_quat(RT.copy())
    quat_j, T_j, factor_j = J.rt_to_quat(RT.copy())
    np.testing.assert_allclose(quat, quat_j, atol=1e-12)
    np.testing.assert_allclose(T_, T_j, atol=1e-12)
    assert factor == factor_j
    R_rec = sst.Rotation.from_quat(quat).as_matrix()
    np.testing.assert_allclose(
        np.abs(np.diag(R_rec.T @ (RT[:3, :3] / np.cbrt(np.linalg.det(RT[:3, :3]))))),
        1.0, atol=0.05)


def test_create_meta_dataset_matches_jax_and_reader_accepts(tmp_path):
    K = constants.INTRINSICS["CAMERA"]
    raw = tmp_path / "raw"
    write_raw_frame(raw / "00000", "0000", K, [15, 25, -30], 0.8, "1 1 model_a\n")
    write_raw_frame(raw / "00000", "0001", K, [-10, 40, 5], 0.7, "1 4 model_b\n", seed=1)
    (raw / "00000" / "0002_color.png").write_bytes(b"")  # no siblings: skipped
    n = T.create_meta_plus_dataset(raw, K)
    assert n == 2
    got = {p.name: json.loads(p.read_text()) for p in sorted(raw.rglob("*_meta+.json"))}
    for p in raw.rglob("*_meta+.json"):
        p.rename(p.with_suffix(".port"))
    assert J.create_meta_plus_dataset(raw, K) == 2
    want = {p.name: json.loads(p.read_text()) for p in sorted(raw.rglob("*_meta+.json"))}
    assert sorted(got) == sorted(want) == ["0000_meta+.json", "0001_meta+.json"]
    for name in want:
        assert_meta_equal(got[name], want[name])
    assert got["0001_meta+.json"]["instance_dict"] == {"1": 4}
    assert T.create_meta_plus_dataset(raw, K) == 0  # existing files are kept
    assert T.create_meta_plus_dataset(raw, K, overwrite=True) == 2

    ds = CAMERADataset(raw, max_instances=4)
    assert len(ds) == 2
    for i in range(2):
        s = ds[i]
        assert s is not None and int(s["agg"]["valid"].sum()) == 1
        assert s["agg"]["z"][0] > 0


def test_create_meta_cli_matches_jax(tmp_path, capsys, monkeypatch):
    """Both CLIs on one raw tree (the REAL layout: the object library's
    L2-normalized scale vectors); the root from the flag and from
    NOCS_REAL_RAW; a missing root refused."""
    K = jconst.INTRINSICS["REAL"]
    raw, lib = tmp_path / "raw", tmp_path / "obj_models"
    write_raw_frame(raw / "scene_1", "0000", K, [5, -20, 30], 0.9, "1 2 bowl_white\n")
    lib.mkdir()
    np.savetxt(lib / "bowl_white.txt", np.asarray([0.2, 0.1, 0.25]))
    assert tcli.main(["--DATASET_NAME", "REAL", "--root", str(raw),
                      "--obj_models_dir", str(lib)]) == 1
    assert "wrote 1 meta+ files" in capsys.readouterr().out
    meta_fp = raw / "scene_1" / "0000_meta+.json"
    got = json.loads(meta_fp.read_text())
    meta_fp.unlink()
    jcli.main(["--DATASET_NAME", "REAL", "--root", str(raw), "--obj_models_dir", str(lib)])
    assert_meta_equal(got, json.loads(meta_fp.read_text()))
    v = np.asarray([0.2, 0.1, 0.25])
    np.testing.assert_allclose(got["scales"][0], v / np.linalg.norm(v), atol=1e-12)
    monkeypatch.setenv("NOCS_REAL_RAW", str(raw))
    assert tcli.main(["--DATASET_NAME", "REAL", "--overwrite"]) == 1
    with pytest.raises(SystemExit, match="--root"):
        tcli.main(["--root", str(tmp_path / "missing")])


def test_obj_model_scale_camera_bbox_difference(tmp_path):
    mdl = tmp_path / "03642806" / "fe2236c135bc169e7e1c85c5c15da7fb"
    mdl.mkdir(parents=True)
    bbox = np.asarray([[0.21, 0.14, 0.30], [-0.21, -0.14, -0.30]])
    np.savetxt(mdl / "bbox.txt", bbox)
    tokens = ("03642806", "fe2236c135bc169e7e1c85c5c15da7fb")
    s = T.obj_model_scale(tmp_path, tokens, "CAMERA")
    np.testing.assert_array_equal(s, J.obj_model_scale(tmp_path, tokens, "CAMERA"))
    np.testing.assert_allclose(s, bbox[0] - bbox[1], atol=1e-12)


def test_obj_model_scale_real_vector_normalized(tmp_path):
    v = np.asarray([0.2, 0.3, 0.6])
    np.savetxt(tmp_path / "mug_brown_starbucks_norm.txt", v)
    s = T.obj_model_scale(tmp_path, ("mug_brown_starbucks_norm",), "REAL")
    np.testing.assert_array_equal(
        s, J.obj_model_scale(tmp_path, ("mug_brown_starbucks_norm",), "REAL"))
    np.testing.assert_allclose(s, v / np.linalg.norm(v), atol=1e-12)


def test_obj_model_scale_missing_returns_none(tmp_path):
    assert T.obj_model_scale(tmp_path, ("nope",), "REAL") is None
    assert T.obj_model_scale(None, ("a", "b"), "CAMERA") is None
    assert T.obj_model_scale(tmp_path, (), "CAMERA") is None
    assert T.obj_model_scale(tmp_path, ("only_one",), "CAMERA") is None


def test_sample_prefers_obj_models_then_model_scales(tmp_path):
    """The library's bbox scale first, then `model_scales`, else the
    visible NOCS extent; both packages alike; `parse_meta_txt` keeps every
    token after the class."""
    K = constants.INTRINSICS["CAMERA"]
    d = tmp_path / "scene"
    write_raw_frame(d, "0000", K, [15, 25, -30], 0.8, "1 6 02880940 modelhash\n\n")
    parsed = T.parse_meta_txt(d / "0000_meta.txt")
    assert parsed == J.parse_meta_txt(d / "0000_meta.txt")
    assert parsed[1]["model_tokens"] == ("02880940", "modelhash")
    lib = tmp_path / "obj_models"
    (lib / "02880940" / "modelhash").mkdir(parents=True)
    bbox = np.asarray([[0.15, 0.1, 0.2], [-0.15, -0.1, -0.2]])
    np.savetxt(lib / "02880940" / "modelhash" / "bbox.txt", bbox)
    color = d / "0000_color.png"
    for kwargs in (dict(obj_models_dir=lib), dict(model_scales={"02880940": [1.0, 2.0, 3.0]}),
                   {}):
        got = T.create_meta_plus_for_sample(color, K, dataset_name="CAMERA", **kwargs)
        assert_meta_equal(got, J.create_meta_plus_for_sample(color, K, dataset_name="CAMERA",
                                                             **kwargs))
    got = T.create_meta_plus_for_sample(color, K, obj_models_dir=lib)
    np.testing.assert_allclose(got["scales"][0], bbox[0] - bbox[1], atol=1e-12)
    (d / "0000_depth.png").unlink()
    assert T.create_meta_plus_for_sample(color, K) is None
