"""Port parity for the whole evaluation slice, and its command-line entry
points on the CPU.

Phase A: the JAX CLI's `collect_raw_errors` (compiled, as the CLI runs it)
and the port's, on the same 3 pose-cue scenes (224x320, trained FULL_c5
weights carried over by `from_jax_params`, 2 batches of 2 with one padded
sample), with JAX's random draws (`jax.random.key(batch)`, split as the
JAX code splits it) handed to the port. Tolerances: the same matched
instances per class (exact), rotation errors within 1e-3 degrees, 3D IoU
within 1e-4, offsets within 1e-3 cm (the network's float32 logits agree
at the golden tolerance, not bit for bit). Phase B: APs exactly equal on
the same raw errors, and the port's tables equal, byte for byte, the CSV
tables the JAX CLI wrote for the committed held-out evaluation.
"""

import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastposecnn_tpu import config as JC
from fastposecnn_tpu import constants as jconst
from fastposecnn_tpu.cli import evaluate as jev
from fastposecnn_tpu.data.nocs import NOCSDataset, collate
from fastposecnn_tpu.data.nocs_writer import write_synthetic_nocs
from fastposecnn_tpu.data.synthetic import SceneConfig
from fastposecnn_tpu.models import PoseRegressorNet as JaxNet
from fastposecnn_tpu_torch import config as C
from fastposecnn_tpu_torch.cli import evaluate as tev
from fastposecnn_tpu_torch.cli import inference as tinf
from fastposecnn_tpu_torch.data import synthetic as tsyn
from fastposecnn_tpu_torch.data.loader import iterate_batches
from fastposecnn_tpu_torch.data.nocs import SyntheticNOCSSource
from fastposecnn_tpu_torch.models.weights import load_npz_checkpoint
from fastposecnn_tpu_torch.ops.voting import VoteDraws

REPO = pathlib.Path(__file__).resolve().parents[1]
CKPT = REPO / "evidence/rot_demo/ckpt_FULL_c5.npz"
HELD_OUT = REPO / "evidence/rot_demo/eval_FULL_c5"
N, SEED, H, W, B, G, P, HYP = 3, 99, 224, 320, 2, 8, 1024, 128
TOL = {"degree_error": 1e-3, "degree_error_geodesic": 1e-3, "3d_iou": 1e-4,
       "offset_error": 1e-3}
SMALL = ["--synthetic", "3", "--IMAGE_HEIGHT", "64", "--IMAGE_WIDTH", "96",
         "--MAX_INSTANCES", "4", "--MAX_VOTE_POINTS", "128",
         "--HV_NUM_OF_HYPOTHESES", "64", "--BATCH_SIZE", "2"]


def jax_draws(bi, max_iter=20):
    """Every draw the JAX evaluator makes for batch `bi`."""
    k_sample, k_vote = jax.random.split(jax.random.key(bi))
    kx, ky = jax.random.split(k_sample)

    def uniform(k):
        return torch.from_numpy(np.array(jax.random.uniform(k, (B, G, P), dtype=jnp.float32)))

    k, pairs = k_vote, []
    for _ in range(max_iter):
        k, k_hyp = jax.random.split(k)
        pairs.append(np.asarray(jax.random.randint(k_hyp, (B * G, HYP, 2), 0, P)))
    return VoteDraws(ux=uniform(kx), uy=uniform(ky), pairs=torch.from_numpy(np.stack(pairs)))


@pytest.fixture(scope="module")
def phase_a(tmp_path_factory):
    """Both packages' phase A on the same scenes, weights and draws."""
    cfg = dict(height=H, width=W, num_classes=7, max_instances=G, render_pose_cues=True)
    sizes = dict(IMAGE_HEIGHT=H, IMAGE_WIDTH=W, BATCH_SIZE=B, VALID_SIZE=N,
                 MAX_INSTANCES=G, MAX_VOTE_POINTS=P, HV_NUM_OF_HYPOTHESES=HYP)
    root = write_synthetic_nocs(tmp_path_factory.mktemp("valid"), N, SEED, SceneConfig(**cfg))
    ds = NOCSDataset(root, max_size=N, max_instances=G)
    batches = [collate([ds[i] for i in range(s, min(s + B, len(ds)))])
               for s in range(0, len(ds), B)]
    flat, _ = load_npz_checkpoint(CKPT)
    tree = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value, jnp.float32)
    state = types.SimpleNamespace(params=tree["params"], batch_stats=tree["batch_stats"])
    hpj = JC.evaluating(**sizes)
    inv_K = np.linalg.inv(jconst.scaled_intrinsics("CAMERA", H, W))
    want = jev.collect_raw_errors(hpj, batches, state, JaxNet(num_classes=7),
                                  JC.pipeline_config_from(hpj, use_pallas=False), inv_K)

    hp = C.evaluating(CHECKPOINT=str(CKPT), **sizes)
    net, hp = tev.build_network(hp, torch.device("cpu"))
    src = SyntheticNOCSSource(N, SEED, tsyn.SceneConfig(**cfg), max_size=N, max_instances=G)
    got, stats = tev.collect_raw_errors(
        hp, iterate_batches(src, B), net, C.pipeline_config_from(hp),
        tev.inverse_intrinsics(hp, "cpu"), torch.device("cpu"), draws_for=jax_draws)
    return want, got, stats


def test_phase_a_matches_jax(phase_a):
    want, got, stats = phase_a
    assert stats["frames"] == N and stats["batches"] == 2
    assert all(1 <= r <= 20 for r in stats["vote_rounds"])
    assert sorted(got) == sorted(want)
    matched = 0
    for metric, per_class in want.items():
        assert sorted(got[metric]) == sorted(per_class) == list(range(1, 7))
        for c, values in per_class.items():
            assert got[metric][c].shape == values.shape, (metric, c)
            assert got[metric][c].dtype == np.float64
            np.testing.assert_allclose(got[metric][c], values, atol=TOL[metric], rtol=0,
                                       err_msg=f"{metric}/{c}")
            matched += values.size
    assert matched >= 4 * 4  # several instances matched, in every metric


def test_phase_b_matches_jax(phase_a, tmp_path):
    want_raw, got_raw, _ = phase_a
    names = list(C.evaluating().SELECTED_CLASSES)
    for raw in (want_raw, got_raw):
        j = jev.compute_aps(raw, names)
        t = tev.compute_aps(raw, names)
        for table_j, table_t in zip((j[0], j[2]), (t[0], t[2])):
            for metric in table_j:
                for cls in table_j[metric]:
                    np.testing.assert_array_equal(table_t[metric][cls], table_j[metric][cls])
    # Port phase A's APs equal JAX phase A's on these scenes.
    got_tables, want_tables = tev.compute_aps(got_raw, names)[2], jev.compute_aps(want_raw, names)[2]
    for metric in want_tables:
        np.testing.assert_array_equal(got_tables[metric]["mean"], want_tables[metric]["mean"])


def test_phase_b_tables_equal_the_committed_ones(tmp_path):
    """The committed held-out evaluation's raw errors through the port's
    phase B give the CSV tables the JAX CLI wrote from them."""
    raw = tev.load_raw(HELD_OUT / "raw_errors_128.npz")
    names = list(C.evaluating().SELECTED_CLASSES)
    _, _, table_aps, table_thr = tev.compute_aps(raw, names)
    out = tev.save_aps(tmp_path / "tables", table_thr, table_aps, names[1:] + ["mean"])
    committed = sorted((HELD_OUT / "128_aps_values_table").glob("*.csv"))
    assert len(committed) == 5
    for path in committed:
        assert (out / path.name).read_text() == path.read_text(), path.name


def test_evaluate_cli_runs_on_cpu_and_skips_phase_a_on_rerun(tmp_path, capsys):
    out = tmp_path / "eval"
    summary = tev.main(SMALL + ["--device", "cpu", "--output", str(out)])
    text = capsys.readouterr().out
    assert "phase A: wrote" in text and "3D-IoU AP@0.25=" in text
    assert summary["frames"] == 3 and summary["batches"] == 2
    assert set(summary["stage_ms"]) == set(tev.STAGES)
    assert (out / "raw_errors_10000.npz").is_file()
    tables = out / "10000_aps_values_table"
    assert sorted(p.name for p in tables.iterdir()) == sorted(
        [f"{m}.csv" for m in tev.METRICS] + ["degree_error+offset_error.csv", "aps.json"])
    again = tev.main(SMALL + ["--device", "cpu", "--output", str(out)])
    assert "phase A skipped" in capsys.readouterr().out
    assert again["table_aps_mean"] == summary["table_aps_mean"]


def test_inference_cli_runs_on_cpu(capsys):
    summary = tinf.main(SMALL[:4] + ["--MAX_VOTE_POINTS", "128", "--HV_NUM_OF_HYPOTHESES",
                                     "256", "--stage_timing", "--device", "cpu"])
    assert summary["frames"] == 3
    assert set(summary["stage_ms"]) == set(tinf.TIMERS)
    text = capsys.readouterr().out
    assert "Hough Voting:" in text and "fps" in text


def test_clis_default_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tev.main(SMALL + ["--output", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        tinf.main(SMALL[:4])
    with pytest.raises(NotImplementedError):  # disk folders are not ported
        tev.main(["--valid_dir", str(tmp_path), "--device", "cpu",
                  "--output", str(tmp_path)])


@pytest.mark.slow
def test_held_out_reproduction_on_cpu(tmp_path):
    """The held-out recipe (128 seed-99 pose-cue scenes at 224x320, FULL_c5)
    through the port on the CPU, with two vote seeds. The rotation does not
    pass through the vote, so the pooled geodesic mean is the same for both
    (a spread of 0); it lies within 0.1 degrees of the committed 22.26,
    which the JAX package computed on a TPU (the JAX package on the CPU
    gives the port's mean to 1e-5 degrees)."""
    if not CKPT.is_file():
        pytest.skip("the FULL_c5 checkpoint is not in this checkout")
    means = []
    for seed in ("0", "1"):
        summary = tev.main([
            "--device", "cpu", "--synthetic", "128", "--synthetic_seed", "99",
            "--synthetic_pose_cues", "--IMAGE_HEIGHT", "224", "--IMAGE_WIDTH", "320",
            "--BATCH_SIZE", "8", "--VALID_SIZE", "128", "--MAX_INSTANCES", "8",
            "--MAX_VOTE_POINTS", "1024", "--HV_NUM_OF_HYPOTHESES", "128",
            "--CHECKPOINT", str(CKPT), "--output", str(tmp_path / seed),
            "--vote_seed", seed])
        means.append(summary["geodesic_mean_deg"])
    committed = np.concatenate(list(tev.load_raw(HELD_OUT / "raw_errors_128.npz")
                                    ["degree_error_geodesic"].values()))
    assert summary["instances"] == committed.size
    assert means[0] == means[1]
    assert abs(means[0] - committed.mean()) < 0.1
