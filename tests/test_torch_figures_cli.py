"""The figure and trace flags of the port's CLIs on the CPU at 64x64: the
inference CLI's `--output --draw 1 --trace` (with the tracer's `fpc/`
ranges in the trace and its counts a frame), the evaluate CLI's `--draw 1`
with phase B's AP plot and table, one epoch of the train CLI with its
per-epoch visualisations and `RunLogger.log_image`. Files are checked to
exist and figures for their shape; without matplotlib the flags are
refused before any frame runs and name the package."""

import json
import subprocess
import sys

import numpy as np
from torch_cleanup import tmp_path  # noqa: F401

from fastposecnn_tpu_torch.cli import evaluate as tev
from fastposecnn_tpu_torch.cli import inference as tinf
from fastposecnn_tpu_torch.cli import train as tcli
from fastposecnn_tpu_torch.data.png import decode_png
from fastposecnn_tpu_torch.utils.tb import RunLogger

SMALL = ["--synthetic", "2", "--IMAGE_HEIGHT", "64", "--IMAGE_WIDTH", "64",
         "--MAX_INSTANCES", "4", "--MAX_VOTE_POINTS", "128", "--device", "cpu"]


def test_inference_cli_figures_and_trace(tmp_path):
    summary = tinf.main(SMALL + ["--HV_NUM_OF_HYPOTHESES", "256", "--output",
                                 str(tmp_path / "fig"), "--draw", "1", "--trace",
                                 str(tmp_path / "trace")])
    assert summary["frames"] == 2
    assert summary["figures"] == [str(tmp_path / "fig" / "0000.png")]
    assert sorted(p.name for p in (tmp_path / "fig").iterdir()) == ["0000.png"]
    img = decode_png(tmp_path / "fig" / "0000.png", rgb=True)
    assert img.shape == (400, 2400, 3)  # six panels of 4 x 4 inches at 100 dpi
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("fastposecnn::cc_label" in n for n in names)
    assert any("fastposecnn::vote_count" in n for n in names)
    assert {"fpc/frame", "fpc/network", "fpc/stages", "fpc/class_compress",
            "fpc/aggregate", "fpc/vote", "fpc/rt"} <= names
    assert summary["counts_per_frame"] == {"vote_rounds": 1.0}  # no flag to read on the CPU


def test_evaluate_cli_draw_plot_and_table(tmp_path):
    out = tmp_path / "eval"
    summary = tev.main(SMALL + ["--HV_NUM_OF_HYPOTHESES", "64", "--BATCH_SIZE", "1",
                                "--output", str(out), "--draw", "1"])
    assert sorted(p.name for p in out.glob("eval_*.png")) == [
        "eval_0000_gt.png", "eval_0000_poses.png", "eval_0000_pred.png"]
    assert decode_png(out / "eval_0000_pred.png", rgb=True).shape == (400, 2400, 3)
    assert decode_png(out / "eval_0000_gt.png", rgb=True).shape == (400, 800, 3)
    assert summary["ap_plot"] == str(out / "all_metrics_10000_aps.png")
    assert decode_png(out / "all_metrics_10000_aps.png", rgb=True).shape == (400, 2000, 3)
    assert sorted(p.name for p in (out / "10000_aps_values_table").iterdir()) == sorted(
        [f"{m}.csv" for m in tev.METRICS] + ["degree_error+offset_error.csv"])


def test_train_cli_epoch_visualisations(tmp_path, monkeypatch):
    monkeypatch.setenv("LOGS", str(tmp_path / "logs"))
    state, run_dir = tcli.main(
        ["-e", "VIZ", "--preset", "HEAD_TRAINING", "--synthetic", "2", "--epochs", "1",
         "--IMAGE_HEIGHT", "64", "--IMAGE_WIDTH", "64", "--BATCH_SIZE", "2",
         "--SELECTED_CLASSES", "bg", "bottle", "bowl", "--MAX_INSTANCES", "4",
         "--MAX_VOTE_POINTS", "128", "--HV_NUM_OF_HYPOTHESES", "32", "--NUM_WORKERS", "1",
         "--no_tb", "--device", "cpu"])
    viz = sorted(p.name for p in (run_dir / "visualizations").iterdir())
    assert viz == ["epoch0_s0.png", "epoch0_s1.png"]
    # rgb, gt_mask, pred_mask, hough, pose: five panels
    assert decode_png(run_dir / "visualizations" / viz[0], rgb=True).shape == (400, 2000, 3)
    assert "visualization failed" not in (run_dir / "run.log").read_text()


def test_run_logger_log_image(tmp_path):
    logger = RunLogger(tmp_path, enabled=True)
    logger.log_image("valid", "epoch_viz/sample_0", np.random.default_rng(0).random((8, 8, 3)), 0)
    logger.close()
    assert list((tmp_path / "_" / "valid").glob("events.out.tfevents.*"))
    RunLogger(tmp_path / "off", enabled=False).log_image("valid", "x", np.zeros((2, 2, 3)), 0)


_NO_MATPLOTLIB = """
import sys
sys.modules["matplotlib"] = None
from fastposecnn_tpu_torch.cli import evaluate, inference
small = {small!r}
for main, args in ((inference.main, ["--output", {out!r}, "--draw", "1"]),
                   (evaluate.main, ["--output", {out!r}, "--draw", "1"])):
    try:
        main(small + args)
    except ImportError as e:
        assert "matplotlib" in str(e), e
    else:
        raise AssertionError("figures without matplotlib")
import pathlib
assert not list(pathlib.Path({out!r}).glob("raw_errors_*.npz"))  # refused before phase A
summary = evaluate.main(small + ["--output", {out!r}])
assert summary["ap_plot"].startswith("no plot:") and "matplotlib" in summary["ap_plot"]
curves = sorted(p.name for p in pathlib.Path(summary["ap_curves"]).glob("*.csv"))
assert len(curves) == 4, curves  # the curves are kept without the plot
print("ok")
"""


def test_figure_flags_without_matplotlib(tmp_path):
    code = _NO_MATPLOTLIB.format(small=SMALL + ["--HV_NUM_OF_HYPOTHESES", "64"],
                                 out=str(tmp_path / "out"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tev.pathlib.Path(tev.__file__)
                          .resolve().parents[2], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]
