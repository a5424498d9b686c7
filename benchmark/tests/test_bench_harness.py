"""The harness: cells, configurations, traffic mixes and per-layer metrics
found by name; BENCHMARK.json within the contract's characters and keys; a
run without a card, or without the program, exits non-zero and prints no
result."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

import harness
import run
from conftest import BENCH, REPO, small

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCHMARK = json.loads((REPO / "BENCHMARK.json").read_text())


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "bench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((root / "configs" / "fastposecnn-r18.json").read_text())
    (root / "configs" / "another-net.json").write_text(json.dumps(dict(cfg, encoder="resnet34")))
    tr = json.loads((root / "traffic" / "serve-f32-b1.json").read_text())
    (root / "traffic" / "serve-more.json").write_text(json.dumps(dict(tr, pool=32)))
    (root / "metrics" / "answer.serve.py").write_text("def read(record):\n    return 42.0\n")
    e2e = [dict(m, workloads=["x-serve"]) if m["name"] == "frame_ms_p95" else m
           for m in BENCHMARK["end_to_end"]]
    bench = dict(BENCHMARK, end_to_end=e2e,
                 workloads=[{"name": "x-serve", "config": "another-net",
                                        "traffic": "serve-more", "chips": 1, "why": "test"}],
                 per_layer=[{"name": "answer.serve", "unit": "%", "better": "higher",
                             "source": "program_counter", "layer": "network",
                             "moves": "frame_ms_p95", "workloads": ["x-serve"]}])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.find_cell("x-serve", tmp_path / "BENCHMARK.json", root)
    assert cell.config["encoder"] == "resnet34" and cell.traffic["pool"] == 32
    assert [m["name"] for m in cell.per_layer()] == ["answer.serve"]
    assert {m["name"] for m in cell.end_to_end()} == {"frame_ms_p95", "setup_s"}
    assert harness.load_metric(root, "answer.serve").read(None) == 42.0
    assert hasattr(harness.load_driver(cell), "run")


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs", "workloads",
                              "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCHMARK[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCHMARK["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (REPO / c["file"]).is_file()
    e2e = {m["name"]: m for m in BENCHMARK["end_to_end"]}
    for w in BENCHMARK["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] == 1 and len(w["why"]) <= 200
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        own = {n for n, m in e2e.items() if w["name"] in m.get("workloads", [w["name"]])}
        assert "setup_s" in own and len(own) >= 2
        cell = harness.find_cell(w["name"])
        assert cell.per_layer(), w["name"]
    for m in BENCHMARK["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCHMARK["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])


@pytest.mark.parametrize("workload,part,key,value", [
    ("r18-serve", "traffic", "batch", 4),
    ("r18-serve", "traffic", "clients", 2),
    ("r18-serve", "config", "decoder_pyramid_channels", 128),
    ("r18-train-head", "config", "decoder_segmentation_channels", 64),
    ("r50-train-mask", "config", "parameters", 1),
    ("r50-train-mask", "config", "head_upsampling", 2),
])
def test_a_size_the_run_does_not_have_is_refused(workload, part, key, value):
    """A configuration or traffic file stating what the port or the driver
    does not run makes the run refuse, not run the defaults."""
    sizes = small(workload)
    sizes[part] = dict(sizes[part], **{key: value})
    args = run.parse(["--workload", workload, "--seed", "3", "--seconds", "0.5",
                      "--trace", "0", "--device", "cpu", "--small", json.dumps(sizes)])
    with pytest.raises(harness.Refused):
        run.run_cell(args, 0.0)


def test_a_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "r18-serve",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_the_benchmark_alone_refuses(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's folder
    (no program), a run exits non-zero with no result."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "r18-serve",
                           "--seed", "1", "--seconds", "1", "--trace", "0", "--device", "cpu"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
