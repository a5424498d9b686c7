"""Port parity for the rotating scene-bank pool
(`fastposecnn_tpu_torch/data/bank_pool.py`): the seven cases of
`tests/test_bank_pool.py`, each run on the port's pool and on the JAX
package's with the same fake renderer scripts (the same directories,
seeds, cursor moves and errors), and the port's real renderer command.
Tolerance: exact.
"""

import os
import pathlib
import subprocess
import sys

import pytest

from fastposecnn_tpu.data import bank_pool as jpool
from fastposecnn_tpu_torch.data import bank_pool as tpool
from fastposecnn_tpu_torch.data.nocs import NOCSDataset

POOLS = {"port": tpool.BankPool, "jax": jpool.BankPool}


@pytest.fixture(params=sorted(POOLS))
def make_pool(request):
    cls = POOLS[request.param]

    def make(root: pathlib.Path, **kw):
        kw.setdefault("scene_count", 2)
        kw.setdefault("height", 32)
        kw.setdefault("width", 32)
        kw.setdefault("num_classes", 7)
        kw.setdefault("max_instances", 2)
        kw.setdefault("pose_cues", False)
        return cls(root, **kw)
    return make


def fake_render(pool, script: str) -> None:
    """Replace the writer subprocess with a tiny inline script (it gets the
    --out folder as argv[1])."""
    pool._command = lambda out_dir, seed: [sys.executable, "-c", script, str(out_dir)]


OK_SCRIPT = ("import sys, pathlib; d = pathlib.Path(sys.argv[1]);"
             "d.mkdir(parents=True); (d / 'scene.png').write_bytes(b'x')")
FAIL_SCRIPT = "import sys; sys.exit(3)"


def test_adopts_completed_banks_and_clears_partials(tmp_path, make_pool):
    (tmp_path / "train").mkdir()
    (tmp_path / "bank_2").mkdir()
    (tmp_path / "bank_5").mkdir()
    (tmp_path / "bank_7.part").mkdir()
    (tmp_path / "bank_7.part" / "half.png").write_bytes(b"x")
    pool = make_pool(tmp_path, initial=[tmp_path / "train"])
    assert pool.dirs == [tmp_path / "train", tmp_path / "bank_2", tmp_path / "bank_5"]
    assert not (tmp_path / "bank_7.part").exists()
    assert pool.seed == 6  # resumes after the highest adopted bank


def test_empty_pool_starts_at_seed_2(tmp_path, make_pool):
    assert make_pool(tmp_path).seed == 2  # 0 is the train bank, 1 the valid one


def test_resumed_pool_skips_heldout_seed_99(tmp_path, make_pool):
    """A pool adopted at bank_98 starts at seed 99, the held-out evaluation
    stream: the launch skips it."""
    (tmp_path / "bank_98").mkdir()
    pool = make_pool(tmp_path, initial=[])
    assert pool.seed == 99
    fake_render(pool, OK_SCRIPT)
    pool.launch()
    pool.proc.wait()
    assert pool.render_dir.name == "bank_100.part"
    assert not list(tmp_path.glob("bank_99*"))
    pool.shutdown()


def test_rotate_harvests_and_round_robins(tmp_path, make_pool):
    (tmp_path / "train").mkdir()
    pool = make_pool(tmp_path, initial=[tmp_path / "train"])
    fake_render(pool, OK_SCRIPT)
    pool.launch()
    pool.proc.wait()
    assert pool.rotate() == tmp_path / "bank_2"  # harvested, renamed from .part
    assert (tmp_path / "bank_2" / "scene.png").exists()
    pool.proc.wait()  # the harvest started seed 3
    assert pool.rotate() == tmp_path / "bank_3"
    assert pool.rotate() == tmp_path / "train"  # wraps around
    pool.shutdown()


def test_eviction_respects_cap(tmp_path, make_pool):
    (tmp_path / "train").mkdir()
    pool = make_pool(tmp_path, initial=[tmp_path / "train"], cap=2)
    fake_render(pool, OK_SCRIPT)
    pool.launch()
    seen = []
    for _ in range(3):
        pool.proc.wait()
        seen.append((pool.rotate().name, pool.rr))
    assert len(pool.dirs) <= 2
    assert not (tmp_path / "train").exists()  # the oldest evicted
    # the cursor moved back with each eviction
    assert seen == [("bank_2", 1), ("bank_3", 1), ("bank_4", 1)]
    pool.shutdown()


def test_renderer_failure_retries_then_raises(tmp_path, make_pool):
    (tmp_path / "train").mkdir()
    pool = make_pool(tmp_path, initial=[tmp_path / "train"], max_consecutive_failures=2)
    fake_render(pool, FAIL_SCRIPT)
    pool.launch()
    for _ in range(2):  # two failed harvests tolerated, each relaunches
        pool.proc.wait()
        assert pool.rotate() == tmp_path / "train"
    pool.proc.wait()
    with pytest.raises(RuntimeError, match="failed 3 times"):
        pool.rotate()
    assert not list(tmp_path.glob("bank_*"))  # failed renders left nothing
    pool.shutdown()


def test_shutdown_reaps_inflight_render(tmp_path, make_pool):
    (tmp_path / "train").mkdir()
    pool = make_pool(tmp_path, initial=[tmp_path / "train"])
    fake_render(pool, "import time; time.sleep(60)")
    pool.launch()
    pool.shutdown()
    assert pool.proc.poll() is not None  # reaped, not orphaned


def test_real_renderer_writes_a_readable_bank_without_the_card(tmp_path, monkeypatch):
    """The port's own command (`python -m fastposecnn_tpu_torch.data.
    nocs_writer`), started from another directory: the bank lands whole,
    with its marker, and reads back; the child was told to see no card."""
    (tmp_path / "train").mkdir()
    monkeypatch.chdir(tmp_path)
    pool = tpool.BankPool(tmp_path, scene_count=3, height=32, width=40, num_classes=7,
                          max_instances=3, pose_cues=True, initial=[tmp_path / "train"])
    cmd = pool._command(tmp_path / "x", 5)
    assert cmd[1:3] == ["-m", "fastposecnn_tpu_torch.data.nocs_writer"]
    assert "--pose_cues" in cmd and cmd[cmd.index("--seed") + 1] == "5"
    envs = []
    real_popen = subprocess.Popen

    def popen(*a, **kw):
        envs.append(kw["env"])
        return real_popen(*a, **kw)

    monkeypatch.setattr(tpool.subprocess, "Popen", popen)
    pool.launch()
    assert pool.proc.wait(timeout=120) == 0
    assert envs[0]["CUDA_VISIBLE_DEVICES"] == ""
    assert str(tpool.PACKAGE_ROOT) in envs[0]["PYTHONPATH"].split(os.pathsep)
    bank = pool.rotate()
    assert bank == tmp_path / "bank_2" and (bank / ".complete").exists()
    assert len(NOCSDataset(bank, max_instances=3)) >= 1
    pool.shutdown()
