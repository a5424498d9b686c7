"""Rotating synthetic scene-bank pool (counterpart of the JAX package's
`data/bank_pool.py`).

Defeats scene-bank memorization during device-resident staged training
(BASELINE.md round-3 root cause #2: with a fixed synthetic set the mask
head memorizes the bank while validation diverges). A fixed bank is
replaced by a POOL of bank directories: each restage round-robins the
dataset onto the next already-rendered bank (cost = the re-stage read
only, never a render wait) while ONE background subprocess continuously
renders fresh banks into the pool, evicting the oldest beyond the cap.
Training-set freshness then tracks renderer throughput and the live
diversity is cap x bank_size scenes, with zero training stalls.

Crash consistency (a pool may be persistent across relaunches, e.g.
after a device outage): renders go to a `bank_N.part` directory and are
renamed to `bank_N` only on success, so on adoption anything named
`bank_N` is whole and every `*.part` is an orphan to delete.

The reference has no counterpart (it trains on the fixed NOCS corpus);
this exists for the synthetic training path in zero-egress environments.
The renderer is this package's writer (`python -m
fastposecnn_tpu_torch.data.nocs_writer`), started with
`CUDA_VISIBLE_DEVICES=""` so that it never touches the card.
"""

from __future__ import annotations

import os
import pathlib
import shutil
import subprocess
import sys
from typing import List, Optional, Sequence

# Seeds that must never appear in a training bank. 99 is the held-out
# evaluation stream (cli.evaluate --synthetic_seed 99, rotation_demo.sh
# stage 3): training on it would silently invalidate held-out results.
RESERVED_SEEDS = frozenset({99})
PACKAGE_ROOT = pathlib.Path(__file__).resolve().parents[2]


class BankPool:
    """Owns the bank directories under `root` plus one renderer subprocess.

    `root` is expected to contain the initial `train` bank (and anything
    else the caller staged); completed `bank_N` directories already
    present — e.g. from an interrupted run with a persistent pool dir —
    are adopted in seed order and the seed stream resumes after the
    highest one.
    """

    def __init__(
        self,
        root: pathlib.Path,
        scene_count: int,
        height: int,
        width: int,
        num_classes: int,
        max_instances: int,
        pose_cues: bool,
        cue_boost: bool = False,
        initial: Sequence[pathlib.Path] = (),
        cap: int = 6,
        max_consecutive_failures: int = 3,
    ):
        self.root = pathlib.Path(root)
        self.scene_count = scene_count
        self.height = height
        self.width = width
        self.num_classes = num_classes
        self.max_instances = max_instances
        self.pose_cues = pose_cues
        self.cue_boost = cue_boost
        self.cap = cap
        self.max_consecutive_failures = max_consecutive_failures

        existing = sorted(
            (d for d in self.root.glob("bank_[0-9]*")
             if d.is_dir() and not d.name.endswith(".part")),
            key=lambda d: int(d.name.split("_")[1]),
        )
        for part in self.root.glob("bank_*.part"):
            shutil.rmtree(part, ignore_errors=True)

        self.dirs: List[pathlib.Path] = list(initial) + existing
        self.rr = 0  # round-robin cursor into self.dirs
        self.seed = (int(existing[-1].name.split("_")[1]) + 1
                     if existing else 2)
        self.proc: Optional[subprocess.Popen] = None
        self.render_dir: Optional[pathlib.Path] = None
        self.fails = 0
        self._log = None

    # -- renderer subprocess ------------------------------------------------

    def _command(self, out_dir: pathlib.Path, seed: int) -> List[str]:
        cmd = [
            sys.executable, "-m", "fastposecnn_tpu_torch.data.nocs_writer",
            "--out", str(out_dir),
            "--num", str(self.scene_count),
            "--seed", str(seed),
            "--height", str(self.height),
            "--width", str(self.width),
            "--num_classes", str(self.num_classes),
            "--max_instances", str(self.max_instances),
        ]
        if self.pose_cues:
            cmd.append("--pose_cues")
        if self.cue_boost:
            cmd.append("--cue_boost")
        return cmd

    def launch(self) -> None:
        """Start rendering the next bank in the background."""
        while self.seed in RESERVED_SEEDS:
            # Guard at USE time: a pool adopted at bank_98 initializes
            # seed=99 directly, so a post-increment check is not enough.
            self.seed += 1
        if self._log is None:
            self._log = open(self.root / "regen.log", "a")
        self.render_dir = self.root / f"bank_{self.seed}.part"
        # The child finds this package wherever the parent was started from.
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=os.pathsep.join(
            filter(None, (str(PACKAGE_ROOT), os.environ.get("PYTHONPATH")))))
        self.proc = subprocess.Popen(
            self._command(self.render_dir, self.seed), env=env,
            stdout=self._log, stderr=self._log,
        )
        self.seed += 1

    def _harvest(self) -> None:
        """If the background render finished, admit its bank to the pool
        (evicting the oldest beyond the cap) and start the next one.
        A renderer hiccup must not abort hours of device training: keep
        rotating the existing banks and retry (bounded — a deterministic
        failure should still surface, loudly)."""
        if self.proc is None or self.proc.poll() is None:
            return
        if self.proc.returncode != 0:
            self.fails += 1
            if self.fails > self.max_consecutive_failures:
                raise RuntimeError(
                    f"background scene-bank render failed {self.fails} "
                    f"times in a row (last exit {self.proc.returncode}); "
                    f"see {self.root / 'regen.log'}"
                )
            print(
                f"WARNING: background scene-bank render failed (exit "
                f"{self.proc.returncode}, attempt {self.fails}/"
                f"{self.max_consecutive_failures}); continuing on "
                f"{len(self.dirs)} pooled bank(s), retrying — see "
                f"{self.root / 'regen.log'}",
                flush=True,
            )
            shutil.rmtree(self.render_dir, ignore_errors=True)
            self.launch()
            return
        self.fails = 0
        done = self.render_dir.with_name(
            self.render_dir.name[: -len(".part")]
        )
        self.render_dir.rename(done)
        self.dirs.append(done)
        if len(self.dirs) > self.cap:
            victim = self.dirs.pop(0)
            if self.rr > 0:
                self.rr -= 1
            shutil.rmtree(victim, ignore_errors=True)
        self.launch()

    # -- training-loop interface --------------------------------------------

    def rotate(self) -> pathlib.Path:
        """Harvest any finished render, advance to the next pooled bank,
        and return its directory (the restage callback repoints the
        dataset here)."""
        self._harvest()
        self.rr = (self.rr + 1) % len(self.dirs)
        return self.dirs[self.rr]

    def shutdown(self) -> None:
        """Reap the in-flight render (it would keep burning host CPU and
        pool-dir disk after training exits) and release the log handle."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        if self._log is not None:
            self._log.close()
            self._log = None
