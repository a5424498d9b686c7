"""Nothing under benchmark/ imports JAX, flax or the JAX package, and the
plain reference imports nothing of the port. Module names are compared by
their whole top-level name: `fastposecnn_tpu_torch` is not
`fastposecnn_tpu`."""

from __future__ import annotations

import ast
import json
import pathlib
import subprocess
import sys

from conftest import BENCH, REPO, small

FORBIDDEN = {"jax", "jaxlib", "flax", "fastposecnn_tpu"}


def imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    bad = {str(f.relative_to(BENCH)): sorted(imported_roots(f) & FORBIDDEN) for f in files}
    assert not {k: v for k, v in bad.items() if v}


def test_reference_imports_nothing_of_the_port():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        assert "fastposecnn_tpu_torch" not in imported_roots(f), f


BLOCKER = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {"jax", "jaxlib", "flax", "fastposecnn_tpu"}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.argv = ["run.py"] + sys.argv[1:]
sys.path.insert(0, %r)
import run
sys.exit(run.main(sys.argv[1:]))
"""


def test_a_run_with_the_imports_blocked():
    """A whole run (on the CPU, small) with JAX and the JAX package made
    unimportable: it ends with a result, and its own check of `sys.modules`
    finds nothing."""
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKER % str(BENCH), "--workload", "r18-serve", "--seed", "3",
         "--seconds", "0.5", "--device", "cpu", "--small", json.dumps(small("r18-serve"))],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"]
