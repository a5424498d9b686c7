"""Port parity for the whole post-network INFERENCE path, plus the port's
package rules: it imports nothing of JAX or of the JAX package, and its
entry points run on CUDA unless the caller asks for the CPU."""

import ast
import dataclasses
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastposecnn_tpu.data.synthetic import SceneConfig, generate_scene, perfect_logits
from fastposecnn_tpu.pipeline import PipelineConfig as JaxPipelineConfig
from fastposecnn_tpu.pipeline import run_pipeline as jax_run_pipeline
from fastposecnn_tpu_torch import config as C
from fastposecnn_tpu_torch.device import resolve_device
from fastposecnn_tpu_torch.ops.voting import VoteDraws
from fastposecnn_tpu_torch.pipeline import PipelineConfig, run_pipeline
from fastposecnn_tpu_torch.serve import InferenceServer

ATOL, RTOL = 2e-4, 1e-4
REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "fastposecnn_tpu", "scripts")


def jax_draws(key, b, n, max_points, num_hyp):
    """The draws JAX `hough_vote` makes from `key`, as a port `VoteDraws`."""
    k_sample, k_vote = jax.random.split(key)
    kx, ky = jax.random.split(k_sample)
    ux = jax.random.uniform(kx, (b, n, max_points), dtype=jnp.float32)
    uy = jax.random.uniform(ky, (b, n, max_points), dtype=jnp.float32)
    shifts = jax.random.randint(k_vote, (max(1, -(-num_hyp // max_points)),),
                                1, max_points)
    return VoteDraws(torch.from_numpy(np.array(ux)), torch.from_numpy(np.array(uy)),
                     tuple(int(s) for s in np.asarray(shifts)))


@pytest.mark.parametrize("seed", [3, 8])
def test_inference_path_matches_jax(seed):
    """Synthetic scene logits -> class compression -> CC -> aggregation ->
    voting (16 slots, 128 points, 256 hypotheses) -> R/T, both packages."""
    rng = np.random.default_rng(seed)
    cfg = SceneConfig(height=96, width=128, max_instances=16,
                      max_scene_instances=4)
    scene = generate_scene(rng, cfg)
    logits = perfect_logits(scene, cfg.num_classes)  # NHWC, batch 1
    inv_K = np.linalg.inv(scene["intrinsics"]).astype(np.float32)
    n, p, hyp = 16, 128, 256
    key = jax.random.key(seed)

    want = jax_run_pipeline(
        {k: jnp.asarray(v, jnp.float32) for k, v in logits.items()}, key,
        JaxPipelineConfig(max_instances=n, max_points=p, hv_num_hypotheses=hyp,
                          hv_adaptive=False, use_pallas=False),
        jnp.asarray(inv_K))
    got = run_pipeline(
        {k: torch.from_numpy(np.ascontiguousarray(v.transpose(0, 3, 1, 2)))
         for k, v in logits.items()},
        PipelineConfig(max_instances=n, max_points=p, hv_num_hypotheses=hyp,
                       hv_adaptive=False),
        torch.from_numpy(inv_K), draws=jax_draws(key, 1, n, p, hyp))

    np.testing.assert_array_equal(got["categorical"]["mask"].numpy(),
                                  np.asarray(want["categorical"]["mask"]))
    ga, wa = got["aggregated"], want["aggregated"]
    np.testing.assert_array_equal(ga["class_ids"].numpy(), np.asarray(wa["class_ids"]))
    np.testing.assert_array_equal(ga["valid"].numpy(), np.asarray(wa["valid"]))
    assert ga["valid"].sum() == scene["agg"]["valid"].sum()
    for key_ in ("xy", "z", "RT"):
        np.testing.assert_allclose(ga[key_].numpy(), np.asarray(wa[key_]),
                                   atol=ATOL, rtol=RTOL, err_msg=key_)


def test_unported_options_raise():
    """Soft voting is not ported (nor are unknown sampler or refinement
    names); the adaptive loop, the cdf sampler and the sampled refinement
    are, and pass the check."""
    logits = {"mask": torch.zeros(1, 3, 32, 32)}
    for field, value in (("hv_implementation", "soft"), ("hv_sampler", "grid"),
                         ("hv_refine", "none")):
        cfg = dataclasses.replace(PipelineConfig(hv_adaptive=False), **{field: value})
        with pytest.raises(NotImplementedError):
            run_pipeline(logits, cfg, torch.eye(3))
    PipelineConfig(hv_adaptive=True, hv_sampler="cdf", hv_refine="sampled").check_ported()


def test_inference_preset_config():
    cfg = C.pipeline_config_from(C.inference())
    assert (cfg.hv_num_hypotheses, cfg.max_points, cfg.max_instances) == (4096, 1024, 16)
    assert not cfg.hv_adaptive and cfg.impl is None
    cfg.check_ported()


def _port_sources():
    files = sorted((REPO / "fastposecnn_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_sources_import_no_jax():
    """AST scan: no file of the port, nor chip_smoke.py, imports jax, flax,
    the JAX package or its scripts (the probes included)."""
    files = _port_sources()
    assert len(files) > 15
    assert REPO / "fastposecnn_tpu_torch" / "probes" / "vote_variants.py" in files
    for module in ("losses.py", "train/optim.py", "train/task.py"):
        assert REPO / "fastposecnn_tpu_torch" / module in files
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


_BLOCKED_IMPORT = """
import importlib, pkgutil, sys
FORBIDDEN = {forbidden!r}
for m in [m for m in sys.modules if m.split('.')[0] in FORBIDDEN]:
    del sys.modules[m]
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in FORBIDDEN:
            raise ImportError('port imported ' + name)
sys.meta_path.insert(0, Block())
import fastposecnn_tpu_torch
for info in pkgutil.walk_packages(fastposecnn_tpu_torch.__path__, 'fastposecnn_tpu_torch.'):
    importlib.import_module(info.name)
bad = [m for m in sys.modules if m.split('.')[0] in FORBIDDEN]
assert not bad, bad
assert 'fastposecnn_tpu_torch.probes.vote_variants' in sys.modules
assert 'fastposecnn_tpu_torch.train.task' in sys.modules
assert 'fastposecnn_tpu_torch.losses' in sys.modules
print('ok')
"""


def test_port_imports_no_jax_in_subprocess():
    code = _BLOCKED_IMPORT.format(forbidden=FORBIDDEN)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_nvcc_lookup_order(monkeypatch, tmp_path):
    from fastposecnn_tpu_torch.kernels import build

    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert build.find_nvcc() == str(nvcc)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    if not pathlib.Path("/usr/local/cuda/bin/nvcc").is_file():
        assert build.find_nvcc() == str(nvcc)
        monkeypatch.setenv("PATH", str(tmp_path / "none"))
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.find_nvcc()


# Lines as `nvcc -Xptxas -v` prints them on the card (abridged).
_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN53_GLOBAL__N__3aa0f22d_20_vote_expanded_mma_cu_e052ecb924vote_expanded_mma_kernelEPK6float2S2_S2_PKfPfiiifii' for 'sm_90a'
ptxas info    : Function properties for _ZN53_GLOBAL__N__3aa0f22d_20_vote_expanded_mma_cu_e052ecb924vote_expanded_mma_kernelEPK6float2S2_S2_PKfPfiiifii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 100 registers, used 1 barriers, 256 bytes smem, 400 bytes cmem[0]
ptxas info    : (C7514) Potential Performance Loss: wgmma.mma_async instructions are serialized due to non wgmma instructions reading accumulator registers of  a wgmma between start and end of the pipeline stage in the function '_ZN12_GLOBAL__N_14kernILb1EEEvv'
ptxas info    : Function properties for _ZN46_GLOBAL__N__be2f8cbc_13_vote_count_cu_9981d1ad17vote_count_kernelEPK6float2S2_S2_PKfPKiPfiiif
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 39 registers, used 1 barriers, 4240 bytes smem, 400 bytes cmem[0]
"""


def test_ptxas_report_is_parsed():
    from fastposecnn_tpu_torch.kernels import build

    got = build.parse_ptxas(_PTXAS_LOG)
    assert got["vote_expanded_mma_kernel"] == dict(
        stack_bytes=0, spill_stores=0, spill_loads=0, registers=100, smem_bytes=256)
    assert got["vote_count_kernel"] == dict(
        stack_bytes=8, spill_stores=4, spill_loads=4, registers=39, smem_bytes=4240)
    assert got["kern"]["notes"][0].startswith("ptxas info    : (C7514)")
    assert build._kernel_name("_Z9my_kerneli") == "my_kernel"


def test_build_keeps_the_ptxas_report(monkeypatch, tmp_path):
    """The build passes -Xptxas -v and keeps what the compiler reports beside
    the library, so a reused library reports it too."""
    from fastposecnn_tpu_torch.kernels import build

    assert ("-Xptxas", "-v") in zip(build.NVCC_FLAGS, build.NVCC_FLAGS[1:])
    nvcc = tmp_path / "nvcc"
    log = tmp_path / "ptxas.log"
    log.write_text(_PTXAS_LOG)
    # A stand-in nvcc: writes its -o target and prints the report on stderr.
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    f'touch "$2"\ncat "{log}" >&2\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    target = tmp_path / "build" / "libfpcnn_kernels_test.so"
    build._compile(str(nvcc), target)
    assert target.is_file()
    report = json.loads(target.with_suffix(".ptxas.json").read_text())
    assert report == json.loads(json.dumps(build.parse_ptxas(_PTXAS_LOG)))


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceServer()
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceServer(device="cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def _small_inference_preset(monkeypatch):
    """Make `InferenceServer` build a small INFERENCE preset (64x96, 3
    classes, 128 points, 256 hypotheses) so the test runs fast on the CPU."""
    hp = C.inference(IMAGE_HEIGHT=64, IMAGE_WIDTH=96, MAX_VOTE_POINTS=128,
                     HV_NUM_OF_HYPOTHESES=256,
                     SELECTED_CLASSES=("bg", "bottle", "bowl"))
    monkeypatch.setattr(C, "inference", lambda: hp)


def test_server_answers_on_cpu_when_asked(monkeypatch):
    _small_inference_preset(monkeypatch)
    server = InferenceServer(device="cpu", seed=1)
    image = torch.from_numpy(
        np.random.default_rng(0).normal(size=(1, 3, 64, 96)).astype(np.float32))
    mask, class_ids, xy, z, RT = server(image)
    assert mask.shape == (1, 64, 96) and mask.dtype == torch.int32
    assert class_ids.shape == (1, 16) and xy.shape == (1, 16, 2)
    assert z.shape == (1, 16) and RT.shape == (1, 16, 4, 4)
    for t in (xy, z, RT):
        assert torch.isfinite(t).all()
    # Same weights and seed, same answer.
    again = InferenceServer(device="cpu", seed=1)(image)
    assert torch.equal(again[0], mask) and torch.equal(again[4], RT)
