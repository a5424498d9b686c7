"""Model export for serving (counterpart of the JAX package's
`utils/export.py`, which writes StableHLO with `jax.export`).

    path = export_forward(net, "model.pt2", image_shape=(1, 3, 480, 640),
                          pipeline_config=pcfg, inv_intrinsics=inv_K, seed=0)
    serve = load_exported(path)        # in any process
    mask, class_ids, xy, z, RT = serve(image)

`export_forward` traces the network (eval mode) with `torch.export.export`
on the device its parameters are on, and writes the program with
`torch.export.save` (a `.pt2` file). Without `pipeline_config` the program
is image -> the network's logits (a dict); with one it is the whole
pipeline, image -> (mask, class_ids, xy, z, RT, K1's error flag). The
kernels K1 and K2 are the custom ops `fastposecnn::cc_label` and
`fastposecnn::vote_count` in the program, so on the card the loaded program
launches the hand-written kernels (and counts their launches), and on the
CPU their plain versions.

The random draws are baked into the program, as the JAX export fixes
`jax.random.key(0)` inside its function: pass `draws` (a
`ops.voting.VoteDraws`, on the network's device or the host) or a `seed`
from which they are made; every call of the program uses the same draws.
The adaptive vote loop of `hv_adaptive` is one `while_loop` higher-order op
in the program (`ops.voting.ransac_vote_centers_adaptive`), so its draws
need every round's `pairs`.

`load_exported` registers the port's ops in the loading process (by
importing their modules), runs the program inside `device.full_float32()`
(TF32 is process state, not part of the program) and reads K1's flag once,
after the call, raising if it is set.
"""

from __future__ import annotations

import json
import pathlib
from typing import Optional

import numpy as np
import torch

from fastposecnn_tpu_torch.device import full_float32

_META = "fastposecnn.json"


class _Pipeline(torch.nn.Module):
    """image -> (mask, class_ids, xy, z, RT, K1's flag) with fixed draws."""

    def __init__(self, net: torch.nn.Module, config, inv_k: torch.Tensor, draws):
        super().__init__()
        self.net = net
        self.config = config
        self.register_buffer("inv_k", inv_k, persistent=False)
        self.draw_names = []
        for name in ("ux", "uy", "u", "pairs"):
            value = getattr(draws, name)
            if value is not None:
                self.register_buffer(f"draw_{name}", value.to(inv_k.device), persistent=False)
                self.draw_names.append(name)
        self.shifts = draws.shifts

    def forward(self, image: torch.Tensor):
        from fastposecnn_tpu_torch.ops.voting import VoteDraws
        from fastposecnn_tpu_torch.pipeline import run_pipeline

        draws = VoteDraws(shifts=self.shifts,
                          **{n: getattr(self, f"draw_{n}") for n in self.draw_names})
        out = run_pipeline(self.net(image), self.config, self.inv_k, draws=draws)
        agg = out["aggregated"]
        flag = agg["cc_error"]
        if flag is None:  # the plain version sets no flag
            flag = torch.zeros(1, dtype=torch.int32, device=image.device)
        return (out["categorical"]["mask"], agg["class_ids"], agg["xy"], agg["z"],
                agg["RT"], flag)


def make_draws(config, batch: int, seed: int, device):
    """The draws of one call of the pipeline at `config` for a batch of
    `batch`, from `seed`: the sampler's uniforms, the single shot's shifts
    and, for the adaptive loop, `hv_max_iter` rounds of pairs."""
    from fastposecnn_tpu_torch.ops.voting import sample_draws

    n, p, h = config.max_instances, config.max_points, config.hv_num_hypotheses
    gen = torch.Generator().manual_seed(seed)
    draws = sample_draws(batch, n, p, h, gen, gen, config.hv_sampler)
    if config.hv_adaptive:
        draws.pairs = torch.randint(0, p, (config.hv_max_iter, batch * n, h, 2),
                                    generator=gen)
    for name in ("ux", "uy", "u", "pairs"):
        if getattr(draws, name) is not None:
            setattr(draws, name, getattr(draws, name).to(device))
    return draws


def export_forward(net: torch.nn.Module, path, image_shape=(1, 3, 480, 640),
                   pipeline_config=None, inv_intrinsics: Optional[np.ndarray] = None,
                   draws=None, seed: int = 0) -> pathlib.Path:
    """Trace `net` (put in eval mode) on its parameters' device and save the
    program to `path` (`.pt2`). `image_shape` is the port's [B, 3, H, W].
    With `pipeline_config` (a `pipeline.PipelineConfig`; `inv_intrinsics`
    [3, 3] is then needed) the program is the whole pipeline with the
    draws `draws`, or those `make_draws` makes from `seed`."""
    device = next(net.parameters()).device
    net.eval()
    meta = {"kind": "network", "image_shape": list(image_shape), "device": str(device)}
    module = net
    if pipeline_config is not None:
        if inv_intrinsics is None:
            raise ValueError("exporting the pipeline needs inv_intrinsics")
        pipeline_config.check_ported()
        if pipeline_config.hv_implementation != "ransac":
            raise NotImplementedError("the exported pipeline votes with RANSAC (K2)")
        if draws is None:
            draws = make_draws(pipeline_config, image_shape[0], seed, device)
        if pipeline_config.hv_adaptive and draws.pairs is None:
            raise ValueError("an adaptive pipeline's draws need their pairs")
        inv_k = torch.as_tensor(np.asarray(inv_intrinsics), dtype=torch.float32).to(device)
        module = _Pipeline(net, pipeline_config, inv_k, draws)
        meta["kind"] = "pipeline"
    example = torch.zeros(image_shape, dtype=torch.float32, device=device)
    with torch.no_grad(), full_float32():
        program = torch.export.export(module, (example,))
    path = pathlib.Path(path)
    torch.export.save(program, path, extra_files={_META: json.dumps(meta)})
    return path


def load_exported(path):
    """Load a program `export_forward` wrote; returns a callable image ->
    logits (a network) or image -> (mask, class_ids, xy, z, RT) (the
    pipeline, K1's flag read once after the call), whose `meta` holds the
    kind, image shape and device. The call moves the image to the device
    the program was exported on, and runs under `torch.inference_mode`, as
    the served path does."""
    from fastposecnn_tpu_torch.ops import connected_components, voting  # noqa: F401 (the ops)
    from fastposecnn_tpu_torch.ops.connected_components import raise_on_error_flag

    extra = {_META: ""}
    program = torch.export.load(pathlib.Path(path), extra_files=extra)
    meta = json.loads(extra[_META])
    module = program.module()

    device = torch.device(meta["device"])

    def call(image: torch.Tensor):
        with torch.inference_mode(), full_float32():
            out = module(image.to(device))
        if meta["kind"] != "pipeline":
            return out
        raise_on_error_flag(out[-1])
        return out[:-1]

    call.meta = meta
    return call
