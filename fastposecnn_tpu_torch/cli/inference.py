"""Real-time inference CLI: a batch-1 loop over synthetic scenes with the
per-stage ms / fps report of the reference's six timers (counterpart of the
JAX package's `cli/inference.py`), on CUDA unless `--device cpu` is given.

    python -m fastposecnn_tpu_torch.cli.inference --synthetic 8 --stage_timing \
        [--CHECKPOINT weights.npz] [--device cpu]

`forward` times the network and every post-network stage of one frame
(the INFERENCE preset's single 4096-hypothesis vote); `--stage_timing` runs
the frame a second time stage by stage, each stage fed the previous one's
output, and times `model`, `class_compress`, `aggregation`,
`hough_voting` and `rt_calculation` alone, all in full float32 (TF32
off). On CUDA the timers are CUDA events, read after each frame, and
the CC kernel's error flags are read after them. The figures of the JAX CLI
(`--output`, `--draw`) and its profiler trace are not ported.
"""

from __future__ import annotations

import argparse

import torch

from fastposecnn_tpu_torch import config as C
from fastposecnn_tpu_torch import pipeline as P
from fastposecnn_tpu_torch.cli.evaluate import build_network, inverse_intrinsics, scene_source
from fastposecnn_tpu_torch.device import full_float32, resolve_device
from fastposecnn_tpu_torch.ops.connected_components import raise_on_error_flag
from fastposecnn_tpu_torch.utils.timer import StageTimer, report_runtime

TIMERS = {
    "forward": "forward",
    "model": "model",
    "class_compress": "Class Compression",
    "aggregation": "Aggregation",
    "hough_voting": "Hough Voting",
    "rt_calculation": "RT Calculation",
}


def main(argv=None) -> dict:
    """Run the loop; returns {stage: average ms} and the frame count."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--valid_dir", default=None,
                        help="a NOCS folder on disk (not ported: use --synthetic)")
    parser.add_argument("--synthetic", type=int, default=0)
    parser.add_argument("--synthetic_pose_cues", action="store_true")
    parser.add_argument("--synthetic_cue_boost", action="store_true")
    parser.add_argument("--synthetic_seed", type=int, default=999983)
    parser.add_argument("--stage_timing", action="store_true")
    parser.add_argument("--device", default=None, help="'cuda' (the default) or 'cpu'")
    C.add_cli_overrides(parser, C.HParams())
    args = parser.parse_args(argv)

    hp = C.apply_cli_overrides(C.inference(), args)
    device = resolve_device(args.device)
    if hp.CHECKPOINT:
        from fastposecnn_tpu_torch.models.weights import merge_arch_from_any

        hp = merge_arch_from_any(hp.CHECKPOINT, hp)
    from fastposecnn_tpu_torch.data.loader import iterate_batches, pad_batch, upcast_batch

    source = scene_source(hp, args)
    net, hp = build_network(hp, device)
    pcfg = C.pipeline_config_from(hp)
    pcfg.check_ported()
    inv_K = inverse_intrinsics(hp, device)
    gens = dict(generator=torch.Generator(device).manual_seed(0),
                cpu_generator=torch.Generator().manual_seed(0))
    timers = {k: StageTimer(name, device) for k, name in TIMERS.items()}

    frames = 0
    with torch.inference_mode(), full_float32():
        for batch in iterate_batches(source, 1):
            if batch is None:
                continue
            image = upcast_batch(pad_batch(batch, 1)[0], device)["image"]
            with timers["forward"].measure():
                out = P.run_pipeline(net(image), pcfg, inv_K, **gens)
            flags = [out["aggregated"]["cc_error"]]
            if args.stage_timing:
                with timers["model"].measure():
                    logits = net(image)
                with timers["class_compress"].measure():
                    cat = P.stage_class_compress(logits)
                with timers["aggregation"].measure():
                    agg = P.stage_aggregate(cat, pcfg)
                flags.append(agg["cc_error"])
                with timers["hough_voting"].measure():
                    agg = P.stage_hough_voting(agg, pcfg, **gens)
                with timers["rt_calculation"].measure():
                    P.stage_rt_calculation(agg, inv_K)
            frames += 1
            for t in timers.values():
                t.flush()
            # The CC kernel's error flags, read after the frame's timers.
            for err in flags:
                raise_on_error_flag(err)
    report_runtime(timers)
    return {"frames": frames, "device": str(device),
            "stage_ms": {k: t.average for k, t in timers.items() if t.times_ms}}


if __name__ == "__main__":
    main()
