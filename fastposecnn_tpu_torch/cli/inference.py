"""Real-time inference CLI: a batch-1 loop over synthetic scenes with the
per-stage ms / fps report of the reference's six timers (counterpart of the
JAX package's `cli/inference.py`), on CUDA unless `--device cpu` is given.

    python -m fastposecnn_tpu_torch.cli.inference (--synthetic 8 | --valid_dir D) \
        [--stage_timing] [--output DIR [--draw N]] [--trace DIR] \
        [--CHECKPOINT weights.npz|ref.ckpt|checkpoints/best] [--device cpu]

`forward` times the network and every post-network stage of one frame
(the INFERENCE preset's single 4096-hypothesis vote) and the host's read
of the CC kernel's error flag; `--stage_timing` runs the frame a second
time stage by stage, each stage fed the previous one's output, and times
`model`, `class_compress`, `aggregation`, `hough_voting` and
`rt_calculation` alone, all in full float32 (TF32 off). The loop runs with
the port's tracer on (`utils.timer.tracing()`), and each timer reads the
tracer's span of its stage (`TIMERS`); on CUDA a span's time is a CUDA
event pair, read after the loop.

`--output DIR` saves a summary figure of each of the first `--draw` frames
(default 20) as DIR/<frame>.png: the image, the predicted and GT masks, the
GT and predicted poses (predictions matched to the GT by mask IoU), the
voted centres and the first instance's hypothesis cloud. It needs
matplotlib and cv2; without them the CLI raises before the first frame and
names the package. `--trace DIR` records the loop with `torch.profiler`
(the host and, on CUDA, the card's kernels) and writes a Chrome trace,
DIR/trace.json; it needs no other package.

The `--trace` file holds the tracer's spans as ranges, nested on the
host's timeline: `fpc/frame` around each frame, `fpc/network` around the
network, `fpc/stages` around the post-network stages with
`fpc/class_compress`, `fpc/aggregate`, `fpc/vote` and `fpc/rt` inside,
and `fpc/host_read/cc_flag` where the host reads the flag. The returned
summary holds the tracer's counts a frame (`counts_per_frame`:
`launch/<kernel>`, `host_read/<site>`, `vote_rounds`).
"""

from __future__ import annotations

import argparse
import contextlib
import pathlib

import numpy as np
import torch

from fastposecnn_tpu_torch import config as C
from fastposecnn_tpu_torch import pipeline as P
from fastposecnn_tpu_torch.cli.evaluate import build_network, inverse_intrinsics, scene_source
from fastposecnn_tpu_torch.device import full_float32, resolve_device
from fastposecnn_tpu_torch.ops.connected_components import raise_on_error_flag
from fastposecnn_tpu_torch.utils import timer

# The reference's six timers: {key: (the tracer's span it reads, its label)}.
TIMERS = {
    "forward": ("frame", "forward"),
    "model": ("network", "model"),
    "class_compress": ("class_compress", "Class Compression"),
    "aggregation": ("aggregate", "Aggregation"),
    "hough_voting": ("vote", "Hough Voting"),
    "rt_calculation": ("rt", "RT Calculation"),
}


def main(argv=None) -> dict:
    """Run the loop; returns the frame count, {stage: average ms}, the
    tracer's counts a frame, the figures written and the trace's path
    (with `--trace`)."""
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--valid_dir", default=None, help="a NOCS folder on disk")
    parser.add_argument("--synthetic", type=int, default=0)
    parser.add_argument("--synthetic_pose_cues", action="store_true")
    parser.add_argument("--synthetic_cue_boost", action="store_true")
    parser.add_argument("--synthetic_seed", type=int, default=999983)
    parser.add_argument("--output", default=None, help="dir for the figures")
    parser.add_argument("--draw", type=int, default=20,
                        help="save figures of the first N frames (with --output)")
    parser.add_argument("--stage_timing", action="store_true")
    parser.add_argument("--trace", default=None,
                        help="write a torch.profiler Chrome trace into this dir")
    parser.add_argument("--device", default=None, help="'cuda' (the default) or 'cpu'")
    C.add_cli_overrides(parser, C.HParams())
    args = parser.parse_args(argv)

    hp = C.apply_cli_overrides(C.inference(), args)
    device = resolve_device(args.device)
    if hp.CHECKPOINT:
        from fastposecnn_tpu_torch.train.checkpoint import merge_arch_from_any

        hp = merge_arch_from_any(hp.CHECKPOINT, hp)
    from fastposecnn_tpu_torch.data.loader import iterate_batches, pad_batch, upcast_batch

    source = scene_source(hp, args)
    net, hp = build_network(hp, device)
    pcfg = C.pipeline_config_from(hp)
    pcfg.check_ported()
    inv_K = inverse_intrinsics(hp, device)
    gens = dict(generator=torch.Generator(device).manual_seed(0),
                cpu_generator=torch.Generator().manual_seed(0))
    out_dir = pathlib.Path(args.output) if args.output else None
    if out_dir and args.draw > 0:
        from fastposecnn_tpu_torch.utils.optional import need, pyplot

        pyplot("the inference CLI's --output figures")
        need("cv2", "the inference CLI's --output figures")
        out_dir.mkdir(parents=True, exist_ok=True)
    profiler = contextlib.nullcontext()
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)

    frames, figures = 0, []
    with timer.tracing() as window, profiler as prof, torch.inference_mode(), full_float32():
        for batch in iterate_batches(source, 1):
            if batch is None:
                continue
            batch = pad_batch(batch, 1)[0]
            db = upcast_batch(batch, device)
            image = db["image"]
            with timer.span("frame"):
                with timer.span("network"):
                    logits = net(image)
                out = P.run_pipeline(logits, pcfg, inv_K, **gens)
                raise_on_error_flag(out["aggregated"]["cc_error"])
            if args.stage_timing:
                with timer.span("network"):
                    logits = net(image)
                cat = P.stage_class_compress(logits)
                agg = P.stage_aggregate(cat, pcfg)
                agg = P.stage_hough_voting(agg, pcfg, **gens)
                P.stage_rt_calculation(agg, inv_K)
                raise_on_error_flag(agg["cc_error"])
            if out_dir and frames < args.draw:
                figures.append(save_frame_figure(out, db, batch, hp, out_dir / f"{frames:04d}.png"))
            frames += 1
    stage_ms = timer.stage_ms(window, {k: span for k, (span, _) in TIMERS.items()})
    print(timer.report_runtime({TIMERS[k][1]: ms for k, ms in stage_ms.items()}))
    summary = {"frames": frames, "device": str(device), "figures": figures,
               "stage_ms": stage_ms,
               "counts_per_frame": {k: v / max(frames, 1)
                                    for k, v in sorted(window.counts.items())}}
    if args.trace:
        trace_dir = pathlib.Path(args.trace)
        trace_dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace_dir / "trace.json"))
        summary["trace"] = str(trace_dir / "trace.json")
    return summary


def save_frame_figure(out, db, batch, hp, path: pathlib.Path) -> str:
    """The summary figure of one frame (the JAX CLI's): the image, the
    predicted and GT masks, the GT and predicted poses of the matched
    instances, the voted centres and the first valid slot's hypothesis
    cloud; returns the path written."""
    from fastposecnn_tpu_torch import constants
    from fastposecnn_tpu_torch.ops.matching import gather_matched, match_instances
    from fastposecnn_tpu_torch.utils import visualize as vz
    from fastposecnn_tpu_torch.utils.optional import pyplot

    agg = out["aggregated"]
    matched = gather_matched(agg, db["agg"], match_instances(agg, db["agg"]),
                             keys=("scales", "RT"))
    m = {k: v[0].cpu().numpy() for k, v in matched.items()}
    a = {k: agg[k][0].cpu().numpy() for k in ("valid", "xy", "hypothesis", "pruned_hypothesis")}
    pred_mask = out["categorical"]["mask"][0].cpu().numpy()
    img = vz.denormalize_image(np.asarray(batch["image"][0]))
    intrinsics = constants.scaled_intrinsics(hp.DATASET_NAME, hp.IMAGE_HEIGHT, hp.IMAGE_WIDTH)
    slot = int(np.argmax(a["valid"])) if a["valid"].any() else 0
    fig = vz.make_summary_figure(
        rgb=img,
        pred_mask=vz.colorize_mask(pred_mask, hp.num_classes),
        gt_mask=vz.colorize_mask(np.asarray(batch["mask"][0]), hp.num_classes),
        pose=vz.compare_pose_performance(img, m["gt_RT"], m["gt_scales"], m["pred_RT"],
                                         m["pred_scales"], m["valid"], intrinsics),
        hough=vz.visualize_hypothesis(img, a["xy"], a["valid"]),
        hough_cloud=vz.visualize_hough_voting(pred_mask, a["hypothesis"][slot],
                                              a["pruned_hypothesis"][slot], a["xy"][slot]),
    )
    fig.savefig(str(path))
    pyplot("the inference CLI's --output figures").close(fig)
    return str(path)


if __name__ == "__main__":
    main()
