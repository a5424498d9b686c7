"""Two-phase evaluation CLI (counterpart of the JAX package's
`cli/evaluate.py`), on CUDA unless `--device cpu` is given.

    python -m fastposecnn_tpu_torch.cli.evaluate --synthetic 8 --output out \
        [--CHECKPOINT weights.npz] [--device cpu] [--HV_NUM_OF_HYPOTHESES ...]

Phase A (skipped when `raw_errors_<VALID_SIZE>.npz` exists in --output):
the validation scenes go through the network and the post-network stages
of the EVALUATING preset (adaptive RANSAC), GT and predictions are matched
by mask IoU, and the per-class raw errors (3D IoU, rotation in degrees as
the reference's chord metric and as the true geodesic angle, offset in cm)
are computed on the host in float64 and saved. Phase B: 50-point AP curves
and the table APs at {IoU .25/.5, 5/10 deg, 5/10 cm} with the joint
5deg5cm / 10deg5cm / 10deg10cm APs, written as CSV (one file per metric,
classes as columns) and JSON with numpy alone.

The scenes are the in-memory synthetic source (`--synthetic N`, the same
scenes as the JAX CLI's for the same seed); reading NOCS folders from disk,
the AP plot and the xlsx table, `--draw` and data-parallel evaluation are
not ported.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from fastposecnn_tpu_torch import config as C
from fastposecnn_tpu_torch import constants, eval_host
from fastposecnn_tpu_torch import pipeline as P
from fastposecnn_tpu_torch.device import full_float32, resolve_device
from fastposecnn_tpu_torch.ops.connected_components import raise_on_error_flag
from fastposecnn_tpu_torch.utils.timer import StageTimer, report_runtime

APS_NUM_OF_POINTS = 50
STAGES = ("model", "class_compress", "aggregation", "hough_voting",
          "rt_calculation", "matching", "errors")
METRICS = ("3d_iou", "degree_error", "degree_error_geodesic", "offset_error")


def instance_errors(m: Dict[str, np.ndarray], fpc_compat_iou: bool = False):
    """Float64 errors of every GT slot of a matched payload held in numpy:
    {metric: [B, G]}."""
    return {
        "degree_error": eval_host.quat_distance_deg(
            m["gt_quaternion"], m["pred_quaternion"], m["symmetric_ids"]),
        "degree_error_geodesic": eval_host.geodesic_quat_distance_deg(
            m["gt_quaternion"], m["pred_quaternion"], m["symmetric_ids"]),
        "3d_iou": eval_host.asymmetric_3d_iou(
            m["gt_RT"], m["pred_RT"], m["gt_scales"], m["pred_scales"],
            fpc_compat=fpc_compat_iou),
        "offset_error": eval_host.offset_error_cm(m["gt_T"], m["pred_T"]),
    }


def collect_raw_errors(hp, batches, net, pcfg, inv_K: torch.Tensor,
                       device: torch.device, fpc_compat_iou: bool = False,
                       draws_for: Optional[Callable[[int], object]] = None,
                       generator: Optional[torch.Generator] = None,
                       cpu_generator: Optional[torch.Generator] = None,
                       timers: Optional[Dict[str, StageTimer]] = None):
    """Phase A: forward, match and per-class raw errors over `batches`
    (collated numpy batches, None for an all-rejected one).

    The network and the stages after it run in full float32 (TF32 off).
    Batch `bi` votes with `draws_for(bi)` when given, else with fresh draws
    from `generator` and `cpu_generator`. The CC kernel's error flag is
    read once a batch, after the matched values are read back, and raises
    if set. Returns (raw errors
    {metric: {class: float64 array}}, stats {frames, batches, vote_rounds
    per batch, seconds, and the first batch's frames and seconds, which
    include cuDNN timing its algorithms for the batch's shape})."""
    from fastposecnn_tpu_torch.data.loader import pad_batch, upcast_batch
    from fastposecnn_tpu_torch.ops.matching import gather_matched, match_instances

    if timers is None:
        timers = {name: StageTimer(name, device) for name in STAGES}
    num_classes = hp.num_classes
    raw = {m: {c: [] for c in range(1, num_classes)} for m in METRICS}
    stats = {"frames": 0, "batches": 0, "vote_rounds": []}
    t0 = time.perf_counter()
    for bi, batch in enumerate(batches):
        if batch is None:
            continue
        batch, n_real = pad_batch(batch, hp.BATCH_SIZE)
        db = upcast_batch(batch, device)
        draws = draws_for(bi) if draws_for is not None else None
        with torch.inference_mode(), full_float32():
            with timers["model"].measure():
                logits = net(db["image"])
            with timers["class_compress"].measure():
                cat = P.stage_class_compress(logits)
            with timers["aggregation"].measure():
                agg = P.stage_aggregate(cat, pcfg)
            with timers["hough_voting"].measure():
                agg = P.stage_hough_voting(agg, pcfg, draws, generator,
                                           cpu_generator)
            with timers["rt_calculation"].measure():
                agg = P.stage_rt_calculation(agg, inv_K)
            with timers["matching"].measure():
                match = match_instances(agg, db["agg"])
                matched = gather_matched(
                    agg, db["agg"], match,
                    keys=("quaternion", "scales", "z", "xy", "T", "R", "RT"))
        with timers["errors"].measure():
            m = {k: v[:n_real].cpu().numpy() for k, v in matched.items()}
            # After the readback above, which waited for the batch.
            raise_on_error_flag(agg["cc_error"])
            errors = instance_errors(m, fpc_compat_iou)
            for c in range(1, num_classes):
                sel = m["valid"] & (m["class_ids"] == c)
                for metric, values in errors.items():
                    raw[metric][c].append(values[sel])
        stats["frames"] += n_real
        stats["batches"] += 1
        stats["vote_rounds"].append(agg["vote_rounds"])
        if stats["batches"] == 1:
            stats["first_batch_frames"] = n_real
            stats["first_batch_seconds"] = time.perf_counter() - t0
    stats["seconds"] = time.perf_counter() - t0
    raw = {metric: {c: np.concatenate(v) if v else np.zeros((0,))
                    for c, v in per.items()}
           for metric, per in raw.items()}
    return raw, stats


def compute_aps(raw, class_names):
    """Phase B: the AP curves and table APs, in float64 numpy."""
    figure_thresholds = {
        "3d_iou": np.linspace(0, 1, APS_NUM_OF_POINTS),
        "degree_error": np.linspace(0, 60, APS_NUM_OF_POINTS),
        "degree_error_geodesic": np.linspace(0, 60, APS_NUM_OF_POINTS),
        "offset_error": np.linspace(0, 10, APS_NUM_OF_POINTS),
    }
    table_thresholds = {
        "3d_iou": np.asarray([0.25, 0.50]),
        "degree_error": np.asarray([5.0, 10.0]),
        "degree_error_geodesic": np.asarray([5.0, 10.0]),
        "offset_error": np.asarray([5.0, 10.0]),
    }
    greater = {"3d_iou": True, "degree_error": False,
               "degree_error_geodesic": False, "offset_error": False}

    def build(thresholds):
        aps = {}
        for metric, per_class in raw.items():
            aps[metric] = {}
            curves = []
            for c, values in per_class.items():
                curve = eval_host.calculate_ap(
                    values, np.ones(values.shape, bool), thresholds[metric],
                    greater_is_better=greater[metric])
                aps[metric][class_names[c]] = curve
                curves.append(curve)
            aps[metric]["mean"] = np.mean(np.stack(curves), axis=0)
        return aps

    figure_aps = build(figure_thresholds)
    table_aps = build(table_thresholds)

    # Joint degree + offset APs at (5, 5), (10, 5), (10, 10).
    joint, curves = {}, []
    deg_t = np.asarray([5.0, 10.0, 10.0])
    off_t = np.asarray([5.0, 5.0, 10.0])
    for c in raw["degree_error"]:
        d = raw["degree_error"][c]
        curve = eval_host.calculate_joint_ap(
            d, raw["offset_error"][c], np.ones(d.shape, bool), deg_t, off_t)
        joint[class_names[c]] = curve
        curves.append(curve)
    joint["mean"] = np.mean(np.stack(curves), axis=0)
    table_aps["degree_error+offset_error"] = joint
    table_thresholds["degree_error+offset_error"] = np.asarray([5.5, 10.5, 10.10])
    return figure_aps, figure_thresholds, table_aps, table_thresholds


def save_aps(out_dir, thresholds, aps, cls_names) -> pathlib.Path:
    """One CSV per metric (thresholds as rows, classes as columns, APs in
    percent), in the layout of the JAX package's CSV fallback, plus
    `aps.json` holding the same numbers."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    as_json = {}
    for metric, per_class in aps.items():
        names = [n for n in cls_names if n in per_class]
        cols = [100 * np.asarray(per_class[n], np.float64) for n in names]
        lines = ["," + ",".join(names)]
        for i, t in enumerate(np.asarray(thresholds[metric], np.float64)):
            lines.append(",".join([repr(float(t))] + [repr(float(c[i])) for c in cols]))
        (out_dir / f"{metric}.csv").write_text("\n".join(lines) + "\n")
        as_json[metric] = {"thresholds": [float(t) for t in thresholds[metric]],
                           **{n: [float(v) for v in c] for n, c in zip(names, cols)}}
    (out_dir / "aps.json").write_text(json.dumps(as_json, indent=1))
    return out_dir


def load_raw(path) -> Dict[str, Dict[int, np.ndarray]]:
    raw: Dict[str, Dict[int, np.ndarray]] = {}
    with np.load(path) as loaded:
        for key in loaded.files:
            metric, c = key.rsplit("/", 1)
            raw.setdefault(metric, {})[int(c)] = loaded[key]
    return raw


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--valid_dir", default=None,
                        help="a NOCS folder on disk (not ported: use --synthetic)")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="evaluate on this many in-memory synthetic scenes")
    parser.add_argument("--synthetic_pose_cues", action="store_true")
    parser.add_argument("--synthetic_cue_boost", action="store_true")
    parser.add_argument("--synthetic_seed", type=int, default=999983,
                        help="scene seed for --synthetic (the JAX CLI's default)")
    parser.add_argument("--output", default="eval_output")
    parser.add_argument("--fpc_compat_iou", action="store_true",
                        help="the reference evaluator's 3D-IoU corner-axis "
                             "reduction quirk")
    parser.add_argument("--device", default=None,
                        help="'cuda' (the default) or 'cpu'")
    parser.add_argument("--vote_seed", type=int, default=0,
                        help="seed of the RANSAC draws")
    C.add_cli_overrides(parser, C.HParams())
    return parser


def scene_source(hp, args):
    from fastposecnn_tpu_torch.data.nocs import SyntheticNOCSSource
    from fastposecnn_tpu_torch.data.synthetic import SceneConfig

    if args.valid_dir or not args.synthetic:
        raise NotImplementedError(
            "reading NOCS folders from disk is not ported: pass --synthetic N")
    cfg = SceneConfig(height=hp.IMAGE_HEIGHT, width=hp.IMAGE_WIDTH,
                      num_classes=hp.num_classes, max_instances=hp.MAX_INSTANCES,
                      render_pose_cues=args.synthetic_pose_cues,
                      cue_boost=args.synthetic_cue_boost)
    return SyntheticNOCSSource(
        args.synthetic, args.synthetic_seed, cfg, dataset_name=hp.DATASET_NAME,
        selected_classes=hp.SELECTED_CLASSES, max_size=hp.VALID_SIZE,
        max_instances=hp.MAX_INSTANCES)


def build_network(hp, device):
    """The network on `device`, with the weights of `hp.CHECKPOINT` or
    random ones from seed 0. Returns (net, hp with the checkpoint's arch
    fields)."""
    from fastposecnn_tpu_torch.models import PoseRegressorNet
    from fastposecnn_tpu_torch.models.weights import init_random_, load_any_checkpoint

    state = None
    if hp.CHECKPOINT:
        state, hp = load_any_checkpoint(hp.CHECKPOINT, hp)
    if hp.ENCODER != "resnet18":
        raise NotImplementedError(f"ENCODER={hp.ENCODER!r}: only resnet18 is ported")
    net = PoseRegressorNet(num_classes=hp.num_classes)
    if state is None:
        init_random_(net, 0)
    else:
        net.load_state_dict(state)
    return net.eval().to(device), hp


def inverse_intrinsics(hp, device) -> torch.Tensor:
    K = constants.scaled_intrinsics(hp.DATASET_NAME, hp.IMAGE_HEIGHT, hp.IMAGE_WIDTH)
    return torch.tensor(np.linalg.inv(K), dtype=torch.float32, device=device)


def main(argv=None) -> dict:
    """Run both phases; returns a summary (phase A's stats and stage ms when
    it ran, the mean table APs, the pooled rotation means)."""
    args = build_parser().parse_args(argv)
    hp = C.apply_cli_overrides(C.evaluating(), args)
    device = resolve_device(args.device)
    if hp.CHECKPOINT:
        from fastposecnn_tpu_torch.models.weights import merge_arch_from_any

        hp = merge_arch_from_any(hp.CHECKPOINT, hp)

    out_dir = pathlib.Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    results_path = out_dir / f"raw_errors_{hp.VALID_SIZE}.npz"
    class_names = list(hp.SELECTED_CLASSES)
    summary: dict = {"device": str(device)}

    if not results_path.exists():
        from fastposecnn_tpu_torch.data.loader import iterate_batches

        t0 = time.perf_counter()
        source = scene_source(hp, args)
        summary["scene_seconds"] = time.perf_counter() - t0
        net, hp = build_network(hp, device)
        pcfg = C.pipeline_config_from(hp)
        pcfg.check_ported()
        timers = {name: StageTimer(name, device) for name in STAGES}
        raw, stats = collect_raw_errors(
            hp, iterate_batches(source, hp.BATCH_SIZE), net, pcfg,
            inverse_intrinsics(hp, device), device,
            fpc_compat_iou=args.fpc_compat_iou,
            generator=torch.Generator(device).manual_seed(args.vote_seed),
            cpu_generator=torch.Generator().manual_seed(args.vote_seed),
            timers=timers)
        np.savez(results_path,
                 **{f"{m}/{c}": v for m, per in raw.items() for c, v in per.items()})
        fps = stats["frames"] / stats["seconds"] if stats["seconds"] > 0 else 0.0
        fps_after, after = None, ""
        if stats["batches"] > 1:
            fps_after = ((stats["frames"] - stats["first_batch_frames"])
                         / (stats["seconds"] - stats["first_batch_seconds"]))
            after = f" ({fps_after:.2f} after the first batch)"
        print(f"phase A: wrote {results_path}")
        print(f"phase A: {stats['frames']} frames in {stats['batches']} batches "
              f"of {hp.BATCH_SIZE} on {device}, {stats['seconds']:.2f} s, "
              f"{fps:.2f} frames/s{after}; vote rounds per batch {stats['vote_rounds']}")
        report_runtime(timers)
        summary.update(stats, frames_per_s=fps, frames_per_s_after_first_batch=fps_after,
                       stage_ms={k: t.average for k, t in timers.items()})
    else:
        print(f"phase A skipped: {results_path} exists")
        summary["phase_a_skipped"] = True

    # ---- Phase B ----
    raw = load_raw(results_path)
    figure_aps, fig_thr, table_aps, table_thr = compute_aps(raw, class_names)
    names = class_names[1:] + ["mean"]
    tables = save_aps(out_dir / f"{hp.VALID_SIZE}_aps_values_table", table_thr,
                      table_aps, names)
    curves = save_aps(out_dir / f"{hp.VALID_SIZE}_aps_curves", fig_thr,
                      figure_aps, names)
    print(f"phase B: tables -> {tables}, curves -> {curves}")
    mean_ious = table_aps["3d_iou"]["mean"]
    mean_joint = table_aps["degree_error+offset_error"]["mean"]
    print(
        f"3D-IoU AP@0.25={100*mean_ious[0]:.2f} @0.5={100*mean_ious[1]:.2f} | "
        f"5d5cm={100*mean_joint[0]:.2f} 10d5cm={100*mean_joint[1]:.2f} "
        f"10d10cm={100*mean_joint[2]:.2f}"
    )
    summary["table_aps_mean"] = {m: [float(v) for v in per["mean"]]
                                 for m, per in table_aps.items()}
    all_geo = np.concatenate(list(raw["degree_error_geodesic"].values()))
    all_deg = np.concatenate(list(raw["degree_error"].values()))
    summary["instances"] = int(all_geo.size)
    if all_geo.size:
        print(f"rotation mean: geodesic={all_geo.mean():.1f} deg "
              f"(median {np.median(all_geo):.1f}) | "
              f"parity-chord={all_deg.mean():.1f} deg")
        summary["geodesic_mean_deg"] = float(all_geo.mean())
        summary["chord_mean_deg"] = float(all_deg.mean())
    return summary


if __name__ == "__main__":
    main()
