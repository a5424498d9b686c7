"""Two-phase evaluation CLI (counterpart of the JAX package's
`cli/evaluate.py`), on CUDA unless `--device cpu` is given.

    python -m fastposecnn_tpu_torch.cli.evaluate (--synthetic 8 | --valid_dir D) \
        --output out [--draw N] [--CHECKPOINT weights.npz|ref.ckpt|checkpoints/best] \
        [--device cpu] [--HV_NUM_OF_HYPOTHESES ...]

Phase A (skipped when `raw_errors_<VALID_SIZE>.npz` exists in --output):
the validation scenes go through the network and the post-network stages
of the EVALUATING preset (adaptive RANSAC), GT and predictions are matched
by mask IoU, and the per-class raw errors (3D IoU, rotation in degrees as
the reference's chord metric and as the true geodesic angle, offset in cm)
are computed on the host in float64 and saved. `--draw N` saves the
comparison figures of the first image of each of the first N batches
(`eval_<batch>_{gt,pred,poses}.png`, `utils.visualize.compare_all_performance`);
they need matplotlib and cv2, and without them the CLI raises before phase
A and names the package. Phase B: 50-point AP curves and the table APs at
{IoU .25/.5, 5/10 deg, 5/10 cm} with the joint 5deg5cm / 10deg5cm /
10deg10cm APs. The curves are plotted into
`all_metrics_<VALID_SIZE>_aps.png` when matplotlib imports (else phase B
says that it has no plot and why). The table and the curves go through
`utils.report.save_aps` to `<VALID_SIZE>_aps_values_table.xlsx` and
`<VALID_SIZE>_aps_curves.xlsx` with pandas and an Excel engine, else to one
CSV per metric in `<VALID_SIZE>_aps_values_table/` and
`<VALID_SIZE>_aps_curves/` (numpy alone, so they are written on every
machine).

The scenes are a NOCS folder (`--valid_dir`, read by `data.nocs.NOCSDataset`
as the JAX CLI reads it) or the in-memory synthetic source (`--synthetic N`,
the same scenes as the JAX CLI writes and reads back for the same seed).

`--NUM_DEVICES N [--NUM_TP T]` runs phase A over the JAX CLI's mesh
`make_mesh(N, tp=T)`: N ranks (`parallel.mesh.launch`; one a card over
NCCL, or N gloo processes with `--device cpu`), rank r at (r // T, r %
T). Each of the N / T data ranks loads and runs its rows of every batch
of `BATCH_SIZE`, with the vote draws of the whole batch, and the matched
values are gathered in the single-device order, so the raw errors equal
the single-device ones; with T above 1 the network's wide convolutions
are sharded over the T ranks of each group (`mesh.shard_state_tp`, as the
JAX CLI shards its state). With fewer cards than N, or a `BATCH_SIZE`
that N / T does not divide, it warns and evaluates on one device, as the
JAX CLI does; a T that does not divide N raises.
"""

from __future__ import annotations

import argparse
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
from fastposecnn_tpu_torch.parallel import mesh
from fastposecnn_tpu_torch.utils.report import save_aps
from fastposecnn_tpu_torch.utils import timer

APS_NUM_OF_POINTS = 50
# Phase A's stage report: {stage: the tracer's span it reads}.
STAGES = {"model": "network", "class_compress": "class_compress",
          "aggregation": "aggregate", "hough_voting": "vote",
          "rt_calculation": "rt", "matching": "matching", "errors": "errors"}
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
                       draw: int = 0, draw_dir=None):
    """Phase A: forward, match and per-class raw errors over `batches`
    (collated numpy batches, None for an all-rejected one).

    The network and the stages after it run in full float32 (TF32 off).
    Batch `bi` votes with `draws_for(bi)` when given, else with fresh draws
    from `generator` and `cpu_generator`. The CC kernel's error flag is
    read once a batch, after the matched values are read back, and raises
    if set. Inside a process group (`parallel.mesh`), `batches` are this
    rank's rows of each batch (None where it has none), the draws are the
    whole batch's, a flag set on any rank raises on every rank, and the
    matched values of the ranks are gathered in row order before the
    errors, which every rank computes alike. With `draw` and `draw_dir`,
    the first `draw` batches' comparison figures go to `draw_dir`
    (`save_comparison_figure`; this rank's first image). Returns (raw errors
    {metric: {class: float64 array}}, stats {frames, batches, vote_rounds
    per batch, seconds, and the first batch's frames and seconds, which
    include cuDNN timing its algorithms for the batch's shape}). Each stage
    is a span of the tracer (`STAGES`), which a caller's
    `timer.tracing()` window keeps."""
    from fastposecnn_tpu_torch.data.loader import empty_batch, pad_batch, upcast_batch
    from fastposecnn_tpu_torch.ops.matching import gather_matched, match_instances

    num_classes = hp.num_classes
    raw = {m: {c: [] for c in range(1, num_classes)} for m in METRICS}
    stats = {"frames": 0, "batches": 0, "vote_rounds": []}
    t0 = time.perf_counter()
    ranks = mesh.dp_size()
    for bi, batch in enumerate(batches):
        if batch is None:
            if ranks == 1:
                continue
            batch = empty_batch(hp.IMAGE_HEIGHT, hp.IMAGE_WIDTH, hp.MAX_INSTANCES)
        batch, n_real = pad_batch(batch, hp.BATCH_SIZE // ranks)
        db = upcast_batch(batch, device)
        draws = draws_for(bi) if draws_for is not None else None
        with torch.inference_mode(), full_float32():
            with timer.span("network"):
                logits = net(db["image"])
            cat = P.stage_class_compress(logits)
            agg = P.stage_aggregate(cat, pcfg)
            agg = P.stage_hough_voting(agg, pcfg, draws, generator, cpu_generator)
            agg = P.stage_rt_calculation(agg, inv_K)
            with timer.span("matching"):
                match = match_instances(agg, db["agg"])
                matched = gather_matched(
                    agg, db["agg"], match,
                    keys=("quaternion", "scales", "z", "xy", "T", "R", "RT"))
        if draw_dir is not None and bi < draw:
            save_comparison_figure(hp, batch, matched, cat, agg, bi, draw_dir)
        with timer.span("errors"):
            m = {k: v.cpu().numpy() for k, v in matched.items()}
            real = np.arange(len(m["valid"])) < n_real
            # After the readback above, which waited for the batch.
            cc_error = agg["cc_error"]
            if ranks > 1:
                if cc_error is not None:
                    cc_error = mesh.global_sum(cc_error, over="world")
                parts = mesh.all_gather_object((m, real))
                m = {k: np.concatenate([part[k] for part, _ in parts]) for k in m}
                real = np.concatenate([r for _, r in parts])
                n_real = int(real.sum())
            raise_on_error_flag(cc_error)
            if not n_real:  # every sample of the batch rejected
                continue
            m = {k: v[real] for k, v in m.items()}
            errors = instance_errors(m, fpc_compat_iou)
            for c in range(1, num_classes):
                sel = m["valid"] & (m["class_ids"] == c)
                for metric, values in errors.items():
                    raw[metric][c].append(values[sel])
        stats["frames"] += n_real
        stats["batches"] += 1
        stats["vote_rounds"].append(agg.get("vote_rounds"))  # None: soft voting
        if stats["batches"] == 1:
            stats["first_batch_frames"] = n_real
            stats["first_batch_seconds"] = time.perf_counter() - t0
    stats["seconds"] = time.perf_counter() - t0
    raw = {metric: {c: np.concatenate(v) if v else np.zeros((0,))
                    for c, v in per.items()}
           for metric, per in raw.items()}
    return raw, stats


def save_comparison_figure(hp, batch, matched, cat, agg, bi: int, draw_dir) -> None:
    """The gt / pred / poses figures of a batch's first image, as
    `eval_<bi>_{gt,pred,poses}.png` (the reference's DRAW option,
    FPC/evaluate.py:161-187; the JAX CLI's `_save_comparison_figure`)."""
    from fastposecnn_tpu_torch.utils import visualize as vz
    from fastposecnn_tpu_torch.utils.optional import pyplot

    def first(d):
        return {k: v[0].cpu().numpy() for k, v in d.items() if isinstance(v, torch.Tensor)}

    intr = constants.scaled_intrinsics(hp.DATASET_NAME, hp.IMAGE_HEIGHT, hp.IMAGE_WIDTH)
    figs = vz.compare_all_performance(
        vz.denormalize_image(np.asarray(batch["image"][0])), first(cat), hp.num_classes,
        gt_mask=np.asarray(batch["mask"][0]), matched=first(matched),
        aggregated=first(agg), intrinsics=intr)
    plt = pyplot("the evaluate CLI's --draw figures")
    for name, fig in zip(("gt", "pred", "poses"), figs):
        fig.savefig(str(pathlib.Path(draw_dir) / f"eval_{bi:04d}_{name}.png"))
        plt.close(fig)


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


def save_ap_plot(path: pathlib.Path, figure_aps, thresholds, names) -> str:
    """Phase B's AP curves (`utils.visualize.plot_aps`) at `path`; without
    matplotlib, no plot: returns the reason instead of the path."""
    from fastposecnn_tpu_torch.utils import visualize as vz
    from fastposecnn_tpu_torch.utils.optional import pyplot

    try:
        plt = pyplot("phase B's AP plot")
    except ImportError as e:
        return f"no plot: {e}"
    fig = vz.plot_aps(
        figure_aps, thresholds,
        titles={"3d_iou": "3D Iou AP", "degree_error": "Rotation AP",
                "degree_error_geodesic": "Rotation AP (geodesic)",
                "offset_error": "Translation AP"},
        x_labels={"3d_iou": "3D IoU %", "degree_error": "Rotation error/degree",
                  "degree_error_geodesic": "True rotation error/degree",
                  "offset_error": "Translation error/cm"},
        cls_names=names)
    fig.savefig(str(path))
    plt.close(fig)
    return str(path)


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
    parser.add_argument("--valid_dir", default=None, help="a NOCS folder on disk")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="evaluate on this many in-memory synthetic scenes")
    parser.add_argument("--synthetic_pose_cues", action="store_true")
    parser.add_argument("--synthetic_cue_boost", action="store_true")
    parser.add_argument("--synthetic_seed", type=int, default=999983,
                        help="scene seed for --synthetic (the JAX CLI's default)")
    parser.add_argument("--output", default="eval_output")
    parser.add_argument("--draw", type=int, default=0,
                        help="save comparison figures of the first N batches")
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
    """The scenes to evaluate: `--synthetic N` in memory, else the folder
    `--valid_dir`."""
    from fastposecnn_tpu_torch.data.nocs import NOCSDataset, SyntheticNOCSSource
    from fastposecnn_tpu_torch.data.synthetic import SceneConfig

    common = dict(dataset_name=hp.DATASET_NAME, selected_classes=hp.SELECTED_CLASSES,
                  max_size=hp.VALID_SIZE, max_instances=hp.MAX_INSTANCES)
    if not args.synthetic:
        if not args.valid_dir:
            raise SystemExit("No dataset: pass --valid_dir or --synthetic N")
        return NOCSDataset(args.valid_dir, **common)
    cfg = SceneConfig(height=hp.IMAGE_HEIGHT, width=hp.IMAGE_WIDTH,
                      num_classes=hp.num_classes, max_instances=hp.MAX_INSTANCES,
                      render_pose_cues=args.synthetic_pose_cues,
                      cue_boost=args.synthetic_cue_boost)
    return SyntheticNOCSSource(args.synthetic, args.synthetic_seed, cfg, **common)


def build_network(hp, device):
    """The network on `device`, its encoder `hp.ENCODER` after the
    checkpoint's arch fields are merged, with the weights of
    `hp.CHECKPOINT` (an npz snapshot, a reference torch checkpoint or a full
    checkpoint of the port's trainer, `train.checkpoint.load_weights`) or
    random ones from seed 0. Returns (net, hp with the checkpoint's arch
    fields)."""
    from fastposecnn_tpu_torch.models import PoseRegressorNet
    from fastposecnn_tpu_torch.models.weights import init_random_
    from fastposecnn_tpu_torch.train.checkpoint import load_weights, merge_arch_from_any

    if hp.CHECKPOINT:
        hp = merge_arch_from_any(hp.CHECKPOINT, hp)
    net = PoseRegressorNet(num_classes=hp.num_classes, encoder_name=hp.ENCODER)
    if hp.CHECKPOINT:
        hp = load_weights(net, hp.CHECKPOINT, hp)
    else:
        init_random_(net, 0)
    return net.eval().to(device), hp


def inverse_intrinsics(hp, device) -> torch.Tensor:
    K = constants.scaled_intrinsics(hp.DATASET_NAME, hp.IMAGE_HEIGHT, hp.IMAGE_WIDTH)
    return torch.tensor(np.linalg.inv(K), dtype=torch.float32, device=device)


def phase_a_layout(hp, device) -> Optional[mesh.Mesh]:
    """The layout of phase A (`--NUM_DEVICES`, `--NUM_TP`), or None (one
    device) with the JAX CLI's warnings: fewer cards than asked, or a
    `BATCH_SIZE` that the dp = NUM_DEVICES // NUM_TP ranks do not divide
    (`cli/evaluate.py:320-341` of the JAX package). A `--NUM_TP` below 1,
    or that does not divide the ranks, raises."""
    n = hp.NUM_DEVICES
    if n <= 1:
        return None
    if hp.NUM_TP < 1:
        raise ValueError(f"--NUM_TP {hp.NUM_TP}: the 'tp' axis needs at least one rank")
    dp = max(n // hp.NUM_TP, 1)
    if device.type == "cuda" and torch.cuda.device_count() < n:
        print(f"WARNING: --NUM_DEVICES={n} requested but only "
              f"{torch.cuda.device_count()} device(s) visible — falling back to "
              "single-device evaluation.")
        return None
    if hp.BATCH_SIZE % dp:
        print(f"WARNING: --NUM_DEVICES={n} requested but BATCH_SIZE={hp.BATCH_SIZE} "
              f"is not divisible by dp={n}//NUM_TP({hp.NUM_TP})={dp} — falling back to "
              f"single-device evaluation. Pick a BATCH_SIZE that is a multiple of {dp}.")
        return None
    return mesh.make_mesh(n, tp=hp.NUM_TP)


def phase_a(hp, args, device):
    """Phase A on this rank (on its rows of each batch inside a process
    group): the scenes, the network and `collect_raw_errors` with the
    `--vote_seed` generators. Returns (raw errors, stats with the scene
    seconds, each stage's ms and their report)."""
    from fastposecnn_tpu_torch.data.loader import iterate_batches

    device = mesh.use_rank_device(device)
    t0 = time.perf_counter()
    source = scene_source(hp, args)
    scene_seconds = time.perf_counter() - t0
    net, hp = build_network(hp, device)
    mesh.shard_network_tp(net)  # every rank built the same weights
    pcfg = C.pipeline_config_from(hp)
    pcfg.check_ported()
    with timer.tracing() as window:
        raw, stats = collect_raw_errors(
            hp, iterate_batches(source, hp.BATCH_SIZE, shard=(mesh.dp_rank(), mesh.dp_size())),
            net, pcfg, inverse_intrinsics(hp, device), device,
            fpc_compat_iou=args.fpc_compat_iou,
            generator=torch.Generator(device).manual_seed(args.vote_seed),
            cpu_generator=torch.Generator().manual_seed(args.vote_seed),
            draw=args.draw, draw_dir=args.output if mesh.rank() == 0 else None)
    stage_ms = timer.stage_ms(window, STAGES)
    stats.update(scene_seconds=scene_seconds, stage_ms=stage_ms,
                 stage_report=timer.report_runtime(stage_ms))
    return raw, stats


def main(argv=None) -> dict:
    """Run both phases; returns a summary (phase A's stats and stage ms when
    it ran, the mean table APs, the pooled rotation means)."""
    args = build_parser().parse_args(argv)
    hp = C.apply_cli_overrides(C.evaluating(), args)
    device = resolve_device(args.device)
    if hp.CHECKPOINT:
        from fastposecnn_tpu_torch.train.checkpoint import merge_arch_from_any

        hp = merge_arch_from_any(hp.CHECKPOINT, hp)

    out_dir = pathlib.Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    results_path = out_dir / f"raw_errors_{hp.VALID_SIZE}.npz"
    class_names = list(hp.SELECTED_CLASSES)
    summary: dict = {"device": str(device)}

    if not results_path.exists():
        if args.draw > 0:
            from fastposecnn_tpu_torch.utils.optional import need, pyplot

            pyplot("the evaluate CLI's --draw figures")
            need("cv2", "the evaluate CLI's --draw figures")
        layout = phase_a_layout(hp, device)
        if layout is not None:
            print(f"phase A: data-parallel over {layout.shape} mesh")
            raw, stats = mesh.launch(phase_a, layout.size, (hp, args, device),
                                     backend=mesh.default_backend(device), layout=layout,
                                     threads=mesh.cpu_threads(layout.size, device))[0]
        else:
            raw, stats = phase_a(hp, args, device)
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
        print(stats.pop("stage_report"))
        summary.update(stats, frames_per_s=fps, frames_per_s_after_first_batch=fps_after)
    else:
        print(f"phase A skipped: {results_path} exists")
        summary["phase_a_skipped"] = True

    # ---- Phase B ----
    raw = load_raw(results_path)
    figure_aps, fig_thr, table_aps, table_thr = compute_aps(raw, class_names)
    names = class_names[1:] + ["mean"]
    plot = save_ap_plot(out_dir / f"all_metrics_{hp.VALID_SIZE}_aps.png", figure_aps,
                        fig_thr, names)
    tables = save_aps(out_dir / f"{hp.VALID_SIZE}_aps_values_table.xlsx", table_thr,
                      table_aps, names)
    curves = save_aps(out_dir / f"{hp.VALID_SIZE}_aps_curves.xlsx", fig_thr,
                      figure_aps, names)
    print(f"phase B: plot -> {plot}, tables -> {tables}, curves -> {curves}")
    summary.update(ap_plot=plot, ap_tables=str(tables), ap_curves=str(curves))
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
