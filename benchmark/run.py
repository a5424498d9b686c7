"""Run one cell of the benchmark of `fastposecnn_tpu_torch` once.

    python3 benchmark/run.py --workload r18-serve --seed 7 --seconds 10 --trace 0

The cell's configuration, traffic mix and driver are found by the names in
BENCHMARK.json (see `harness.py`). With `--trace 0` the result line holds
the cell's end-to-end metrics, with `--trace 1` its per-layer metrics, read
from a traced window by `metrics/<name>.py`. Every run judges what the
program produced against the plain reference (`reference/`), prints each
number compared beside its limit as the last lines of standard error and
under the result line's last key, `checks`, and prints the result as the
last line of standard output.

A run exits non-zero with no result when the card or a file is missing, or
when JAX, flax or the JAX package was loaded.

For the readings that set the limits: `--control tf32|fp8` puts the
reference, computed in that lower precision, in the program's place;
`--fault count|state_unchanged|half_batch` plants a fault in the program;
`--device cpu` runs without the card (at the sizes of `--small`, for the
tests).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
CHECKOUT = HERE.parent


def build_caches() -> None:
    """Kernel and build caches at fixed paths inside the checkout (the
    port's own kernels build into `fastposecnn_tpu_torch/_build/`)."""
    cache = CHECKOUT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32", "fp8"), default=None)
    ap.add_argument("--fault", choices=("count", "state_unchanged", "half_batch"),
                    default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", default=None,
                    help="JSON of configuration and traffic keys to override")
    return ap.parse_args(argv)


def run_cell(args, t0: float) -> dict:
    """Drive one run; returns the result's fields (raises `Refused`)."""
    import torch

    import harness

    cell = harness.find_cell(args.workload)
    if args.small:
        small = json.loads(args.small)
        cell.config.update(small.get("config", {}))
        cell.traffic.update(small.get("traffic", {}))
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise harness.Refused("CUDA is not available")
        if torch.cuda.device_count() < cell.workload["chips"]:
            raise harness.Refused(f"the cell needs {cell.workload['chips']} cards, "
                                  f"{torch.cuda.device_count()} found")
    torch.manual_seed(args.seed)
    driver = harness.load_driver(cell)
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace), device, t0,
                     control=args.control, fault=args.fault)
    ok, checks = harness.judge(out["numbers"], cell.traffic["limits"])
    metrics = {}
    result = {"correct": ok and out["failed"] == 0, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": out["device"]}
    if "record" in out:
        record = out["record"]
        for m in cell.per_layer():
            value = harness.load_metric(cell.root, m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["device"].update(busy_s=record.busy_s, window_s=record.window_s)
        result["breakdown"] = harness.breakdown(record)
    elif "metrics" in out:  # a control's run has no window
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": out["metrics"][m["name"]], "unit": m["unit"]}
    result["card"] = harness.power_limit() if device.type == "cuda" else "cpu"
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse(argv)
    build_caches()
    sys.path[:0] = [str(HERE), str(CHECKOUT)]
    try:
        import harness
    except ImportError as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 2
    try:
        result = run_cell(args, T0)
    except (harness.Refused, ImportError) as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 2
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
