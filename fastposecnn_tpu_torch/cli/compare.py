"""Compare phase-A raw errors (`raw_errors_<N>.npz` of either package's
evaluate CLI) with a reference file.

    python -m fastposecnn_tpu_torch.cli.compare REFERENCE.npz OTHER.npz [...]

For each file: the instances per metric, the pooled mean of each metric and
its difference from the reference's, and the largest per-instance
difference (only where both files hold the same instances per class).
"""

from __future__ import annotations

import argparse

import numpy as np

from fastposecnn_tpu_torch.cli.evaluate import load_raw


def compare(reference: str, others) -> list:
    ref = load_raw(reference)
    rows = []
    for path in others:
        raw = load_raw(path)
        for metric, per_class in ref.items():
            a = np.concatenate([raw[metric][c] for c in sorted(per_class)])
            b = np.concatenate([per_class[c] for c in sorted(per_class)])
            same = all(raw[metric][c].shape == per_class[c].shape for c in per_class)
            rows.append(dict(file=path, metric=metric, instances=int(a.size),
                             mean=float(a.mean()) if a.size else None,
                             mean_minus_reference=float(a.mean() - b.mean())
                             if a.size and b.size else None,
                             max_abs_diff=float(np.abs(a - b).max())
                             if same and a.size else None))
    return rows


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("reference")
    parser.add_argument("others", nargs="+")
    args = parser.parse_args(argv)
    rows = compare(args.reference, args.others)
    for r in rows:
        print(f"{r['file']}  {r['metric']:<22} n={r['instances']:<4} mean={r['mean']!r} "
              f"minus_ref={r['mean_minus_reference']!r} max|diff|={r['max_abs_diff']!r}")
    return rows


if __name__ == "__main__":
    main()
