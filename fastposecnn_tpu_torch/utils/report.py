"""AP tables as an xlsx workbook or CSV files (counterpart of the JAX
package's `utils/report.py`; the reference's FPC/tools/excel_tools.py:8-48,
`save_aps_to_excel`): one sheet per metric, classes as columns, thresholds
as the index, APs in percent.

`save_aps` writes the xlsx through pandas when pandas and an Excel engine
(openpyxl) import; otherwise one CSV per metric in a directory beside the
requested path, with the text pandas' `to_csv` writes, through numpy and
`csv` alone (the GPU machine has no pandas).
"""

from __future__ import annotations

import csv
import math
import pathlib
from typing import Dict, Sequence

import numpy as np

from fastposecnn_tpu_torch.utils.optional import need


def _columns(per_class, cls_names):
    return {name: 100 * np.asarray(per_class[name]) for name in cls_names
            if name in per_class}


def aps_to_frames(thresholds: Dict[str, np.ndarray],
                  aps: Dict[str, Dict[str, np.ndarray]],
                  cls_names: Sequence[str]):
    """{metric: pandas.DataFrame} (needs pandas)."""
    pd = need("pandas", "aps_to_frames")
    return {metric: pd.DataFrame(_columns(per_class, cls_names),
                                 index=np.asarray(thresholds[metric]))
            for metric, per_class in aps.items()}


def _csv_text_cell(value: float) -> str:
    """A float as pandas' `to_csv` writes it: the shortest repr, and an
    empty cell for NaN."""
    value = float(value)
    return "" if math.isnan(value) else repr(value)


def _write_csv(path: pathlib.Path, thresholds, columns: Dict[str, np.ndarray]) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow([""] + list(columns))
        for i, t in enumerate(np.asarray(thresholds)):
            writer.writerow([_csv_text_cell(t)]
                            + [_csv_text_cell(c[i]) for c in columns.values()])


def save_aps(path, thresholds: Dict[str, np.ndarray],
             aps: Dict[str, Dict[str, np.ndarray]],
             cls_names: Sequence[str]) -> pathlib.Path:
    """The xlsx workbook at `path`, or (without pandas or an Excel engine)
    one `<metric>.csv` per metric under `path` without its suffix; returns
    what it wrote."""
    path = pathlib.Path(path)
    try:
        frames = aps_to_frames(thresholds, aps, cls_names)
        import pandas as pd

        with pd.ExcelWriter(path) as writer:
            for metric, frame in frames.items():
                frame.to_excel(writer, sheet_name=metric[:31])
        return path
    except (ImportError, ValueError):
        pass  # no pandas or no Excel engine: the CSV files below
    out = path.with_suffix("")
    out.mkdir(parents=True, exist_ok=True)
    for metric, per_class in aps.items():
        _write_csv(out / f"{metric}.csv", thresholds[metric],
                   _columns(per_class, cls_names))
    return out
