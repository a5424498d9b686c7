"""TensorBoard logging: three writers and epoch averages (a copy of the JAX
package's `utils/tb.py`; the reference's `MyLogger`, FPC/logger.py, and
`log_epoch_average`, FPC/callbacks.py:219-257).

With `enabled=True` the writers come from `torch.utils.tensorboard`; if it
cannot be imported, `RunLogger` raises and names `--no_tb` rather than
logging nothing. With `enabled=False` it still keeps the epoch averages.
"""

from __future__ import annotations

import collections
import pathlib
from typing import Dict


class RunLogger:
    def __init__(self, log_dir, enabled: bool = True):
        self.log_dir = pathlib.Path(log_dir)
        self.enabled = enabled
        self._writers = {}
        self._accum: Dict[str, Dict[str, list]] = collections.defaultdict(
            lambda: collections.defaultdict(list))
        if enabled:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                raise RuntimeError(
                    "TensorBoard logging needs torch.utils.tensorboard (the "
                    f"tensorboard package), which does not import here ({e}); "
                    "pass --no_tb to train without it") from e
            self._writers = {
                "base": SummaryWriter(log_dir=str(self.log_dir / "_")),
                "train": SummaryWriter(log_dir=str(self.log_dir / "_" / "train")),
                "valid": SummaryWriter(log_dir=str(self.log_dir / "_" / "valid")),
            }

    def log_metrics(self, mode: str, metrics: Dict[str, float], step: int,
                    accumulate: bool = True):
        for name, value in metrics.items():
            value = float(value)
            if self.enabled:
                self._writers[mode].add_scalar(name, value, step)
            if accumulate:
                self._accum[mode][name].append(value)

    def log_epoch_average(self, mode: str, epoch: int, prefix: str = "epoch_average"):
        out = {}
        for name, values in self._accum[mode].items():
            if values:
                avg = sum(values) / len(values)
                out[name] = avg
                if self.enabled:
                    self._writers[mode].add_scalar(f"{prefix}/{name}", avg, epoch)
        self._accum[mode].clear()
        return out

    def log_hparams(self, hparams: Dict[str, object], metrics: Dict[str, float]):
        """Final hparams dump (FPC/callbacks.py:541-568)."""
        if self.enabled:
            clean = {k: (v if isinstance(v, (int, float, str, bool)) else str(v))
                     for k, v in hparams.items()}
            self._writers["base"].add_hparams(clean, metrics)

    def close(self):
        for w in self._writers.values():
            w.close()
