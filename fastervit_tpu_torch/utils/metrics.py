"""Training metrics bookkeeping (port of fastervit_tpu/utils/metrics.py):
AverageMeter and update_summary (timm semantics), and the optional
loggers, TensorboardLogger (torch.utils.tensorboard) and WandbLogger. Each
logger logs one warning and does nothing when its package is missing, as
JAX's do."""
from __future__ import annotations

import csv
import logging
import os
from collections import OrderedDict
from typing import Optional

log = logging.getLogger(__name__)


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(self.count, 1)


def update_summary(epoch: int, train_metrics: dict, eval_metrics: dict,
                   filename: str, write_header: bool = False):
    """Append a row to summary.csv (timm update_summary semantics)."""
    row = OrderedDict(epoch=epoch)
    row.update([("train_" + k, v) for k, v in train_metrics.items()])
    row.update([("eval_" + k, v) for k, v in eval_metrics.items()])
    with open(filename, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(row.keys()))
        if write_header:
            w.writeheader()
        w.writerow(row)


class WandbLogger:
    """Optional Weights & Biases logging, import-gated as the reference's
    (train.py:383-388): without the wandb package, a warning, and training
    goes on."""

    def __init__(self, enabled: bool, project: str = "fastervit-tpu",
                 run_name: Optional[str] = None,
                 config: Optional[dict] = None):
        self._wandb = None
        if not enabled:
            return
        try:
            import wandb
        except ImportError:
            log.warning("wandb requested but not installed; metrics will not "
                        "be logged to wandb")
            return
        wandb.init(project=project, name=run_name, config=config)
        self._wandb = wandb

    def log(self, metrics: dict, step: Optional[int] = None) -> None:
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()


class TensorboardLogger:
    """Scalar logger (reference tensorboard.py TensorboardLogger) on
    torch.utils.tensorboard's SummaryWriter, writing event files into
    `log_dir`; a no-op with log_dir None, or (after one warning) when the
    tensorboard package is missing."""

    def __init__(self, log_dir: Optional[str], run_name: Optional[str] = None):
        self._writer = None
        if not log_dir:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            log.warning("tensorboard requested but not installed; scalars "
                        "will not be written")
            return
        if run_name:
            log_dir = os.path.join(log_dir, run_name)
        os.makedirs(log_dir, exist_ok=True)
        self._writer = SummaryWriter(log_dir)

    @property
    def active(self) -> bool:
        return self._writer is not None

    def log_scalar(self, tag: str, value: float, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, value, step)

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
