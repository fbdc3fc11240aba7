"""Training metrics bookkeeping: a copy of AverageMeter and update_summary
from fastervit_tpu/utils/metrics.py (timm semantics)."""
from __future__ import annotations

import csv
from collections import OrderedDict


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
