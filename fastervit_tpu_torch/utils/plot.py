"""Training-curve and precision/recall plotting (matplotlib, import-gated;
a copy of fastervit_tpu/utils/plot.py).

Reference: dino/util/plot_utils.py (plot_logs over per-epoch log files,
plot_precision_recall over saved COCO eval state). Here the native log
artifact is summary.csv (utils/metrics.py update_summary), and COCO eval
state is the dict returned by detection/coco_eval.py.
"""
from __future__ import annotations

import csv
import os
from typing import Optional, Sequence


def _read_summary(path: str):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    cols = {k: [float(r[k]) for r in rows if r.get(k) not in (None, "")]
            for k in (rows[0].keys() if rows else [])}
    return cols


def plot_summaries(paths: Sequence[str],
                   fields: Sequence[str] = ("train_loss", "eval_top1"),
                   labels: Optional[Sequence[str]] = None,
                   output: Optional[str] = None):
    """Overlay training curves from one or more summary.csv files
    (reference plot_logs semantics: one subplot per field, one line per
    run). Returns the matplotlib figure."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    labels = labels or [os.path.dirname(p) or p for p in paths]
    fig, axes = plt.subplots(1, len(fields), figsize=(5 * len(fields), 4))
    if len(fields) == 1:
        axes = [axes]
    for path, label in zip(paths, labels):
        cols = _read_summary(path)
        for ax, field in zip(axes, fields):
            if field in cols:
                ax.plot(cols["epoch"][:len(cols[field])], cols[field],
                        label=label)
    for ax, field in zip(axes, fields):
        ax.set_title(field)
        ax.set_xlabel("epoch")
        ax.legend()
    fig.tight_layout()
    if output:
        fig.savefig(output, dpi=120)
    return fig


def plot_precision_recall(precisions, iou_index: int = 0,
                          area_index: int = 0, maxdet_index: int = -1,
                          output: Optional[str] = None):
    """Precision-recall curves per class from a cocoeval-style precision
    array (T, R, K, A, M) (reference plot_precision_recall). Accepts the
    'precision' entry of detection/coco_eval.py's eval state."""
    import numpy as np
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    p = np.asarray(precisions)[iou_index, :, :, area_index, maxdet_index]
    recall = np.linspace(0.0, 1.0, p.shape[0])
    fig, ax = plt.subplots(figsize=(6, 5))
    mean_p = np.where(p > -1, p, np.nan)
    ax.plot(recall, np.nanmean(mean_p, axis=1), label="mean over classes")
    ax.set_xlabel("recall")
    ax.set_ylabel("precision")
    ax.set_title("precision-recall")
    ax.legend()
    fig.tight_layout()
    if output:
        fig.savefig(output, dpi=120)
    return fig
