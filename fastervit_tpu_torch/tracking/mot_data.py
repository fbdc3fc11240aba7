"""MOT-format files (DanceTrack/MOT17 gt.txt and tracker output: the
formats the reference's TrackEval reads and submit_dance.py writes) and
their evaluation: the port's copy of fastervit_tpu/tracking/mot_data.py,
`load_mot_file` (:17), `write_mot_file` (:39), `build_eval_data` (:52) and
`evaluate_mot_files` (:79).

MOT text rows: frame,id,x,y,w,h,conf,... (1-based frames; xywh pixels).
`build_eval_data` converts a (gt, tracker) pair into the metric suite's
sequence dict with IoU similarity (tracking/metrics.py).
"""
from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np


def load_mot_file(path: str) -> Dict[int, Dict[str, np.ndarray]]:
    """-> {frame: {'ids': (N,), 'boxes': (N, 4) xyxy, 'conf': (N,)}}"""
    per_frame = defaultdict(lambda: {"ids": [], "boxes": [], "conf": []})
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.replace(" ", ",").split(",")
            frame, tid = int(float(parts[0])), int(float(parts[1]))
            x, y, w, h = map(float, parts[2:6])
            conf = float(parts[6]) if len(parts) > 6 else 1.0
            d = per_frame[frame]
            d["ids"].append(tid)
            d["boxes"].append([x, y, x + w, y + h])
            d["conf"].append(conf)
    return {f: {"ids": np.asarray(v["ids"], int),
                "boxes": np.asarray(v["boxes"], float).reshape(-1, 4),
                "conf": np.asarray(v["conf"], float)}
            for f, v in per_frame.items()}


def write_mot_file(path: str, per_frame_results: List[Dict]) -> None:
    """Tracker output writer (submit_dance.py's format): per frame
    {'ids', 'boxes' (xyxy pixels)[, 'scores']}, as the streaming loops
    return them once scaled to the image."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for fi, res in enumerate(per_frame_results, start=1):
            for tid, box, score in zip(res["ids"], res["boxes"],
                                       res.get("scores",
                                               [1.0] * len(res["ids"]))):
                x0, y0, x1, y1 = box
                f.write(f"{fi},{int(tid)},{x0:.2f},{y0:.2f},"
                        f"{x1 - x0:.2f},{y1 - y0:.2f},{float(score):.4f},"
                        "-1,-1,-1\n")


def build_eval_data(gt: Dict[int, Dict], pred: Dict[int, Dict],
                    num_frames: Optional[int] = None) -> Dict:
    """(gt, tracker) per-frame dicts -> the metric suite's sequence format
    (contiguous ids, IoU similarity per frame)."""
    from fastervit_tpu_torch.detection.coco_eval import _iou_matrix
    frames = sorted(set(gt) | set(pred))
    if num_frames is not None:
        frames = list(range(1, num_frames + 1))
    gt_idmap: Dict[int, int] = {}
    pr_idmap: Dict[int, int] = {}
    gt_ids, pr_ids, sims = [], [], []
    for f in frames:
        g = gt.get(f, {"ids": np.zeros(0, int), "boxes": np.zeros((0, 4))})
        p = pred.get(f, {"ids": np.zeros(0, int), "boxes": np.zeros((0, 4))})
        for i in g["ids"]:
            gt_idmap.setdefault(int(i), len(gt_idmap))
        for i in p["ids"]:
            pr_idmap.setdefault(int(i), len(pr_idmap))
        gt_ids.append(np.asarray([gt_idmap[int(i)] for i in g["ids"]], int))
        pr_ids.append(np.asarray([pr_idmap[int(i)] for i in p["ids"]], int))
        sims.append(_iou_matrix(np.asarray(g["boxes"], float),
                                np.asarray(p["boxes"], float)))
    return {"num_gt_ids": len(gt_idmap), "num_tracker_ids": len(pr_idmap),
            "gt_ids": gt_ids, "tracker_ids": pr_ids,
            "similarity_scores": sims}


def evaluate_mot_files(gt_path: str, pred_path: str) -> Dict[str, float]:
    """One-call evaluation of a tracker output file against gt.txt."""
    from fastervit_tpu_torch.tracking.metrics import (
        clear_metrics, hota_metrics, identity_metrics)
    data = build_eval_data(load_mot_file(gt_path), load_mot_file(pred_path))
    out = {}
    out.update({k: v for k, v in clear_metrics(data).items()})
    out.update(identity_metrics(data))
    out.update({k: v for k, v in hota_metrics(data).items()
                if not k.endswith("_alpha")})
    return out
