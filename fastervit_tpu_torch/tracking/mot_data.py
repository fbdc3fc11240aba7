"""MOT-format files (DanceTrack/MOT17 gt.txt and tracker output: the
formats the reference's TrackEval reads and submit_dance.py writes): the
port's copy of fastervit_tpu/tracking/mot_data.py's `load_mot_file` (:17)
and `write_mot_file` (:39).

MOT text rows: frame,id,x,y,w,h,conf,... (1-based frames; xywh pixels).
"""
from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List

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
