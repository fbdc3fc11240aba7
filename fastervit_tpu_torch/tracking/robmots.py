"""RobMOTS combined benchmark adapter (TrackEval trackeval/datasets/
rob_mots.py semantics): the unified multi-benchmark MOTS challenge format
evaluated over the COCO-80 class vocabulary plus a class-agnostic 'all'.

Layout (rob_mots.py:89-127, 132-160): per sub-benchmark
(`mots_challenge`, `kitti_mots`, `bdd_mots`, `davis_unsupervised`,
`youtube_vis`, `ovis`, `waymo`, `tao`):
  * gt at GT_FOLDER/<split>/<sub>/data/<seq>.txt, a `seqmap.txt`
    (`seq len h w [ignore_cls_ids...]`) and a `clsmap.txt` (evaluated
    class ids);
  * trackers at TRACKERS_FOLDER/<split>/<tracker>/data/<sub>/<seq>.txt.

Unified space-delimited rows, frames 0-based:
  * gt (mask benchmarks):    frame id class _ im_h im_w rle
  * gt (waymo/tao, box gt):  frame id class _ x0 y0 x1 y1
  * tracker (always masks):  frame id class conf im_h im_w rle
gt classes >= 100 are ignore regions (100 = general, cls+100 =
class-specific); valid det masks per frame must be non-overlapping.

Preprocessing (rob_mots.py:342-457): per class (or 'all' = every det,
gt classes < 100), Hungarian-match at IoU >= 0.5, keep all matched dets
and all gt; remove unmatched dets that are (a) of a class in the
sequence's ignore list (everything unmatched), or (b) too small
(max(w, h) <= min(seq_size)/8), or (c) > 50% inside the merged ignore
regions; for 'all', additionally unmatched dets of ignore-listed or
non-evaluated classes. waymo merges [car, truck, bus, motorcycle] gt into
'car'. Similarity is mask IoU, except box-gt benchmarks compare gt boxes
against the tracker masks' bounding boxes (rob_mots.py:494-508).

The port's copy of fastervit_tpu/tracking/robmots.py: the same names,
signatures and code, importing nothing of the JAX package.
"""
from __future__ import annotations

import csv
import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy.optimize import linear_sum_assignment

from fastervit_tpu_torch.tracking.benchmarks import (
    EPS, _all_metrics, _metric_data, combine_sequence_data,
    write_detailed_csv)
from fastervit_tpu_torch.utils.rle import rle_iou, rle_merge, rle_to_bbox

# COCO-80 vocabulary (ids 1-80; TrackEval rob_mots_classmap.py)
COCO_CLASS_NAMES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep",
    "cow", "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush")
CLS_ID_TO_NAME = {i + 1: n for i, n in enumerate(COCO_CLASS_NAMES)}
CLS_NAME_TO_ID = {n: i for i, n in CLS_ID_TO_NAME.items()}

WAYMO_VEHICLE_IDS = (3, 4, 6, 8)   # car, motorcycle, bus, truck


class RobMOTSDataset:
    """RobMOTS combined benchmark (see module docstring)."""

    VALID_BENCHMARKS = ("mots_challenge", "kitti_mots", "bdd_mots",
                        "davis_unsupervised", "youtube_vis", "ovis",
                        "waymo", "tao")
    BOX_GT_BENCHMARKS = ("waymo", "tao")

    def __init__(self, gt_folder: str, trackers_folder: str,
                 sub_benchmark: str, split: str = "train",
                 classes: Optional[Sequence[str]] = None,
                 trackers_to_eval: Optional[List[str]] = None,
                 tracker_sub_fol: str = "data"):
        if sub_benchmark not in self.VALID_BENCHMARKS:
            raise ValueError(f"invalid sub-benchmark {sub_benchmark!r}; "
                             f"valid: {self.VALID_BENCHMARKS}")
        self.sub = sub_benchmark
        self.split = split
        self.gt_fol = gt_folder
        self.tracker_fol = os.path.join(trackers_folder, split)
        self.tracker_sub_fol = tracker_sub_fol
        self.box_gt = sub_benchmark in self.BOX_GT_BENCHMARKS

        base = os.path.join(gt_folder, split, sub_benchmark)
        seqmap = os.path.join(base, "seqmap.txt")
        if not os.path.isfile(seqmap):
            raise FileNotFoundError(f"no seqmap found: {seqmap}")
        self.seq_list, self.seq_lengths = [], {}
        self.seq_sizes, self.seq_ignore_class_ids = {}, {}
        with open(seqmap) as fp:
            for row in csv.reader(fp, delimiter=" ", skipinitialspace=True):
                row = [r for r in row if r != ""]
                if len(row) >= 4:
                    seq = row[0]
                    self.seq_list.append(seq)
                    self.seq_lengths[seq] = int(row[1])
                    self.seq_sizes[seq] = (int(row[2]), int(row[3]))
                    self.seq_ignore_class_ids[seq] = [int(x)
                                                      for x in row[4:]]
        self.valid_class_ids = np.atleast_1d(np.genfromtxt(
            os.path.join(base, "clsmap.txt"))).astype(int)
        valid_names = [CLS_ID_TO_NAME[i] for i in self.valid_class_ids]
        self.class_ids = dict(CLS_NAME_TO_ID, all=-1)
        if classes is None:
            self.class_list = valid_names + ["all"]
        else:
            bad = [c for c in classes if c not in valid_names + ["all"]]
            if bad:
                raise ValueError(f"invalid classes {bad}; valid: "
                                 f"{valid_names + ['all']}")
            self.class_list = list(classes)
        for seq in self.seq_list:
            p = os.path.join(base, "data", seq + ".txt")
            if not os.path.isfile(p):
                raise FileNotFoundError(f"GT file not found: {p}")
        if trackers_to_eval is None:
            self.tracker_list = sorted(os.listdir(self.tracker_fol))
        else:
            self.tracker_list = list(trackers_to_eval)
        for tracker in self.tracker_list:
            for seq in self.seq_list:
                p = os.path.join(self.tracker_fol, tracker,
                                 tracker_sub_fol, self.sub, seq + ".txt")
                if not os.path.isfile(p):
                    raise FileNotFoundError(f"tracker file not found: {p}")

    # ---- raw loading -------------------------------------------------------
    def _load(self, path: str, is_gt: bool, seq: str):
        """-> per-frame list of rows (id, cls, conf, det) where det is an
        RLE dict, or an x0y0x1y1 box for box-gt benchmark gt rows. Also
        validates that valid (cls < 100) masks don't overlap."""
        per_frame = defaultdict(list)
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                fr, tid, cls = int(parts[0]), int(parts[1]), int(parts[2])
                conf = float(parts[3]) if not is_gt else 1.0
                if is_gt and self.box_gt:
                    det = np.asarray([float(v) for v in parts[4:8]])
                else:
                    det = {"size": [int(parts[4]), int(parts[5])],
                           "counts": parts[6]}
                per_frame[fr].append((tid, cls, conf, det))
        nt = self.seq_lengths[seq]
        extra = set(per_frame) - set(range(nt))
        if extra:
            raise ValueError(f"invalid timesteps in {seq}: {sorted(extra)}")
        if not (is_gt and self.box_gt):
            for fr, rows in per_frame.items():
                valid = [det for _, cls, _, det in rows if cls < 100]
                for i in range(len(valid)):
                    for j in range(i + 1, len(valid)):
                        if rle_iou([valid[i]], [valid[j]],
                                   iscrowd=[1])[0, 0] > 0:
                            raise ValueError(
                                f"overlapping masks in frame {fr}")
        return [per_frame.get(t, []) for t in range(nt)]

    def _similarity(self, gt_dets, trk_dets):
        """Mask IoU, or gt-box vs tracker-mask-bbox IoU for box-gt
        benchmarks (rob_mots.py:494-508)."""
        if not self.box_gt:
            return rle_iou(gt_dets, trk_dets)
        if not len(gt_dets) or not trk_dets:
            return np.zeros((len(gt_dets), len(trk_dets)))
        tb = np.stack([rle_to_bbox(d) for d in trk_dets])
        tb[:, 2:] += tb[:, :2]                       # xywh -> x0y0x1y1
        g = np.asarray(gt_dets)
        ix = np.maximum(0, np.minimum(g[:, None, 2], tb[None, :, 2])
                        - np.maximum(g[:, None, 0], tb[None, :, 0]))
        iy = np.maximum(0, np.minimum(g[:, None, 3], tb[None, :, 3])
                        - np.maximum(g[:, None, 1], tb[None, :, 1]))
        inter = ix * iy
        ga = (g[:, 2] - g[:, 0]) * (g[:, 3] - g[:, 1])
        da = (tb[:, 2] - tb[:, 0]) * (tb[:, 3] - tb[:, 1])
        denom = ga[:, None] + da[None] - inter
        return np.where(denom > 0, inter / np.maximum(denom, EPS), 0.0)

    # ---- evaluation data ---------------------------------------------------
    def sequence_data(self, tracker: str, seq: str, cls: str) -> Dict:
        base = os.path.join(self.gt_fol, self.split, self.sub)
        gt = self._load(os.path.join(base, "data", seq + ".txt"), True, seq)
        trk = self._load(os.path.join(
            self.tracker_fol, tracker, self.tracker_sub_fol, self.sub,
            seq + ".txt"), False, seq)
        cls_id = self.class_ids[cls]
        seq_ignore = self.seq_ignore_class_ids[seq]
        min_size = min(self.seq_sizes[seq]) / 8
        gt_ids_l, trk_ids_l, sims = [], [], []
        for g_rows, t_rows in zip(gt, trk):
            g_cls = np.asarray([c for _, c, _, _ in g_rows], int)
            if cls == "all":
                g_mask = g_cls < 100
                ig_mask = g_cls >= 100
            elif self.sub == "waymo" and cls == "car":
                g_mask = np.isin(g_cls, WAYMO_VEHICLE_IDS)
                ig_mask = (g_cls == cls_id + 100) | (g_cls == 100)
            else:
                g_mask = g_cls == cls_id
                ig_mask = (g_cls == cls_id + 100) | (g_cls == 100)
            gi = np.asarray([r[0] for r, k in zip(g_rows, g_mask) if k],
                            int)
            g_dets = [r[3] for r, k in zip(g_rows, g_mask) if k]
            ignore_regions = [r[3] for r, k in zip(g_rows, ig_mask) if k]
            if self.box_gt and ignore_regions:
                # box-gt ignore regions are boxes; rasterize to RLEs
                from fastervit_tpu_torch.utils.rle import rle_encode
                h, w = self.seq_sizes[seq]
                masks = []
                for b in ignore_regions:
                    m = np.zeros((h, w), np.uint8)
                    x0, y0, x1, y1 = [int(round(v)) for v in b]
                    m[max(y0, 0):y1, max(x0, 0):x1] = 1
                    masks.append(rle_encode(m))
                ignore_regions = masks
            t_cls = np.asarray([c for _, c, _, _ in t_rows], int)
            t_mask = (np.ones(len(t_rows), bool) if cls == "all"
                      else t_cls == cls_id)
            ti = np.asarray([r[0] for r, k in zip(t_rows, t_mask) if k],
                            int)
            t_dets = [r[3] for r, k in zip(t_rows, t_mask) if k]
            t_classes = t_cls[t_mask]
            sim = self._similarity(g_dets, t_dets)
            remove = np.zeros(len(ti), bool)
            if len(ti):
                unmatched = np.arange(len(ti))
                if len(gi):
                    ms = sim.copy()
                    ms[ms < 0.5 - EPS] = 0
                    r, c = linear_sum_assignment(-ms)
                    unmatched = np.setdiff1d(unmatched, c[ms[r, c] > EPS])
                if cls_id in seq_ignore:
                    remove[unmatched] = True
                else:
                    um_dets = [t_dets[i] for i in unmatched]
                    boxes = (np.stack([rle_to_bbox(d) for d in um_dets])
                             if um_dets else np.zeros((0, 4)))
                    too_small = (np.maximum(boxes[:, 2], boxes[:, 3])
                                 <= min_size + EPS)
                    if ignore_regions:
                        merged = rle_merge(ignore_regions)
                        ioa = rle_iou(um_dets, [merged], iscrowd=[1])
                        in_ignore = ioa[:, 0] > 0.5 + EPS
                        remove[unmatched[too_small | in_ignore]] = True
                    else:
                        remove[unmatched[too_small]] = True
                if cls == "all":
                    um_cls = t_classes[unmatched]
                    bad = (np.isin(um_cls, seq_ignore)
                           | ~np.isin(um_cls, self.valid_class_ids))
                    remove[unmatched[bad]] = True
            gt_ids_l.append(gi.copy())
            trk_ids_l.append(ti[~remove])
            sims.append(sim[:, ~remove])
        return _metric_data(gt_ids_l, trk_ids_l, sims)

    def evaluate(self, trackers: Optional[List[str]] = None,
                 output_folder: Optional[str] = None) -> Dict:
        """-> {tracker: {class: {seq | 'COMBINED_SEQ': {metric: value}}}}."""
        results = {}
        for tracker in (trackers or self.tracker_list):
            per_cls = {}
            for cls in self.class_list:
                per_seq, datas = {}, []
                for seq in self.seq_list:
                    data = self.sequence_data(tracker, seq, cls)
                    datas.append(data)
                    per_seq[seq] = _all_metrics(data)
                per_seq["COMBINED_SEQ"] = _all_metrics(
                    combine_sequence_data(datas))
                per_cls[cls] = per_seq
                if output_folder:
                    os.makedirs(output_folder, exist_ok=True)
                    write_detailed_csv(os.path.join(
                        output_folder,
                        f"{tracker}_{cls.replace(' ', '_')}_detailed.csv"),
                        per_seq)
            results[tracker] = per_cls
        return results
