"""Mask-based TrackEval benchmark adapters: MOTSChallenge and KITTI-MOTS
(TrackEval trackeval/datasets/mots_challenge.py / kitti_mots.py semantics),
built on the pure-numpy COCO-RLE codec (fastervit_tpu_torch/utils/rle.py)
instead of pycocotools.

Shared row format (both benchmarks): space-delimited
`frame id class img_h img_w rle` where rle is a COCO compressed-RLE string.
Class `10` rows are crowd-ignore regions (merged into one mask per frame);
per-frame masks (detections + ignore) must be non-overlapping
(mots_challenge.py:264-271). Similarity is mask IoU; preprocessing removes
unmatched tracker masks that are > 50% inside the frame's merged ignore
region (mots_challenge.py:333-345). Matched detections and gt are never
removed.

Layout differences:
  * MOTSChallenge (mots_challenge.py:20-40): MOTChallenge folder scheme —
    GT_FOLDER/MOTS-<split>/<seq>/gt/gt.txt with seqinfo.ini, seqmaps, and
    trackers at TRACKERS_FOLDER/MOTS-<split>/<tracker>/data/<seq>.txt;
    frames 1-based; single pedestrian class ('2').
  * KITTI-MOTS (kitti_mots.py:20-33, 117): KITTI scheme — gt at
    GT_FOLDER/label_02/<seq>.txt, seqmap `evaluate_mots.seqmap.<split>`;
    frames 0-based; classes car ('1') and pedestrian ('2').

The port's copy of fastervit_tpu/tracking/mots.py: the same names,
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
    EPS, MOTChallengeDataset, _metric_data)
from fastervit_tpu_torch.utils.rle import rle_iou, rle_merge


def load_mots_rows(path: str):
    """MOTS text file -> {frame: [(id, class_id, rle_dict), ...]}."""
    per_frame = defaultdict(list)
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            fr, tid, cls = int(parts[0]), int(parts[1]), int(parts[2])
            rle = {"size": [int(parts[3]), int(parts[4])],
                   "counts": parts[5]}
            per_frame[fr].append((tid, cls, rle))
    return per_frame


def _mots_frame_data(rows, ignore_cls: int = 10):
    """-> (ids, classes, rles, merged_ignore_rle) for one frame, validating
    that all masks are pairwise non-overlapping."""
    dets = [(i, c, r) for i, c, r in rows if c != ignore_cls]
    ignores = [r for _, c, r in rows if c == ignore_cls]
    merged_ignore = rle_merge(ignores)
    # dets must be pairwise disjoint and disjoint from the merged ignore
    # region (mots_challenge.py:264-271; ignore regions may overlap each
    # other since the reference merges them before the check)
    all_masks = [r for _, _, r in dets] + ([merged_ignore] if ignores
                                           else [])
    for i in range(len(all_masks)):
        for j in range(i + 1, len(all_masks)):
            if rle_iou([all_masks[i]], [all_masks[j]],
                       iscrowd=[1])[0, 0] > 0:
                raise ValueError("overlapping masks within a frame")
    ids = np.asarray([i for i, _, _ in dets], int)
    cls = np.asarray([c for _, c, _ in dets], int)
    return ids, cls, [r for _, _, r in dets], merged_ignore


def _mots_sequence_data(gt_rows, trk_rows, frames: Sequence[int],
                        cls_id: int) -> Dict:
    """Shared MOTS preprocessing over the given frame keys."""
    gt_ids, trk_ids, sims = [], [], []
    for fr in frames:
        gi, gc, gr, ign = _mots_frame_data(gt_rows.get(fr, []))
        ti, tc, tr, _ = _mots_frame_data(trk_rows.get(fr, []))
        gm, tm = gc == cls_id, tc == cls_id
        gi = gi[gm]
        gr = [r for r, k in zip(gr, gm) if k]
        ti = ti[tm]
        tr = [r for r, k in zip(tr, tm) if k]
        sim = rle_iou(gr, tr) if gr and tr else np.zeros((len(gr), len(tr)))
        unmatched = np.arange(len(ti))
        if len(gi) and len(ti):
            ms = sim.copy()
            ms[ms < 0.5 - EPS] = -10000
            r, c = linear_sum_assignment(-ms)
            unmatched = np.setdiff1d(unmatched, c[ms[r, c] > EPS])
        keep = np.ones(len(ti), bool)
        if len(unmatched):
            ioa = rle_iou([tr[i] for i in unmatched], [ign], iscrowd=[1])
            keep[unmatched[ioa[:, 0] > 0.5 + EPS]] = False
        gt_ids.append(gi.copy())
        trk_ids.append(ti[keep])
        sims.append(sim[:, keep])
    return _metric_data(gt_ids, trk_ids, sims)


class MOTSChallengeDataset(MOTChallengeDataset):
    """MOTSChallenge benchmark adapter (see module docstring). Reuses the
    MOTChallenge seqmap/seqinfo/folder handling; single pedestrian class."""

    benchmark_default = "MOTS"
    distractor_names: Sequence[str] = ()
    CLASS_IDS = {"pedestrian": 2, "ignore": 10}

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("do_preproc", False)  # box preproc n/a for masks
        super().__init__(*args, **kwargs)

    def sequence_data(self, tracker: str, seq: str,
                      cls: str = "pedestrian") -> Dict:
        gt_rows = load_mots_rows(
            self.gt_loc_format.format(gt_folder=self.gt_fol, seq=seq))
        trk_rows = load_mots_rows(os.path.join(
            self.tracker_fol, tracker, self.tracker_sub_fol, seq + ".txt"))
        nt = self.seq_lengths[seq]
        extra = (set(gt_rows) | set(trk_rows)) - set(range(1, nt + 1))
        if extra:
            raise ValueError(f"invalid timesteps in {seq}: {sorted(extra)}")
        return _mots_sequence_data(gt_rows, trk_rows, range(1, nt + 1),
                                   self.CLASS_IDS[cls])


class KITTIMOTSDataset:
    """KITTI-MOTS benchmark adapter (see module docstring): per-class
    (car, pedestrian) evaluation over the KITTI folder scheme."""

    CLASS_IDS = {"car": 1, "pedestrian": 2, "ignore": 10}

    def __init__(self, gt_folder: str, trackers_folder: str,
                 split: str = "val",
                 classes: Sequence[str] = ("car", "pedestrian"),
                 trackers_to_eval: Optional[List[str]] = None,
                 tracker_sub_fol: str = "data"):
        for c in classes:
            if c == "ignore" or c not in self.CLASS_IDS:
                raise ValueError(f"class {c!r} is not evaluatable "
                                 "(only car/pedestrian)")
        self.gt_fol, self.tracker_fol = gt_folder, trackers_folder
        self.class_list = list(classes)
        self.tracker_sub_fol = tracker_sub_fol
        seqmap = os.path.join(gt_folder, f"evaluate_mots.seqmap.{split}")
        if not os.path.isfile(seqmap):
            raise FileNotFoundError(f"no seqmap found: {seqmap}")
        self.seq_list, self.seq_lengths = [], {}
        with open(seqmap) as fp:
            for row in csv.reader(fp, delimiter=" ", skipinitialspace=True):
                row = [r for r in row if r != ""]
                if len(row) >= 4:
                    self.seq_list.append(row[0])
                    self.seq_lengths[row[0]] = int(row[3])
        for seq in self.seq_list:
            p = os.path.join(self.gt_fol, "label_02", seq + ".txt")
            if not os.path.isfile(p):
                raise FileNotFoundError(f"GT file not found: {p}")
        if trackers_to_eval is None:
            self.tracker_list = sorted(os.listdir(self.tracker_fol))
        else:
            self.tracker_list = list(trackers_to_eval)
        for tracker in self.tracker_list:
            for seq in self.seq_list:
                p = os.path.join(self.tracker_fol, tracker,
                                 self.tracker_sub_fol, seq + ".txt")
                if not os.path.isfile(p):
                    raise FileNotFoundError(f"tracker file not found: {p}")

    def sequence_data(self, tracker: str, seq: str, cls: str) -> Dict:
        gt_rows = load_mots_rows(
            os.path.join(self.gt_fol, "label_02", seq + ".txt"))
        trk_rows = load_mots_rows(os.path.join(
            self.tracker_fol, tracker, self.tracker_sub_fol, seq + ".txt"))
        nt = self.seq_lengths[seq]
        extra = (set(gt_rows) | set(trk_rows)) - set(range(nt))
        if extra:
            raise ValueError(f"invalid timesteps in {seq}: {sorted(extra)}")
        return _mots_sequence_data(gt_rows, trk_rows, range(nt),
                                   self.CLASS_IDS[cls])

    def evaluate(self, trackers: Optional[List[str]] = None,
                 output_folder: Optional[str] = None) -> Dict:
        """-> {tracker: {class: {seq | 'COMBINED_SEQ': {metric: value}}}}."""
        from fastervit_tpu_torch.tracking.benchmarks import (
            _all_metrics, combine_sequence_data, write_detailed_csv)
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
                        output_folder, f"{tracker}_{cls}_detailed.csv"),
                        per_seq)
            results[tracker] = per_cls
        return results
