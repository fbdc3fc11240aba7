"""TrackEval-style benchmark dataset adapters: MOTChallenge / DanceTrack
folder layouts feeding the metric suite (tracking/metrics.py).

Reproduces the reference's vendored TrackEval dataset semantics
(TrackEval/trackeval/datasets/mot_challenge_2d_box.py):

  * folder layout  GT_FOLDER/<BENCHMARK>-<SPLIT>/<seq>/gt/gt.txt with
    per-sequence seqinfo.ini, sequence selection via
    GT_FOLDER/seqmaps/<BENCHMARK>-<SPLIT>.txt (mot_challenge_2d_box.py:131-171);
  * tracker layout TRACKERS_FOLDER/<BENCHMARK>-<SPLIT>/<tracker>/data/<seq>.txt
    (mot_challenge_2d_box.py:120-126);
  * MOT preprocessing (mot_challenge_2d_box.py:322-400): Hungarian-match
    tracker boxes to ALL gt boxes at IoU >= 0.5 and drop tracker dets matched
    to distractor classes; keep only zero_marked != 0, class == pedestrian gt;
  * per-sequence results plus a pooled COMBINED_SEQ row (TrackEval's
    combine_sequences — here via exact id-disjoint concatenation).

DanceTrack uses the same layout with no distractor classes and no
class-filtering (every annotation is class 1).

The port's copy of fastervit_tpu/tracking/benchmarks.py: the same names,
signatures and code, importing nothing of the JAX package.
"""
from __future__ import annotations

import configparser
import csv
import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy.optimize import linear_sum_assignment

EPS = np.finfo(float).eps

# MOTChallenge class ids (mot_challenge_2d_box.py:196-199)
CLASS_IDS = {"pedestrian": 1, "person_on_vehicle": 2, "car": 3, "bicycle": 4,
             "motorbike": 5, "non_mot_vehicle": 6, "static_person": 7,
             "distractor": 8, "occluder": 9, "occluder_on_ground": 10,
             "occluder_full": 11, "reflection": 12, "crowd": 13}
_DISTRACTORS = ("person_on_vehicle", "static_person", "distractor",
                "reflection")


def load_mot_rows(path: str) -> Dict[int, np.ndarray]:
    """MOT text file -> {frame: (N, >=9) float rows}. Row layout:
    frame,id,x,y,w,h,conf,class,visibility — missing columns padded with 1
    (tracker files often stop after conf)."""
    per_frame = defaultdict(list)
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.replace(" ", ",").split(",")
            vals = [float(p) for p in parts if p != ""]
            vals = vals + [1.0] * max(0, 9 - len(vals))
            per_frame[int(vals[0])].append(vals[:9])
    return {fr: np.asarray(rows, float) for fr, rows in per_frame.items()}


def _iou_xywh(g: np.ndarray, d: np.ndarray) -> np.ndarray:
    """IoU between (G, 4) and (D, 4) xywh boxes."""
    if len(g) == 0 or len(d) == 0:
        return np.zeros((len(g), len(d)))
    gx0, gy0 = g[:, 0], g[:, 1]
    gx1, gy1 = g[:, 0] + g[:, 2], g[:, 1] + g[:, 3]
    dx0, dy0 = d[:, 0], d[:, 1]
    dx1, dy1 = d[:, 0] + d[:, 2], d[:, 1] + d[:, 3]
    ix = np.maximum(0, np.minimum(gx1[:, None], dx1[None]) -
                    np.maximum(gx0[:, None], dx0[None]))
    iy = np.maximum(0, np.minimum(gy1[:, None], dy1[None]) -
                    np.maximum(gy0[:, None], dy0[None]))
    inter = ix * iy
    union = (g[:, 2] * g[:, 3])[:, None] + (d[:, 2] * d[:, 3])[None] - inter
    return np.where(union > 0, inter / np.maximum(union, EPS), 0.0)


class MOTChallengeDataset:
    """MOTChallenge 2D-box benchmark adapter (TrackEval
    MotChallenge2DBox semantics)."""

    benchmark_default = "MOT17"
    distractor_names: Sequence[str] = _DISTRACTORS

    def __init__(self, gt_folder: str, trackers_folder: str,
                 benchmark: Optional[str] = None, split: str = "train",
                 seqmap_file: Optional[str] = None,
                 seq_info: Optional[Dict[str, Optional[int]]] = None,
                 trackers_to_eval: Optional[List[str]] = None,
                 tracker_sub_fol: str = "data", do_preproc: bool = True,
                 gt_loc_format: str = "{gt_folder}/{seq}/gt/gt.txt",
                 skip_split_fol: bool = False):
        self.benchmark = benchmark or self.benchmark_default
        self.split = split
        self.gt_set = f"{self.benchmark}-{split}"
        split_fol = "" if skip_split_fol else self.gt_set
        self.gt_fol = os.path.join(gt_folder, split_fol)
        self.tracker_fol = os.path.join(trackers_folder, split_fol)
        self.tracker_sub_fol = tracker_sub_fol
        self.do_preproc = do_preproc and self.benchmark != "MOT15"
        self.gt_loc_format = gt_loc_format
        distractors = list(self.distractor_names)
        if self.benchmark == "MOT20":
            distractors.append("non_mot_vehicle")
        self.distractor_classes = [CLASS_IDS[n] for n in distractors]

        self.seq_list, self.seq_lengths = self._get_seq_info(
            gt_folder, seqmap_file, seq_info)
        if not self.seq_list:
            raise ValueError("no sequences selected")
        for seq in self.seq_list:
            p = self.gt_loc_format.format(gt_folder=self.gt_fol, seq=seq)
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

    def _read_seq_length(self, seq: str) -> int:
        ini = os.path.join(self.gt_fol, seq, "seqinfo.ini")
        if not os.path.isfile(ini):
            raise FileNotFoundError(f"seqinfo.ini not found for {seq}")
        cp = configparser.ConfigParser()
        cp.read(ini)
        return int(cp["Sequence"]["seqLength"])

    def _get_seq_info(self, gt_folder, seqmap_file, seq_info):
        if seq_info:
            lengths = {s: (n if n is not None else self._read_seq_length(s))
                       for s, n in seq_info.items()}
            return list(lengths), lengths
        if seqmap_file is None:
            seqmap_file = os.path.join(gt_folder, "seqmaps",
                                       self.gt_set + ".txt")
        if not os.path.isfile(seqmap_file):
            raise FileNotFoundError(f"no seqmap found: {seqmap_file}")
        seq_list, lengths = [], {}
        with open(seqmap_file) as fp:
            for i, row in enumerate(csv.reader(fp)):
                if i == 0 or not row or row[0] == "":
                    continue  # header line ("name") skipped like TrackEval
                seq_list.append(row[0])
                lengths[row[0]] = self._read_seq_length(row[0])
        return seq_list, lengths

    # ---- per-sequence evaluation data ------------------------------------
    def sequence_data(self, tracker: str, seq: str) -> Dict:
        """-> metric-suite data dict (contiguous ids, IoU similarity) after
        MOT preprocessing."""
        gt_rows = load_mot_rows(
            self.gt_loc_format.format(gt_folder=self.gt_fol, seq=seq))
        trk_rows = load_mot_rows(os.path.join(
            self.tracker_fol, tracker, self.tracker_sub_fol, seq + ".txt"))
        nt = self.seq_lengths[seq]
        extra = set(gt_rows) - set(range(1, nt + 1))
        extra |= set(trk_rows) - set(range(1, nt + 1))
        if extra:
            raise ValueError(f"invalid timesteps in {seq}: {sorted(extra)}")

        gt_idmap: Dict[int, int] = {}
        trk_idmap: Dict[int, int] = {}
        gt_ids, trk_ids, sims = [], [], []
        gt_dets_n = trk_dets_n = 0
        for t in range(1, nt + 1):
            g = gt_rows.get(t, np.zeros((0, 9)))
            d = trk_rows.get(t, np.zeros((0, 9)))
            sim = _iou_xywh(g[:, 2:6], d[:, 2:6])
            keep_trk = np.ones(len(d), bool)
            if self.do_preproc and len(g) and len(d):
                # drop tracker dets Hungarian-matched (IoU >= 0.5) to
                # distractor-class gt (mot_challenge_2d_box.py:359-381)
                ms = sim.copy()
                ms[ms < 0.5 - EPS] = 0
                r, c = linear_sum_assignment(-ms)
                ok = ms[r, c] > EPS
                r, c = r[ok], c[ok]
                is_distr = np.isin(g[r, 7].astype(int),
                                   self.distractor_classes)
                keep_trk[c[is_distr]] = False
            keep_gt = self._gt_keep_mask(g)
            g, d = g[keep_gt], d[keep_trk]
            sim = sim[keep_gt][:, keep_trk]
            for i in g[:, 1].astype(int):
                gt_idmap.setdefault(i, len(gt_idmap))
            for i in d[:, 1].astype(int):
                trk_idmap.setdefault(i, len(trk_idmap))
            gt_ids.append(np.asarray([gt_idmap[i] for i in
                                      g[:, 1].astype(int)], int))
            trk_ids.append(np.asarray([trk_idmap[i] for i in
                                       d[:, 1].astype(int)], int))
            sims.append(sim)
            gt_dets_n += len(g)
            trk_dets_n += len(d)
        return {"num_gt_ids": len(gt_idmap),
                "num_tracker_ids": len(trk_idmap),
                "num_gt_dets": gt_dets_n, "num_tracker_dets": trk_dets_n,
                "gt_ids": gt_ids, "tracker_ids": trk_ids,
                "similarity_scores": sims}

    def _gt_keep_mask(self, g: np.ndarray) -> np.ndarray:
        if len(g) == 0:
            return np.ones(0, bool)
        if self.do_preproc:
            # zero_marked (conf column) != 0 AND pedestrian class
            return (g[:, 6] != 0) & (g[:, 7].astype(int) == 1)
        return g[:, 6] != 0

    # ---- full benchmark evaluation ---------------------------------------
    def evaluate(self, trackers: Optional[List[str]] = None,
                 output_folder: Optional[str] = None) -> Dict:
        """-> {tracker: {seq | 'COMBINED_SEQ': {metric: value}}}. Writes a
        per-tracker detailed CSV when output_folder is given (the
        TrackEval *_detailed.csv analog)."""
        all_metrics = _all_metrics
        results = {}
        for tracker in (trackers or self.tracker_list):
            per_seq = {}
            datas = []
            for seq in self.seq_list:
                data = self.sequence_data(tracker, seq)
                datas.append(data)
                per_seq[seq] = all_metrics(data)
            per_seq["COMBINED_SEQ"] = all_metrics(combine_sequence_data(datas))
            results[tracker] = per_seq
            if output_folder:
                os.makedirs(output_folder, exist_ok=True)
                write_detailed_csv(
                    os.path.join(output_folder, f"{tracker}_detailed.csv"),
                    per_seq)
        return results


class HeadTrackingDataset(MOTChallengeDataset):
    """Head Tracking Challenge (CroHD) benchmark adapter (TrackEval
    head_tracking_challenge.py): MOTChallenge layout with benchmark 'HT'.

    Differences from MOT (head_tracking_challenge.py:76, 383-412):
      * class map pedestrian/static/ignore/person_on_vehicle (1-4); every
        non-pedestrian gt class acts as a distractor;
      * the distractor-matching Hungarian uses IoU >= 0.4 (not 0.5);
      * tracker dets matched to INVISIBLE gt (visibility column == 0) are
        also removed. The reference's zero-confidence condition is dead
        code (`np.logical_or(a, b, c)` uses c as the out parameter,
        head_tracking_challenge.py:387) — so dets matched to zero-marked
        gt are kept, and this adapter reproduces that behavior;
      * gt is kept only if pedestrian with conf > 0 and visibility > 0;
      * tracker files must be single-class (class id <= 1).
    """

    benchmark_default = "HT"
    distractor_names: Sequence[str] = ()
    HT_CLASS_IDS = {"pedestrian": 1, "static": 2, "ignore": 3,
                    "person_on_vehicle": 4}
    match_threshold = 0.4

    def sequence_data(self, tracker: str, seq: str) -> Dict:
        gt_rows = load_mot_rows(
            self.gt_loc_format.format(gt_folder=self.gt_fol, seq=seq))
        trk_rows = load_mot_rows(os.path.join(
            self.tracker_fol, tracker, self.tracker_sub_fol, seq + ".txt"))
        nt = self.seq_lengths[seq]
        gt_idmap: Dict[int, int] = {}
        trk_idmap: Dict[int, int] = {}
        gt_ids, trk_ids, sims = [], [], []
        gt_dets_n = trk_dets_n = 0
        valid = set(self.HT_CLASS_IDS.values())
        for t in range(1, nt + 1):
            g = gt_rows.get(t, np.zeros((0, 9)))
            d = trk_rows.get(t, np.zeros((0, 9)))
            bad_cls = set(g[:, 7].astype(int)) - valid
            if bad_cls:
                raise ValueError(f"invalid gt classes in {seq}: {bad_cls}")
            if len(d) and d[:, 7].max() > 1:
                raise ValueError(
                    f"evaluation is only valid for the pedestrian class; "
                    f"found class {int(d[:, 7].max())} in {seq}")
            sim = _iou_xywh(g[:, 2:6], d[:, 2:6])
            keep_trk = np.ones(len(d), bool)
            if self.do_preproc and len(g) and len(d):
                ms = sim.copy()
                ms[ms < self.match_threshold - EPS] = 0
                r, c = linear_sum_assignment(-ms)
                ok = ms[r, c] > EPS
                r, c = r[ok], c[ok]
                remove = (g[r, 7].astype(int) != 1) | (g[r, 8] < EPS)
                keep_trk[c[remove]] = False
            keep_gt = ((g[:, 6] > 0) & (g[:, 7].astype(int) == 1)
                       & (g[:, 8] > 0))
            g, d = g[keep_gt], d[keep_trk]
            sim = sim[keep_gt][:, keep_trk]
            for i in g[:, 1].astype(int):
                gt_idmap.setdefault(i, len(gt_idmap))
            for i in d[:, 1].astype(int):
                trk_idmap.setdefault(i, len(trk_idmap))
            gt_ids.append(np.asarray([gt_idmap[i] for i in
                                      g[:, 1].astype(int)], int))
            trk_ids.append(np.asarray([trk_idmap[i] for i in
                                       d[:, 1].astype(int)], int))
            sims.append(sim)
            gt_dets_n += len(g)
            trk_dets_n += len(d)
        return {"num_gt_ids": len(gt_idmap),
                "num_tracker_ids": len(trk_idmap),
                "num_gt_dets": gt_dets_n, "num_tracker_dets": trk_dets_n,
                "gt_ids": gt_ids, "tracker_ids": trk_ids,
                "similarity_scores": sims}


class DanceTrackDataset(MOTChallengeDataset):
    """DanceTrack benchmark adapter: MOTChallenge layout, single class, no
    distractor preprocessing (every annotation is class 1)."""

    benchmark_default = "DanceTrack"
    distractor_names: Sequence[str] = ()

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("split", "val")
        kwargs.setdefault("do_preproc", False)
        super().__init__(*args, **kwargs)


def _iou_xyxy(g: np.ndarray, d: np.ndarray, ioa: bool = False) -> np.ndarray:
    """IoU (or intersection-over-area-of-d when ioa) between (G, 4) and
    (D, 4) x0y0x1y1 boxes (TrackEval _base_dataset._calculate_box_ious)."""
    if len(g) == 0 or len(d) == 0:
        return np.zeros((len(g), len(d)))
    ix = np.maximum(0, np.minimum(g[:, None, 2], d[None, :, 2]) -
                    np.maximum(g[:, None, 0], d[None, :, 0]))
    iy = np.maximum(0, np.minimum(g[:, None, 3], d[None, :, 3]) -
                    np.maximum(g[:, None, 1], d[None, :, 1]))
    inter = ix * iy
    ga = (g[:, 2] - g[:, 0]) * (g[:, 3] - g[:, 1])
    da = (d[:, 2] - d[:, 0]) * (d[:, 3] - d[:, 1])
    denom = ga[:, None] if ioa else ga[:, None] + da[None] - inter
    return np.where(denom > 0, inter / np.maximum(denom, EPS), 0.0)


def _contiguize(ids_per_t: List[np.ndarray]) -> int:
    """Relabel raw track ids in-place to a contiguous 0..K-1 range; -> K."""
    idmap: Dict[int, int] = {}
    for t, ids in enumerate(ids_per_t):
        for i in ids:
            idmap.setdefault(int(i), len(idmap))
        ids_per_t[t] = np.asarray([idmap[int(i)] for i in ids], int)
    return len(idmap)


def _metric_data(gt_ids, trk_ids, sims) -> Dict:
    n_gt = _contiguize(gt_ids)
    n_trk = _contiguize(trk_ids)
    return {"num_gt_ids": n_gt, "num_tracker_ids": n_trk,
            "num_gt_dets": int(sum(len(i) for i in gt_ids)),
            "num_tracker_dets": int(sum(len(i) for i in trk_ids)),
            "gt_ids": gt_ids, "tracker_ids": trk_ids,
            "similarity_scores": sims}


def _all_metrics(data: Dict) -> Dict:
    from fastervit_tpu_torch.tracking.metrics import (
        clear_metrics, hota_metrics, identity_metrics)
    out = {"Dets": data["num_gt_dets"], "PredDets": data["num_tracker_dets"],
           "IDs": data["num_gt_ids"], "PredIDs": data["num_tracker_ids"]}
    out.update(clear_metrics(data))
    out.update(identity_metrics(data))
    out.update({k: v for k, v in hota_metrics(data).items()
                if not k.endswith("_alpha")})
    return out


class KITTI2DBoxDataset:
    """KITTI 2D-box tracking benchmark adapter (TrackEval
    kitti_2d_box.py semantics).

    Layout (kitti_2d_box.py:66-115): sequence list + lengths from
    `GT_FOLDER/evaluate_tracking.seqmap.<split>` rows `seq _ start length`;
    gt at `GT_FOLDER/label_02/<seq>.txt` in the KITTI tracking label format
    (frame id type truncated occluded alpha x1 y1 x2 y2 ... [score]); tracker
    files at `TRACKERS_FOLDER/<tracker>/data/<seq>.txt`. Frames 0-based.

    Per-class evaluation (car, pedestrian), preprocessing steps
    (kitti_2d_box.py:262-351):
      1) gt rows restricted to the class + its distractor (car<-van,
         pedestrian<-person); tracker rows to the class only; `dontcare`
         rows become crowd-ignore regions regardless of id;
      2) tracker dets Hungarian-matched (IoU >= 0.5) to gt that is a
         distractor class OR occlusion > 2 OR truncation > 0 are removed;
      3) unmatched tracker dets with height <= 25 px, or > 50% of their
         area inside a dontcare region, are removed;
      4) gt kept only if exactly the class with occlusion <= 2 and
         truncation <= 0.
    """

    CLASS_IDS = {"car": 1, "van": 2, "truck": 3, "pedestrian": 4,
                 "person": 5, "cyclist": 6, "tram": 7, "misc": 8,
                 "dontcare": 9, "car_2": 1}
    DISTRACTORS = {"car": ("van",), "pedestrian": ("person",)}
    max_occlusion = 2
    max_truncation = 0
    min_height = 25

    def __init__(self, gt_folder: str, trackers_folder: str,
                 split: str = "training",
                 classes: Sequence[str] = ("car", "pedestrian"),
                 trackers_to_eval: Optional[List[str]] = None,
                 tracker_sub_fol: str = "data"):
        for c in classes:
            if c not in self.DISTRACTORS:
                raise ValueError(f"class {c!r} is not evaluatable "
                                 "(only car/pedestrian)")
        self.gt_fol, self.tracker_fol = gt_folder, trackers_folder
        self.class_list = list(classes)
        self.tracker_sub_fol = tracker_sub_fol
        seqmap = os.path.join(gt_folder, f"evaluate_tracking.seqmap.{split}")
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

    def _load(self, path: str, is_gt: bool):
        """-> (per-frame det rows, per-frame dontcare boxes). Det rows are
        (frame, id, class_id, trunc, occ, x1, y1, x2, y2, conf); string
        classes outside the evaluated set are dropped at load like
        TrackEval's valid_filter; negative ids dropped (dets only)."""
        valid = set(self.class_list)
        if is_gt:
            for c in self.class_list:
                valid.update(self.DISTRACTORS[c])
        dets, ignores = defaultdict(list), defaultdict(list)
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                fr, cls_name = int(float(parts[0])), parts[2].lower()
                box = [float(v) for v in parts[6:10]]
                if is_gt and cls_name == "dontcare":
                    ignores[fr].append(box)
                    continue
                if cls_name not in valid or float(parts[1]) < 0:
                    continue
                conf = float(parts[17]) if len(parts) > 17 else 1.0
                dets[fr].append([float(parts[1]), self.CLASS_IDS[cls_name],
                                 float(parts[3]), float(parts[4])] + box
                                + [conf])
        return dets, ignores

    def sequence_data(self, tracker: str, seq: str, cls: str) -> Dict:
        """-> metric-suite data dict for one class after KITTI preprocessing."""
        gt_rows, ignores = self._load(
            os.path.join(self.gt_fol, "label_02", seq + ".txt"), True)
        trk_rows, _ = self._load(os.path.join(
            self.tracker_fol, tracker, self.tracker_sub_fol, seq + ".txt"),
            False)
        nt = self.seq_lengths[seq]
        extra = (set(gt_rows) | set(trk_rows)) - set(range(nt))
        if extra:
            raise ValueError(f"invalid timesteps in {seq}: {sorted(extra)}")
        cls_id = self.CLASS_IDS[cls]
        distr = [self.CLASS_IDS[n] for n in self.DISTRACTORS[cls]]
        gt_ids, trk_ids, sims = [], [], []
        for t in range(nt):
            g = np.asarray(gt_rows.get(t, []), float).reshape(-1, 9)
            d = np.asarray(trk_rows.get(t, []), float).reshape(-1, 9)
            ign = np.asarray(ignores.get(t, []), float).reshape(-1, 4)
            g = g[np.isin(g[:, 1].astype(int), [cls_id] + distr)]
            d = d[d[:, 1].astype(int) == cls_id]
            sim = _iou_xyxy(g[:, 4:8], d[:, 4:8])
            # step 2: drop tracker dets matched to distractor/occluded/
            # truncated gt (kitti_2d_box.py:305-323)
            remove = np.zeros(len(d), bool)
            unmatched = np.arange(len(d))
            if len(g) and len(d):
                ms = sim.copy()
                ms[ms < 0.5 - EPS] = 0
                r, c = linear_sum_assignment(-ms)
                ok = ms[r, c] > EPS
                r, c = r[ok], c[ok]
                bad = (np.isin(g[r, 1].astype(int), distr)
                       | (g[r, 3] > self.max_occlusion + EPS)
                       | (g[r, 2] > self.max_truncation + EPS))
                remove[c[bad]] = True
                unmatched = np.setdiff1d(unmatched, c)
            # step 3: unmatched too-small or inside-dontcare dets
            um = d[unmatched]
            too_small = (um[:, 7] - um[:, 5]) <= self.min_height + EPS
            in_ignore = np.any(
                _iou_xyxy(um[:, 4:8], ign, ioa=True) > 0.5 + EPS, axis=1)
            remove[unmatched[too_small | in_ignore]] = True
            # step 4: gt kept only for the exact class, visible enough
            keep_gt = ((g[:, 1].astype(int) == cls_id)
                       & (g[:, 3] <= self.max_occlusion)
                       & (g[:, 2] <= self.max_truncation))
            gt_ids.append(g[keep_gt, 0].astype(int))
            trk_ids.append(d[~remove, 0].astype(int))
            sims.append(sim[keep_gt][:, ~remove])
        return _metric_data(gt_ids, trk_ids, sims)

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
                        output_folder, f"{tracker}_{cls}_detailed.csv"),
                        per_seq)
            results[tracker] = per_cls
        return results


class BDD100KDataset:
    """BDD100K MOT benchmark adapter (TrackEval bdd100k.py semantics).

    Layout (bdd100k.py:66-93): one gt json per sequence directly under
    GT_FOLDER (`<seq>.json`, a list of frames with `index` and `labels`
    [{category, id, box2d{x1,y1,x2,y2}, attributes{Crowd}}]); tracker files
    at `TRACKERS_FOLDER/<tracker>/data/<seq>.json`.

    Eight classes evaluated separately; gt labels of a distractor class
    ('other person', 'trailer', 'other vehicle') or with Crowd=True become
    crowd-ignore regions (bdd100k.py:136-169). Preprocessing
    (bdd100k.py:209-258): matched tracker dets are never removed; unmatched
    tracker dets > 50% inside an ignore region are removed; all class gt is
    kept. Super-categories HUMAN/VEHICLE/BIKE group the per-class results
    (bdd100k.py:59-61) via `class_averaged`."""

    VALID_CLASSES = ("pedestrian", "rider", "car", "bus", "truck", "train",
                     "motorcycle", "bicycle")
    CLASS_IDS = {"pedestrian": 1, "rider": 2, "other person": 3, "car": 4,
                 "bus": 5, "truck": 6, "train": 7, "trailer": 8,
                 "other vehicle": 9, "motorcycle": 10, "bicycle": 11}
    DISTRACTORS = ("other person", "trailer", "other vehicle")
    SUPER_CATEGORIES = {"HUMAN": ("pedestrian", "rider"),
                        "VEHICLE": ("car", "truck", "bus", "train"),
                        "BIKE": ("motorcycle", "bicycle")}

    def __init__(self, gt_folder: str, trackers_folder: str,
                 classes: Optional[Sequence[str]] = None,
                 trackers_to_eval: Optional[List[str]] = None,
                 tracker_sub_fol: str = "data"):
        self.gt_fol, self.tracker_fol = gt_folder, trackers_folder
        self.class_list = list(classes or self.VALID_CLASSES)
        for c in self.class_list:
            if c not in self.VALID_CLASSES:
                raise ValueError(f"class {c!r} is not evaluatable")
        self.tracker_sub_fol = tracker_sub_fol
        self.seq_list = sorted(f[:-5] for f in os.listdir(gt_folder)
                               if f.endswith(".json"))
        if not self.seq_list:
            raise FileNotFoundError(f"no gt json files in {gt_folder}")
        if trackers_to_eval is None:
            self.tracker_list = sorted(os.listdir(self.tracker_fol))
        else:
            self.tracker_list = list(trackers_to_eval)
        for tracker in self.tracker_list:
            for seq in self.seq_list:
                p = os.path.join(self.tracker_fol, tracker,
                                 self.tracker_sub_fol, seq + ".json")
                if not os.path.isfile(p):
                    raise FileNotFoundError(f"tracker file not found: {p}")

    def _load(self, path: str, is_gt: bool):
        """-> per-frame (ids, class_ids, boxes, ignore_boxes) in frame-index
        order. Unknown tracker categories map to -1 (never match a class)
        rather than raising, unlike the reference's KeyError."""
        import json
        with open(path) as f:
            frames = sorted(json.load(f), key=lambda x: x["index"])
        out = []
        for fr in frames:
            ids, cls, boxes, ign = [], [], [], []
            for ann in fr.get("labels", []):
                b = ann["box2d"]
                box = [b["x1"], b["y1"], b["x2"], b["y2"]]
                crowd = bool(ann.get("attributes", {}).get("Crowd", False))
                if is_gt and (ann["category"] in self.DISTRACTORS or crowd):
                    ign.append(box)
                    continue
                ids.append(int(ann["id"]))
                cls.append(self.CLASS_IDS.get(ann["category"], -1))
                boxes.append(box)
            out.append((np.asarray(ids, int), np.asarray(cls, int),
                        np.asarray(boxes, float).reshape(-1, 4),
                        np.asarray(ign, float).reshape(-1, 4)))
        return out

    def sequence_data(self, tracker: str, seq: str, cls: str) -> Dict:
        gt = self._load(os.path.join(self.gt_fol, seq + ".json"), True)
        trk = self._load(os.path.join(
            self.tracker_fol, tracker, self.tracker_sub_fol, seq + ".json"),
            False)
        if len(gt) != len(trk):
            raise ValueError(
                f"gt and tracker timestep counts differ for {seq}: "
                f"{len(gt)} vs {len(trk)}")
        cls_id = self.CLASS_IDS[cls]
        gt_ids, trk_ids, sims = [], [], []
        for (gi, gc, gb, ign), (ti, tc, tb, _) in zip(gt, trk):
            gm, tm = gc == cls_id, tc == cls_id
            gi, gb = gi[gm], gb[gm]
            ti, tb = ti[tm], tb[tm]
            sim = _iou_xyxy(gb, tb)
            unmatched = np.arange(len(ti))
            if len(gi) and len(ti):
                ms = sim.copy()
                ms[ms < 0.5 - EPS] = 0
                r, c = linear_sum_assignment(-ms)
                unmatched = np.setdiff1d(unmatched, c[ms[r, c] > EPS])
            in_ignore = np.any(
                _iou_xyxy(tb[unmatched], ign, ioa=True) > 0.5 + EPS, axis=1)
            keep = np.ones(len(ti), bool)
            keep[unmatched[in_ignore]] = False
            gt_ids.append(gi.copy())
            trk_ids.append(ti[keep])
            sims.append(sim[:, keep])
        return _metric_data(gt_ids, trk_ids, sims)

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
                        output_folder, f"{tracker}_{cls}_detailed.csv"),
                        per_seq)
            results[tracker] = per_cls
        return results


def class_averaged(per_cls: Dict[str, Dict], row: str = "COMBINED_SEQ",
                   classes: Optional[Sequence[str]] = None) -> Dict:
    """Arithmetic mean of final metric values over classes — TrackEval's
    cls_comb_cls_av pooling (eval.py combined_cls_keys), also used for the
    BDD100K super-categories (pass classes=SUPER_CATEGORIES[name])."""
    names = [c for c in (classes or per_cls) if c in per_cls]
    fields = per_cls[names[0]][row]
    return {k: float(np.mean([per_cls[c][row][k] for c in names]))
            for k in fields}


def combine_sequence_data(seqs: List[Dict]) -> Dict:
    """Pool per-sequence data into one dict with disjoint id spaces —
    numerically identical to TrackEval's field-summing combine_sequences."""
    out = {"num_gt_ids": 0, "num_tracker_ids": 0, "num_gt_dets": 0,
           "num_tracker_dets": 0, "gt_ids": [], "tracker_ids": [],
           "similarity_scores": []}
    for d in seqs:
        go, po = out["num_gt_ids"], out["num_tracker_ids"]
        out["gt_ids"] += [ids + go for ids in d["gt_ids"]]
        out["tracker_ids"] += [ids + po for ids in d["tracker_ids"]]
        out["similarity_scores"] += list(d["similarity_scores"])
        out["num_gt_ids"] += d["num_gt_ids"]
        out["num_tracker_ids"] += d["num_tracker_ids"]
        out["num_gt_dets"] += d.get("num_gt_dets", 0)
        out["num_tracker_dets"] += d.get("num_tracker_dets", 0)
    return out


def write_detailed_csv(path: str, per_seq: Dict[str, Dict]) -> None:
    """Per-sequence metric table, one row per sequence + COMBINED_SEQ
    (TrackEval utils.write_detail format: 'seq' column then metric fields)."""
    rows = sorted(per_seq)
    fields = sorted(per_seq[rows[0]])
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["seq"] + fields)
        for seq in rows:
            w.writerow([seq] + [f"{float(per_seq[seq][k]):.6f}"
                                for k in fields])


def read_detailed_csv(path: str) -> Dict[str, Dict[str, float]]:
    with open(path, newline="") as f:
        r = csv.reader(f)
        header = next(r)
        return {row[0]: {k: float(v) for k, v in zip(header[1:], row[1:])}
                for row in r}
