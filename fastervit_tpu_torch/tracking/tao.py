"""TAO benchmark adapter (TrackEval trackeval/datasets/tao.py semantics):
federated large-vocabulary tracking evaluation feeding both the HOTA/CLEAR/
Identity suite (tracking/metrics.py) and TrackMAP (track_map_metrics).

Layout (tao.py:51-118): GT_FOLDER holds exactly one TAO-format json
(videos / images with frame_index / annotations with xywh bbox, track_id,
category_id / tracks / categories, where a category may carry a `merged`
list); each tracker at TRACKERS_FOLDER/<tracker>/data/ holds exactly one
json list of result annotations {image_id, bbox, score, track_id,
category_id[, video_id]}.

Semantics reproduced:
  * category merging via the `merged` tag (tao.py:402-415);
  * per-image detection cap by score, MAX_DETECTIONS=300 (tao.py:503-521);
  * missing tracker video_ids filled from the gt image table
    (tao.py:523-535); tracker track ids made unique across videos
    (tao.py:537-566);
  * timesteps are the gt-ANNOTATED images of a video ordered by
    frame_index; tracker dets on other images are ignored
    (tao.py:176-181, 486-501);
  * only classes with ground truth anywhere are evaluated (tao.py:81-82);
  * federated preprocessing (tao.py:280-337): matched tracker dets are
    never removed; unmatched dets are removed at timesteps with no gt of
    the class unless the class is in the video's `neg_category_ids`, and
    always removed for classes in `not_exhaustive_category_ids`;
  * TrackMAP track representations: per-class whole tracks with mean
    score, detections score-sorted (tao.py:372-392).

The port's copy of fastervit_tpu/tracking/tao.py: the same names, signatures
and code, importing nothing of the JAX package.
"""
from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

from fastervit_tpu_torch.tracking.benchmarks import (
    EPS, _all_metrics, _iou_xywh, _metric_data, combine_sequence_data,
    write_detailed_csv)


def _one_json(folder: str) -> str:
    files = [f for f in os.listdir(folder) if f.endswith(".json")]
    if len(files) != 1:
        raise FileNotFoundError(
            f"{folder} must contain exactly one json file, found {files}")
    return os.path.join(folder, files[0])


class TAODataset:
    """TAO federated tracking benchmark (see module docstring)."""

    def __init__(self, gt_folder: str, trackers_folder: str,
                 classes: Optional[Sequence[str]] = None,
                 trackers_to_eval: Optional[List[str]] = None,
                 tracker_sub_fol: str = "data", max_detections: int = 300):
        self.tracker_fol = trackers_folder
        self.tracker_sub_fol = tracker_sub_fol
        self.max_detections = max_detections
        with open(_one_json(gt_folder)) as f:
            gt = json.load(f)
        self._images = {im["id"]: im for im in gt["images"]}
        self._merge_map = {m["id"]: cat["id"] for cat in gt["categories"]
                           for m in cat.get("merged", ())}
        for ann in gt["annotations"] + gt["tracks"]:
            ann["category_id"] = self._merge_map.get(ann["category_id"],
                                                     ann["category_id"])
        self.seq_list = [v["name"].replace("/", "-") for v in gt["videos"]]
        self._seq_ids = {v["name"].replace("/", "-"): v["id"]
                         for v in gt["videos"]}
        self._gt_by_vid = self._vid_mappings(gt["annotations"])
        # timesteps: gt-annotated images only, ordered by frame_index
        self._img_to_t: Dict[int, Dict[int, int]] = {}
        self.seq_lengths: Dict[int, int] = {}
        for v in gt["videos"]:
            imgs = sorted({a["image_id"] for a in self._gt_by_vid[v["id"]]},
                          key=lambda i: self._images[i]["frame_index"])
            self._img_to_t[v["id"]] = {im: t for t, im in enumerate(imgs)}
            self.seq_lengths[v["id"]] = len(imgs)
        self._seq_classes = {
            v["id"]: {
                "pos": {a["category_id"] for a in self._gt_by_vid[v["id"]]},
                "neg": set(v.get("neg_category_ids", ())),
                "not_exhaustive": set(v.get("not_exhaustive_category_ids",
                                            ()))}
            for v in gt["videos"]}
        seen = set().union(*(c["pos"] for c in self._seq_classes.values()))
        self.valid_classes = [c["name"] for c in gt["categories"]
                              if c["id"] in seen]
        self.class_ids = {c["name"]: c["id"] for c in gt["categories"]
                          if c["name"] in self.valid_classes}
        if classes is None:
            self.class_list = list(self.valid_classes)
        else:
            bad = [c for c in classes if c not in self.valid_classes]
            if bad:
                raise ValueError(
                    f"classes {bad} have no ground truth; valid: "
                    f"{self.valid_classes}")
            self.class_list = list(classes)
        if trackers_to_eval is None:
            self.tracker_list = sorted(os.listdir(trackers_folder))
        else:
            self.tracker_list = list(trackers_to_eval)
        self._trk_by_vid: Dict[str, Dict[int, List[dict]]] = {}
        for tracker in self.tracker_list:
            with open(_one_json(os.path.join(
                    trackers_folder, tracker, tracker_sub_fol))) as f:
                anns = json.load(f)
            anns = self._limit_dets(anns)
            img_to_vid = {i: im["video_id"]
                          for i, im in self._images.items()}
            for a in anns:
                a.setdefault("video_id", img_to_vid[a["image_id"]])
            self._unique_track_ids(anns)
            for a in anns:
                a["category_id"] = self._merge_map.get(a["category_id"],
                                                       a["category_id"])
            self._trk_by_vid[tracker] = self._vid_mappings(anns)

    # ---- raw-data helpers --------------------------------------------------
    def _vid_mappings(self, anns: List[dict]) -> Dict[int, List[dict]]:
        by_vid = defaultdict(list)
        for a in anns:
            by_vid[a["video_id"]].append(a)
        for vid in self._seq_ids.values():
            by_vid.setdefault(vid, [])
        return dict(by_vid)

    def _limit_dets(self, anns: List[dict]) -> List[dict]:
        """Per-image score cap (tao.py:503-521, MAX_DETECTIONS)."""
        if not self.max_detections:
            return anns
        per_img = defaultdict(list)
        for a in anns:
            per_img[a["image_id"]].append(a)
        out = []
        for img_anns in per_img.values():
            if len(img_anns) > self.max_detections:
                img_anns = sorted(img_anns, key=lambda x: x["score"],
                                  reverse=True)[:self.max_detections]
            out.extend(img_anns)
        return out

    @staticmethod
    def _unique_track_ids(anns: List[dict]) -> int:
        """Disambiguate track ids reused across videos (tao.py:537-566)."""
        first_vid, clashes, max_id = {}, set(), 0
        for a in anns:
            t = a["track_id"]
            first_vid.setdefault(t, a["video_id"])
            if a["video_id"] != first_vid[t]:
                clashes.add(t)
            max_id = max(max_id, t)
        if clashes:
            fresh: Dict[Tuple[int, int], int] = {}
            for a in anns:
                t = a["track_id"]
                if t in clashes:
                    key = (t, a["video_id"])
                    fresh.setdefault(key, max_id + 1 + len(fresh))
                    a["track_id"] = fresh[key]
        return len(clashes)

    def _per_timestep(self, anns: List[dict], vid: int):
        """-> per-timestep (ids, classes, xywh boxes) arrays."""
        nt = self.seq_lengths[vid]
        img_to_t = self._img_to_t[vid]
        rows = [[] for _ in range(nt)]
        for a in anns:
            t = img_to_t.get(a["image_id"])
            if t is not None:      # non-gt-annotated images are ignored
                rows[t].append(a)
        out = []
        for r in rows:
            out.append((np.asarray([a["track_id"] for a in r], int),
                        np.asarray([a["category_id"] for a in r], int),
                        np.asarray([a["bbox"] for a in r],
                                   float).reshape(-1, 4)))
        return out

    # ---- evaluation data ---------------------------------------------------
    def sequence_data(self, tracker: str, seq: str, cls: str) -> Dict:
        """-> metric-suite data dict after federated TAO preprocessing."""
        vid = self._seq_ids[seq]
        cls_id = self.class_ids[cls]
        info = self._seq_classes[vid]
        is_neg = cls_id in info["neg"]
        not_exhaustive = cls_id in info["not_exhaustive"]
        gt_ts = self._per_timestep(self._gt_by_vid[vid], vid)
        trk_ts = self._per_timestep(self._trk_by_vid[tracker][vid], vid)
        gt_ids, trk_ids, sims = [], [], []
        for (gi, gc, gb), (ti, tc, tb) in zip(gt_ts, trk_ts):
            gm, tm = gc == cls_id, tc == cls_id
            gi, gb = gi[gm], gb[gm]
            ti, tb = ti[tm], tb[tm]
            sim = _iou_xywh(gb, tb)
            unmatched = np.arange(len(ti))
            if len(gi) and len(ti):
                ms = sim.copy()
                ms[ms < 0.5 - EPS] = 0
                r, c = linear_sum_assignment(-ms)
                unmatched = np.setdiff1d(unmatched, c[ms[r, c] > EPS])
            if (len(gi) == 0 and not is_neg) or not_exhaustive:
                keep = np.ones(len(ti), bool)
                keep[unmatched] = False
            else:
                keep = np.ones(len(ti), bool)
            gt_ids.append(gi.copy())
            trk_ids.append(ti[keep])
            sims.append(sim[:, keep])
        return _metric_data(gt_ids, trk_ids, sims)

    def track_representations(self, tracker: str, cls: str) -> List[Dict]:
        """-> track_map_metrics sequences for one class: whole gt/dt tracks
        keyed by IMAGE id (tao.py:221-223 — unlike the HOTA preprocessing,
        TrackMAP track representations keep detections on images without gt
        annotations) with mean-score dt ordering (tao.py:372-392). dt tracks
        of classes outside the video's pos+neg set are excluded; tracks of
        not-exhaustively-labeled classes get the ignore-unmatched rule
        (track_map.py:155-157, 325)."""
        cls_id = self.class_ids[cls]
        out = []
        for seq in self.seq_list:
            vid = self._seq_ids[seq]
            info = self._seq_classes[vid]

            def tracks_of(anns, want_scores):
                tracks = defaultdict(dict)
                scores = defaultdict(list)
                for a in anns:
                    if a["category_id"] != cls_id:
                        continue
                    x, y, w, h = a["bbox"]
                    tracks[a["track_id"]][a["image_id"]] = np.asarray(
                        [x, y, x + w, y + h], float)
                    if want_scores:
                        scores[a["track_id"]].append(float(a["score"]))
                return tracks, scores

            gt_tracks, _ = tracks_of(self._gt_by_vid[vid], False)
            if cls_id in info["pos"] | info["neg"]:   # tao.py:213-214
                dt_tracks, dt_scores = tracks_of(
                    self._trk_by_vid[tracker][vid], True)
            else:
                dt_tracks, dt_scores = {}, {}
            tids = sorted(dt_tracks,
                          key=lambda t: -float(np.mean(dt_scores[t])))
            out.append({"gt_tracks": [gt_tracks[t]
                                      for t in sorted(gt_tracks)],
                        "dt_tracks": [dt_tracks[t] for t in tids],
                        "dt_scores": [float(np.mean(dt_scores[t]))
                                      for t in tids],
                        "ignore_unmatched_dt":
                            cls_id in info["not_exhaustive"]})
        return out

    def evaluate(self, trackers: Optional[List[str]] = None,
                 output_folder: Optional[str] = None) -> Dict:
        """-> {tracker: {class: {seq | 'COMBINED_SEQ': {metric: value}}}};
        the COMBINED_SEQ row also carries the class's pooled TrackMAP."""
        from fastervit_tpu_torch.tracking.metrics import track_map_metrics
        results = {}
        for tracker in (trackers or self.tracker_list):
            per_cls = {}
            for cls in self.class_list:
                per_seq, datas = {}, []
                for seq in self.seq_list:
                    data = self.sequence_data(tracker, seq, cls)
                    datas.append(data)
                    per_seq[seq] = _all_metrics(data)
                combined = _all_metrics(combine_sequence_data(datas))
                per_seq["COMBINED_SEQ"] = combined
                per_cls[cls] = per_seq
                if output_folder:
                    os.makedirs(output_folder, exist_ok=True)
                    write_detailed_csv(os.path.join(
                        output_folder, f"{tracker}_{cls}_detailed.csv"),
                        per_seq)
                # TrackMAP pools whole tracks across sequences; added after
                # the CSV so per-seq and combined rows share one schema
                combined.update(track_map_metrics(
                    self.track_representations(tracker, cls)))
            results[tracker] = per_cls
        return results
