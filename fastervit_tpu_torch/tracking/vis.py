"""YouTube-VIS benchmark adapter (TrackEval trackeval/datasets/
youtube_vis.py semantics): video instance segmentation evaluated per class
with mask-IoU HOTA/CLEAR/Identity and mask-3D-IoU TrackMAP.

Layout (youtube_vis.py:37-53, 98-107): GT_FOLDER holds exactly one
YouTube-VIS json (videos with `file_names`, categories, annotations = whole
tracks with per-timestep `segmentations` — None for absent frames — plus
`areas`, `iscrowd`, height/width); each tracker at
TRACKERS_FOLDER/<tracker>/data/ holds exactly one json list of result
tracks {video_id, score, category_id, segmentations}.

Semantics reproduced:
  * sequence names are the first path component of `file_names`
    (youtube_vis.py:73); lengths = len(file_names);
  * ALL categories are evaluated (not just gt-present ones,
    youtube_vis.py:59);
  * no preprocessing at all: nothing is removed on either side
    (youtube_vis.py:222-227) — crowd gt participates in HOTA/CLEAR as
    regular detections;
  * TrackMAP: whole tracks keyed by timestep with mask 3D IoU; crowd gt
    tracks are ignore-only there (track_map.py:343-346), and detection
    tracks are sorted by their single track score (youtube_vis.py:304-310).

Segmentations must be RLE dicts (compressed string or uncompressed
count-list counts — utils/rle.as_compressed); polygon segmentations are
not supported in this environment (no rasterizer parity target).

The port's copy of fastervit_tpu/tracking/vis.py: the same names, signatures
and code, importing nothing of the JAX package.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from fastervit_tpu_torch.tracking.benchmarks import (
    _all_metrics, _metric_data, combine_sequence_data, write_detailed_csv)
from fastervit_tpu_torch.utils.rle import as_compressed, rle_iou


def _one_json(folder: str) -> str:
    files = [f for f in os.listdir(folder) if f.endswith(".json")]
    if len(files) != 1:
        raise FileNotFoundError(
            f"{folder} must contain exactly one json file, found {files}")
    return os.path.join(folder, files[0])


def _norm_segs(track) -> List[Optional[Dict]]:
    segs = []
    for seg in track["segmentations"]:
        if not seg:
            segs.append(None)
        elif isinstance(seg, dict):
            segs.append(as_compressed(seg))
        else:
            raise ValueError(
                "polygon segmentations are not supported; provide RLE")
    return segs


class YouTubeVISDataset:
    """YouTube-VIS benchmark (see module docstring)."""

    def __init__(self, gt_folder: str, trackers_folder: str,
                 classes: Optional[Sequence[str]] = None,
                 trackers_to_eval: Optional[List[str]] = None,
                 tracker_sub_fol: str = "data"):
        with open(_one_json(gt_folder)) as f:
            gt = json.load(f)
        self.class_ids = {c["name"]: c["id"] for c in gt["categories"]}
        if classes is None:
            self.class_list = [c["name"] for c in gt["categories"]]
        else:
            bad = [c for c in classes if c not in self.class_ids]
            if bad:
                raise ValueError(f"invalid classes {bad}; valid: "
                                 f"{sorted(self.class_ids)}")
            self.class_list = list(classes)
        self.seq_list = [v["file_names"][0].split("/")[0]
                         for v in gt["videos"]]
        self._seq_ids = dict(zip(self.seq_list,
                                 (v["id"] for v in gt["videos"])))
        self.seq_lengths = {v["id"]: len(v["file_names"])
                            for v in gt["videos"]}
        self._gt_tracks: Dict[int, List[dict]] = {
            v["id"]: [] for v in gt["videos"]}
        for ann in gt["annotations"]:
            ann = dict(ann, segmentations=_norm_segs(ann))
            self._gt_tracks[ann["video_id"]].append(ann)
        if trackers_to_eval is None:
            self.tracker_list = sorted(os.listdir(trackers_folder))
        else:
            self.tracker_list = list(trackers_to_eval)
        self._dt_tracks: Dict[str, Dict[int, List[dict]]] = {}
        for tracker in self.tracker_list:
            with open(_one_json(os.path.join(
                    trackers_folder, tracker, tracker_sub_fol))) as f:
                results = json.load(f)
            by_vid: Dict[int, List[dict]] = {v: [] for v in self._gt_tracks}
            # global track ids in file order (youtube_vis.py:362-363)
            for tid, tr in enumerate(results):
                tr = dict(tr, segmentations=_norm_segs(tr), id=tid)
                by_vid[tr["video_id"]].append(tr)
            self._dt_tracks[tracker] = by_vid

    def sequence_data(self, tracker: str, seq: str, cls: str) -> Dict:
        """-> metric-suite data dict (no preprocessing; mask IoU)."""
        vid = self._seq_ids[seq]
        cls_id = self.class_ids[cls]
        nt = self.seq_lengths[vid]
        gts = [t for t in self._gt_tracks[vid]
               if t["category_id"] == cls_id]
        dts = [t for t in self._dt_tracks[tracker][vid]
               if t["category_id"] == cls_id]
        gt_ids, trk_ids, sims = [], [], []
        for t in range(nt):
            g = [(tr["id"], tr["segmentations"][t]) for tr in gts
                 if tr["segmentations"][t]]
            d = [(tr["id"], tr["segmentations"][t]) for tr in dts
                 if tr["segmentations"][t]]
            gt_ids.append(np.asarray([i for i, _ in g], int))
            trk_ids.append(np.asarray([i for i, _ in d], int))
            sims.append(rle_iou([r for _, r in g], [r for _, r in d]))
        return _metric_data(gt_ids, trk_ids, sims)

    def track_representations(self, tracker: str, cls: str) -> List[Dict]:
        """-> track_map_metrics sequences: mask tracks keyed by timestep,
        crowd gt marked gt_ignore, dt score-sorted."""
        cls_id = self.class_ids[cls]
        out = []
        for seq in self.seq_list:
            vid = self._seq_ids[seq]
            gts = [t for t in self._gt_tracks[vid]
                   if t["category_id"] == cls_id]
            dts = sorted((t for t in self._dt_tracks[tracker][vid]
                          if t["category_id"] == cls_id),
                         key=lambda t: -float(t["score"]))
            to_track = lambda tr: {i: s for i, s in
                                   enumerate(tr["segmentations"]) if s}
            out.append({
                "gt_tracks": [to_track(t) for t in gts],
                "gt_ignore": [int(t.get("iscrowd", 0)) for t in gts],
                "dt_tracks": [to_track(t) for t in dts],
                "dt_scores": [float(t["score"]) for t in dts],
                "iou_type": "mask"})
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
                combined.update(track_map_metrics(
                    self.track_representations(tracker, cls)))
            results[tracker] = per_cls
        return results
