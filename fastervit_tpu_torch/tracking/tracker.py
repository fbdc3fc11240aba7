"""Streaming multi-object tracker runtime (reference
downstream/object_tracking/motrv2/models/motr.py:302-326 RuntimeTrackerBase
and submit_dance.py:29-121 Detector loop, rebuilt).

The MOTR pattern: a detector proposes per-frame instances with scores; track
identities are born above `score_thresh`, kept while above `filter_thresh`,
and retired after `miss_tolerance` consecutive misses. The track state is
plain numpy carried frame to frame on the host; IoU association turns any
standalone detector (DINO's postprocess output, say) into a tracker. The
MOTR detectors carry their own query-based tracks (tracking/motr_exact.py).

The port's copy of fastervit_tpu/tracking/tracker.py: the same names,
signatures and code, importing nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from fastervit_tpu_torch.ops.boxes import hungarian_match


@dataclasses.dataclass
class TrackState:
    boxes: np.ndarray          # (N, 4) xyxy
    scores: np.ndarray         # (N,)
    labels: np.ndarray         # (N,)
    ids: np.ndarray            # (N,) persistent identities
    misses: np.ndarray         # (N,) consecutive miss counts


class RuntimeTracker:
    """Score-threshold birth/death with IoU association."""

    def __init__(self, score_thresh: float = 0.7, filter_thresh: float = 0.6,
                 miss_tolerance: int = 5, iou_thresh: float = 0.3):
        self.score_thresh = score_thresh
        self.filter_thresh = filter_thresh
        self.miss_tolerance = miss_tolerance
        self.iou_thresh = iou_thresh
        self._next_id = 0

    def _new_ids(self, n: int) -> np.ndarray:
        ids = np.arange(self._next_id, self._next_id + n)
        self._next_id += n
        return ids

    def update(self, state: Optional[TrackState], boxes, scores, labels
               ) -> TrackState:
        boxes = np.asarray(boxes, float)
        scores = np.asarray(scores, float)
        labels = np.asarray(labels)
        if state is None or len(state.ids) == 0:
            keep = scores >= self.score_thresh
            return TrackState(boxes[keep], scores[keep], labels[keep],
                              self._new_ids(int(keep.sum())),
                              np.zeros(int(keep.sum()), int))
        # associate detections to existing tracks by IoU
        from fastervit_tpu_torch.detection.coco_eval import _iou_matrix
        iou = _iou_matrix(state.boxes, boxes) if len(boxes) else \
            np.zeros((len(state.boxes), 0))
        matched_det = np.full(len(boxes), -1)
        matched_trk = np.full(len(state.boxes), -1)
        if iou.size:
            rows, cols = hungarian_match(-iou)
            for r, c in zip(rows, cols):
                if iou[r, c] >= self.iou_thresh and scores[c] >= self.filter_thresh:
                    matched_trk[r] = c
                    matched_det[c] = r

        out_boxes, out_scores, out_labels, out_ids, out_miss = [], [], [], [], []
        for ti in range(len(state.ids)):
            di = matched_trk[ti]
            if di >= 0:
                out_boxes.append(boxes[di])
                out_scores.append(scores[di])
                out_labels.append(labels[di])
                out_ids.append(state.ids[ti])
                out_miss.append(0)
            elif state.misses[ti] + 1 < self.miss_tolerance:
                out_boxes.append(state.boxes[ti])
                out_scores.append(state.scores[ti])
                out_labels.append(state.labels[ti])
                out_ids.append(state.ids[ti])
                out_miss.append(state.misses[ti] + 1)
        for di in range(len(boxes)):
            if matched_det[di] < 0 and scores[di] >= self.score_thresh:
                out_boxes.append(boxes[di])
                out_scores.append(scores[di])
                out_labels.append(labels[di])
                out_ids.append(self._new_ids(1)[0])
                out_miss.append(0)
        return TrackState(
            np.asarray(out_boxes).reshape(-1, 4),
            np.asarray(out_scores, float).reshape(-1),
            np.asarray(out_labels).reshape(-1),
            np.asarray(out_ids, int).reshape(-1),
            np.asarray(out_miss, int).reshape(-1))

    def active(self, state: TrackState) -> TrackState:
        """Visible tracks only (no pending misses) for result writing."""
        keep = state.misses == 0
        return TrackState(state.boxes[keep], state.scores[keep],
                          state.labels[keep], state.ids[keep],
                          state.misses[keep])


def track_sequence(detections_per_frame: List[Dict],
                   tracker: Optional[RuntimeTracker] = None) -> List[Dict]:
    """Run the tracker over per-frame detections; returns per-frame
    {'ids', 'boxes', 'scores', 'labels'} of active tracks."""
    tracker = tracker or RuntimeTracker()
    state = None
    out = []
    for det in detections_per_frame:
        state = tracker.update(state, det["boxes"], det["scores"],
                               det["labels"])
        act = tracker.active(state)
        out.append({"ids": act.ids, "boxes": act.boxes,
                    "scores": act.scores, "labels": act.labels})
    return out
