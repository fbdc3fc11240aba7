"""DAVIS unsupervised VOS benchmark adapter + J&F metric (TrackEval
trackeval/datasets/davis.py and trackeval/metrics/j_and_f.py semantics).

Layout (davis.py:44-99): per-sequence folders of indexed PNG frames under
GT_FOLDER/<seq> (pixel value = object id, 255 = void) and
TRACKERS_FOLDER/<tracker>/data/<seq>; gt and tracker must have the same
frame count. There are no classes ('general' only) and no preprocessing
except void-pixel zeroing: tracker masks that touch a frame's void region
get those pixels cleared (davis.py:234-246).

J&F (j_and_f.py:20-122): per-(tracker, gt, timestep) Jaccard with the
both-empty => 1 rule; track pairs matched by Hungarian on mean J
('J' optim_type, the TrackEval default); boundary F on matched pairs via
1-pixel boundary maps (_seg2bmap) dilated by a disk of radius
ceil(0.008 * ||frame shape||) (cv2.dilate, matching the reference exactly);
per-gt-track means, >0.5 recalls, first-vs-last-quarter decay; unmatched gt
tracks contribute zero rows. Sequences combine by num_gt_tracks-weighted
average (j_and_f.py:124-129).

The port's copy of fastervit_tpu/tracking/davis.py: the same names,
signatures and code, importing nothing of the JAX package.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
from scipy.optimize import linear_sum_assignment

from fastervit_tpu_torch.tracking.benchmarks import (
    _all_metrics, _metric_data, combine_sequence_data, write_detailed_csv)
from fastervit_tpu_torch.utils.rle import rle_iou

EPS = np.finfo(float).eps


def seg2bmap(seg: np.ndarray) -> np.ndarray:
    """1-pixel-wide binary boundary map, offset 1/2 px towards the origin
    (j_and_f.py:148-204, same-size path)."""
    seg = np.asarray(seg, bool)
    e = np.zeros_like(seg)
    s = np.zeros_like(seg)
    se = np.zeros_like(seg)
    e[:, :-1] = seg[:, 1:]
    s[:-1, :] = seg[1:, :]
    se[:-1, :-1] = seg[1:, 1:]
    b = seg ^ e | seg ^ s | seg ^ se
    b[-1, :] = seg[-1, :] ^ e[-1, :]
    b[:, -1] = seg[:, -1] ^ s[:, -1]
    b[-1, -1] = 0
    return b


def _disk(radius: float) -> np.ndarray:
    """skimage.morphology.disk: L2 ball on the integer grid."""
    r = int(radius)
    grid = np.arange(-r, r + 1)
    x, y = np.meshgrid(grid, grid)
    return (x * x + y * y <= radius * radius).astype(np.uint8)


def boundary_f(gt_mask: np.ndarray, trk_mask: np.ndarray,
               bound_th: float = 0.008) -> float:
    """Boundary F-measure between two masks (j_and_f.py:207-272)."""
    import cv2
    bound_pix = (bound_th if bound_th >= 1 - EPS
                 else np.ceil(bound_th * np.linalg.norm(trk_mask.shape)))
    fg_b = seg2bmap(trk_mask)
    gt_b = seg2bmap(gt_mask)
    kernel = _disk(bound_pix)
    fg_dil = cv2.dilate(fg_b.astype(np.uint8), kernel)
    gt_dil = cv2.dilate(gt_b.astype(np.uint8), kernel)
    n_fg, n_gt = int(fg_b.sum()), int(gt_b.sum())
    if n_fg == 0 and n_gt > 0:
        precision, recall = 1.0, 0.0
    elif n_fg > 0 and n_gt == 0:
        precision, recall = 0.0, 1.0
    elif n_fg == 0 and n_gt == 0:
        precision, recall = 1.0, 1.0
    else:
        precision = float((fg_b & (gt_dil > 0)).sum()) / n_fg
        recall = float((gt_b & (fg_dil > 0)).sum()) / n_gt
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def j_and_f_metrics(gt_tracks: List[Dict[int, np.ndarray]],
                    trk_tracks: List[Dict[int, np.ndarray]],
                    num_timesteps: int, frame_shape,
                    bound_th: float = 0.008) -> Dict[str, float]:
    """J&F for one sequence. Tracks are {timestep: bool mask}; absent
    timesteps count as empty masks (the reference zero-pads,
    j_and_f.py:48-64)."""
    empty = np.zeros(frame_shape, bool)
    get = lambda tr, t: tr.get(t, empty)
    n_gt, n_tr = len(gt_tracks), len(trk_tracks)
    n_tr_pad = max(n_tr, n_gt)        # pad missing tracker ids with empties
    j = np.zeros((n_tr_pad, n_gt, num_timesteps))
    for t in range(num_timesteps):
        for k in range(n_tr_pad):
            d = get(trk_tracks[k], t) if k < n_tr else empty
            da = int(d.sum())
            for i in range(n_gt):
                g = get(gt_tracks[i], t)
                ga = int(g.sum())
                if da == 0 and ga == 0:
                    j[k, i, t] = 1.0   # both empty => 1 (j_and_f.py:304)
                else:
                    inter = int((d & g).sum())
                    union = da + ga - inter
                    j[k, i, t] = inter / union if union else 0.0
    rows, cols = linear_sum_assignment(-np.mean(j, axis=2))
    j_m = j[rows, cols, :]
    f_m = np.zeros_like(j_m)
    for i, (k, gi) in enumerate(zip(rows, cols)):
        dt = trk_tracks[k] if k < n_tr else {}
        f_m[i] = [boundary_f(get(gt_tracks[gi], t), get(dt, t), bound_th)
                  for t in range(num_timesteps)]
    if j_m.shape[0] < n_gt:            # unmatched gt => zero rows
        diff = n_gt - j_m.shape[0]
        j_m = np.concatenate([j_m, np.zeros((diff, num_timesteps))])
        f_m = np.concatenate([f_m, np.zeros((diff, num_timesteps))])
    res = {"J-Mean": [np.nanmean(j_m[i]) for i in range(len(j_m))],
           "J-Recall": [np.nanmean(j_m[i] > 0.5 + EPS)
                        for i in range(len(j_m))],
           "F-Mean": [np.nanmean(f_m[i]) for i in range(len(f_m))],
           "F-Recall": [np.nanmean(f_m[i] > 0.5 + EPS)
                        for i in range(len(f_m))],
           "J-Decay": [], "F-Decay": []}
    ids = (np.round(np.linspace(1, num_timesteps, 5) + 1e-10) - 1).astype(int)
    for m, key in ((j_m, "J-Decay"), (f_m, "F-Decay")):
        for k in range(len(m)):
            bins = [m[k][ids[i]:ids[i + 1] + 1] for i in range(4)]
            res[key].append(np.nanmean(bins[0]) - np.nanmean(bins[3]))
    out = {k: float(np.mean(v)) for k, v in res.items()}
    out["J&F"] = (out["J-Mean"] + out["F-Mean"]) / 2
    out["num_gt_tracks"] = n_gt
    return out


def combine_j_and_f(per_seq: List[Dict[str, float]]) -> Dict[str, float]:
    """num_gt_tracks-weighted average across sequences (j_and_f.py:124)."""
    total = sum(r["num_gt_tracks"] for r in per_seq)
    out = {}
    for k in ["J-Mean", "J-Recall", "J-Decay", "F-Mean", "F-Recall",
              "F-Decay", "J&F"]:
        out[k] = (sum(r[k] * r["num_gt_tracks"] for r in per_seq)
                  / max(total, 1))
    out["num_gt_tracks"] = total
    return out


class DAVISDataset:
    """DAVIS unsupervised benchmark (see module docstring)."""

    def __init__(self, gt_folder: str, trackers_folder: str,
                 seq_list: Optional[List[str]] = None,
                 trackers_to_eval: Optional[List[str]] = None,
                 tracker_sub_fol: str = "data", max_det: int = 0):
        self.gt_fol, self.tracker_fol = gt_folder, trackers_folder
        self.tracker_sub_fol = tracker_sub_fol
        self.max_det = max_det
        self.seq_list = seq_list or sorted(os.listdir(gt_folder))
        if not self.seq_list:
            raise FileNotFoundError(f"no sequences under {gt_folder}")
        self.seq_lengths = {
            seq: len(os.listdir(os.path.join(gt_folder, seq)))
            for seq in self.seq_list}
        if trackers_to_eval is None:
            self.tracker_list = sorted(os.listdir(trackers_folder))
        else:
            self.tracker_list = list(trackers_to_eval)
        for tracker in self.tracker_list:
            for seq in self.seq_list:
                d = os.path.join(trackers_folder, tracker, tracker_sub_fol,
                                 seq)
                if not os.path.isdir(d):
                    raise FileNotFoundError(f"tracker dir not found: {d}")
                if len(os.listdir(d)) != self.seq_lengths[seq]:
                    raise ValueError(
                        f"gt and tracker frame counts differ for {seq}")

    @staticmethod
    def _read_frames(seq_dir: str):
        """-> per-frame (ids, masks (N,H,W) bool, void mask)."""
        from PIL import Image
        out = []
        for name in sorted(os.listdir(seq_dir)):
            frame = np.array(Image.open(os.path.join(seq_dir, name)))
            void = frame == 255
            frame = np.where(void, 0, frame)
            ids = np.unique(frame)
            ids = ids[ids != 0]
            masks = frame[None] == ids[:, None, None]
            out.append((ids.astype(int), masks, void))
        return out

    def sequence_masks(self, tracker: str, seq: str):
        """-> (gt frames, tracker frames with void pixels zeroed,
        frame_shape). Raises when a tracker exceeds max_det objects
        (davis.py:156-158)."""
        gt = self._read_frames(os.path.join(self.gt_fol, seq))
        trk = self._read_frames(os.path.join(
            self.tracker_fol, tracker, self.tracker_sub_fol, seq))
        n_obj = len({i for ids, _, _ in trk for i in ids})
        if self.max_det and n_obj > self.max_det:
            raise ValueError(
                f"number of proposals ({n_obj}) for {seq} exceeds "
                f"MAX_DETECTIONS ({self.max_det})")
        trk = [(ids, masks & ~gt_void[None], void)
               for (ids, masks, void), (_, _, gt_void) in zip(trk, gt)]
        return gt, trk, gt[0][2].shape

    def sequence_data(self, tracker: str, seq: str) -> Dict:
        """-> metric-suite data dict (mask IoU over per-frame objects)."""
        from fastervit_tpu_torch.utils.rle import rle_encode
        gt, trk, _ = self.sequence_masks(tracker, seq)
        gt_ids, trk_ids, sims = [], [], []
        for (gi, gm, _), (ti, tm, _) in zip(gt, trk):
            g_rles = [rle_encode(m) for m in gm]
            t_rles = [rle_encode(m) for m in tm]
            gt_ids.append(gi.copy())
            trk_ids.append(ti.copy())
            sims.append(rle_iou(g_rles, t_rles))
        return _metric_data(gt_ids, trk_ids, sims)

    def _tracks(self, frames):
        tracks: Dict[int, Dict[int, np.ndarray]] = {}
        for t, (ids, masks, _) in enumerate(frames):
            for i, m in zip(ids, masks):
                tracks.setdefault(int(i), {})[t] = m
        return [tracks[i] for i in sorted(tracks)]

    def evaluate(self, trackers: Optional[List[str]] = None,
                 output_folder: Optional[str] = None) -> Dict:
        """-> {tracker: {seq | 'COMBINED_SEQ': {metric: value}}} with both
        the HOTA/CLEAR/Identity suite and J&F per row."""
        results = {}
        for tracker in (trackers or self.tracker_list):
            per_seq, datas, jfs = {}, [], []
            for seq in self.seq_list:
                data = self.sequence_data(tracker, seq)
                datas.append(data)
                gt, trk, shape = self.sequence_masks(tracker, seq)
                jf = j_and_f_metrics(self._tracks(gt), self._tracks(trk),
                                     self.seq_lengths[seq], shape)
                jfs.append(jf)
                per_seq[seq] = {**_all_metrics(data),
                                **{k: v for k, v in jf.items()
                                   if k != "num_gt_tracks"}}
            combined = _all_metrics(combine_sequence_data(datas))
            cjf = combine_j_and_f(jfs)
            combined.update({k: v for k, v in cjf.items()
                             if k != "num_gt_tracks"})
            per_seq["COMBINED_SEQ"] = combined
            results[tracker] = per_seq
            if output_folder:
                os.makedirs(output_folder, exist_ok=True)
                write_detailed_csv(os.path.join(
                    output_folder, f"{tracker}_detailed.csv"), per_seq)
        return results
