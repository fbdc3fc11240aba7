"""COCO-style detection evaluator (numpy; no pycocotools dependency): a
copy of fastervit_tpu/detection/coco_eval.py, which the port keeps since
importing the JAX package runs jax, with one repair: a detection in an image
that has no ground truth of its class counts as a false positive (the JAX
copy raised IndexError on it).

Implements the pycocotools COCOeval bbox protocol the reference reports
through (dino/datasets/coco_eval.py): per-class greedy score-ordered matching
at IoU thresholds .50:.05:.95 with crowd/area-range ignore semantics
(cocoeval.evaluateImg), 101-point interpolated AP and max-recall AR
accumulated over classes/thresholds (cocoeval.accumulate), reported as the
standard 12 metrics (AP, AP50, AP75, APs/m/l, AR@1/10/100, ARs/m/l).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def _iou_matrix(a: np.ndarray, b: np.ndarray,
                b_crowd: Optional[np.ndarray] = None) -> np.ndarray:
    """xyxy IoU: a (N,4), b (M,4) -> (N,M). Crowd columns use intersection
    over detection area (maskUtils.iou iscrowd semantics)."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    if b_crowd is not None and b_crowd.any():
        union = np.where(b_crowd[None, :], area_a[:, None], union)
    return inter / np.maximum(union, 1e-9)


def _match_image(iou: np.ndarray, g_ignore: np.ndarray, g_crowd: np.ndarray,
                 d_out_of_range: np.ndarray, thr: float
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """cocoeval.evaluateImg greedy matcher for one image/class/threshold.

    iou: (D, G) with detections already score-sorted and gts ordered
    ignored-last. Crowd gts may be matched many-to-one (cocoeval's
    `gtm>0 and not iscrowd` continue-condition).
    Returns (dt_matched (D,), dt_ignored (D,))."""
    d, g = iou.shape
    g_taken = np.zeros(g, bool)
    dt_m = np.full(d, -1, np.int64)
    for di in range(d):
        best, best_iou = -1, min(thr, 1 - 1e-10) - 1e-12
        for gi in range(g):
            if g_taken[gi] and not g_crowd[gi]:
                continue
            if best > -1 and not g_ignore[best] and g_ignore[gi]:
                break
            if iou[di, gi] < best_iou:
                continue
            best_iou = iou[di, gi]
            best = gi
        if best > -1:
            dt_m[di] = best
            g_taken[best] = True
    matched = dt_m >= 0
    # a detection takes its gt's ignore flag; an image with no gt of the
    # class has none to index (the JAX package's copy raised IndexError
    # there): its detections are plain false positives
    dt_ig = np.zeros(d, bool)
    dt_ig[matched] = g_ignore[dt_m[matched]]
    dt_ig = dt_ig | (~matched & d_out_of_range)
    return matched, dt_ig


def _ap_ar(scores, matched, ignored, n_gt) -> Tuple[float, float]:
    """(101-point interpolated AP, max recall) from score-ordered flags."""
    if n_gt == 0:
        return np.nan, np.nan
    order = np.argsort(-scores, kind="stable")
    keep = ~ignored[order]
    tp = matched[order][keep].astype(float)
    if tp.size == 0:
        return 0.0, 0.0
    fp = 1.0 - tp
    ctp, cfp = np.cumsum(tp), np.cumsum(fp)
    recall = ctp / n_gt
    precision = ctp / np.maximum(ctp + cfp, 1e-9)
    for i in range(len(precision) - 1, 0, -1):
        precision[i - 1] = max(precision[i - 1], precision[i])
    idx = np.searchsorted(recall, RECALL_POINTS, side="left")
    prec_at = np.where(idx < len(precision), precision[np.minimum(
        idx, max(len(precision) - 1, 0))], 0.0)
    return float(prec_at.mean()), float(recall[-1])


def _box_area(b: np.ndarray) -> np.ndarray:
    return np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(
        b[:, 3] - b[:, 1], 0, None)


def evaluate_detections(predictions: List[Dict], ground_truths: List[Dict],
                        max_dets: int = 100,
                        full_breakdown: bool = False) -> Dict[str, float]:
    """predictions/ground_truths: per-image dicts of numpy arrays
    {'boxes' (N,4) xyxy, 'labels' (N,), 'scores' (N,) [preds only],
    'iscrowd' (N,) [gts, optional], 'area' (N,) [gts, optional — defaults to
    box area]}.

    Returns {'mAP', 'AP50', 'AP75'}; with full_breakdown also
    {'APs','APm','APl','AR1','AR10','AR100','ARs','ARm','ARl'}."""
    classes = sorted({int(c) for gt in ground_truths
                      for c in np.asarray(gt["labels"]).tolist()})
    t_n = len(IOU_THRESHOLDS)
    area_items = (list(AREA_RANGES.items()) if full_breakdown
                  else [("all", AREA_RANGES["all"])])
    det_caps = sorted({max_dets} | (set(MAX_DETS) if full_breakdown else set()))
    # ap[class, thr, area, maxdet], ar likewise
    ap = np.full((len(classes), t_n, len(area_items), len(det_caps)), np.nan)
    ar = np.full_like(ap, np.nan)

    for ci, cls in enumerate(classes):
        per_image = []
        for pred, gt in zip(predictions, ground_truths):
            g_mask = np.asarray(gt["labels"]) == cls
            g_boxes = np.asarray(gt["boxes"], float).reshape(-1, 4)[g_mask]
            g_crowd = (np.asarray(gt.get("iscrowd", np.zeros(len(g_mask))))
                       .astype(bool)[g_mask])
            g_area = (np.asarray(gt["area"], float)[g_mask]
                      if "area" in gt else _box_area(g_boxes))
            p_mask = np.asarray(pred["labels"]) == cls
            p_boxes = np.asarray(pred["boxes"], float).reshape(-1, 4)[p_mask]
            p_scores = np.asarray(pred["scores"], float)[p_mask]
            order = np.argsort(-p_scores, kind="stable")
            p_boxes, p_scores = p_boxes[order], p_scores[order]
            per_image.append((p_boxes, p_scores, g_boxes, g_crowd, g_area))

        for ai, (_, (lo, hi)) in enumerate(area_items):
            for mi, cap in enumerate(det_caps):
                all_scores, n_gt = [], 0
                all_matched = [[] for _ in range(t_n)]
                all_ignored = [[] for _ in range(t_n)]
                for p_boxes, p_scores, g_boxes, g_crowd, g_area in per_image:
                    g_ig = g_crowd | (g_area < lo) | (g_area > hi)
                    # gts ordered ignored-last (cocoeval sorts by _ignore)
                    g_order = np.argsort(g_ig, kind="stable")
                    g_boxes_s, g_ig_s = g_boxes[g_order], g_ig[g_order]
                    n_gt += int((~g_ig).sum())
                    pb, ps = p_boxes[:cap], p_scores[:cap]
                    d_area = _box_area(pb)
                    d_oor = (d_area < lo) | (d_area > hi)
                    g_crowd_s = g_crowd[g_order]
                    iou = (_iou_matrix(pb, g_boxes_s, g_crowd_s)
                           if len(pb) and len(g_boxes_s)
                           else np.zeros((len(pb), len(g_boxes_s))))
                    all_scores.append(ps)
                    for ti, thr in enumerate(IOU_THRESHOLDS):
                        m, ig = _match_image(iou, g_ig_s, g_crowd_s, d_oor,
                                             thr)
                        all_matched[ti].append(m)
                        all_ignored[ti].append(ig)
                scores = (np.concatenate(all_scores) if all_scores
                          else np.zeros(0))
                for ti in range(t_n):
                    m = (np.concatenate(all_matched[ti]) if all_matched[ti]
                         else np.zeros(0, bool))
                    ig = (np.concatenate(all_ignored[ti]) if all_ignored[ti]
                          else np.zeros(0, bool))
                    ap[ci, ti, ai, mi], ar[ci, ti, ai, mi] = _ap_ar(
                        scores, m, ig, n_gt)

    ai_all = [a for a, _ in area_items].index("all")
    mi_cap = det_caps.index(max_dets)
    out = {"mAP": float(np.nanmean(ap[:, :, ai_all, mi_cap])),
           "AP50": float(np.nanmean(ap[:, 0, ai_all, mi_cap])),
           "AP75": float(np.nanmean(ap[:, 5, ai_all, mi_cap]))}
    if full_breakdown:
        names = [a for a, _ in area_items]
        for key, aname in (("APs", "small"), ("APm", "medium"),
                           ("APl", "large")):
            out[key] = float(np.nanmean(ap[:, :, names.index(aname), mi_cap]))
        for cap in MAX_DETS:
            out[f"AR{cap}"] = float(np.nanmean(
                ar[:, :, ai_all, det_caps.index(cap)]))
        for key, aname in (("ARs", "small"), ("ARm", "medium"),
                           ("ARl", "large")):
            out[key] = float(np.nanmean(
                ar[:, :, names.index(aname), det_caps.index(100)]))
    return out
