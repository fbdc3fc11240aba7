"""Multi-object-tracking metrics: CLEAR (MOTA/MOTP/IDSW), Identity (IDF1),
HOTA — the metric suite the reference vendors as TrackEval
(downstream/object_tracking/motrv2/TrackEval: metrics/clear.py,
identity.py, hota.py semantics, re-derived from the published definitions).

Input format (one sequence):
    data = {
      "num_gt_ids": G, "num_tracker_ids": P,
      "gt_ids": [int array per frame], "tracker_ids": [int array per frame],
      "similarity_scores": [(len(gt_t), len(trk_t)) array per frame],
    }
Similarity is IoU-like in [0, 1]. IDs are 0..G-1 / 0..P-1.

The port's copy of fastervit_tpu/tracking/metrics.py: the same names,
signatures and code, importing nothing of the JAX package.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
from scipy.optimize import linear_sum_assignment

EPS = np.finfo(float).eps


def clear_metrics(data: Dict, threshold: float = 0.5) -> Dict[str, float]:
    """CLEAR-MOT: frame-by-frame matching with previous-match continuity
    (Bernardin & Stiefelhagen 2008; TrackEval clear.py semantics)."""
    tp = fn = fp = idsw = 0
    motp_sum = 0.0
    prev_match: Dict[int, int] = {}       # gt_id -> tracker_id (last match)
    gt_total = 0
    matched_per_frame = []                # set of matched gt ids per frame
    for t in range(len(data["gt_ids"])):
        gids = np.asarray(data["gt_ids"][t])
        pids = np.asarray(data["tracker_ids"][t])
        sim = np.asarray(data["similarity_scores"][t], float)
        gt_total += len(gids)
        matched_per_frame.append(set())
        if len(gids) == 0:
            fp += len(pids)
            continue
        if len(pids) == 0:
            fn += len(gids)
            continue
        # bonus for continuing the previous frame's assignment
        score = sim.copy()
        for i, g in enumerate(gids):
            if g in prev_match:
                j = np.where(pids == prev_match[g])[0]
                if len(j):
                    score[i, j[0]] += 1000.0 * (sim[i, j[0]] >= threshold - EPS)
        score = np.where(sim >= threshold - EPS, score, -1e9)
        rows, cols = linear_sum_assignment(-score)
        matched = sim[rows, cols] >= threshold - EPS
        rows, cols = rows[matched], cols[matched]
        tp += len(rows)
        fn += len(gids) - len(rows)
        fp += len(pids) - len(rows)
        motp_sum += float(sim[rows, cols].sum())
        for i, j in zip(rows, cols):
            g, p = int(gids[i]), int(pids[j])
            matched_per_frame[-1].add(g)
            if g in prev_match and prev_match[g] != p:
                idsw += 1
            prev_match[g] = p
    # TrackEval clear.py:178 numerator form: identical to
    # 1 - (FN+FP+IDSW)/gt when gt > 0. Sequences with no gt return MOTA 0
    # regardless of FPs (clear.py:51-54 early path skips the final fields).
    mota = (tp - fp - idsw) / gt_total if gt_total else 0.0
    # track-level stats (TrackEval clear.py:99-122): MT tracked-ratio > 0.8,
    # PT >= 0.2, ML the rest; Frag counts untracked->tracked re-acquisitions
    # (any unmatched or absent timestep breaks the run) minus the first
    # acquisition per gt id
    g = data["num_gt_ids"]
    gt_frames = np.zeros(g)
    matched_frames = np.zeros(g)
    frag_count = np.zeros(g)
    prev_matched = np.zeros(g, bool)
    for t in range(len(data["gt_ids"])):
        gids = np.asarray(data["gt_ids"][t])
        gt_frames[gids] += 1
        now = np.zeros(g, bool)
        for gid in matched_per_frame[t]:
            now[gid] = True
        matched_frames[now] += 1
        frag_count += (~prev_matched) & now
        prev_matched = now
    frag = int(np.sum(frag_count[frag_count > 0] - 1))
    ratio = matched_frames[gt_frames > 0] / gt_frames[gt_frames > 0]
    mt = int((ratio > 0.8).sum())
    pt = int((ratio >= 0.2).sum()) - mt
    return {"MOTA": mota, "MOTP": motp_sum / max(1, tp), "CLR_TP": tp,
            "CLR_FN": fn, "CLR_FP": fp, "IDSW": idsw,
            "CLR_Re": tp / max(1, tp + fn), "CLR_Pr": tp / max(1, tp + fp),
            "MT": mt, "PT": pt, "ML": int((gt_frames > 0).sum()) - mt - pt,
            "Frag": frag}


def identity_metrics(data: Dict, threshold: float = 0.5) -> Dict[str, float]:
    """ID metrics (Ristani et al. 2016): one global bipartite assignment of
    gt tracks to predicted tracks maximizing ID-TP (TrackEval identity.py)."""
    g, p = data["num_gt_ids"], data["num_tracker_ids"]
    potential = np.zeros((g, p))
    gt_count = np.zeros(g)
    trk_count = np.zeros(p)
    for t in range(len(data["gt_ids"])):
        gids = np.asarray(data["gt_ids"][t])
        pids = np.asarray(data["tracker_ids"][t])
        sim = np.asarray(data["similarity_scores"][t], float)
        gt_count[gids] += 1
        trk_count[pids] += 1
        if len(gids) and len(pids):
            ok = sim >= threshold - EPS
            potential[gids[:, None], pids[None, :]] += ok
    # square LP with auxiliary unmatched rows/cols (Ristani et al. 2016):
    # real-real cost = IDFN+IDFP of the pairing; gt i may go unmatched only
    # via its own aux column (cost = its IDFN), likewise predictions.
    big = 1e10
    size = g + p
    cost = np.full((size, size), big)
    cost[:g, :p] = gt_count[:, None] + trk_count[None, :] - 2 * potential
    cost[np.arange(g), p + np.arange(g)] = gt_count
    cost[g + np.arange(p), np.arange(p)] = trk_count
    cost[g:, p:] = 0.0
    rows, cols = linear_sum_assignment(cost)
    idtp = idfn = idfp = 0.0
    for r, c in zip(rows, cols):
        if r < g and c < p:
            idtp += potential[r, c]
            idfn += gt_count[r] - potential[r, c]
            idfp += trk_count[c] - potential[r, c]
        elif r < g:
            idfn += gt_count[r]
        elif c < p:
            idfp += trk_count[c]
    idf1 = 2 * idtp / max(EPS, 2 * idtp + idfn + idfp)
    idr = idtp / max(EPS, idtp + idfn)
    idp = idtp / max(EPS, idtp + idfp)
    return {"IDF1": idf1, "IDR": idr, "IDP": idp, "IDTP": idtp,
            "IDFN": idfn, "IDFP": idfp}


def hota_metrics(data: Dict,
                 alphas: np.ndarray = np.arange(0.05, 0.99, 0.05)) -> Dict:
    """HOTA (Luiten et al. 2021; TrackEval hota.py): detection/association
    decomposition averaged over 19 IoU thresholds."""
    g, p = data["num_gt_ids"], data["num_tracker_ids"]
    nt = len(data["gt_ids"])
    # global alignment score from soft potential matches
    potential = np.zeros((g, p))
    gt_count = np.zeros(g)
    trk_count = np.zeros(p)
    for t in range(nt):
        gids = np.asarray(data["gt_ids"][t])
        pids = np.asarray(data["tracker_ids"][t])
        sim = np.asarray(data["similarity_scores"][t], float)
        gt_count[gids] += 1
        trk_count[pids] += 1
        if len(gids) and len(pids):
            denom = sim.sum(0)[None, :] + sim.sum(1)[:, None] - sim
            sim_iou = np.zeros_like(sim)
            mask = sim > EPS
            sim_iou[mask] = sim[mask] / denom[mask]
            potential[gids[:, None], pids[None, :]] += sim_iou
    global_align = potential / np.maximum(
        gt_count[:, None] + trk_count[None, :] - potential, EPS)

    na = len(alphas)
    tp = np.zeros(na)
    fn = np.zeros(na)
    fp = np.zeros(na)
    loc_sum = np.zeros(na)
    match_counts = np.zeros((na, g, p))
    for t in range(nt):
        gids = np.asarray(data["gt_ids"][t])
        pids = np.asarray(data["tracker_ids"][t])
        sim = np.asarray(data["similarity_scores"][t], float)
        if len(gids) == 0:
            fp += len(pids)
            continue
        if len(pids) == 0:
            fn += len(gids)
            continue
        score = global_align[gids[:, None], pids[None, :]] * sim
        rows, cols = linear_sum_assignment(-score)
        matched_sim = sim[rows, cols]
        for a, alpha in enumerate(alphas):
            ok = matched_sim >= alpha - EPS
            n_m = int(ok.sum())
            tp[a] += n_m
            fn[a] += len(gids) - n_m
            fp[a] += len(pids) - n_m
            loc_sum[a] += float(matched_sim[ok].sum())
            match_counts[a][gids[rows[ok]], pids[cols[ok]]] += 1

    det_a = tp / np.maximum(1, tp + fn + fp)
    ass_a = np.zeros(na)
    for a in range(na):
        if tp[a] > 0:
            ass = match_counts[a] / np.maximum(
                EPS, gt_count[:, None] + trk_count[None, :] - match_counts[a])
            ass_a[a] = (ass * match_counts[a]).sum() / tp[a]
    hota = np.sqrt(det_a * ass_a)
    loc_a = np.where(tp > 0, loc_sum / np.maximum(tp, 1), 1.0)
    return {"HOTA": float(hota.mean()), "DetA": float(det_a.mean()),
            "AssA": float(ass_a.mean()), "LocA": float(loc_a.mean()),
            "HOTA_alpha": hota, "DetA_alpha": det_a, "AssA_alpha": ass_a,
            "LocA_alpha": loc_a}


def vace_metrics(data: Dict, threshold: float = 0.5) -> Dict[str, float]:
    """VACE (Manohar et al. 2006), relaxed variant — TrackEval vace.py
    semantics: STDA/ATA from Hungarian-matched track-level temporal IoU
    (frames with spatial overlap >= threshold over frames where either
    track exists), FDA/SFDA from per-frame Hungarian spatial overlap."""
    g, p = data["num_gt_ids"], data["num_tracker_ids"]
    potential = np.zeros((g, p))
    gt_count = np.zeros(g)
    trk_count = np.zeros(p)
    both = np.zeros((g, p))
    fda = 0.0
    non_empty = 0
    for t in range(len(data["gt_ids"])):
        gids = np.asarray(data["gt_ids"][t])
        pids = np.asarray(data["tracker_ids"][t])
        sim = np.asarray(data["similarity_scores"][t], float)
        ig, ip = np.nonzero(sim >= threshold)
        potential[gids[ig], pids[ip]] += 1
        gt_count[gids] += 1
        trk_count[pids] += 1
        if len(gids) and len(pids):
            both[gids[:, None], pids[None, :]] += 1
        n_g, n_d = len(gids), len(pids)
        if n_g or n_d:
            non_empty += 1
            if n_g and n_d:
                r, c = linear_sum_assignment(-sim)
                fda += sim[r, c].sum() / (0.5 * (n_g + n_d))
    union = gt_count[:, None] + trk_count[None, :] - both
    temporal_iou = np.where(union > 0, potential / np.maximum(union, EPS), 0.0)
    stda = 0.0
    if g and p:
        r, c = linear_sum_assignment(-temporal_iou)
        stda = float(temporal_iou[r, c].sum())
    return {
        "STDA": stda,
        "ATA": stda / max(0.5 * (g + p), EPS),
        "FDA": float(fda),
        "SFDA": float(fda) / max(non_empty, 1),
    }


def evaluate_sequences(seqs: List[Dict]) -> Dict[str, float]:
    """Average metrics over sequences (simple mean, TrackEval-style summary)."""
    outs = []
    for d in seqs:
        m = {}
        m.update(clear_metrics(d))
        m.update(identity_metrics(d))
        m.update(hota_metrics(d))
        m.update(vace_metrics(d))
        outs.append(m)
    keys = ["MOTA", "MOTP", "IDF1", "HOTA", "DetA", "AssA", "ATA", "SFDA"]
    return {k: float(np.mean([o[k] for o in outs])) for k in keys}


def track_iou_3d(dt_track: Dict[int, np.ndarray],
                 gt_track: Dict[int, np.ndarray]) -> float:
    """Spatio-temporal track IoU (TrackEval track_map.py
    _compute_bb_track_iou, x0y0x1y1 format): summed per-frame intersections
    over summed per-frame unions across the union of both tracks' frames."""
    intersect = union = 0.0
    for t in set(gt_track) | set(dt_track):
        g = gt_track.get(t)
        d = dt_track.get(t)
        if d is not None and g is not None:
            w = max(min(d[2], g[2]) - max(d[0], g[0]), 0.0)
            h = max(min(d[3], g[3]) - max(d[1], g[1]), 0.0)
            i = w * h
            union += ((d[2] - d[0]) * (d[3] - d[1])
                      + (g[2] - g[0]) * (g[3] - g[1]) - i)
            intersect += i
        elif g is not None:
            union += (g[2] - g[0]) * (g[3] - g[1])
        elif d is not None:
            union += (d[2] - d[0]) * (d[3] - d[1])
    return intersect / union if union > 0 else 0.0


def track_iou_3d_mask(dt_track: Dict[int, np.ndarray],
                      gt_track: Dict[int, np.ndarray]) -> float:
    """Spatio-temporal track IoU over boolean masks (TrackEval track_map.py
    _compute_mask_track_iou): summed per-frame mask intersections over
    summed per-frame unions across the union of both tracks' frames."""
    intersect = union = 0
    for t in set(gt_track) | set(dt_track):
        g = gt_track.get(t)
        d = dt_track.get(t)
        if d is not None and g is not None:
            i = int((d & g).sum())
            union += int(d.sum()) + int(g.sum()) - i
            intersect += i
        elif g is not None:
            union += int(g.sum())
        elif d is not None:
            union += int(d.sum())
    return intersect / union if union > 0 else 0.0


def track_map_metrics(sequences: List[Dict],
                      iou_thresholds: np.ndarray = None) -> Dict[str, float]:
    """TrackMAP (TrackEval track_map.py / TAO protocol, base ignore mask):
    COCO-style AP over whole tracks using 3D track IoU.

    sequences: list of {'gt_tracks': [ {frame: box_xyxy} ],
                        'dt_tracks': [ {frame: box_xyxy} ],
                        'dt_scores': [float],
                        'ignore_unmatched_dt': bool (optional),
                        'gt_ignore': [bool] (optional),
                        'iou_type': 'bbox'|'mask' (optional)}.
    Detections are score-sorted before greedy matching (TAO convention).
    ignore_unmatched_dt reproduces the TAO not-exhaustively-labeled rule
    (track_map.py:155-157): unmatched detections of such sequences are
    neither TPs nor FPs, while matched ones still count as TPs.
    gt_ignore reproduces the YouTube-VIS crowd rule (track_map.py:343-346):
    ignored gt match only when no regular gt is available, don't count in
    the recall denominator, and ignore the detections matched to them.
    iou_type 'mask' computes the 3D track IoU over RLE masks
    (track_map.py:384-410) — track frames map to RLE dicts, not boxes.
    Returns {'TrackmAP', 'TrackAP50', 'TrackAP75'}."""
    if iou_thresholds is None:
        iou_thresholds = np.arange(0.5, 0.99, 0.05)
    rec_thrs = np.linspace(0.0, 1.0, 101)
    n_thr = len(iou_thresholds)
    all_scores, all_matched, all_ignored = [], [], []
    num_gt = 0
    for seq in sequences:
        gt, dt = seq["gt_tracks"], seq["dt_tracks"]
        if seq.get("iou_type", "bbox") == "mask":
            from fastervit_tpu_torch.utils.rle import rle_decode
            decode = lambda tr: {f: rle_decode(r).astype(bool)
                                 for f, r in tr.items() if r is not None}
            gt = [decode(g) for g in gt]
            dt = [decode(d) for d in dt]
            iou_fn = track_iou_3d_mask
        else:
            iou_fn = track_iou_3d
        scores = np.asarray(seq["dt_scores"], float)
        order = np.argsort(-scores, kind="mergesort")
        gt_ig = np.asarray(seq.get("gt_ignore", [0] * len(gt)), bool)
        num_gt += int((~gt_ig).sum())
        # regular gt first (ignored sorted last, track_map.py:133-135)
        gt_order = np.argsort(gt_ig, kind="mergesort")
        ious = np.zeros((len(dt), len(gt)))
        for di, d in enumerate(dt):
            for gi, g in enumerate(gt):
                ious[di, gi] = iou_fn(d, g)
        matched = np.zeros((n_thr, len(dt)), bool)
        ig_match = np.zeros((n_thr, len(dt)), bool)
        for ti, thr in enumerate(iou_thresholds):
            gt_taken = np.zeros(len(gt), bool)
            for di in order:
                best, best_iou = -1, min(thr, 1 - 1e-10)
                for gi in gt_order:
                    if gt_taken[gi] or ious[di, gi] < best_iou - EPS:
                        continue
                    # a regular match is never displaced by an ignored gt
                    if best >= 0 and not gt_ig[best] and gt_ig[gi]:
                        break
                    best, best_iou = gi, ious[di, gi]
                if best >= 0:
                    gt_taken[best] = True
                    matched[ti, di] = True
                    ig_match[ti, di] = gt_ig[best]
        all_scores.append(scores)
        all_matched.append(matched & ~ig_match)
        ignored = ig_match.copy()
        if seq.get("ignore_unmatched_dt"):
            ignored |= ~matched
        all_ignored.append(ignored)
    if not all_scores or num_gt == 0:
        return {"TrackmAP": 0.0, "TrackAP50": 0.0, "TrackAP75": 0.0}
    scores = np.concatenate(all_scores)
    matched = np.concatenate(all_matched, axis=1)
    ignored = np.concatenate(all_ignored, axis=1)
    order = np.argsort(-scores, kind="mergesort")
    matched = matched[:, order]
    ignored = ignored[:, order]
    aps = np.zeros(n_thr)
    for ti in range(n_thr):
        tp = np.cumsum(matched[ti])
        fp = np.cumsum(~matched[ti] & ~ignored[ti])
        rc = tp / num_gt
        pr = tp / np.maximum(tp + fp, EPS)
        # precision envelope + 101-point interpolation (COCO accumulate)
        for i in range(len(pr) - 2, -1, -1):
            pr[i] = max(pr[i], pr[i + 1])
        idx = np.searchsorted(rc, rec_thrs, side="left")
        aps[ti] = np.mean([pr[j] if j < len(pr) else 0.0 for j in idx])
    t50 = int(np.argmin(np.abs(iou_thresholds - 0.5)))
    t75 = int(np.argmin(np.abs(iou_thresholds - 0.75)))
    return {"TrackmAP": float(aps.mean()), "TrackAP50": float(aps[t50]),
            "TrackAP75": float(aps[t75])}
