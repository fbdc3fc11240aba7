"""The port's tracking metrics, COCO-RLE codec, MOT-file evaluation and
runtime tracker (fastervit_tpu_torch/tracking/metrics.py, utils/rle.py,
tracking/mot_data.py, tracking/tracker.py) against their JAX-package
originals on the same seeded numpy inputs.

Tolerance: rtol 1e-12, atol 0 (tests/track_parity.py): both sides run the
same numpy code, so equality is expected; ids, labels and RLE strings are
compared exactly."""
import numpy as np
import pytest

from fastervit_tpu.tracking import metrics as jax_metrics
from fastervit_tpu.tracking import mot_data as jax_mot_data
from fastervit_tpu.tracking import tracker as jax_tracker
from fastervit_tpu.utils import rle as jax_rle
from fastervit_tpu_torch.tracking import metrics, mot_data, tracker
from fastervit_tpu_torch.utils import rle
from track_parity import assert_tree_equal


def random_sequence(seed: int, frames: int = 12):
    """A metric-suite sequence: G gt and P tracker identities, each present
    on a random subset of frames, similarity uniform with a share of
    zeros and of near-perfect overlaps."""
    rng = np.random.RandomState(seed)
    g, p = rng.randint(1, 6), rng.randint(1, 7)
    gt_ids, trk_ids, sims = [], [], []
    for _ in range(frames):
        gi = np.flatnonzero(rng.rand(g) < 0.8)
        ti = np.flatnonzero(rng.rand(p) < 0.7)
        s = rng.rand(len(gi), len(ti))
        s[rng.rand(*s.shape) < 0.3] = 0.0
        s[rng.rand(*s.shape) < 0.2] = 0.97
        gt_ids.append(gi)
        trk_ids.append(ti)
        sims.append(s)
    return {"num_gt_ids": g, "num_tracker_ids": p, "gt_ids": gt_ids,
            "tracker_ids": trk_ids, "similarity_scores": sims}


METRICS = ["clear_metrics", "identity_metrics", "hota_metrics",
           "vace_metrics"]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("name", METRICS)
def test_sequence_metrics_match_jax(name, seed):
    data = random_sequence(seed)
    assert_tree_equal(getattr(metrics, name)(data),
                      getattr(jax_metrics, name)(data), name)


def test_metric_thresholds_and_sequence_average_match_jax():
    seqs = [random_sequence(s) for s in range(5)]
    assert_tree_equal(metrics.evaluate_sequences(seqs),
                      jax_metrics.evaluate_sequences(seqs))
    for name in ("clear_metrics", "identity_metrics", "vace_metrics"):
        assert_tree_equal(getattr(metrics, name)(seqs[1], threshold=0.3),
                          getattr(jax_metrics, name)(seqs[1], threshold=0.3))
    alphas = np.asarray([0.1, 0.5, 0.9])
    assert_tree_equal(metrics.hota_metrics(seqs[2], alphas),
                      jax_metrics.hota_metrics(seqs[2], alphas))


def random_track(rng, frames, size=None):
    """{frame: xyxy box} (or a boolean mask when size is given) on a random
    subset of frames, drifting a little a frame."""
    out = {}
    x, y = rng.uniform(0, 40, 2)
    for t in range(frames):
        if rng.rand() < 0.75:
            x, y = x + rng.uniform(-2, 3), y + rng.uniform(-2, 3)
            w, h = rng.uniform(5, 20, 2)
            if size is None:
                out[t] = np.asarray([x, y, x + w, y + h])
            else:
                m = np.zeros(size, bool)
                m[int(y) % size[0]:int(y + h) % size[0] + 1,
                  int(x) % size[1]:int(x + w) % size[1] + 1] = True
                out[t] = m
    return out


@pytest.mark.parametrize("seed", range(3))
def test_track_iou_3d_matches_jax(seed):
    rng = np.random.RandomState(seed)
    a, b = random_track(rng, 10), random_track(rng, 10)
    assert metrics.track_iou_3d(a, b) == jax_metrics.track_iou_3d(a, b)
    a, b = random_track(rng, 10, (48, 64)), random_track(rng, 10, (48, 64))
    assert (metrics.track_iou_3d_mask(a, b)
            == jax_metrics.track_iou_3d_mask(a, b))


def map_sequences(seed: int, iou_type: str):
    """TrackMAP input: three sequences of gt and detection tracks, some
    detections copies of a gt track with noise, one sequence not
    exhaustively labelled, one with crowd gt."""
    rng = np.random.RandomState(seed)
    size = (40, 56) if iou_type == "mask" else None
    seqs = []
    for s in range(3):
        gt = [random_track(rng, 8, size) for _ in range(rng.randint(1, 4))]
        dt = [dict(g) for g in gt if rng.rand() < 0.7]
        dt += [random_track(rng, 8, size) for _ in range(rng.randint(0, 3))]
        if iou_type == "mask":
            gt = [{t: rle.rle_encode(m) for t, m in g.items()} for g in gt]
            dt = [{t: rle.rle_encode(m) for t, m in d.items()} for d in dt]
        seq = {"gt_tracks": gt, "dt_tracks": dt,
               "dt_scores": rng.rand(len(dt)).round(2).tolist(),
               "iou_type": iou_type}
        if s == 1:
            seq["ignore_unmatched_dt"] = True
        if s == 2:
            seq["gt_ignore"] = [i == 0 for i in range(len(gt))]
        seqs.append(seq)
    return seqs


@pytest.mark.parametrize("iou_type", ["bbox", "mask"])
def test_track_map_matches_jax(iou_type):
    for seed in range(3):
        seqs = map_sequences(seed, iou_type)
        assert_tree_equal(metrics.track_map_metrics(seqs),
                          jax_metrics.track_map_metrics(seqs))
    assert_tree_equal(metrics.track_map_metrics([]),
                      jax_metrics.track_map_metrics([]))


def random_masks(seed: int, n: int, shape=(23, 31)):
    rng = np.random.RandomState(seed)
    masks = [rng.rand(*shape) < rng.uniform(0.05, 0.6) for _ in range(n)]
    masks[0][:] = False                  # empty
    masks[1][:] = True                   # full: the counts start at 0
    return masks


@pytest.mark.parametrize("seed", range(3))
def test_rle_codec_matches_jax(seed):
    masks = random_masks(seed, 6)
    for m in masks:
        enc = rle.rle_encode(m)
        assert enc == jax_rle.rle_encode(m)
        np.testing.assert_array_equal(rle.rle_decode(enc),
                                      jax_rle.rle_decode(enc))
        np.testing.assert_array_equal(rle.rle_decode(enc), m)
        assert rle.rle_area(enc) == jax_rle.rle_area(enc) == m.sum()
        np.testing.assert_array_equal(rle.rle_to_bbox(enc),
                                      jax_rle.rle_to_bbox(enc))
        counts = rle._string_to_counts(enc["counts"])
        for seg in ({"size": enc["size"], "counts": counts},
                    {"size": enc["size"],
                     "counts": enc["counts"].encode()}):
            assert rle.as_compressed(seg) == jax_rle.as_compressed(seg)
    encs = [rle.rle_encode(m) for m in masks]
    for intersect in (False, True):
        assert (rle.rle_merge(encs[2:], intersect)
                == jax_rle.rle_merge(encs[2:], intersect))
    assert rle.rle_merge([]) == jax_rle.rle_merge([])
    crowd = [0, 1, 0, 1, 0, 0]
    for iscrowd in (None, crowd):
        np.testing.assert_array_equal(
            rle.rle_iou(encs[:4], encs, iscrowd),
            jax_rle.rle_iou(encs[:4], encs, iscrowd))


def write_mot_pair(tmp_path, seed: int):
    """A gt.txt and a tracker file in MOT format: 5 identities over 15
    frames, the tracker's boxes jittered, ids swapped half-way, some rows
    missed and some false."""
    rng = np.random.RandomState(seed)
    gt, trk = [], []
    for tid in range(1, 6):
        x, y = rng.uniform(0, 300, 2)
        w, h = rng.uniform(20, 80, 2)
        for f in range(1, 16):
            if rng.rand() < 0.1:
                continue
            x += rng.uniform(-3, 5)
            gt.append(f"{f},{tid},{x:.2f},{y:.2f},{w:.2f},{h:.2f},1,1,1")
            if rng.rand() < 0.85:
                j = rng.uniform(-4, 4, 4)
                pid = 100 + (tid if f < 8 or tid > 2 else 3 - tid)
                trk.append(f"{f},{pid},{x + j[0]:.2f},{y + j[1]:.2f},"
                           f"{w + j[2]:.2f},{h + j[3]:.2f},0.9,-1,-1,-1")
    for f in range(1, 16, 4):
        trk.append(f"{f},999,5,5,30,30,0.3,-1,-1,-1")
    g, p = tmp_path / f"gt{seed}.txt", tmp_path / f"trk{seed}.txt"
    g.write_text("\n".join(gt) + "\n")
    p.write_text("\n".join(trk) + "\n")
    return str(g), str(p)


@pytest.mark.parametrize("seed", range(2))
def test_mot_file_evaluation_matches_jax(tmp_path, seed):
    g, p = write_mot_pair(tmp_path, seed)
    gt, pred = mot_data.load_mot_file(g), mot_data.load_mot_file(p)
    assert_tree_equal(gt, jax_mot_data.load_mot_file(g))
    for n in (None, 17):
        assert_tree_equal(mot_data.build_eval_data(gt, pred, n),
                          jax_mot_data.build_eval_data(gt, pred, n))
    got = mot_data.evaluate_mot_files(g, p)
    assert_tree_equal(got, jax_mot_data.evaluate_mot_files(g, p))
    assert 0.0 < got["HOTA"] < 1.0 and got["IDSW"] > 0


def crossing_scene(seed: int, frames: int = 20):
    """Per-frame detections of a seeded scene: two targets crossing each
    other, a third born at frame 5 and missed at frames 9-10 (then dying
    under a short miss tolerance), a fourth born late, low-score clutter,
    scores near the birth and filter thresholds."""
    rng = np.random.RandomState(seed)
    out = []
    for t in range(frames):
        boxes, scores = [], []
        boxes.append([4 * t, 10, 4 * t + 20, 40])
        boxes.append([80 - 4 * t, 12, 100 - 4 * t, 42])
        scores += [0.9, rng.uniform(0.62, 0.95)]
        if t >= 5 and t not in (9, 10):
            boxes.append([50 + t, 60, 70 + t, 90])
            scores.append(rng.uniform(0.55, 0.9))
        if t >= 14:
            boxes.append([120, 5 + t, 140, 35 + t])
            scores.append(0.8)
        for _ in range(rng.randint(0, 3)):
            x, y = rng.uniform(0, 150, 2)
            boxes.append([x, y, x + 10, y + 10])
            scores.append(rng.uniform(0.1, 0.75))
        boxes = np.asarray(boxes, float) + rng.uniform(-1, 1, (len(boxes), 4))
        order = rng.permutation(len(boxes))
        out.append({"boxes": boxes[order],
                    "scores": np.asarray(scores)[order],
                    "labels": rng.randint(0, 3, len(boxes))})
    return out


@pytest.mark.parametrize("kwargs", [
    {}, {"miss_tolerance": 1}, {"score_thresh": 0.6, "filter_thresh": 0.5,
                                "iou_thresh": 0.5}])
def test_track_sequence_matches_jax(kwargs):
    scene = crossing_scene(0)
    got = tracker.track_sequence(scene, tracker.RuntimeTracker(**kwargs))
    want = jax_tracker.track_sequence(scene,
                                      jax_tracker.RuntimeTracker(**kwargs))
    assert len(got) == len(want) == 20
    for t, (a, b) in enumerate(zip(got, want)):
        for k in ("ids", "labels"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{t} {k}")
        assert_tree_equal({k: a[k] for k in ("boxes", "scores")},
                          {k: b[k] for k in ("boxes", "scores")}, str(t))
    ids = [set(r["ids"].tolist()) for r in got]
    assert len(set().union(*ids)) >= 3           # births
    assert any(len(a) > len(b) for a, b in zip(ids, ids[1:]))   # misses


def test_tracker_state_steps_match_jax():
    scene = crossing_scene(1, 8)
    a, b = tracker.RuntimeTracker(), jax_tracker.RuntimeTracker()
    sa = sb = None
    for det in scene:
        sa = a.update(sa, det["boxes"], det["scores"], det["labels"])
        sb = b.update(sb, det["boxes"], det["scores"], det["labels"])
        assert_tree_equal(vars(sa), vars(sb))
        assert_tree_equal(vars(a.active(sa)), vars(b.active(sb)))
