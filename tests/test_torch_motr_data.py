"""The port's MOTR training readers (fastervit_tpu_torch/tracking/
dance_data.py and joint_data.py) against the JAX package's on fixtures
the tests write: a MOT-layout root of two JPEG sequences with marked-out
and non-person rows and a proposal db, and a CrowdHuman-style list of
static images with labels_with_ids files. For the same seeds both give
equal clip indices, frame ids, targets, proposals, frames and batches, and
the same progressive clip lengths over epochs: the port's copies draw the
same random numbers in the same order."""
import json
import os

import numpy as np
import pytest

from fastervit_tpu.tracking import dance_data as jdd
from fastervit_tpu.tracking import joint_data as jjd
from fastervit_tpu_torch.tracking import dance_data as pdd
from fastervit_tpu_torch.tracking import joint_data as pjd

SIZE = (64, 48)        # the sequences' frames, (w, h)
IMAGE = (32, 40)       # the clips' (h, w)


def _make_seq(root, split, name, num_frames, num_objs=2):
    """A MOT-layout sequence: moving boxes on JPEG frames, a marked-out and
    a non-person row a frame (both filtered), an identity that leaves."""
    from PIL import Image

    seq = os.path.join(root, split, name)
    os.makedirs(os.path.join(seq, "gt"), exist_ok=True)
    os.makedirs(os.path.join(seq, "img1"), exist_ok=True)
    w, h = SIZE
    rng = np.random.RandomState(num_frames)
    rows = []
    for t in range(1, num_frames + 1):
        arr = rng.randint(0, 64, (h, w, 3)).astype(np.uint8)
        for i in range(num_objs if t < num_frames - 2 else 1):
            x, y = 2 + 3 * t + 10 * i, 4 + 2 * t + 6 * i
            rows.append(f"{t},{i + 1},{x},{y},8,10,1,1,1")
            arr[y:y + 10, x:x + 8] = 255
        rows.append(f"{t},99,0,0,5,5,0,1,1")
        rows.append(f"{t},98,0,0,5,5,1,4,1")
        Image.fromarray(arr).save(os.path.join(seq, "img1", f"{t:08d}.jpg"))
    with open(os.path.join(seq, "gt", "gt.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")


@pytest.fixture(scope="module")
def dance_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("DanceTrack"))
    _make_seq(root, "train", "seq0", num_frames=12)
    _make_seq(root, "train", "seq1", num_frames=9)
    det_db = {os.path.join("train/seq0", "img1", f"{t:08d}.txt"):
              [f"{5 + t},6,8,10,0.9", f"{20 + t},10,8,10,0.4",
               "1,1,4,4,0.7"] for t in range(1, 12, 2)}
    with open(os.path.join(root, "det_db.json"), "w") as f:
        json.dump(det_db, f)
    return root


@pytest.fixture(scope="module")
def static_txt(tmp_path_factory):
    """Two static images with a central and a left-edge box each."""
    from PIL import Image
    base = tmp_path_factory.mktemp("crowd")
    img_dir, lbl_dir = base / "images", base / "labels_with_ids"
    img_dir.mkdir()
    lbl_dir.mkdir()
    rng = np.random.RandomState(0)
    paths = []
    for i in range(2):
        p = img_dir / f"im{i}.jpg"
        Image.fromarray((rng.rand(64, 80, 3) * 255).astype(np.uint8)).save(p)
        (lbl_dir / f"im{i}.txt").write_text(
            "0 1 0.5 0.5 0.3 0.4\n0 2 0.05 0.5 0.08 0.2\n")
        paths.append(str(p))
    txt = base / "data.txt"
    txt.write_text("\n".join(paths) + "\n")
    return str(txt)


def _same(got, want, what=""):
    """Equal nested clips: arrays bit for bit, lists and dicts by item."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _same(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}[{i}]")
    elif want is None:
        assert got is None, what
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype, (what, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=what)


def test_parse_gt_matches_jax(dance_root):
    gt = os.path.join(dance_root, "train", "seq0", "gt", "gt.txt")
    want = jdd._parse_gt(gt)
    got = pdd._parse_gt(gt)
    assert dict(got) == dict(want)
    assert all(len(r) == 2 for t, r in want.items() if t < 10)


def test_dance_indices_targets_and_proposals_match_jax(dance_root):
    kw = dict(clip_len=4, sample_interval=3, det_db="det_db.json",
              num_proposals=4)
    want, got = jdd.DanceTrackClips(dance_root, **kw), \
        pdd.DanceTrackClips(dance_root, **kw)
    assert got.indices == want.indices and len(got) == len(want) == 8 + 5
    assert got.video_dict == want.video_dict
    assert got.vid_tmax == want.vid_tmax
    for vid, frames in want.labels_full.items():
        for t in frames:
            _same(got.frame_targets(vid, t, SIZE),
                  want.frame_targets(vid, t, SIZE), f"{vid} {t}")
            _same(got.frame_proposals(vid, t, SIZE),
                  want.frame_proposals(vid, t, SIZE), f"{vid} {t}")
            assert got.frame_image_path(vid, t) == \
                want.frame_image_path(vid, t)
    assert got.frame_proposals("train/seq0", 1, SIZE)[0, 4] == \
        pytest.approx(0.9)


def test_progressive_lengths_match_jax(dance_root):
    kw = dict(clip_len=5, sample_interval=10, sampler_steps=[2, 4],
              sampler_lengths=[2, 3, 5])
    want, got = jdd.DanceTrackClips(dance_root, **kw), \
        pdd.DanceTrackClips(dance_root, **kw)
    seen = []
    for epoch in range(6):
        if epoch % 2:
            want.step_epoch()
            got.step_epoch()
        else:
            want.set_epoch(epoch)
            got.set_epoch(epoch)
        assert got.num_frames_per_batch == want.num_frames_per_batch
        assert got.period_idx == want.period_idx
        seen.append(got.num_frames_per_batch)
    assert seen == [2, 2, 3, 3, 5, 5]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dance_clips_match_jax(dance_root, seed):
    kw = dict(clip_len=3, sample_interval=4, det_db="det_db.json",
              num_proposals=4)
    want, got = jdd.DanceTrackClips(dance_root, **kw), \
        pdd.DanceTrackClips(dance_root, **kw)
    jr, pr = np.random.RandomState(seed), np.random.RandomState(seed)
    for vid, t0 in want.indices:
        assert got.sample_frame_indices(vid, t0, pr) == \
            want.sample_frame_indices(vid, t0, jr)
    for idx in (0, len(want) - 1):
        _same(got.load_clip(idx, pr, IMAGE, with_proposals=True),
              want.load_clip(idx, jr, IMAGE, with_proposals=True),
              f"clip {idx}")
    _same(got.load_clip(1, pr), want.load_clip(1, jr), "native size")
    _same(list(got.clip_batches(2, pr, IMAGE, with_proposals=True)),
          list(want.clip_batches(2, jr, IMAGE, with_proposals=True)),
          "batches")
    assert jr.randint(1 << 30) == pr.randint(1 << 30)


def test_parse_labels_with_ids_matches_jax(static_txt, tmp_path):
    label = static_txt.replace("data.txt", "labels_with_ids/im0.txt")
    _same(pjd.parse_labels_with_ids(label),
          jjd.parse_labels_with_ids(label))
    with pytest.raises(ValueError, match="invalid label path"):
        pjd.parse_labels_with_ids(str(tmp_path / "missing.txt"))


@pytest.mark.parametrize("shift", [10, 49])
def test_static_clips_match_jax(static_txt, shift):
    want = jjd.StaticImageClips(static_txt, shift_padding=shift,
                                video_offset=7)
    got = pjd.StaticImageClips(static_txt, shift_padding=shift,
                               video_offset=7)
    assert got.img_files == want.img_files
    assert got.label_files == want.label_files
    jr, pr = np.random.RandomState(shift), np.random.RandomState(shift)
    dropped = False
    for _ in range(6):
        for idx in range(len(want)):
            w = want.load_clip(idx, jr, IMAGE, clip_len=5,
                               with_proposals=True)
            _same(got.load_clip(idx, pr, IMAGE, clip_len=5,
                                with_proposals=True), w, f"image {idx}")
            dropped |= len(w[1][-1]["boxes"]) < 2
    assert jr.randint(1 << 30) == pr.randint(1 << 30)
    if shift == 49:
        assert dropped, "the edge box never left a pseudo-clip"


def test_joint_clips_match_jax(dance_root, static_txt):
    def joint(dd, jd):
        dance = dd.DanceTrackClips(dance_root, sample_interval=2,
                                   sampler_lengths=[3], det_db="det_db.json",
                                   num_proposals=4)
        static = jd.StaticImageClips(static_txt, num_proposals=4,
                                     video_offset=10_000)
        return jd.JointClips([dance, static], sampler_lengths=[3, 2],
                             sampler_steps=[2])

    want, got = joint(jdd, jjd), joint(pdd, pjd)
    assert len(got) == len(want) == 15 + 2
    jr, pr = np.random.RandomState(5), np.random.RandomState(5)
    for epoch in (0, 2):
        want.set_epoch(epoch)
        got.set_epoch(epoch)
        assert got.num_frames_per_batch == want.num_frames_per_batch
        w = list(want.clip_batches(1, jr, IMAGE, with_proposals=True))
        _same(list(got.clip_batches(1, pr, IMAGE, with_proposals=True)), w,
              f"epoch {epoch}")
        assert w[0][0].shape[0] == (3 if epoch == 0 else 2)
    _same(got.load_clip(16, pr, IMAGE), want.load_clip(16, jr, IMAGE),
          "a static clip by its joint index")
