"""The port's MOTR training CLI (fastervit_tpu_torch.tracking.main) on the
CPU: its synthetic, DanceTrack and joint clips against the JAX CLI's
(equal arrays up to the NCHW layout, for the same seeds); one synthetic
epoch, one epoch on a MOT-layout fixture with a proposal db and one on it
joined with static images, each writing a checkpoint.pth that loads strictly through build_motr_detector
and tracks two frames; and the errors: no data source, no card.

The CLI builds faster_vit_0_any_res at its full width, here at 64x96 with
a 64-wide transformer of one encoder and one decoder layer, 3 queries and
2 proposals, clips of 2 frames."""
import json
import logging

import numpy as np
import pytest
import torch
from PIL import Image

from fastervit_tpu.tracking import main as jax_cli
from fastervit_tpu.tracking.dance_data import DanceTrackClips as JaxDance
from fastervit_tpu.tracking.joint_data import JointClips as JaxJoint
from fastervit_tpu.tracking.joint_data import StaticImageClips as JaxStatic
from fastervit_tpu_torch.tracking import main as cli
from fastervit_tpu_torch.tracking import motr
from fastervit_tpu_torch.tracking.dance_data import DanceTrackClips
from fastervit_tpu_torch.tracking.joint_data import (JointClips,
                                                     StaticImageClips)
from torch_parity import few_torch_threads  # noqa: F401

H, W = 64, 96
NARROW = ["--img-height", str(H), "--img-width", str(W), "--dim", "64",
          "--num-queries", "3", "--num-proposals", "2", "--enc-layers", "1",
          "--dec-layers", "1", "--sampler-lengths", "2", "--epochs", "1",
          "--device", "cpu"]


@pytest.fixture(scope="module")
def mot_root(tmp_path_factory):
    """train/seq0{1,2}/ with 6 JPEG frames of 72x108, gt.txt (two
    identities, one leaving) and a proposal db for seq01."""
    root = tmp_path_factory.mktemp("mot")
    rng = np.random.RandomState(0)
    db = {}
    for s in (1, 2):
        seq = root / "train" / f"seq0{s}"
        (seq / "img1").mkdir(parents=True)
        (seq / "gt").mkdir()
        rows = []
        for t in range(1, 7):
            Image.fromarray(rng.randint(0, 255, (72, 108, 3), np.uint8)).save(
                seq / "img1" / f"{t:08d}.jpg")
            rows.append(f"{t},1,{10 + 4 * t},12,20,30,1,1,1")
            if t < 5:
                rows.append(f"{t},2,60,{20 + 2 * t},16,24,1,1,1")
            if s == 1:
                db[f"train/seq01/img1/{t:08d}.txt"] = [
                    f"{8 + 4 * t},10,24,34,0.9", "58,22,18,26,0.6"]
        (seq / "gt" / "gt.txt").write_text("\n".join(rows) + "\n")
    (root / "det_db.json").write_text(json.dumps(db))
    return root


@pytest.fixture(scope="module")
def static_txt(tmp_path_factory):
    base = tmp_path_factory.mktemp("crowd")
    (base / "images").mkdir()
    (base / "labels_with_ids").mkdir()
    rng = np.random.RandomState(1)
    path = base / "images" / "im0.jpg"
    Image.fromarray(rng.randint(0, 255, (60, 90, 3), np.uint8)).save(path)
    (base / "labels_with_ids" / "im0.txt").write_text(
        "0 1 0.5 0.5 0.3 0.4\n0 2 0.2 0.4 0.1 0.2\n")
    (base / "data.txt").write_text(f"{path}\n")
    return str(base / "data.txt")


def _same_clips(got, want):
    """Clips equal: frames up to NHWC -> NCHW, targets and proposals."""
    assert len(got) == len(want) > 0
    for (gf, gt, gp), (wf, wt, wp) in zip(got, want):
        np.testing.assert_array_equal(gf, np.asarray(wf).transpose(
            0, 1, 4, 2, 3))
        assert gf.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(gp, wp)
        assert len(gt) == len(wt)
        for g_img, w_img in zip(gt, wt):
            for g, w in zip(g_img, w_img):
                assert sorted(g) == sorted(w)
                for k in w:
                    np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("seed,clip_len", [(0, 2), (3, 5)])
def test_synthetic_clips_match_jax(seed, clip_len):
    _same_clips(list(cli._synthetic_clips(2, clip_len, 16, 24, 3, seed)),
                list(jax_cli._synthetic_clips(2, clip_len, 16, 24, 3, seed)))


def test_dance_and_joint_clips_match_jax(mot_root, static_txt):
    args = cli.parse_args(["--mot-path", str(mot_root), "--det-db",
                           "det_db.json", "--clips-per-epoch", "3",
                           "--sample-interval", "2", *NARROW])
    kw = dict(sample_interval=2, sampler_lengths=[2], det_db="det_db.json",
              num_proposals=2)
    got = list(cli._dance_clips(DanceTrackClips(str(mot_root), **kw), args,
                                np.random.RandomState(4)))
    want = list(jax_cli._dance_clips(JaxDance(str(mot_root), **kw), args,
                                     np.random.RandomState(4)))
    _same_clips(got, want)
    assert got[0][0].shape == (2, 1, 3, H, W) and len(got) == 3

    def joint(dance, static, joint_cls):
        return joint_cls([dance(str(mot_root), **kw),
                          static(static_txt, num_proposals=2,
                                 video_offset=10_000)],
                         sampler_lengths=[2])

    args.clips_per_epoch = 4
    got = list(cli._joint_clips(joint(DanceTrackClips, StaticImageClips,
                                      JointClips), args,
                                np.random.RandomState(5)))
    want = list(jax_cli._joint_clips(joint(JaxDance, JaxStatic, JaxJoint),
                                     args, np.random.RandomState(5)))
    _same_clips(got, want)


def _loads_and_tracks(path):
    """checkpoint.pth loads strictly into the CLI's detector, which then
    tracks two frames with finite boxes."""
    det = motr.build_motr_detector(
        (H, W), device="cpu", checkpoint=str(path), dim=64,
        num_detect_queries=3, num_track_queries=3, num_proposal_queries=2,
        enc_layers=1, dec_layers=1)
    frames = np.random.RandomState(6).randn(2, H, W, 3).astype(np.float32)
    res = motr.motr_inference_sequence(det, frames, num_track_slots=3,
                                       dim=64, score_thresh=0.0)
    assert len(res) == 2 and all(np.isfinite(r["boxes"]).all() for r in res)
    return det


def test_synthetic_epoch_writes_a_checkpoint(tmp_path, caplog):
    with caplog.at_level(logging.INFO, "fastervit_tpu_torch.tracking"):
        metrics = cli.main(["--synthetic", "--output", str(tmp_path),
                            *NARROW])
    assert np.isfinite(metrics["loss"]) and metrics["loss"] > 0
    assert sum("--lr-backbone" in r.getMessage()
               for r in caplog.records) == 1
    trained = _loads_and_tracks(tmp_path / "checkpoint.pth")
    fresh = motr.build_motr_detector(
        (H, W), device="cpu", generator=torch.Generator().manual_seed(42),
        dim=64, num_detect_queries=3, num_track_queries=3,
        num_proposal_queries=2, enc_layers=1, dec_layers=1)
    # the weights moved from their seeded init (the class head and the
    # backbone's stem); BatchNorm's statistics did not
    before = dict(fresh.named_parameters())
    for name in ("transformer.decoder.class_embed.0.weight",
                 "backbone.0.patch_embed.conv_down.0.weight"):
        assert not torch.equal(dict(trained.named_parameters())[name],
                               before[name]), name
    for n, b in trained.named_buffers():
        if "running" in n:
            assert torch.equal(b, dict(fresh.named_buffers())[n]), n


def test_mot_path_epoch_writes_a_checkpoint(mot_root, tmp_path):
    metrics = cli.main(["--mot-path", str(mot_root), "--det-db",
                        "det_db.json", "--clips-per-epoch", "1",
                        "--sample-interval", "2", "--output", str(tmp_path),
                        *NARROW])
    assert np.isfinite(metrics["loss"])
    _loads_and_tracks(tmp_path / "checkpoint.pth")


def test_joint_epoch_writes_a_checkpoint(mot_root, static_txt, tmp_path):
    """--mot-path and --joint-static-txt together: JointClips over both."""
    metrics = cli.main(["--mot-path", str(mot_root), "--joint-static-txt",
                        static_txt, "--clips-per-epoch", "2",
                        "--sample-interval", "2", "--output", str(tmp_path),
                        *NARROW])
    assert np.isfinite(metrics["loss"])
    _loads_and_tracks(tmp_path / "checkpoint.pth")


def test_no_data_source_raises(tmp_path):
    with pytest.raises(ValueError, match="--mot-path, --joint-static-txt "
                                         "or --synthetic"):
        cli.main(["--output", str(tmp_path), *NARROW])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_the_card_is_the_default_and_its_absence_raises(tmp_path):
    assert cli.parse_args([]).device == "cuda"
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["--synthetic", "--output", str(tmp_path)])
