"""MOTR tracking training CLI: the PyTorch port of fastervit_tpu/tracking/
main.py (reference motrv2/main.py:33-47 args + epoch loop,
tools/ddp_train.sh).

    python -m fastervit_tpu_torch.tracking.main --mot-path /data/DanceTrack \\
        --det-db det_db_motrv2.json --sampler-lengths 5 --output out/

Flag files work the reference way via argparse @-expansion
(`python -m fastervit_tpu_torch.tracking.main @configs/my.args`). The flags
and defaults are the JAX CLI's, plus --device.

The JAX package's own MOTRDetector (tracking/motr.py; 60 detect and 60
track queries, 10 proposals, 3 + 3 layers, dim 256 on faster_vit_0_any_res
at 800x1536) with weights drawn from --seed, trained clip by clip
(`motr_clip_train_epoch`: a matching pass, the clip-consistent matcher on
the host, then the gradient pass) in f32, with one AdamW at --lr over every
parameter behind a global-norm clip. --lr-backbone is parsed and, as in
the JAX CLI, not used. The clips come from the DanceTrack sampler with
progressive lengths (--mot-path; MOTRv2's proposal queries from a --det-db
json), mixed with CrowdHuman-style static pseudo-clips
(--joint-static-txt), or --synthetic. Each epoch writes
<output>/checkpoint.pth, a `torch.save` of the detector's state_dict,
which `build_motr_detector(checkpoint=...)` and tracking/submit.py
--checkpoint read.

It runs on the card (--device cuda, the default) and raises without one;
--device cpu runs the plain versions of the kernels. Nothing falls back
to the CPU.
"""
from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

log = logging.getLogger("fastervit_tpu_torch.tracking")

MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def parse_args(argv=None):
    p = argparse.ArgumentParser("MOTR tracking (GPU)",
                                fromfile_prefix_chars="@")
    p.add_argument("--backbone", default="faster_vit_0_any_res")
    p.add_argument("--mot-path", default="", help="DanceTrack/MOT root")
    p.add_argument("--det-db", default="", help="det_db json (MOTRv2 proposals)")
    p.add_argument("--output", default="./output_motr")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--lr-backbone", type=float, default=2e-5,
                   help="parsed and not used: one AdamW at --lr covers "
                        "every parameter, as in the JAX CLI")
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--clip-max-norm", type=float, default=0.1)
    p.add_argument("--img-height", type=int, default=800)
    p.add_argument("--img-width", type=int, default=1536)
    p.add_argument("--sample-interval", type=int, default=10)
    p.add_argument("--sampler-steps", type=int, nargs="*", default=[])
    p.add_argument("--sampler-lengths", type=int, nargs="*", default=[5])
    p.add_argument("--num-queries", type=int, default=60)
    p.add_argument("--num-proposals", type=int, default=10)
    p.add_argument("--enc-layers", type=int, default=3)
    p.add_argument("--dec-layers", type=int, default=3)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--clips-per-epoch", type=int, default=100)
    p.add_argument("--joint-static-txt", default="",
                   help="CrowdHuman-style data_txt of static images: enables "
                        "joint multi-dataset training (reference "
                        "datasets/joint.py)")
    p.add_argument("--joint-static-root", default="",
                   help="root the data_txt paths are relative to")
    p.add_argument("--shift-padding", type=int, default=50,
                   help="static pseudo-clip shift jitter in px")
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic clips smoke run")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu, which runs the plain "
                        "versions of the kernels")
    return p.parse_args(argv)


def _nchw(frames: np.ndarray) -> np.ndarray:
    """(F, B, H, W, 3) -> (F, B, 3, H, W)."""
    return np.ascontiguousarray(frames.transpose(0, 1, 4, 2, 3))


def _synthetic_clips(n, clip_len, h, w, num_proposals, seed=0):
    """The JAX CLI's synthetic clips, drawn alike from RandomState(seed):
    N(0, 1) frames (F, 1, 3, H, W), one target a frame (track id 7, a box
    moving right) and num_proposals copies of its box with random scores
    (F, 1, P, 5)."""
    rng = np.random.RandomState(seed)
    for _ in range(n):
        frames = rng.randn(clip_len, 1, h, w, 3).astype(np.float32)
        targets, props = [], []
        for f in range(clip_len):
            boxes = np.asarray([[0.4 + 0.01 * f, 0.4, 0.1, 0.2]], np.float32)
            targets.append([{"boxes": boxes,
                             "labels": np.zeros(1, np.int32),
                             "track_ids": np.asarray([7])}])
            props.append(np.concatenate(
                [np.tile(boxes, (num_proposals, 1)),
                 rng.rand(num_proposals, 1).astype(np.float32)],
                -1)[None])
        yield _nchw(frames), targets, np.stack(props)


def _dance_clips(sampler, args, rng):
    """(frames (F, 1, 3, H, W), targets, proposals (F, 1, P, 5)) clips from
    the sampler: --clips-per-epoch random starts, each frame resized by
    PIL's bicubic filter and normalised with ImageNet's mean and std."""
    from PIL import Image

    order = rng.permutation(len(sampler.indices))[:args.clips_per_epoch]
    for i in order:
        vid, t0 = sampler.indices[int(i)]
        ts = sampler.sample_frame_indices(vid, t0, rng)
        frames, targets, props = [], [], []
        for t in ts:
            img = Image.open(sampler.frame_image_path(vid, t)).convert("RGB")
            w0, h0 = img.size
            img = img.resize((args.img_width, args.img_height), 3)
            x = (np.asarray(img, np.float32) / 255.0 - MEAN) / STD
            frames.append(x[None])
            targets.append([sampler.frame_targets(vid, t, (w0, h0))])
            props.append(sampler.frame_proposals(vid, t, (w0, h0))[None])
        yield _nchw(np.stack(frames)), targets, np.stack(props)


def _joint_clips(sampler, args, rng):
    """Normalised NCHW clips from a JointClips sampler (mixed video +
    static pseudo-clip sources), at most --clips-per-epoch."""
    n = 0
    for frames, targets, props in sampler.clip_batches(
            1, rng, (args.img_height, args.img_width), with_proposals=True):
        yield _nchw((frames - MEAN) / STD), targets, props
        n += 1
        if n >= args.clips_per_epoch:
            return


def _sampler(args):
    """The clip source the flags name, or None for --synthetic."""
    if args.synthetic:
        return None
    if not (args.mot_path or args.joint_static_txt):
        raise ValueError("no training data: pass --mot-path, "
                         "--joint-static-txt or --synthetic")
    from fastervit_tpu_torch.tracking.dance_data import DanceTrackClips
    sources = []
    if args.mot_path:
        sources.append(DanceTrackClips(
            args.mot_path, sample_interval=args.sample_interval,
            sampler_steps=args.sampler_steps,
            sampler_lengths=args.sampler_lengths,
            det_db=args.det_db or None,
            num_proposals=args.num_proposals))
    if not args.joint_static_txt:
        return sources[0]
    from fastervit_tpu_torch.tracking.joint_data import (JointClips,
                                                         StaticImageClips)
    sources.append(StaticImageClips(
        args.joint_static_txt, args.joint_static_root,
        shift_padding=args.shift_padding, num_proposals=args.num_proposals,
        video_offset=10_000))
    return JointClips(sources, sampler_steps=args.sampler_steps,
                      sampler_lengths=args.sampler_lengths)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    from fastervit_tpu_torch.detection.engine import DetectionTrainState
    from fastervit_tpu_torch.tracking.motr import (build_motr_detector,
                                                   create_motr_optimizer,
                                                   motr_clip_train_epoch)

    sampler = _sampler(args)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the "
                         "plain versions on the CPU")
    log.info("--lr-backbone %g is not used: one AdamW at --lr %g covers "
             "every parameter, as in the JAX CLI", args.lr_backbone, args.lr)
    det = build_motr_detector(
        (args.img_height, args.img_width), backbone=args.backbone,
        device=dev, generator=torch.Generator().manual_seed(args.seed),
        num_classes=1, dim=args.dim, num_detect_queries=args.num_queries,
        num_track_queries=args.num_queries,
        num_proposal_queries=args.num_proposals,
        enc_layers=args.enc_layers, dec_layers=args.dec_layers)
    state = DetectionTrainState(det, create_motr_optimizer(
        det, args.lr, args.weight_decay, args.clip_max_norm))

    os.makedirs(args.output, exist_ok=True)
    rng = np.random.RandomState(args.seed)
    metrics = {}
    for epoch in range(args.epochs):
        t0 = time.time()
        if sampler is not None:
            sampler.set_epoch(epoch)
            if args.joint_static_txt:
                clips = _joint_clips(sampler, args, rng)
            else:
                clips = _dance_clips(sampler, args, rng)
        else:
            clips = _synthetic_clips(2, max(args.sampler_lengths),
                                     args.img_height, args.img_width,
                                     args.num_proposals, seed=epoch)
        metrics = motr_clip_train_epoch(state, clips)
        log.info("epoch %d: loss %.4f (%.0fs)", epoch, metrics["loss"],
                 time.time() - t0)
        torch.save(det.state_dict(),
                   os.path.join(args.output, "checkpoint.pth"))
    return metrics


if __name__ == "__main__":
    main()
