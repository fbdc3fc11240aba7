"""MOTR streaming tracking CLI: the PyTorch port of fastervit_tpu/tracking/
submit.py (reference submit_dance.py:29-121: the image list, the proposal
db and Detector.detect's per-frame loop writing MOT result files).

    python -m fastervit_tpu_torch.tracking.submit --mot-path /data/DanceTrack \\
        --split val --exact --det-db det_db_motrv2.json \\
        --num-queries 10 --enc-layers 6 --dec-layers 6 \\
        --reference-checkpoint motrv2_dancetrack.pth --output results/

Every sequence directory <mot-path>/<split>/<seq>/img1 is read in name
order (JPEG or PNG, through PIL), resized to --img-height x --img-width by
PIL's bicubic filter and normalised with ImageNet's mean and std; the
--det-db JSON (keyed <split>/<seq>/img1/<frame>.txt, rows "x,y,w,h,score"
in pixels) gives each frame its --num-proposals best proposals (the rest
are zero-score centred boxes). A sequence's tracks go to <output>/<seq>.txt
in MOT format, boxes in the original image's pixels, those of area 100
px or less dropped (submit_dance.py:115-118).

--exact (or --reference-checkpoint, an upstream MOTRv2 .pth) runs the
checkpoint-exact detector (tracking/motr_exact.py) with RuntimeTrackerBase's
semantics; the checkpoint must fit the model the flags build (upstream
MOTRv2's: 10 queries, 6 + 6 layers, dim 256), or the run raises. Without
--exact, the JAX package's own MOTRDetector (tracking/motr.py) runs, whose
--checkpoint is a file of the port's own (`torch.save` of its state_dict,
possibly under 'model'). Without a checkpoint the weights are random,
drawn from seed 0.

It runs on the card (--device cuda, the default) and raises without one;
--device cpu runs the plain versions of the kernels. Nothing falls back
to the CPU.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np
import torch

log = logging.getLogger("fastervit_tpu_torch.tracking.submit")


def parse_args(argv=None):
    p = argparse.ArgumentParser("MOTR submit (GPU)",
                                fromfile_prefix_chars="@")
    p.add_argument("--mot-path", required=True)
    p.add_argument("--split", default="val")
    p.add_argument("--checkpoint", default="",
                   help="the port's MOTRDetector state_dict (.pth); random "
                        "init if empty")
    p.add_argument("--det-db", default="",
                   help="proposal JSON under --mot-path")
    p.add_argument("--output", default="./tracker_results")
    p.add_argument("--backbone", default="faster_vit_0_any_res")
    p.add_argument("--img-height", type=int, default=800)
    p.add_argument("--img-width", type=int, default=1536)
    p.add_argument("--num-queries", type=int, default=60)
    p.add_argument("--num-proposals", type=int, default=10)
    p.add_argument("--enc-layers", type=int, default=3)
    p.add_argument("--dec-layers", type=int, default=3)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--score-thresh", type=float, default=0.5)
    p.add_argument("--miss-tolerance", type=int, default=20)
    p.add_argument("--max-frames", type=int, default=0,
                   help="cap frames per sequence (0 = all)")
    p.add_argument("--exact", action="store_true",
                   help="the checkpoint-exact MOTRv2 path "
                        "(tracking/motr_exact.py)")
    p.add_argument("--reference-checkpoint", default="",
                   help="upstream MOTRv2 .pth to load (implies --exact)")
    p.add_argument("--track-capacity", type=int, default=50)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="the detector's compute dtype")
    p.add_argument("--lite-encoder", action="store_true",
                   help="speed mode: the stride-4 level leaves the "
                        "encoder's query set (it stays in the sampled "
                        "values); not reference-exact")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu, which runs the plain "
                        "versions of the kernels")
    return p.parse_args(argv)


def _device(args) -> torch.device:
    """The device asked for; the card's absence raises, never a CPU run."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the "
                         "plain versions on the CPU")
    return dev


def _load_sequences(args):
    """Yield (seq, frames, proposals, orig_sizes) a sequence directory:
    frames normalised (H, W, 3) float32, proposals (num_proposals, 5)
    cxcywh normalised + score, sizes (w0, h0)."""
    from PIL import Image

    det_db = {}
    if args.det_db:
        with open(os.path.join(args.mot_path, args.det_db)) as f:
            det_db = json.load(f)
    mean = np.asarray([0.485, 0.456, 0.406], np.float32)
    std = np.asarray([0.229, 0.224, 0.225], np.float32)
    split_dir = os.path.join(args.mot_path, args.split)
    for seq in sorted(os.listdir(split_dir)):
        img_dir = os.path.join(split_dir, seq, "img1")
        if not os.path.isdir(img_dir):
            continue
        names = sorted(n for n in os.listdir(img_dir)
                       if n.lower().endswith((".jpg", ".jpeg", ".png")))
        if args.max_frames:
            names = names[:args.max_frames]
        frames, props, sizes = [], [], []
        for n in names:
            img = Image.open(os.path.join(img_dir, n)).convert("RGB")
            w0, h0 = img.size
            sizes.append((w0, h0))
            x = np.asarray(img.resize((args.img_width, args.img_height), 3),
                           np.float32) / 255.0
            frames.append((x - mean) / std)
            key = os.path.join(args.split, seq, "img1",
                               os.path.splitext(n)[0] + ".txt")
            prop = np.tile(np.asarray([0.5, 0.5, 0.1, 0.1, 0.0], np.float32),
                           (args.num_proposals, 1))
            rows = []
            for line in det_db.get(key, []):
                x0, y0, bw, bh, s = map(float, line.split(","))
                rows.append([(x0 + bw / 2) / w0, (y0 + bh / 2) / h0,
                             bw / w0, bh / h0, s])
            rows.sort(key=lambda r: -r[4])
            for i, r in enumerate(rows[:args.num_proposals]):
                prop[i] = r
            props.append(prop)
        yield seq, frames, props, sizes


def _write(args, seq, results, sizes) -> None:
    """Boxes to the original image's pixels, the area filter, the file."""
    from fastervit_tpu_torch.tracking.mot_data import write_mot_file

    for res, (w0, h0) in zip(results, sizes):
        res["boxes"] = res["boxes"] * np.asarray([w0, h0, w0, h0])
        wh = res["boxes"][:, 2:4] - res["boxes"][:, 0:2]
        keep = (wh[:, 0] * wh[:, 1]) > 100.0
        for k in ("ids", "boxes", "scores"):
            res[k] = res[k][keep]
    write_mot_file(os.path.join(args.output, f"{seq}.txt"), results)


def _run_exact(args, sequences, dev: torch.device) -> None:
    """Streaming through the checkpoint-exact detector and QIMv2 with
    RuntimeTrackerBase's semantics."""
    from fastervit_tpu_torch.tracking.motr_exact import (
        build_motr_exact, exact_inference_sequence)

    det, qim = build_motr_exact(
        (args.img_height, args.img_width), args.backbone,
        getattr(torch, args.dtype), dev,
        checkpoint=args.reference_checkpoint or None, dim=args.dim,
        num_queries=args.num_queries, enc_layers=args.enc_layers,
        dec_layers=args.dec_layers, lite_encoder=args.lite_encoder)
    for seq, frames, props, sizes in sequences:
        t0 = time.time()
        results = exact_inference_sequence(
            det, qim, frames, num_queries=args.num_queries, dim=args.dim,
            proposals_per_frame=props, num_proposals=args.num_proposals,
            track_capacity=args.track_capacity,
            score_thresh=args.score_thresh,
            miss_tolerance=args.miss_tolerance)
        _write(args, seq, results, sizes)
        log.info("%s (exact): %d frames in %.1fs", seq, len(frames),
                 time.time() - t0)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    dev = _device(args)
    os.makedirs(args.output, exist_ok=True)
    if args.exact or args.reference_checkpoint:
        return _run_exact(args, _load_sequences(args), dev)
    if args.lite_encoder:
        raise SystemExit("--lite-encoder is wired for the --exact streaming "
                         "path (the latency-critical one)")

    from fastervit_tpu_torch.tracking.motr import (build_motr_detector,
                                                   motr_inference_sequence)

    det = build_motr_detector(
        (args.img_height, args.img_width), args.backbone,
        getattr(torch, args.dtype), dev, checkpoint=args.checkpoint or None,
        dim=args.dim, num_detect_queries=args.num_queries,
        num_track_queries=args.num_queries,
        num_proposal_queries=args.num_proposals,
        enc_layers=args.enc_layers, dec_layers=args.dec_layers)
    for seq, frames, props, sizes in _load_sequences(args):
        t0 = time.time()
        results = motr_inference_sequence(
            det, frames, num_track_slots=args.num_queries, dim=args.dim,
            score_thresh=args.score_thresh, filter_thresh=args.score_thresh,
            miss_tolerance=args.miss_tolerance, proposals_per_frame=props)
        _write(args, seq, results, sizes)
        log.info("%s: %d frames in %.1fs", seq, len(frames),
                 time.time() - t0)


if __name__ == "__main__":
    main()
