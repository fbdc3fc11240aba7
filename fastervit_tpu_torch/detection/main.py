"""DINO detection CLI of the port: training and evaluation on COCO-format
or synthetic data (fastervit_tpu/detection/main.py:28-219).

    python -m fastervit_tpu_torch.detection.main --synthetic \\
        --config configs/dino/dino_4scale_faster_vit_4_21k_224.py \\
        --image-size 800 --batch-size 2 --dtype bfloat16 --epochs 1 \\
        --matcher auction --output out/
    python -m fastervit_tpu_torch.detection.main --coco-path /data/coco \\
        --config configs/dino/dino_4scale_faster_vit_4_21k_224.py --eval

builds the detector from the config (python files with `_base_`
inheritance; `--options` takes dotted overrides such as num_select=100) on a
square canvas of `--image-size`, on the card unless `--device cpu`,
optionally loads a reference DINO checkpoint (`--checkpoint`), then:
- with `--eval`: runs the evaluation batches through it and
  `postprocess` and writes the COCO metrics of `evaluate_detections` to
  <output>/eval.json;
- without: trains `--epochs` epochs (the config's `epochs` when 0) of the
  training batches (`detection/engine.py`: frozen BatchNorm, targets
  padded to `--max-targets`, `--matcher` host, auction or auto, AdamW with
  the config's per-module learning rates and its lr_drop epoch, the
  global-norm clip), evaluates after each epoch and writes the best
  weights to <output>/best.pth (a torch.save of the state dict; the JAX
  CLI pickles its variables as best.pkl). `--dtype bfloat16` trains with
  f32 weights and a bf16 forward under autocast.

The batches: with `--synthetic`, the JAX CLI's (four training batches an
epoch, two evaluation batches); else COCO's from `--coco-path` (a root
holding train2017/, val2017/ and annotations/instances_{train,val}2017.json;
`detection/coco_data.py::CocoDetectionDataset`), each image squashed to
the square canvas as the JAX CLI squashes it, so no batch needs a padding
mask.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

log = logging.getLogger("fastervit_tpu_torch.detection")
_TRAIN_BATCHES = 4   # synthetic training batches an epoch, as the JAX CLI's


def parse_args(argv=None):
    p = argparse.ArgumentParser("DINO detection (PyTorch/CUDA port)")
    p.add_argument("--config", required=True,
                   help="python config file (configs/dino/*.py)")
    p.add_argument("--options", nargs="*", default=[],
                   help="dotted config overrides, e.g. num_select=100")
    p.add_argument("--coco-path", default="",
                   help="COCO root (expects {train,val}2017 + annotations)")
    p.add_argument("--output", default="./output_dino")
    p.add_argument("--batch-size", type=int, default=0,
                   help="override config batch_size")
    p.add_argument("--image-size", type=int, default=512,
                   help="square canvas (COCO images squashed to it)")
    p.add_argument("--epochs", type=int, default=0,
                   help="training epochs (0: the config's epochs)")
    p.add_argument("--eval", action="store_true", help="evaluation only")
    p.add_argument("--checkpoint", default="",
                   help="reference DINO .pth checkpoint to load")
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic data (no COCO needed; it takes "
                        "precedence over --coco-path)")
    p.add_argument("--max-targets", type=int, default=20,
                   help="targets an image are padded (and cut) to")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="compute dtype (bfloat16 on the card; training "
                        "keeps f32 weights under autocast)")
    p.add_argument("--matcher", default="auto",
                   choices=["auto", "host", "auction"],
                   help="host: scipy's Hungarian; auction: on the device; "
                        "auto: the auction on the card, host on the CPU")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu, which runs the plain "
                        "versions of the kernels")
    return p.parse_args(argv)


def synthetic_batches(n_batches: int, batch_size: int, image_size: int,
                      num_classes: int, seed: int = 0
                      ) -> Iterable[Tuple[np.ndarray, List[Dict]]]:
    """The JAX CLI's synthetic batches, drawn alike from numpy: (NHWC f32
    images, per-image targets {'boxes' cxcywh in [0, 1], 'labels',
    'orig_size'})."""
    rng = np.random.RandomState(seed)
    for _ in range(n_batches):
        imgs = rng.randn(batch_size, image_size, image_size, 3).astype(
            np.float32)
        targets = []
        for _ in range(batch_size):
            n = rng.randint(1, 6)
            boxes = np.stack([rng.uniform(0.2, 0.8, n),
                              rng.uniform(0.2, 0.8, n),
                              rng.uniform(0.05, 0.2, n),
                              rng.uniform(0.05, 0.2, n)], -1)
            targets.append({"boxes": boxes.astype(np.float32),
                            "labels": rng.randint(0, num_classes, n).astype(
                                np.int32),
                            "orig_size": np.asarray(
                                [image_size, image_size], np.int32)})
        yield imgs, targets


@torch.no_grad()
def run_eval(det, batches, num_select: int = 300,
             dtype: Optional[torch.dtype] = None) -> Dict[str, float]:
    """COCO-protocol evaluation over (NHWC images, targets) batches
    (reference engine.py evaluate + PostProcess): the detector in eval mode
    on its device, in its parameters' dtype or, given a bf16 `dtype` beside
    f32 parameters, under autocast; `postprocess`, `evaluate_detections`."""
    from fastervit_tpu_torch.detection.coco_eval import evaluate_detections
    from fastervit_tpu_torch.detection.dino import postprocess
    from fastervit_tpu_torch.ops.boxes import box_cxcywh_to_xyxy
    from fastervit_tpu_torch.train.steps import _autocast

    p = next(det.parameters())
    amp = dtype if dtype is not None and p.dtype == torch.float32 \
        else torch.float32
    det.eval()
    preds, gts = [], []
    for imgs, targets in batches:
        x = torch.from_numpy(imgs).permute(0, 3, 1, 2).to(p.device, p.dtype)
        sizes = torch.from_numpy(np.stack([t["orig_size"] for t in targets]))
        with _autocast(p.device, amp):
            out = det(x)
        results = postprocess(out, sizes.to(p.device), num_select=num_select)
        results = {k: v.cpu().numpy() for k, v in results.items()}
        for bi, t in enumerate(targets):
            preds.append({k: v[bi] for k, v in results.items()})
            h0, w0 = t["orig_size"]
            gxyxy = box_cxcywh_to_xyxy(torch.from_numpy(t["boxes"])).numpy()
            gts.append({"boxes": gxyxy * np.asarray([w0, h0, w0, h0]),
                        "labels": t["labels"]})
    return evaluate_detections(preds, gts, full_breakdown=True)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    if not args.synthetic and not args.coco_path:
        raise ValueError("no data: pass --coco-path (a COCO root) or "
                         "--synthetic")
    from fastervit_tpu_torch.detection.coco_data import CocoDetectionDataset
    from fastervit_tpu_torch.detection.convert import load_dino_checkpoint
    from fastervit_tpu_torch.detection.dino import build_dino_from_config
    from fastervit_tpu_torch.utils.pyconfig import PyConfig

    cfg = PyConfig.fromfile(args.config)
    for ov in args.options:
        k, v = ov.split("=", 1)
        try:
            v = json.loads(v)
        except ValueError:
            pass
        cfg.merge_from_dict({k: v})
    size = args.image_size
    dtype = getattr(torch, args.dtype)
    # training keeps f32 weights and computes in bf16 under autocast
    det = build_dino_from_config(cfg, resolution=(size, size),
                                 dtype=dtype if args.eval else torch.float32,
                                 device=args.device)
    if args.checkpoint:
        load_dino_checkpoint(det, args.checkpoint)
        log.info("loaded reference checkpoint %s", args.checkpoint)
    batch_size = args.batch_size or int(cfg.get("batch_size", 2))
    num_select = int(cfg.get("num_select", 300))

    def coco(split: str) -> CocoDetectionDataset:
        return CocoDetectionDataset(
            os.path.join(args.coco_path, f"{split}2017"),
            os.path.join(args.coco_path, "annotations",
                         f"instances_{split}2017.json"),
            image_size=(size, size))

    def val_batches():
        if args.synthetic:
            return synthetic_batches(2, batch_size, size, det.num_classes,
                                     seed=1)
        return coco("val").batches(batch_size)

    os.makedirs(args.output, exist_ok=True)
    if args.eval:
        stats = run_eval(det.eval(), val_batches(), num_select=num_select)
        log.info("eval: %s", stats)
        with open(os.path.join(args.output, "eval.json"), "w") as f:
            json.dump(stats, f)
        return stats
    train_ds = None if args.synthetic else coco("train")

    def train_batches():
        if args.synthetic:
            return synthetic_batches(_TRAIN_BATCHES, batch_size, size,
                                     det.num_classes)
        return train_ds.batches(batch_size)

    steps_per_epoch = (_TRAIN_BATCHES if args.synthetic
                       else max(1, len(train_ds) // batch_size))
    return train(args, cfg, det, dtype, train_batches, steps_per_epoch,
                 val_batches, num_select)


def train(args, cfg, det, dtype, train_batches, steps_per_epoch: int,
          val_batches, num_select: int) -> Dict[str, float]:
    """The training path (JAX main.py:175-219): per-module learning rates
    dropped ×0.1 at the config's lr_drop epoch (steps_per_epoch steps an
    epoch), an evaluation after each epoch, the best weights by mAP
    written to <output>/best.pth."""
    from fastervit_tpu_torch.detection.engine import (
        DetectionTrainState, create_detection_optimizer,
        train_detection_epoch)

    epochs = args.epochs or int(cfg.get("epochs", 12))
    optimizer = create_detection_optimizer(
        det, lr=float(cfg.get("lr", 1e-4)),
        lr_backbone=float(cfg.get("lr_backbone", 1e-5)),
        weight_decay=float(cfg.get("weight_decay", 1e-4)),
        clip_norm=float(cfg.get("clip_max_norm", 0.1)),
        lr_linear_proj_mult=float(cfg.get("lr_linear_proj_mult", 1.0)),
        linear_proj_names=tuple(cfg.get("lr_linear_proj_names", [])),
        drop_step=int(cfg.get("lr_drop", 11)) * steps_per_epoch)
    state = DetectionTrainState(det, optimizer)
    best, path = -1.0, os.path.join(args.output, "best.pth")
    for epoch in range(epochs):
        t0 = time.time()
        metrics = train_detection_epoch(
            state, train_batches(), max_targets=args.max_targets,
            matcher=args.matcher, dtype=dtype)
        log.info("epoch %d: loss %.4f (%.0fs)", epoch, metrics["loss"],
                 time.time() - t0)
        stats = run_eval(det, val_batches(), num_select=num_select,
                         dtype=dtype)
        log.info("epoch %d eval: %s", epoch, stats)
        if stats["mAP"] >= best:
            best = stats["mAP"]
            torch.save(det.state_dict(), path)
    return {"best_mAP": best, "loss": metrics["loss"] if epochs else None}


if __name__ == "__main__":
    main()
