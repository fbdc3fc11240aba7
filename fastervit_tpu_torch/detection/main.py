"""DINO detection CLI of the port: evaluation (the `--eval` path of
fastervit_tpu/detection/main.py:28-173).

    python -m fastervit_tpu_torch.detection.main --eval --synthetic \\
        --config configs/dino/dino_4scale_faster_vit_4_21k_224.py \\
        --image-size 800 --batch-size 2 --dtype bfloat16 --output out/

builds the detector from the config (python files with `_base_`
inheritance; `--options` takes dotted overrides such as num_select=100) on a
square canvas of `--image-size`, on the card unless `--device cpu`,
optionally loads a reference DINO checkpoint (`--checkpoint`), runs the
synthetic batches of the JAX CLI through it and `postprocess`, and writes
the COCO metrics of `evaluate_detections` to <output>/eval.json.

Training (no `--eval`, and the flags that only training reads) and COCO
data (`--coco-path`) raise NotImplementedError: the criterion, the
matchers, contrastive denoising, the engine and the COCO loader and
transforms come with the detection training slice, and COCO evaluation on
real images waits for val2017.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

log = logging.getLogger("fastervit_tpu_torch.detection")

_TRAINING = ("{} is a training flag: detection training (the criterion, the "
             "matchers, contrastive denoising, the engine) comes with the "
             "detection training slice")


def parse_args(argv=None):
    p = argparse.ArgumentParser("DINO detection (PyTorch/CUDA port)")
    p.add_argument("--config", required=True,
                   help="python config file (configs/dino/*.py)")
    p.add_argument("--options", nargs="*", default=[],
                   help="dotted config overrides, e.g. num_select=100")
    p.add_argument("--coco-path", default="",
                   help="COCO root (not ported yet: use --synthetic)")
    p.add_argument("--output", default="./output_dino")
    p.add_argument("--batch-size", type=int, default=0,
                   help="override config batch_size")
    p.add_argument("--image-size", type=int, default=512,
                   help="square evaluation canvas")
    p.add_argument("--epochs", type=int, default=0,
                   help="training only (raises)")
    p.add_argument("--eval", action="store_true", help="evaluation only")
    p.add_argument("--checkpoint", default="",
                   help="reference DINO .pth checkpoint to load")
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic data (no COCO needed)")
    p.add_argument("--max-targets", type=int, default=20,
                   help="training only (raises)")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="model dtype (bfloat16 on the card)")
    p.add_argument("--matcher", default="auto",
                   choices=["auto", "host", "auction"],
                   help="training only (raises)")
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
def run_eval(det, batches, num_select: int = 300) -> Dict[str, float]:
    """COCO-protocol evaluation over (NHWC images, targets) batches
    (reference engine.py evaluate + PostProcess): the detector in eval mode
    on its device and dtype, `postprocess`, `evaluate_detections`."""
    from fastervit_tpu_torch.detection.coco_eval import evaluate_detections
    from fastervit_tpu_torch.detection.dino import postprocess
    from fastervit_tpu_torch.ops.boxes import box_cxcywh_to_xyxy

    p = next(det.parameters())
    preds, gts = [], []
    for imgs, targets in batches:
        x = torch.from_numpy(imgs).permute(0, 3, 1, 2).to(p.device, p.dtype)
        sizes = torch.from_numpy(np.stack([t["orig_size"] for t in targets]))
        results = postprocess(det(x), sizes.to(p.device),
                              num_select=num_select)
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
    for flag, set_ in (("--epochs", args.epochs), ("--matcher",
                                                    args.matcher != "auto"),
                       ("--max-targets", args.max_targets != 20)):
        if set_:
            raise NotImplementedError(_TRAINING.format(flag))
    if not args.eval:
        raise NotImplementedError(
            "detection training (no --eval) comes with the detection "
            "training slice; pass --eval")
    if args.coco_path or not args.synthetic:
        raise NotImplementedError(
            "COCO data (coco_data.py, transforms.py) is not ported yet: it "
            "waits for val2017 on the machine; pass --synthetic")
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
    det = build_dino_from_config(cfg, resolution=(size, size),
                                 dtype=getattr(torch, args.dtype),
                                 device=args.device)
    if args.checkpoint:
        load_dino_checkpoint(det, args.checkpoint)
        log.info("loaded reference checkpoint %s", args.checkpoint)
    det.eval()
    batch_size = args.batch_size or int(cfg.get("batch_size", 2))
    batches = synthetic_batches(2, batch_size, size, det.num_classes, seed=1)
    stats = run_eval(det, batches,
                     num_select=int(cfg.get("num_select", 300)))
    log.info("eval: %s", stats)
    os.makedirs(args.output, exist_ok=True)
    with open(os.path.join(args.output, "eval.json"), "w") as f:
        json.dump(stats, f)
    return stats


if __name__ == "__main__":
    main()
