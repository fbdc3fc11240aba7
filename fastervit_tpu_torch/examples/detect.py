"""Detection: FasterViT pyramid + DINO-style detector on synthetic data (the
port's copy of examples/detect.py).

    python -m fastervit_tpu_torch.examples.detect [--device cpu]
"""
import argparse

import numpy as np
import torch

import fastervit_tpu_torch as fvt
from fastervit_tpu_torch.detection.dino import (DINODetector, init_weights,
                                                postprocess)
from fastervit_tpu_torch.detection.engine import (DetectionTrainState,
                                                  create_detection_optimizer,
                                                  train_detection_epoch)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda",
                   help="torch device ('cuda', 'cpu')")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass --device cpu")

    cfg = fvt.get_config("faster_vit_0_224", resolution=256)
    with device:
        det = DINODetector(cfg, num_classes=91, num_queries=300,
                           enc_layers=3, dec_layers=3)
    init_weights(det, torch.Generator().manual_seed(0))
    det.eval()  # inference, and training on frozen BatchNorm statistics

    # inference + top-k postprocess
    x = torch.zeros(2, 3, 256, 256, device=device)
    with torch.no_grad():
        out = det(x)
    res = postprocess(out, torch.tensor([[256, 256]] * 2, device=device),
                      num_select=100)
    print("boxes:", tuple(res["boxes"].shape))

    # one training epoch over synthetic targets
    targets = [{"labels": np.array([3]),
                "boxes": np.array([[0.5, 0.5, 0.3, 0.3]])}
               for _ in range(2)]
    state = DetectionTrainState(det, create_detection_optimizer(det))
    metrics = train_detection_epoch(
        state, [(np.zeros((2, 256, 256, 3), np.float32), targets)])
    print("detection loss:", metrics["loss"])
    return {"boxes": tuple(res["boxes"].shape), "loss": metrics["loss"]}


if __name__ == "__main__":
    main()
