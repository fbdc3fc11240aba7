"""COCO-format dataset plumbing without pycocotools: a copy of
fastervit_tpu/detection/coco_data.py (reference dino/datasets/coco.py):
parse an instances json, yield (NHWC images, targets) batches for the
detection engine (`engine.train_detection_epoch`, the CLI's
`--coco-path`), and adapt targets for the mAP evaluator. Images are read
by PIL, imported when an item is read."""
from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from fastervit_tpu_torch.data.preprocess import load_image, normalize
from fastervit_tpu_torch.models.config import IMAGENET_MEAN, IMAGENET_STD


class CocoDetectionDataset:
    """Minimal COCO instances reader: images resized (squash) to a fixed
    training size; boxes emitted normalized cxcywh (the DETR convention)."""

    def __init__(self, image_dir: str, annotation_json: str,
                 image_size: Tuple[int, int] = (512, 512),
                 mean=IMAGENET_MEAN, std=IMAGENET_STD):
        with open(annotation_json) as f:
            coco = json.load(f)
        self.image_dir = image_dir
        self.image_size = image_size
        self.mean, self.std = mean, std
        self.images = {im["id"]: im for im in coco["images"]}
        cat_ids = sorted(c["id"] for c in coco.get("categories", []))
        # contiguous category mapping (reference datasets/coco.py convention)
        self.cat_to_label = {c: i for i, c in enumerate(cat_ids)}
        self.anns = defaultdict(list)
        for a in coco["annotations"]:
            if a.get("iscrowd", 0):
                continue
            self.anns[a["image_id"]].append(a)
        self.ids = sorted(self.images)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i: int):
        info = self.images[self.ids[i]]
        path = os.path.join(self.image_dir, info["file_name"])
        img = load_image(path)
        w0, h0 = img.size
        th, tw = self.image_size
        img = img.resize((tw, th), 3)  # bicubic squash
        x = normalize(np.asarray(img), self.mean, self.std)
        boxes, labels = [], []
        for a in self.anns.get(info["id"], []):
            bx, by, bw, bh = a["bbox"]
            cx, cy = (bx + bw / 2) / w0, (by + bh / 2) / h0
            boxes.append([cx, cy, bw / w0, bh / h0])
            labels.append(self.cat_to_label[a["category_id"]])
        target = {"labels": np.asarray(labels, np.int32),
                  "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
                  "image_id": info["id"],
                  "orig_size": np.asarray([h0, w0], np.int32)}
        return x, target

    def batches(self, batch_size: int) -> Iterator[Tuple[np.ndarray, List[Dict]]]:
        for start in range(0, len(self) - batch_size + 1, batch_size):
            items = [self[i] for i in range(start, start + batch_size)]
            yield np.stack([x for x, _ in items]), [t for _, t in items]


def targets_to_eval_gt(targets: List[Dict]) -> List[Dict]:
    """Engine targets (normalized cxcywh) -> evaluator gt (absolute xyxy)."""
    out = []
    for t in targets:
        h, w = t["orig_size"]
        b = np.asarray(t["boxes"], float)
        xyxy = np.stack([(b[:, 0] - b[:, 2] / 2) * w,
                         (b[:, 1] - b[:, 3] / 2) * h,
                         (b[:, 0] + b[:, 2] / 2) * w,
                         (b[:, 1] + b[:, 3] / 2) * h], -1) if len(b) else \
            np.zeros((0, 4))
        out.append({"boxes": xyxy, "labels": np.asarray(t["labels"])})
    return out
