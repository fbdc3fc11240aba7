"""DETR-style detection augmentations: a copy of fastervit_tpu/detection/
transforms.py (reference dino/datasets/transforms.py + make_coco_transforms,
dino/datasets/coco.py:487-545).

Host-side numpy/PIL ops over (image, target) pairs where target carries
ABSOLUTE xyxy boxes until the final `normalize_target` step converts to
normalized cxcywh (the reference's T.Normalize does the same).
`pad_to_canvas` puts a batch of images of mixed sizes on one canvas and
returns the padding mask that `DINODetector.forward(..., pad_mask=)` takes
(NestedTensor semantics, util/misc.py). PIL is imported only inside the
functions that take a PIL image, so the module, and `pad_to_canvas`,
import and run without it."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from fastervit_tpu_torch.models.config import IMAGENET_MEAN, IMAGENET_STD


def hflip(img, target: Dict):
    """T.RandomHorizontalFlip's flip op."""
    from PIL import Image

    img = img.transpose(Image.FLIP_LEFT_RIGHT)
    w = img.size[0]
    boxes = target["boxes"].copy()
    if len(boxes):
        boxes = boxes[:, [2, 1, 0, 3]] * np.asarray([-1, 1, -1, 1]) + \
            np.asarray([w, 0, w, 0])
    return img, {**target, "boxes": boxes}


def _size_with_aspect(size: Tuple[int, int], target_short: int,
                      max_size: Optional[int]) -> Tuple[int, int]:
    """Reference get_size_with_aspect_ratio: short side -> target_short,
    long side capped at max_size (transforms.py RandomResize)."""
    w, h = size
    if max_size is not None:
        min_wh, max_wh = float(min(w, h)), float(max(w, h))
        if max_wh / min_wh * target_short > max_size:
            target_short = int(round(max_size * min_wh / max_wh))
    if (w <= h and w == target_short) or (h <= w and h == target_short):
        return h, w
    if w < h:
        ow = target_short
        oh = int(target_short * h / w)
    else:
        oh = target_short
        ow = int(target_short * w / h)
    return oh, ow


def resize(img, target: Dict, short_side: int,
           max_size: Optional[int] = None):
    """T.RandomResize's resize op (bilinear; boxes scaled)."""
    from PIL import Image

    oh, ow = _size_with_aspect(img.size, short_side, max_size)
    rw, rh = ow / img.size[0], oh / img.size[1]
    img = img.resize((ow, oh), Image.BILINEAR)
    boxes = target["boxes"] * np.asarray([rw, rh, rw, rh]) \
        if len(target["boxes"]) else target["boxes"]
    return img, {**target, "boxes": boxes}


def crop(img, target: Dict, region: Tuple[int, int, int, int]):
    """T.crop: region (top, left, h, w); boxes clamped to the crop and
    empty boxes dropped (reference transforms.py crop)."""
    top, left, h, w = region
    img = img.crop((left, top, left + w, top + h))
    boxes = target["boxes"]
    labels = target.get("labels", np.zeros(len(boxes), np.int32))
    if len(boxes):
        boxes = boxes - np.asarray([left, top, left, top])
        boxes = np.stack([boxes[:, 0].clip(0, w), boxes[:, 1].clip(0, h),
                          boxes[:, 2].clip(0, w), boxes[:, 3].clip(0, h)], -1)
        keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
        boxes, labels = boxes[keep], np.asarray(labels)[keep]
    return img, {**target, "boxes": boxes, "labels": labels}


def random_size_crop(img, target: Dict, min_size: int, max_size: int,
                     rng: np.random.RandomState):
    """T.RandomSizeCrop."""
    w = rng.randint(min_size, min(img.size[0], max_size) + 1)
    h = rng.randint(min_size, min(img.size[1], max_size) + 1)
    top = rng.randint(0, img.size[1] - h + 1)
    left = rng.randint(0, img.size[0] - w + 1)
    return crop(img, target, (top, left, h, w))


def make_coco_train_transform(scales: Sequence[int] = (480, 512, 544, 576,
                                                       608, 640, 672, 704,
                                                       736, 768, 800),
                              max_size: int = 1333,
                              scales2_resize: Sequence[int] = (400, 500, 600),
                              scales2_crop: Tuple[int, int] = (384, 600)):
    """The reference train pipeline (coco.py:540-552): hflip(0.5) then
    RandomSelect( multi-scale resize | resize->crop->resize )."""
    def transform(img, target: Dict, rng: np.random.RandomState):
        if rng.rand() < 0.5:
            img, target = hflip(img, target)
        if rng.rand() < 0.5:
            img, target = resize(img, target,
                                 int(rng.choice(scales)), max_size)
        else:
            img, target = resize(img, target, int(rng.choice(scales2_resize)))
            img, target = random_size_crop(img, target, *scales2_crop,
                                           rng=rng)
            img, target = resize(img, target, int(rng.choice(scales)),
                                 max_size)
        return img, target
    return transform


def make_coco_val_transform(short_side: int = 800, max_size: int = 1333):
    """Reference val pipeline: RandomResize([800], max_size=1333)."""
    def transform(img, target: Dict, rng=None):
        return resize(img, target, short_side, max_size)
    return transform


def normalize_target(img, target: Dict,
                     mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """ToTensor+Normalize: image -> float32 normalized array; boxes ->
    normalized cxcywh (reference transforms.py Normalize)."""
    w, h = img.size
    x = (np.asarray(img, np.float32) / 255.0 - np.asarray(mean)) \
        / np.asarray(std)
    boxes = target["boxes"]
    if len(boxes):
        boxes = np.stack([(boxes[:, 0] + boxes[:, 2]) / 2 / w,
                          (boxes[:, 1] + boxes[:, 3]) / 2 / h,
                          (boxes[:, 2] - boxes[:, 0]) / w,
                          (boxes[:, 3] - boxes[:, 1]) / h], -1)
    return x.astype(np.float32), {**target,
                                  "boxes": np.asarray(boxes, np.float32)
                                  .reshape(-1, 4),
                                  "size": np.asarray([h, w], np.int32)}


def pad_to_canvas(images: List[np.ndarray],
                  canvas: Optional[Tuple[int, int]] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Batch variable-size images onto one canvas (bottom/right zero pad)
    with the NestedTensor padding mask (True = padded). A fixed `canvas`
    keeps shapes static across steps for jit."""
    if canvas is None:
        canvas = (max(im.shape[0] for im in images),
                  max(im.shape[1] for im in images))
    ch, cw = canvas
    b = len(images)
    out = np.zeros((b, ch, cw, images[0].shape[2]), np.float32)
    mask = np.ones((b, ch, cw), bool)
    for i, im in enumerate(images):
        h, w = im.shape[:2]
        if h > ch or w > cw:
            im = im[:ch, :cw]
            h, w = im.shape[:2]
        out[i, :h, :w] = im
        mask[i, :h, :w] = False
    return out, mask
