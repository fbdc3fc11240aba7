"""Eval-time image preprocessing with timm semantics: a copy of
fastervit_tpu/data/preprocess.py.

The reference validates through timm's transform stack (validate.py:
269-284, resolve_data_config with per-variant crop_pct / crop_mode /
interpolation from faster_vit.py:21-80). Accuracy is measured through this
preprocessing, so it is reproduced exactly:

  center: resize shorter side to size/crop_pct (bicubic), center-crop.
  squash: resize to (size/crop_pct, size/crop_pct) ignoring aspect ratio,
          center-crop.

Host-side via PIL (imported where it is used, so the module imports
without it); normalisation to float32 HWC follows. The COCO reader
(`detection/coco_data.py`) uses load_image and normalize.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

_PIL_INTERP = {"bicubic": 3, "bilinear": 2, "nearest": 0, "lanczos": 1}


def load_image(path_or_img):
    """A path (or a PIL image) -> the image in RGB, by PIL."""
    from PIL import Image
    if isinstance(path_or_img, (str, bytes)):
        img = Image.open(path_or_img)
    else:
        img = path_or_img
    return img.convert("RGB")


def resize_crop(img, size: Tuple[int, int], crop_pct: float = 0.875,
                crop_mode: str = "center", interpolation: str = "bicubic"):
    """timm transforms_factory eval pipeline: scale by crop_pct then center
    crop to `size` (H, W)."""
    interp = _PIL_INTERP[interpolation]
    th, tw = size
    if crop_mode == "squash":
        scale_h = int(math.floor(th / crop_pct))
        scale_w = int(math.floor(tw / crop_pct))
        img = img.resize((scale_w, scale_h), interp)
    else:  # center (timm also has 'border'; the family only uses these two)
        if th == tw:
            scale = int(math.floor(th / crop_pct))
            w, h = img.size
            if w <= h:
                img = img.resize((scale, int(round(scale * h / w))), interp)
            else:
                img = img.resize((int(round(scale * w / h)), scale), interp)
        else:
            scale_h = int(math.floor(th / crop_pct))
            scale_w = int(math.floor(tw / crop_pct))
            w, h = img.size
            r = max(scale_h / h, scale_w / w)
            img = img.resize((int(round(w * r)), int(round(h * r))), interp)
    w, h = img.size
    left = int(round((w - tw) / 2.0))
    top = int(round((h - th) / 2.0))
    return img.crop((left, top, left + tw, top + th))


def normalize(img_u8: np.ndarray, mean, std) -> np.ndarray:
    """uint8 HWC -> float32 HWC normalised."""
    x = img_u8.astype(np.float32) / 255.0
    return (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def eval_transform(img, cfg) -> np.ndarray:
    """A path or PIL image -> the normalised float32 (H, W, 3) eval input
    of a DataConfig (input_size, crop_pct, crop_mode, interpolation, mean,
    std)."""
    img = load_image(img)
    img = resize_crop(img, cfg.input_size, cfg.crop_pct, cfg.crop_mode,
                      cfg.interpolation)
    return normalize(np.asarray(img), cfg.mean, cfg.std)
