"""Image loading and normalisation: a copy of fastervit_tpu/data/
preprocess.py's load_image and normalize (:30-36, :70-73), which the
COCO reader (`detection/coco_data.py`) uses. PIL is imported inside
load_image, so the module imports without it."""
from __future__ import annotations

import numpy as np


def load_image(path_or_img):
    """A path (or a PIL image) -> the image in RGB, by PIL."""
    from PIL import Image
    if isinstance(path_or_img, (str, bytes)):
        img = Image.open(path_or_img)
    else:
        img = path_or_img
    return img.convert("RGB")


def normalize(img_u8: np.ndarray, mean, std) -> np.ndarray:
    """uint8 HWC -> float32 HWC normalised."""
    x = img_u8.astype(np.float32) / 255.0
    return (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
