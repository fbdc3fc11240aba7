"""RandAugment with timm semantics: a copy of fastervit_tpu/data/
randaugment.py ("rand-m9-mstd0.5-inc1", the reference's
training recipe: configs/faster_vit_0_224_1k.yaml `aa`, train.py:624-669).

Implements the timm `rand` policy op set and increasing-severity magnitude
mappings (timm/data/auto_augment.py semantics, re-derived): 2 layers, each op
applied with prob 0.5, magnitude ~ N(m, mstd) clipped to [0, 10].
Host-side PIL ops.
"""
from __future__ import annotations

import random
from typing import Optional

from PIL import Image, ImageEnhance, ImageOps

_LEVEL_DENOM = 10.0
_FILL = (128, 128, 128)


def _randomly_negate(v, rng):
    return -v if rng.random() > 0.5 else v


# ---- op implementations ------------------------------------------------------

def _shear_x(img, v):
    return img.transform(img.size, Image.AFFINE, (1, v, 0, 0, 1, 0),
                         Image.BICUBIC, fillcolor=_FILL)


def _shear_y(img, v):
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, v, 1, 0),
                         Image.BICUBIC, fillcolor=_FILL)


def _translate_x_rel(img, v):
    pixels = v * img.size[0]
    return img.transform(img.size, Image.AFFINE, (1, 0, pixels, 0, 1, 0),
                         Image.BICUBIC, fillcolor=_FILL)


def _translate_y_rel(img, v):
    pixels = v * img.size[1]
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, 0, 1, pixels),
                         Image.BICUBIC, fillcolor=_FILL)


def _rotate(img, v):
    return img.rotate(v, resample=Image.BICUBIC, fillcolor=_FILL)


def _posterize(img, bits):
    return img if bits >= 8 else ImageOps.posterize(img, max(1, int(bits)))


def _solarize(img, thresh):
    return ImageOps.solarize(img, int(thresh))


def _solarize_add(img, add, thresh=128):
    lut = [min(255, i + int(add)) if i < thresh else i for i in range(256)]
    return img.point(lut * len(img.getbands()))


_OPS = {
    "AutoContrast": lambda img, v: ImageOps.autocontrast(img),
    "Equalize": lambda img, v: ImageOps.equalize(img),
    "Invert": lambda img, v: ImageOps.invert(img),
    "Rotate": _rotate,
    "Posterize": _posterize,
    "Solarize": _solarize,
    "SolarizeAdd": _solarize_add,
    "Color": lambda img, v: ImageEnhance.Color(img).enhance(v),
    "Contrast": lambda img, v: ImageEnhance.Contrast(img).enhance(v),
    "Brightness": lambda img, v: ImageEnhance.Brightness(img).enhance(v),
    "Sharpness": lambda img, v: ImageEnhance.Sharpness(img).enhance(v),
    "ShearX": _shear_x,
    "ShearY": _shear_y,
    "TranslateXRel": _translate_x_rel,
    "TranslateYRel": _translate_y_rel,
}


def _level_to_arg(name: str, level: float, rng, increasing: bool):
    frac = level / _LEVEL_DENOM
    if name in ("AutoContrast", "Equalize", "Invert"):
        return 0.0
    if name == "Rotate":
        return _randomly_negate(30.0 * frac, rng)
    if name in ("ShearX", "ShearY"):
        return _randomly_negate(0.3 * frac, rng)
    if name in ("TranslateXRel", "TranslateYRel"):
        return _randomly_negate(0.45 * frac, rng)
    if name in ("Color", "Contrast", "Brightness", "Sharpness"):
        if increasing:
            return 1.0 + _randomly_negate(0.9 * frac, rng)
        return 1.8 * frac + 0.1
    if name == "Posterize":
        return (4 - int(4 * frac)) if increasing else int(4 * frac)
    if name == "Solarize":
        return (256 - int(256 * frac)) if increasing else int(256 * frac)
    if name == "SolarizeAdd":
        return int(110 * frac)
    raise KeyError(name)


class RandAugment:
    """rand-m{M}-mstd{S}-inc{0|1}: num_layers ops sampled uniformly, each
    applied with prob 0.5."""

    def __init__(self, magnitude: float = 9.0, mstd: float = 0.5,
                 num_layers: int = 2, increasing: bool = True,
                 prob: float = 0.5, seed: Optional[int] = None):
        self.magnitude = magnitude
        self.mstd = mstd
        self.num_layers = num_layers
        self.increasing = increasing
        self.prob = prob
        self.rng = random.Random(seed)

    def __call__(self, img: Image.Image) -> Image.Image:
        for _ in range(self.num_layers):
            if self.rng.random() > self.prob:
                continue
            name = self.rng.choice(list(_OPS))
            m = self.magnitude
            if self.mstd > 0:
                m = self.rng.gauss(m, self.mstd)
            m = min(_LEVEL_DENOM, max(0.0, m))
            img = _OPS[name](img, _level_to_arg(name, m, self.rng,
                                                self.increasing))
        return img


def create_randaugment(spec: str = "rand-m9-mstd0.5-inc1",
                       seed: Optional[int] = None) -> RandAugment:
    """Parse a timm-style RA spec string."""
    parts = spec.split("-")
    assert parts[0] == "rand", spec
    kw = dict(seed=seed)
    for p in parts[1:]:
        if p.startswith("mstd"):
            kw["mstd"] = float(p[4:])
        elif p.startswith("inc"):
            kw["increasing"] = bool(int(p[3:]))
        elif p.startswith("m"):
            kw["magnitude"] = float(p[1:])
        elif p.startswith("n"):
            kw["num_layers"] = int(p[1:])
        elif p.startswith("p"):
            kw["prob"] = float(p[1:])
    return RandAugment(**kw)
