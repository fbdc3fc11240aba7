"""COCO compressed RLE masks in pure numpy (pycocotools `mask` API
semantics: column-major runs, LEB128-style chars with every-other-delta;
pycocotools/common/maskApi.c rleToString/rleFrString). Used by the MOTS
tracking benchmarks (mask-IoU similarity, merged ignore regions) without a
pycocotools dependency.

An RLE is {'size': [h, w], 'counts': str|bytes}; counts runs alternate
zeros/ones over the Fortran-flattened mask, starting with zeros.

The port's copy of fastervit_tpu/utils/rle.py: the same names, signatures
and code, importing nothing of the JAX package.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def _counts_to_string(cnts: Sequence[int]) -> str:
    s = []
    for i, x in enumerate(cnts):
        x = int(x)
        if i > 2:
            x -= int(cnts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = x != -1 if c & 0x10 else x != 0
            if more:
                c |= 0x20
            s.append(chr(c + 48))
    return "".join(s)


def _string_to_counts(s) -> List[int]:
    if isinstance(s, bytes):
        s = s.decode("utf-8")
    cnts: List[int] = []
    p = 0
    while p < len(s):
        x, k, more = 0, 0, True
        while more:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and c & 0x10:
                x |= -1 << (5 * k)
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return cnts


def rle_encode(mask: np.ndarray) -> Dict:
    """Binary (h, w) mask -> compressed RLE."""
    h, w = mask.shape
    flat = np.asarray(mask, bool).flatten(order="F")
    # run-length over [0-run first]: prepend a sentinel diff at each change
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    cnts = np.diff(bounds).tolist()
    if flat.size and flat[0]:
        cnts = [0] + cnts
    if not flat.size:
        cnts = [0]
    return {"size": [h, w], "counts": _counts_to_string(cnts)}


def rle_decode(rle: Dict) -> np.ndarray:
    """Compressed RLE -> (h, w) uint8 mask."""
    h, w = rle["size"]
    cnts = _string_to_counts(rle["counts"])
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for c in cnts:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    if pos != h * w:
        raise ValueError(f"RLE length {pos} != h*w {h * w}")
    return flat.reshape((h, w), order="F")


def as_compressed(seg: Dict) -> Dict:
    """Normalize an RLE dict to the compressed form: accepts uncompressed
    counts (a list of run lengths, the pycocotools frPyObjects input form),
    bytes, or an already-compressed string. Polygon segmentations are not
    supported."""
    c = seg["counts"]
    if isinstance(c, (list, tuple)):
        c = _counts_to_string(c)
    elif isinstance(c, bytes):
        c = c.decode("utf-8")
    return {"size": list(seg["size"]), "counts": c}


def rle_area(rle: Dict) -> int:
    cnts = _string_to_counts(rle["counts"])
    return int(sum(cnts[1::2]))


def rle_merge(rles: List[Dict], intersect: bool = False) -> Dict:
    """Union (or intersection) of masks; [] -> the canonical empty RLE
    (size [0, 0]), mirroring pycocotools merge([])."""
    if not rles:
        return {"size": [0, 0], "counts": _counts_to_string([0])}
    out = rle_decode(rles[0]).astype(bool)
    for r in rles[1:]:
        m = rle_decode(r).astype(bool)
        out = out & m if intersect else out | m
    return rle_encode(out)


def rle_to_bbox(rle: Dict) -> np.ndarray:
    """Tight bounding box [x, y, w, h] of an RLE mask (pycocotools toBbox
    semantics); zeros for an empty mask."""
    m = rle_decode(rle)
    ys, xs = np.nonzero(m)
    if len(xs) == 0:
        return np.zeros(4)
    return np.asarray([xs.min(), ys.min(), xs.max() - xs.min() + 1,
                       ys.max() - ys.min() + 1], float)


def rle_iou(dt: List[Dict], gt: List[Dict],
            iscrowd: Optional[Sequence[int]] = None) -> np.ndarray:
    """(len(dt), len(gt)) mask IoU; for crowd gt the denominator is the dt
    area (pycocotools iscrowd semantics). Empty masks give IoU 0."""
    out = np.zeros((len(dt), len(gt)))
    if not dt or not gt:
        return out
    d_flat = [rle_decode(r).astype(bool).ravel() for r in dt]
    g_flat = [rle_decode(r).astype(bool).ravel() for r in gt]
    for j, g in enumerate(g_flat):
        crowd = bool(iscrowd[j]) if iscrowd is not None else False
        ga = int(g.sum())
        for i, d in enumerate(d_flat):
            da = int(d.sum())
            inter = int((d & g).sum()) if d.size == g.size else 0
            denom = da if crowd else da + ga - inter
            out[i, j] = inter / denom if denom > 0 else 0.0
    return out
