"""COCO panoptic support: dataset loader + panoptic post-processing (a
copy of fastervit_tpu/detection/panoptic.py).

Numpy ports of the reference's panoptic path
(dino/datasets/coco_panoptic.py:15-77 for the loader,
dino/models/dino/segmentation.py:253-375 PostProcessPanoptic for the
post-processing; rgb2id/id2rgb follow the COCO panopticapi encoding
id = R + 256*G + 256^2*B).
"""
from __future__ import annotations

import io
import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np


def rgb2id(color: np.ndarray) -> np.ndarray:
    color = color.astype(np.uint32)
    return color[..., 0] + 256 * color[..., 1] + 256 * 256 * color[..., 2]


def id2rgb(id_map: np.ndarray) -> np.ndarray:
    id_map = id_map.astype(np.uint32)
    return np.stack([id_map % 256, (id_map // 256) % 256,
                     (id_map // (256 * 256)) % 256], -1).astype(np.uint8)


def masks_to_boxes(masks: np.ndarray) -> np.ndarray:
    """(N, H, W) binary masks -> (N, 4) xyxy boxes (zeros for empty masks)."""
    n = masks.shape[0]
    boxes = np.zeros((n, 4), np.float32)
    for i in range(n):
        ys, xs = np.nonzero(masks[i])
        if len(ys):
            boxes[i] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
    return boxes


class CocoPanopticDataset:
    """COCO panoptic annotation loader (reference coco_panoptic.py:15-77):
    a panoptic json + per-image PNG id-masks -> per-image targets with
    per-segment binary masks, labels, boxes (from masks), iscrowd, area."""

    def __init__(self, img_folder: str, ann_folder: str, ann_file: str,
                 return_masks: bool = True):
        with open(ann_file) as f:
            self.coco = json.load(f)
        # images sorted by id so they align with annotations
        self.coco["images"] = sorted(self.coco["images"],
                                     key=lambda x: x["id"])
        if "annotations" in self.coco:
            for img, ann in zip(self.coco["images"], self.coco["annotations"]):
                assert img["file_name"][:-4] == ann["file_name"][:-4]
        self.img_folder = img_folder
        self.ann_folder = ann_folder
        self.return_masks = return_masks

    def __len__(self) -> int:
        return len(self.coco["images"])

    def get_height_and_width(self, idx: int) -> Tuple[int, int]:
        info = self.coco["images"][idx]
        return info["height"], info["width"]

    def __getitem__(self, idx: int):
        from PIL import Image
        ann_info = (self.coco["annotations"][idx]
                    if "annotations" in self.coco
                    else self.coco["images"][idx])
        img_path = os.path.join(self.img_folder,
                                ann_info["file_name"].replace(".png", ".jpg"))
        img = np.asarray(Image.open(img_path).convert("RGB"))
        h, w = img.shape[:2]
        target: Dict = {"image_id": int(ann_info.get("image_id",
                                                     ann_info.get("id", idx))),
                        "size": np.asarray([h, w]),
                        "orig_size": np.asarray([h, w])}
        if "segments_info" in ann_info:
            id_map = rgb2id(np.asarray(Image.open(
                os.path.join(self.ann_folder, ann_info["file_name"]))))
            ids = np.asarray([s["id"] for s in ann_info["segments_info"]])
            masks = (id_map[None] == ids[:, None, None]).astype(np.uint8)
            target["labels"] = np.asarray(
                [s["category_id"] for s in ann_info["segments_info"]],
                np.int64)
            if self.return_masks:
                target["masks"] = masks
            target["boxes"] = masks_to_boxes(masks)
            target["iscrowd"] = np.asarray(
                [s["iscrowd"] for s in ann_info["segments_info"]])
            target["area"] = np.asarray(
                [s["area"] for s in ann_info["segments_info"]])
        return img, target


def _softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def postprocess_panoptic(logits: np.ndarray, masks: np.ndarray,
                         is_thing_map: Dict[int, bool],
                         processed_size: Tuple[int, int],
                         target_size: Optional[Tuple[int, int]] = None,
                         threshold: float = 0.85) -> Dict:
    """PostProcessPanoptic for ONE image (segmentation.py:268-375):

    logits: (Q, C+1) class logits (last class = no-object);
    masks:  (Q, h, w) mask logits. Keeps queries with confident non-null
    class, assigns each pixel to the argmax query (softmax over queries),
    merges same-class stuff segments, drops segments with area <= 4
    (re-running the pixel assignment until stable), and returns
    {'png_string', 'segments_info'} in the COCO panoptic submission format.
    """
    from PIL import Image
    if target_size is None:
        target_size = processed_size
    scores = _softmax(logits).max(-1)
    labels = np.argmax(logits, -1)
    keep = (labels != logits.shape[-1] - 1) & (scores > threshold)
    cur_scores, cur_classes = scores[keep], labels[keep]
    cur_masks = _resize_bilinear(masks[keep], processed_size)
    h, w = processed_size

    stuff_equiv: Dict[int, List[int]] = defaultdict(list)
    for k, label in enumerate(cur_classes):
        if not is_thing_map.get(int(label), True):
            stuff_equiv[int(label)].append(k)

    def get_ids_area(m, scores, dedup=False):
        if m.shape[0] == 0:
            m_id = np.zeros((h, w), np.int64)
        else:
            m_id = np.argmax(_softmax(m.reshape(m.shape[0], -1), axis=0),
                             axis=0).reshape(h, w)
        if dedup:
            for equiv in stuff_equiv.values():
                for eq_id in equiv[1:]:
                    m_id[m_id == eq_id] = equiv[0]
        seg_img = Image.fromarray(id2rgb(m_id))
        seg_img = seg_img.resize((target_size[1], target_size[0]),
                                 Image.NEAREST)
        m_id = rgb2id(np.asarray(seg_img))
        area = [int((m_id == i).sum()) for i in range(len(scores))]
        return area, seg_img

    area, seg_img = get_ids_area(cur_masks, cur_scores, dedup=True)
    if len(cur_classes) > 0:
        while True:
            small = np.asarray([a <= 4 for a in area], bool)
            if not small.any():
                break
            cur_scores = cur_scores[~small]
            cur_classes = cur_classes[~small]
            cur_masks = cur_masks[~small]
            area, seg_img = get_ids_area(cur_masks, cur_scores)
    else:
        cur_classes = np.ones(1, np.int64)

    segments_info = [{"id": i, "isthing": is_thing_map.get(int(c), True),
                      "category_id": int(c), "area": a}
                     for i, (a, c) in enumerate(zip(area, cur_classes))]
    with io.BytesIO() as out:
        seg_img.save(out, format="PNG")
        return {"png_string": out.getvalue(), "segments_info": segments_info}


def _resize_bilinear(masks: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(N, h, w) -> (N, H, W) bilinear (PIL, matching F.interpolate
    align_corners=False closely enough for mask logits)."""
    from PIL import Image
    if masks.shape[1:] == tuple(size):
        return masks.astype(np.float32)
    out = np.zeros((masks.shape[0],) + tuple(size), np.float32)
    for i, m in enumerate(masks):
        out[i] = np.asarray(Image.fromarray(m.astype(np.float32)).resize(
            (size[1], size[0]), Image.BILINEAR))
    return out
