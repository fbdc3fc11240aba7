"""Detection visualizer (a copy of fastervit_tpu/detection/visualizer.py):
box/label overlay rendering for debugging
(reference dino/util/visualizer.py:58-160 COCOVisualizer semantics, numpy +
matplotlib, no torch)."""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def renorm(img: np.ndarray, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> np.ndarray:
    """Undo ImageNet normalization; accepts (H, W, 3) or (3, H, W)
    (visualizer.py:23-40)."""
    if img.ndim == 3 and img.shape[0] == 3:
        img = img.transpose(1, 2, 0)
    return np.clip(img * std + mean, 0.0, 1.0)


class COCOVisualizer:
    """Draw normalized-cxcywh boxes (+ labels) onto an image and save a PNG
    (visualizer.py COCOVisualizer.visualize/addtgt)."""

    def __init__(self, seed: int = 0):
        self._rng = np.random.RandomState(seed)

    def visualize(self, img: np.ndarray, tgt: Dict, caption: Optional[str] = None,
                  dpi: int = 120, savedir: Optional[str] = None) -> Optional[str]:
        """img: (H, W, 3) or (3, H, W) ImageNet-normalized floats.
        tgt: {'boxes': (N, 4) cxcywh in [0,1], 'size': (H, W),
              optional 'box_label': [str], optional 'image_id', 'caption'}.
        Returns the saved file path when savedir is given."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.collections import PatchCollection
        from matplotlib.patches import Polygon

        fig = plt.figure(dpi=dpi)
        plt.rcParams["font.size"] = "5"
        ax = plt.gca()
        ax.imshow(renorm(np.asarray(img, np.float32)))

        h, w = [int(v) for v in tgt["size"]]
        boxes_xywh, colors, polygons = [], [], []
        for box in np.asarray(tgt["boxes"], float):
            cx, cy, bw, bh = box * np.asarray([w, h, w, h])
            x, y = cx - bw / 2, cy - bh / 2
            boxes_xywh.append([x, y, bw, bh])
            poly = np.asarray([[x, y], [x, y + bh], [x + bw, y + bh],
                               [x + bw, y]])
            polygons.append(Polygon(poly))
            colors.append((self._rng.random(3) * 0.6 + 0.4).tolist())
        ax.add_collection(PatchCollection(polygons, facecolor=colors,
                                          linewidths=0, alpha=0.1))
        ax.add_collection(PatchCollection(polygons, facecolor="none",
                                          edgecolors=colors, linewidths=2))
        if "box_label" in tgt:
            assert len(tgt["box_label"]) == len(boxes_xywh)
            for (x, y, _, _), bl, c in zip(boxes_xywh, tgt["box_label"],
                                           colors):
                ax.text(x, y, str(bl), color="black",
                        bbox={"facecolor": c, "alpha": 0.6, "pad": 1})
        if "caption" in tgt:
            ax.set_title(tgt["caption"], wrap=True)

        savename = None
        if savedir is not None:
            os.makedirs(savedir, exist_ok=True)
            image_id = int(tgt.get("image_id", 0))
            stem = f"{caption}-{image_id}" if caption else f"{image_id}"
            savename = os.path.join(savedir, f"{stem}.png")
            plt.savefig(savename)
        plt.close(fig)
        return savename
