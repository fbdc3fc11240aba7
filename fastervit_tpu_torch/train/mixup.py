"""Mixup/CutMix batch transform (port of fastervit_tpu/train/mixup.py; timm
Mixup in batch mode, the reference's mixup 0.8 / cutmix 1.0 / switch 0.5 /
smoothing 0.1, configs/faster_vit_0_224_1k.yaml + train.py:605-617).

The step's five random scalars (apply, switch, λ_mix, λ_cut and the box
centre) are drawn on the host from a numpy Generator seeded from
(seed, step), as timm draws them on the host; `mixup_cutmix_with` then does
the per-pixel work on the images' device. The mixing partner is the
flipped batch (timm's x.flip(0)); under data parallelism, the flipped
global batch, as JAX flips it (`parallel.data_parallel.mirrored_flip`).
Images are NCHW."""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fastervit_tpu_torch.parallel.data_parallel import mirrored_flip


@dataclasses.dataclass(frozen=True)
class MixupConfig:
    mixup_alpha: float = 0.8
    cutmix_alpha: float = 1.0
    prob: float = 1.0
    switch_prob: float = 0.5
    label_smoothing: float = 0.1
    num_classes: int = 1000


def mixup_draws(rng: np.random.Generator, height: int, width: int,
                cfg: MixupConfig) -> Dict[str, object]:
    """The five scalars one batch needs: uniforms `apply` and `switch`,
    Beta draws `lam_mix` and `lam_cut` (1.0 where that alpha is 0), and the
    cutmix box centre `box` = (row, col)."""
    return {
        "apply": float(rng.uniform()),
        "switch": float(rng.uniform()),
        "lam_mix": (float(rng.beta(cfg.mixup_alpha, cfg.mixup_alpha))
                    if cfg.mixup_alpha > 0 else 1.0),
        "lam_cut": (float(rng.beta(cfg.cutmix_alpha, cfg.cutmix_alpha))
                    if cfg.cutmix_alpha > 0 else 1.0),
        "box": (int(rng.integers(0, height)), int(rng.integers(0, width))),
    }


def _box(height: int, width: int, lam: float, centre: Tuple[int, int]
         ) -> Tuple[int, int, int, int, float]:
    """timm rand_bbox: a box of relative area (1 - lam) around `centre`,
    clipped to the image, in JAX's f32 arithmetic; returns y1, y2, x1, x2
    and the λ corrected for the clipped area."""
    ratio = np.sqrt(np.float32(1.0) - np.float32(lam))
    cut_h = int(np.round(np.float32(height) * ratio))
    cut_w = int(np.round(np.float32(width) * ratio))
    ry, rx = centre
    y1, y2 = np.clip([ry - cut_h // 2, ry + cut_h // 2], 0, height)
    x1, x2 = np.clip([rx - cut_w // 2, rx + cut_w // 2], 0, width)
    lam_c = 1.0 - float(np.float32((y2 - y1) * (x2 - x1))
                        / np.float32(height * width))
    return int(y1), int(y2), int(x1), int(x2), lam_c


def mixup_cutmix_with(draws: Dict[str, object], images: torch.Tensor,
                      labels: torch.Tensor, cfg: MixupConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mix a batch with given draws (see `mixup_draws`); returns the mixed
    images (B, C, H, W) and the soft targets (B, classes) in f32.
    images: (B, C, H, W) float; labels: (B,) int. Each row's partner is
    its row of the flipped global batch (`mirrored_flip`)."""
    _, _, h, w = images.shape
    apply = draws["apply"] < cfg.prob
    use_cutmix = cfg.cutmix_alpha > 0 and (
        cfg.mixup_alpha <= 0 or draws["switch"] < cfg.switch_prob)
    lam = 1.0
    if apply and use_cutmix:
        y1, y2, x1, x2, lam = _box(h, w, draws["lam_cut"], draws["box"])
        images = images.clone()
        images[:, :, y1:y2, x1:x2] = mirrored_flip(images)[:, :, y1:y2, x1:x2]
    elif apply:
        lam = draws["lam_mix"]
        images = images * lam + mirrored_flip(images) * (1.0 - lam)
    off = cfg.label_smoothing / cfg.num_classes
    on = 1.0 - cfg.label_smoothing + off
    y1h = F.one_hot(labels.long(), cfg.num_classes).float() * (on - off) + off
    y2h = mirrored_flip(y1h)
    return images, y1h * lam + y2h * (1.0 - lam)


def mixup_cutmix(rng: np.random.Generator, images: torch.Tensor,
                 labels: torch.Tensor, cfg: MixupConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw the batch's scalars from `rng`, then mix (`mixup_cutmix_with`)."""
    draws = mixup_draws(rng, images.shape[2], images.shape[3], cfg)
    return mixup_cutmix_with(draws, images, labels, cfg)
