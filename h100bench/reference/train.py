"""The fine-tuning step in plain PyTorch, float32: the reference of the
training cells. It imports nothing of the program under test.

One step of the recipe (the NVlabs/FasterViT train.py with timm's Mixup,
SoftTargetCrossEntropy and AdamW): mixup or cutmix against the flipped
batch (mixup_alpha 0.8, cutmix_alpha 1.0, switch 0.5, label smoothing
0.1); the forward in training mode with stochastic depth; the soft-target
cross-entropy; the gradients clipped to a global norm; AdamW with
decoupled weight decay on every tensor.

The step's random draws are the recipe's, reproduced from the seed as the
program documents them: mixup's scalars from numpy's default_rng((seed,
step)) in the order apply, switch, λ_mix, λ_cut, box row, box column;
stochastic depth's masks from a torch.Generator on the device seeded with
seed·1,000,003 + step, one Bernoulli(1 - rate) draw of a row per site in
the forward's order (`fastervit.drop_path_sites`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import fastervit

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Recipe:
    lr: float
    weight_decay: float = 0.05
    clip_grad: float = 5.0
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    mixup_alpha: float = 0.8
    cutmix_alpha: float = 1.0
    switch_prob: float = 0.5
    smoothing: float = 0.1


def mixup_draws(seed: int, step: int, h: int, w: int, r: Recipe) -> Dict:
    rng = np.random.default_rng((seed, step))
    return {"apply": float(rng.uniform()), "switch": float(rng.uniform()),
            "lam_mix": float(rng.beta(r.mixup_alpha, r.mixup_alpha)),
            "lam_cut": float(rng.beta(r.cutmix_alpha, r.cutmix_alpha)),
            "box": (int(rng.integers(0, h)), int(rng.integers(0, w)))}


def _box(h: int, w: int, lam: float, centre) -> Tuple[int, int, int, int,
                                                     float]:
    """timm's rand_bbox in float32: a box of area (1 - lam) about `centre`,
    clipped to the image; and λ for the clipped area."""
    ratio = np.sqrt(np.float32(1.0) - np.float32(lam))
    cut_h = int(np.round(np.float32(h) * ratio))
    cut_w = int(np.round(np.float32(w) * ratio))
    ry, rx = centre
    y1, y2 = np.clip([ry - cut_h // 2, ry + cut_h // 2], 0, h)
    x1, x2 = np.clip([rx - cut_w // 2, rx + cut_w // 2], 0, w)
    lam = 1.0 - float(np.float32((y2 - y1) * (x2 - x1)) / np.float32(h * w))
    return int(y1), int(y2), int(x1), int(x2), lam


def mix(images: torch.Tensor, labels: torch.Tensor, classes: int,
        draws: Dict, r: Recipe):
    """(mixed images, soft targets) against the flipped batch."""
    _, _, h, w = images.shape
    flipped = images.flip(0)
    cutmix = draws["switch"] < r.switch_prob
    if cutmix:
        y1, y2, x1, x2, lam = _box(h, w, draws["lam_cut"], draws["box"])
        images = images.clone()
        images[:, :, y1:y2, x1:x2] = flipped[:, :, y1:y2, x1:x2]
    else:
        lam = draws["lam_mix"]
        images = images * lam + flipped * (1.0 - lam)
    off = r.smoothing / classes
    hot = F.one_hot(labels.long(), classes).float() * (1.0 - r.smoothing) \
        + off
    return images, hot * lam + hot.flip(0) * (1.0 - lam)


def drop_masks(cfg: Dict, batch: int, seed: int, step: int,
               device) -> List[Tuple[torch.Tensor, float]]:
    gen = torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)
    return [(torch.empty(rows, device=device).bernoulli_(1.0 - rate,
                                                         generator=gen), rate)
            for rows, rate in fastervit.drop_path_sites(cfg, batch)]


class AdamW:
    """torch.optim.AdamW's update: p·(1 - lr·wd), then the bias-corrected
    moments' step."""

    def __init__(self, params: Params, r: Recipe):
        self.r = r
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: Params, grads: Params) -> None:
        r, (b1, b2) = self.r, self.r.betas
        self.t += 1
        c1, c2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            p.mul_(1.0 - r.lr * r.weight_decay)
            self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (self.v[k].sqrt() / c2 ** 0.5).add_(r.eps)
            p.addcdiv_(self.m[k], denom, value=-r.lr / c1)


def clip(grads: Params, max_norm: float) -> None:
    norm = torch.linalg.vector_norm(
        torch.stack([g.norm() for g in grads.values()]))
    grads_scale = max_norm / torch.clamp(norm, min=max_norm)
    for g in grads.values():
        g.mul_(grads_scale)


def train_steps(params: Params, batches, cfg: Dict, r: Recipe, seed: int,
                cast=None):
    """Run len(batches) steps on `params` (updated in place) from batches
    of (images (B, 3, H, W), labels (B,)). Returns the losses and the
    first step's clipped gradients. Each block's activations are
    recomputed in the backward."""
    # BatchNorm's running statistics: neither trained nor read in training
    statistics = {k for k in params
                  if k.endswith(("running_mean", "running_var"))}
    opt = AdamW({k: v for k, v in params.items() if k not in statistics}, r)
    losses, first = [], None
    for step, (images, labels) in enumerate(batches):
        b, _, h, w = images.shape
        x, targets = mix(images, labels, cfg["num_classes"],
                         mixup_draws(seed, step, h, w, r), r)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items() if k not in statistics}
        mode = fastervit.Mode(train=True, checkpoint=True, cast=cast,
                              masks=drop_masks(cfg, b, seed, step,
                                               images.device))
        logits = fastervit.forward(leaves, x, cfg, mode)
        loss = (-targets * F.log_softmax(logits, -1)).sum(-1).mean()
        names = list(leaves)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [leaves[k] for k in names])))
        clip(grads, r.clip_grad)
        if first is None:
            first = {k: g.clone() for k, g in grads.items()}
        opt.step({k: params[k] for k in grads}, grads)
        losses.append(loss.item())
        del leaves, grads, logits, loss
    return losses, first
