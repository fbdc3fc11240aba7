"""Training losses (port of fastervit_tpu/train/losses.py): the timm losses
the reference selects (train.py:671-689) and the MESA self-distillation
term (train.py:354-361, 869-874). Logits are (B, classes); every loss is a
scalar mean."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def label_smoothing_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                  smoothing: float = 0.1) -> torch.Tensor:
    """timm LabelSmoothingCrossEntropy: labels are int class ids."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[:, None].long())[:, 0]
    smooth = -logp.mean(dim=-1)
    return ((1.0 - smoothing) * nll + smoothing * smooth).mean()


def soft_target_cross_entropy(logits: torch.Tensor,
                              targets: torch.Tensor) -> torch.Tensor:
    """timm SoftTargetCrossEntropy: targets are (B, C) distributions
    (mixup/cutmix soft labels)."""
    return (-targets * F.log_softmax(logits, dim=-1)).sum(-1).mean()


def binary_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                         smoothing: float = 0.0,
                         target_threshold: Optional[float] = None
                         ) -> torch.Tensor:
    """timm BinaryCrossEntropy over one-hot or soft targets; the mean over
    all elements, as torch's BCEWithLogits(reduction='mean')."""
    n = logits.shape[-1]
    if targets.ndim == 1:
        targets = F.one_hot(targets.long(), n).to(logits.dtype)
    if smoothing > 0.0:
        targets = targets * (1.0 - smoothing) + smoothing / n
    if target_threshold is not None:
        targets = (targets >= target_threshold).to(logits.dtype)
    return -(targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits)).mean()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[:, None].long()).mean()


def jsd_cross_entropy(logits_splits: Sequence[torch.Tensor],
                      labels: torch.Tensor, smoothing: float = 0.1,
                      alpha: float = 12.0) -> torch.Tensor:
    """timm JsdCrossEntropy for AugMix-style splits: the clean split's
    label-smoothing CE + alpha · the Jensen-Shannon consistency across
    splits."""
    loss = label_smoothing_cross_entropy(logits_splits[0], labels, smoothing)
    probs = [F.softmax(x, dim=-1) for x in logits_splits]
    logm = torch.log(torch.clamp(sum(probs) / len(probs), 1e-7, 1.0))
    kl = sum((p * (torch.log(torch.clamp(p, min=1e-7)) - logm)).sum(-1).mean()
             for p in probs) / len(probs)
    return loss + alpha * kl


def mesa_kd_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                 temperature: float = 3.0) -> torch.Tensor:
    """MESA sharpness-aware KD against the EMA teacher:
    50 · KL(softmax(t/T) || softmax(s/T)), batch mean (reference
    train.py:356-361)."""
    p = F.log_softmax(student_logits / temperature, dim=-1)
    q = F.softmax(teacher_logits / temperature, dim=-1)
    kl = (q * (torch.log(torch.clamp(q, min=1e-12)) - p)).sum(-1)
    return 50.0 * kl.mean()
