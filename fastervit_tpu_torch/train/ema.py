"""Exponential moving average of a model (port of
fastervit_tpu/train/ema.py; timm ModelEmaV2 with decay 0.9998, reference
train.py:519-525, 290-291)."""
from __future__ import annotations

import copy
from typing import List

import torch
import torch.nn as nn


def _averaged(model: nn.Module) -> List[torch.Tensor]:
    """The tensors EMA follows, each once: the parameters (parameters()
    lists a shared one once, such as the tokenizer conv that the state_dict
    holds under two keys) and the floating-point buffers the state_dict
    holds (BN running statistics; not num_batches_tracked, not the constant
    tables, which are non-persistent)."""
    persistent = {id(t) for t in model.state_dict(keep_vars=True).values()}
    return list(model.parameters()) + [
        b for b in model.buffers()
        if b.is_floating_point() and id(b) in persistent]


def create_ema_model(model: nn.Module) -> nn.Module:
    """A copy of `model` in eval mode with no gradients, to average into."""
    ema = copy.deepcopy(model).eval()
    for p in ema.parameters():
        p.requires_grad_(False)
    return ema


@torch.no_grad()
def ema_update(ema_model: nn.Module, model: nn.Module,
               decay: float = 0.9998) -> None:
    """e = e·decay + p·(1 − decay) for every averaged tensor, in place."""
    ema = _averaged(ema_model)
    new = [t.to(e.dtype) for t, e in zip(_averaged(model), ema)]
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, new, alpha=1.0 - decay)
