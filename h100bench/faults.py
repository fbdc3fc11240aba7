"""Faults planted in the program's train step, for the control readings
(h100bench/control.py) and the fault tests: each wraps the step returned
by `make_train_step` and breaks the timed path underneath it for the
call's duration."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, name, value):
    orig = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield orig
    finally:
        setattr(owner, name, orig)


def unchanged_state(step):
    """The optimizer's update does nothing: the step leaves the weights as
    they were."""
    def broken(state, batch):
        with _patched(state.optimizer, "step", lambda *a, **k: None):
            return step(state, batch)
    return broken


def half_batch(step):
    """The loss is the mean over the first half of the batch's rows."""
    from fastervit_tpu_torch.train import losses
    orig = losses.soft_target_cross_entropy

    def half(logits, targets):
        n = logits.shape[0] // 2
        return orig(logits[:n], targets[:n])

    def broken(state, batch):
        with _patched(losses, "soft_target_cross_entropy", half):
            return step(state, batch)
    return broken


def altered_answer(step):
    """The first image's logits are replaced by the last one's where the
    forward produces them."""
    from fastervit_tpu_torch.models.fastervit import FasterViT
    forward = FasterViT.forward

    def altered(self, x):
        out = forward(self, x)
        return torch.cat([out[-1:], out[1:]])

    def broken(state, batch):
        with _patched(FasterViT, "forward", altered):
            return step(state, batch)
    return broken


def fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one scale a tensor (its largest
    magnitude at 448), the gradient passed straight through: the control's
    precision, one below the configured bf16."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t.detach())
