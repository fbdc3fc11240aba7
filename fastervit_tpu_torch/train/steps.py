"""Train and eval steps (port of fastervit_tpu/train/steps.py; the
reference's train.py:820-951 `train_one_epoch` inner loop and :954-1017
`validate`).

One train step = mixup -> forward in training mode (batch-statistics BN,
DropPath), under torch.autocast(bfloat16) when the compute dtype is bf16,
with f32 parameters, as flax's dtype=bf16 keeps f32 parameters -> loss
(+ MESA distillation against the EMA model in eval mode) -> backward ->
clip by global norm -> optimizer -> EMA.

The step's randomness comes from (seed, step): mixup's scalars from a numpy
Generator on the host, DropPath's masks from a torch.Generator on the
model's device. The two frameworks draw different numbers from one seed, so
the tests hand both the same draws.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Iterable, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn as nn

from fastervit_tpu_torch.models.layers import set_drop_path_generator
from fastervit_tpu_torch.parallel import data_parallel, distributed
from fastervit_tpu_torch.train import losses as L
from fastervit_tpu_torch.train.ema import create_ema_model, ema_update
from fastervit_tpu_torch.train.mixup import MixupConfig, mixup_cutmix


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (reference TRAINING.md + train.py
    defaults)."""
    clip_grad: float = 5.0
    weight_decay: float = 0.05
    opt: str = "adamw"                # 'adamw' | 'lamb'
    ema_decay: float = 0.9998
    use_ema: bool = True
    smoothing: float = 0.1
    bce_loss: bool = False
    mixup: Optional[MixupConfig] = MixupConfig()
    mesa: float = 0.0                 # MESA weight (0.1..5.0 by variant)
    mesa_start_step: int = 0          # the reference starts at 25% of steps
    grad_checkpoint: bool = False


class Lamb(torch.optim.Optimizer):
    """optax.lamb in PyTorch: Adam moments with bias correction (eps outside
    the square root), then decoupled weight decay, then the per-tensor trust
    ratio ||p|| / ||u||, 1 where either norm is 0, then -lr."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                t = state["step"]
                m, v = state["exp_avg"], state["exp_avg_sq"]
                m.mul_(b1).add_(p.grad, alpha=1.0 - b1)
                v.mul_(b2).addcmul_(p.grad, p.grad, value=1.0 - b2)
                u = (m / (1.0 - b1 ** t)) / (
                    (v / (1.0 - b2 ** t)).sqrt() + group["eps"])
                u.add_(p, alpha=group["weight_decay"])
                p_norm, u_norm = p.norm(), u.norm()
                ratio = torch.where((p_norm == 0) | (u_norm == 0),
                                    torch.ones_like(p_norm), p_norm / u_norm)
                p.add_(u * ratio, alpha=-group["lr"])


def create_optimizer(params: Iterable[torch.Tensor],
                     cfg: TrainConfig) -> torch.optim.Optimizer:
    """adamw -> torch.optim.AdamW(betas (0.9, 0.999), eps 1e-8), lamb ->
    `Lamb` (eps 1e-6), both with weight decay on every parameter (optax's
    mask is None). The learning rate is set before each step
    (`optimizer_step`)."""
    if cfg.opt == "adamw":
        return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=cfg.weight_decay)
    if cfg.opt == "lamb":
        return Lamb(params, lr=0.0, weight_decay=cfg.weight_decay)
    raise ValueError(f"unknown optimizer {cfg.opt!r}")


@torch.no_grad()
def optimizer_step(optimizer: torch.optim.Optimizer,
                   lr: Union[float, Sequence[float]],
                   clip_grad: float) -> torch.Tensor:
    """Clip the gradients as optax.clip_by_global_norm does (scale by
    max_norm / max(norm, max_norm) over all groups; no clip when clip_grad
    is 0), set the learning rate (one for every group, or one a group, in
    the optimizer's order), step. Returns the global norm of the unclipped
    gradients as a device scalar."""
    grads = [p.grad for group in optimizer.param_groups
             for p in group["params"] if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    if clip_grad:
        scale = clip_grad / torch.clamp(norm, min=clip_grad)
        torch._foreach_mul_(grads, scale)
    lrs = ([lr] * len(optimizer.param_groups) if isinstance(lr, (int, float))
           else list(lr))
    for group, group_lr in zip(optimizer.param_groups, lrs, strict=True):
        group["lr"] = group_lr
    optimizer.step()
    return norm


@dataclasses.dataclass
class TrainState:
    """What a train step updates: the model (f32 parameters, BN running
    statistics), its EMA copy, the optimizer and the step count. Under data
    parallelism `ddp` is the model's DistributedDataParallel wrapper
    (`parallel.data_parallel.wrap_model`), which the step's forward calls;
    the model itself keeps the weights."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema_model: Optional[nn.Module] = None
    step: int = 0
    ddp: Optional[nn.Module] = None


def create_train_state(model: nn.Module, cfg: TrainConfig = TrainConfig()
                       ) -> TrainState:
    """The optimizer over `model`'s parameters and, with use_ema, its EMA
    copy."""
    return TrainState(model=model,
                      optimizer=create_optimizer(model.parameters(), cfg),
                      ema_model=create_ema_model(model) if cfg.use_ema
                      else None)


def _autocast(device: torch.device, dtype: torch.dtype):
    if dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=dtype)


def to_device_batch(batch: Dict[str, object], device: torch.device
                    ) -> Dict[str, torch.Tensor]:
    """A loader's batch (NHWC images, labels, optional valid mask; numpy or
    torch) on `device`, with the images NCHW."""
    out = {k: torch.as_tensor(v).to(device, non_blocking=True)
           for k, v in batch.items()}
    out["image"] = out["image"].permute(0, 3, 1, 2).contiguous()
    return out


def make_train_step(cfg: TrainConfig = TrainConfig(),
                    schedule_fn: Optional[Callable[[int], float]] = None,
                    dtype: torch.dtype = torch.float32, seed: int = 0):
    """Returns train_step(state, batch) -> metrics, which updates `state` in
    place. batch = {'image': (B, H, W, 3) float, 'label': (B,) int}, numpy
    or torch, moved to the model's device as NCHW. metrics: 'loss' and
    'grad_norm' (of the unclipped gradients) as device scalars, 'lr' (the
    schedule at the step before the increment; 0 without a schedule).
    Gradients stay in the parameters' .grad until the next step.

    Under data parallelism (`state.ddp`) the batch is this process's rows
    of the global batch (`data_parallel.local_slice`): mixup's partners
    are the flipped global batch's rows (`mirrored_flip`), the gradients
    DDP's average and 'loss' the mean over the processes, so the step is
    the one-process step on the global batch, up to the order of sums.

    With cfg.grad_checkpoint, each block of the model recomputes its
    activations in the backward (`FasterViT.set_grad_checkpointing`). The
    JAX package remats the whole forward; in eager PyTorch a whole-forward
    checkpoint would re-materialise every activation at once in the
    backward and lower no peak, so the port checkpoints block by block.
    Values, gradients, DropPath masks and BatchNorm statistics are the
    plain step's."""

    def loss_from_logits(logits, targets, soft):
        if soft:
            return L.soft_target_cross_entropy(logits, targets)
        if cfg.bce_loss:
            return L.binary_cross_entropy(logits, targets,
                                          smoothing=cfg.smoothing)
        if cfg.smoothing > 0:
            return L.label_smoothing_cross_entropy(logits, targets,
                                                   cfg.smoothing)
        return L.cross_entropy(logits, targets)

    def train_step(state: TrainState, batch: Dict[str, object]
                   ) -> Dict[str, object]:
        model = state.model
        device = next(model.parameters()).device
        b = to_device_batch(batch, device)
        images, labels = b["image"], b["label"]
        if cfg.mixup is not None:
            rng = np.random.default_rng((seed, state.step))
            images, targets = mixup_cutmix(rng, images, labels, cfg.mixup)
            soft = True
        else:
            targets, soft = labels, False

        model.train()
        if cfg.grad_checkpoint:
            model.set_grad_checkpointing(True)
        # a process's own stream of DropPath and dropout draws
        gen = torch.Generator(device=device)
        set_drop_path_generator(model, gen.manual_seed(
            (seed * 1_000_003 + state.step) * distributed.world_size()
            + distributed.rank()))
        state.optimizer.zero_grad(set_to_none=True)
        with _autocast(device, dtype):
            logits = (model if state.ddp is None else state.ddp)(images)
        loss = loss_from_logits(logits.float(), targets, soft)
        if (cfg.mesa > 0.0 and state.ema_model is not None
                and state.step >= cfg.mesa_start_step):
            with torch.no_grad(), _autocast(device, dtype):
                teacher = state.ema_model.eval()(images)
            loss = loss + cfg.mesa * L.mesa_kd_loss(logits.float(),
                                                    teacher.float())
        loss.backward()
        lr = float(schedule_fn(state.step)) if schedule_fn is not None else 0.0
        grad_norm = optimizer_step(state.optimizer, lr, cfg.clip_grad)
        if cfg.use_ema and state.ema_model is not None:
            ema_update(state.ema_model, model, cfg.ema_decay)
        state.step += 1
        return {"loss": data_parallel.mean_over_processes(loss.detach()),
                "grad_norm": grad_norm, "lr": lr}

    return train_step


def make_eval_step(dtype: torch.dtype = torch.float32):
    """eval_step(model, batch) -> summed 'loss_sum', 'top1', 'top5' and
    'count' as device scalars (the caller divides by the total count).
    Respects an optional boolean 'valid' mask for padded final batches."""
    @torch.no_grad()
    def eval_step(model: nn.Module, batch: Dict[str, object]
                  ) -> Dict[str, torch.Tensor]:
        device = next(model.parameters()).device
        b = to_device_batch(batch, device)
        labels = b["label"].long()
        valid = b.get("valid", torch.ones_like(labels, dtype=torch.bool))
        with _autocast(device, dtype):
            logits = model.eval()(b["image"]).float()
        logp = torch.log_softmax(logits, -1)
        per_ex = -logp.gather(-1, labels[:, None])[:, 0]
        top1 = ((logits.argmax(-1) == labels) & valid).sum()
        k = min(5, logits.shape[-1])
        top5 = ((logits.topk(k, -1).indices == labels[:, None]).any(-1)
                & valid).sum()
        return {"loss_sum": torch.where(valid, per_ex, 0.0).sum(),
                "top1": top1, "top5": top5, "count": valid.sum()}
    return eval_step
