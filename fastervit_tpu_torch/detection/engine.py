"""DINO detection training engine: the PyTorch port of fastervit_tpu/
detection/engine.py (:30-303; reference dino/engine.py:20-120
train_one_epoch).

A train step runs the detector in eval mode with gradients on, which is
the JAX step's `training=False`: BatchNorm on its frozen running
statistics (upstream's FrozenBatchNorm2d), no dropout. Under a bf16
compute dtype it runs the forward under torch.autocast with f32 parameters,
as flax's dtype=bf16 keeps f32 parameters, and the loss in f32. Then the
set criterion given assignments (`detection_loss`), backward, the global
norm clip, AdamW with per-module learning rates and the lr_drop step
schedule (`create_detection_optimizer`), and EMA (`train/ema.py`).

Targets are padded to a fixed `max_targets` a image (`pad_targets`), and
the matcher gives each target a query, layer by layer:
- "host": scipy's Hungarian on the host (`solve_assignments`, the
  reference's matcher), from costs of the step's own forward. The JAX
  engine runs a second, gradient-free forward for the costs because jit
  cannot call scipy in the middle of a program; eager PyTorch can, so the
  port costs one forward, not two, for the same assignments;
- "auction": the on-device auction (`matcher_device`), one step with no
  host round trip (`make_fused_detection_train_step`);
- "auto": the auction on the card and the host Hungarian on the CPU, the
  counterpart of the JAX engine's "auction on TPU, host elsewhere".
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from fastervit_tpu_torch.detection.dino import sigmoid_focal_loss
from fastervit_tpu_torch.detection.matcher_device import \
    solve_assignments_device
from fastervit_tpu_torch.ops.boxes import (aligned_generalized_box_iou,
                                           box_cxcywh_to_xyxy,
                                           hungarian_cost_matrix,
                                           hungarian_match)
from fastervit_tpu_torch.parallel import data_parallel
from fastervit_tpu_torch.train.ema import create_ema_model, ema_update
from fastervit_tpu_torch.train.steps import _autocast, optimizer_step

GROUPS = ("main", "backbone", "linear_proj")


def pad_targets(targets: List[Dict], max_targets: int
                ) -> Dict[str, np.ndarray]:
    """Per-image {'labels', 'boxes'} -> fixed-size arrays: labels (B, T)
    int32, boxes (B, T, 4) f32, mask (B, T) bool; targets past max_targets
    are dropped."""
    b = len(targets)
    labels = np.zeros((b, max_targets), np.int32)
    boxes = np.zeros((b, max_targets, 4), np.float32)
    mask = np.zeros((b, max_targets), bool)
    for i, t in enumerate(targets):
        n = min(len(t["labels"]), max_targets)
        labels[i, :n] = np.asarray(t["labels"])[:n]
        boxes[i, :n] = np.asarray(t["boxes"])[:n]
        mask[i, :n] = True
    return {"labels": labels, "boxes": boxes, "mask": mask}


def targets_on(tgt: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """pad_targets' arrays as tensors on `device`."""
    return {k: torch.as_tensor(v).to(device) for k, v in tgt.items()}


def loss_layers(outputs: Dict) -> Tuple[List, List]:
    """The matched layers: each decoder layer, then the encoder's top-k
    (interm) proposals (reference dino.py:302-307)."""
    logits, boxes = list(outputs["logits"]), list(outputs["boxes"])
    if "interm_logits" in outputs:
        logits.append(outputs["interm_logits"])
        boxes.append(outputs["interm_boxes"])
    return logits, boxes


@torch.no_grad()
def compute_costs(outputs: Dict, tgt: Dict[str, torch.Tensor],
                  num_layers: int, cost_bbox: float = 5.0,
                  cost_giou: float = 2.0) -> List[torch.Tensor]:
    """The matcher's cost of each matched layer, (B, Q_l, T), from the
    outputs with no gradient; an invalid target costs 1e6, so that it never
    matches. The box weights are the criterion's (dino.criterion)."""
    logits_l, boxes_l = loss_layers(outputs)
    costs = []
    for li in range(num_layers):
        c = hungarian_cost_matrix(logits_l[li].detach().float(),
                                  boxes_l[li].detach().float(),
                                  tgt["labels"], tgt["boxes"],
                                  cost_bbox=cost_bbox, cost_giou=cost_giou)
        costs.append(torch.where(tgt["mask"][:, None, :], c,
                                 torch.tensor(1e6, device=c.device)))
    return costs


def solve_assignments(costs: Sequence, tgt_mask) -> np.ndarray:
    """L costs (B, Q_l, T) -> (L, B, T) int32 on the host: the query of each
    target by scipy's Hungarian on its image's valid targets, -1 for an
    invalid one."""
    mask = np.asarray(tgt_mask.cpu() if isinstance(tgt_mask, torch.Tensor)
                      else tgt_mask)
    costs = [c.float().cpu().numpy() if isinstance(c, torch.Tensor)
             else np.asarray(c) for c in costs]
    b, _, t = costs[0].shape
    out = np.full((len(costs), b, t), -1, np.int32)
    for li, ci in enumerate(costs):
        for bi in range(b):
            n = int(mask[bi].sum())
            if n == 0:
                continue
            rows, cols = hungarian_match(ci[bi][:, :n])
            out[li, bi, cols] = rows
    return out


def detection_loss(outputs: Dict, tgt: Dict[str, torch.Tensor],
                   assignment: torch.Tensor, num_classes: int,
                   weight_class: float = 1.0, weight_bbox: float = 5.0,
                   weight_giou: float = 2.0
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The set criterion given assignments (L, B, T) over the matched layers
    (`loss_layers`): the focal class loss over every query against the
    one-hot labels of its targets, the L1 and GIoU losses of the matched
    boxes, each over max(1, number of targets). Returns (loss, {'loss_ce',
    'loss_bbox', 'loss_giou'}). Under data parallelism the number of
    targets is the group's (`data_parallel.global_num_boxes`)."""
    logits_l, boxes_l = loss_layers(outputs)
    num_boxes = data_parallel.global_num_boxes(tgt["mask"])
    total_ce = total_bbox = total_giou = 0.0
    for li, (logits, boxes) in enumerate(zip(logits_l, boxes_l)):
        b, q, k = logits.shape
        a = assignment[li].long()
        idx = a.clamp(0, q - 1)                                   # (B, T)
        valid = (a >= 0) & tgt["mask"]
        scat = (F.one_hot(tgt["labels"].long(), k).to(logits.dtype)
                * valid[..., None])
        onehot = torch.zeros_like(logits).scatter_add_(
            1, idx[..., None].expand(-1, -1, k), scat)
        total_ce = total_ce + sigmoid_focal_loss(logits,
                                                 onehot).sum() / num_boxes
        pb = boxes.gather(1, idx[..., None].expand(-1, -1, 4))    # (B, T, 4)
        l1 = (pb - tgt["boxes"]).abs().sum(-1)
        total_bbox = total_bbox + torch.where(valid, l1, 0.0).sum() / num_boxes
        giou = aligned_generalized_box_iou(box_cxcywh_to_xyxy(pb),
                                           box_cxcywh_to_xyxy(tgt["boxes"]))
        total_giou = total_giou + torch.where(valid, 1 - giou,
                                              0.0).sum() / num_boxes
    loss = (weight_class * total_ce + weight_bbox * total_bbox
            + weight_giou * total_giou)
    return loss, {"loss_ce": total_ce, "loss_bbox": total_bbox,
                  "loss_giou": total_giou}


def detection_param_groups(model: nn.Module, backbone_key: str = "backbone",
                           linear_proj_names: Sequence[str] = ()
                           ) -> Dict[str, List[Tuple[str, nn.Parameter]]]:
    """Each parameter's group by its name, as the JAX engine's
    detection_param_labels labels its path (reference dino/util/
    get_param_dicts.py:22-51): 'backbone' where backbone_key is in the name,
    'linear_proj' where one of linear_proj_names is, 'main' otherwise. A
    shared parameter is listed once, under its first name."""
    groups = {g: [] for g in GROUPS}
    for name, p in model.named_parameters():
        if backbone_key in name:
            groups["backbone"].append((name, p))
        elif any(k in name for k in linear_proj_names):
            groups["linear_proj"].append((name, p))
        else:
            groups["main"].append((name, p))
    return groups


class DetectionOptimizer:
    """The JAX engine's optax chain: clip_by_global_norm(clip_norm), then
    AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay on every
    parameter) at each group's learning rate, each rate times 0.1 from step
    `drop_step` on (optax.piecewise_constant_schedule(base, {drop: 0.1}))."""

    def __init__(self, model: nn.Module, lrs: Dict[str, float],
                 weight_decay: float, clip_norm: float,
                 drop_step: Optional[int], linear_proj_names: Sequence[str]):
        groups = detection_param_groups(model,
                                        linear_proj_names=linear_proj_names)
        self.names = [g for g in GROUPS if groups[g]]
        self.base_lrs = [lrs[g] for g in self.names]
        self.params = [p for g in self.names for _, p in groups[g]]
        self.clip_norm, self.drop_step = clip_norm, drop_step
        self.optimizer = torch.optim.AdamW(
            [{"params": [p for _, p in groups[g]]} for g in self.names],
            lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)

    def lrs(self, step: int) -> List[float]:
        """Each group's learning rate at update `step` (0 for the first)."""
        drop = self.drop_step is not None and step >= self.drop_step
        return [lr * 0.1 if drop else lr for lr in self.base_lrs]

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self, step: int) -> torch.Tensor:
        """Clip and update at update `step`; a parameter the loss did not
        reach gets a zero gradient, so that it decays as optax decays it.
        Returns the unclipped global norm."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return optimizer_step(self.optimizer, self.lrs(step), self.clip_norm)


def create_detection_optimizer(model: nn.Module, lr: float = 1e-4,
                               lr_backbone: float = 1e-5,
                               weight_decay: float = 1e-4,
                               clip_norm: float = 0.1,
                               lr_linear_proj_mult: float = 1.0,
                               linear_proj_names: Sequence[str] = (),
                               drop_step: Optional[int] = None
                               ) -> DetectionOptimizer:
    """AdamW with per-group learning rates and global-norm clipping
    (fastervit_tpu/detection/engine.py::create_detection_optimizer;
    reference dino/main.py:230-238: clip_max_norm 0.1, weight decay 1e-4,
    lr 1e-4, backbone 1e-5): 'main' at lr, 'backbone' at lr_backbone,
    'linear_proj' at lr·lr_linear_proj_mult, all ×0.1 from update
    drop_step on (None: never)."""
    return DetectionOptimizer(
        model, {"main": lr, "backbone": lr_backbone,
                "linear_proj": lr * lr_linear_proj_mult},
        weight_decay, clip_norm, drop_step, tuple(linear_proj_names))


@dataclasses.dataclass
class DetectionTrainState:
    """What a train step updates: the detector (f32 parameters), its
    optimizer, the EMA copy (or None) and the count of updates. Under data
    parallelism `ddp` is the DistributedDataParallel wrapper that the
    gradient pass calls (`parallel.data_parallel.wrap_model`; for the MOTR
    clip step, of `tracking.motr.ClipForward`); the model keeps the
    weights."""
    model: nn.Module
    optimizer: DetectionOptimizer
    ema_model: Optional[nn.Module] = None
    step: int = 0
    ddp: Optional[nn.Module] = None


def _f32(outputs: Dict) -> Dict:
    """The matched layers' logits and boxes in f32, for the loss."""
    out = {"logits": [t.float() for t in outputs["logits"]],
           "boxes": [t.float() for t in outputs["boxes"]]}
    if "interm_logits" in outputs:
        out["interm_logits"] = outputs["interm_logits"].float()
        out["interm_boxes"] = outputs["interm_boxes"].float()
    return out


def _make_step(assign: Callable, dtype: torch.dtype, ema_decay: float):
    def train_step(state: DetectionTrainState, images: torch.Tensor,
                   tgt: Dict[str, torch.Tensor], *args) -> Dict:
        model = state.model.eval()      # frozen BatchNorm statistics
        device = next(model.parameters()).device
        if ema_decay > 0.0 and state.ema_model is None:
            state.ema_model = create_ema_model(model)
        state.optimizer.zero_grad()
        with _autocast(device, dtype):
            out = (model if state.ddp is None else state.ddp)(images)
        out = _f32(out)
        assignment = assign(out, tgt, *args)
        loss, parts = detection_loss(out, tgt, assignment,
                                     model.num_classes)
        loss.backward()
        grad_norm = state.optimizer.step(state.step)
        if ema_decay > 0.0:
            ema_update(state.ema_model, model, ema_decay)
        state.step += 1
        return {"loss": data_parallel.mean_over_processes(loss.detach()),
                "grad_norm": grad_norm, "assignment": assignment,
                **{k: v.detach() for k, v in parts.items()}}
    return train_step


def make_detection_train_step(dtype: torch.dtype = torch.float32,
                              ema_decay: float = 0.0):
    """train_step(state, images, tgt, assignment=None) -> metrics, which
    updates `state` in place (fastervit_tpu/detection/engine.py::
    make_detection_train_step). images (B, 3, H, W) on the model's device;
    tgt: `targets_on(pad_targets(...))`; assignment (L, B, T): given, or
    None for the host Hungarian on this forward's costs. metrics: 'loss',
    'loss_ce', 'loss_bbox', 'loss_giou', 'grad_norm' as device scalars and
    the 'assignment' used. With ema_decay > 0, state.ema_model follows
    the model (a copy of it before the first update if None, as the JAX
    epoch starts its EMA from the parameters)."""
    def assign(out, tgt, assignment=None):
        if assignment is None:
            costs = compute_costs(out, tgt, len(loss_layers(out)[0]))
            assignment = solve_assignments(costs, tgt["mask"])
        return torch.as_tensor(assignment).to(tgt["mask"].device)
    return _make_step(assign, dtype, ema_decay)


def make_fused_detection_train_step(dtype: torch.dtype = torch.float32,
                                    ema_decay: float = 0.0,
                                    eps: float = 1e-3):
    """train_step(state, images, tgt) -> metrics, with the on-device auction
    in place of the host Hungarian (engine.py::
    make_fused_detection_train_step): forward, costs, auction, loss,
    backward and update with no round trip to the host but the auction's
    termination checks. Matching within Σvalid·eps of the optimum."""
    def assign(out, tgt):
        costs = compute_costs(out, tgt, len(loss_layers(out)[0]))
        return solve_assignments_device(costs, tgt["mask"], eps)
    return _make_step(assign, dtype, ema_decay)


def train_detection_epoch(state: DetectionTrainState,
                          loader: Iterable[Tuple[np.ndarray, List[Dict]]],
                          max_targets: int = 20, matcher: str = "auto",
                          dtype: torch.dtype = torch.float32,
                          ema_decay: float = 0.0) -> Dict[str, float]:
    """One epoch over (NHWC images, per-image targets) batches (JAX
    engine.py::train_detection_epoch): each batch's images go to the
    model's device as NCHW, its targets through pad_targets, then one step
    with `matcher` ('host', 'auction' or 'auto'). Returns {'loss': the
    epoch's mean}."""
    device = next(state.model.parameters()).device
    if matcher == "auto":
        matcher = "auction" if device.type == "cuda" else "host"
    make = (make_fused_detection_train_step if matcher == "auction"
            else make_detection_train_step)
    step = make(dtype, ema_decay)
    losses = []
    for images, targets in loader:
        x = torch.from_numpy(np.ascontiguousarray(images)).to(device)
        x = x.permute(0, 3, 1, 2).contiguous()
        tgt = targets_on(pad_targets(targets, max_targets), device)
        losses.append(step(state, x, tgt)["loss"])
    return {"loss": float(torch.stack(losses).mean()) if losses
            else float("nan")}
