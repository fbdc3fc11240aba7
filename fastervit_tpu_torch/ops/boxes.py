"""Box operations, the Hungarian matcher's cost and the CIoU/DIoU losses
for the detection heads (PyTorch port of fastervit_tpu/ops/boxes.py;
reference dino/util/box_ops.py, models/dino/matcher.py and
util/box_loss.py). Boxes are (..., 4) tensors, cxcywh or xyxy; the
pairwise functions take (..., N, 4) and (..., M, 4) and batch over the
leading dimensions."""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h,
                        cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0],
                       dim=-1)


def box_area(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def box_iou(a: torch.Tensor, b: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pairwise IoU of xyxy boxes a (..., N, 4) and b (..., M, 4): (iou,
    union), each (..., N, M)."""
    area_a = box_area(a)[..., :, None]
    area_b = box_area(b)[..., None, :]
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a + area_b - inter
    return inter / union.clamp(min=1e-9), union


def generalized_box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise GIoU of xyxy boxes a (..., N, 4) and b (..., M, 4),
    (..., N, M)."""
    iou, union = box_iou(a, b)
    lt = torch.minimum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.maximum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area.clamp(min=1e-9)


def aligned_generalized_box_iou(a: torch.Tensor,
                                b: torch.Tensor) -> torch.Tensor:
    """GIoU of xyxy box pairs a[..., i] and b[..., i], (...,): the diagonal
    of `generalized_box_iou`, computed pair by pair."""
    area_a, area_b = box_area(a), box_area(b)
    wh = (torch.minimum(a[..., 2:], b[..., 2:])
          - torch.maximum(a[..., :2], b[..., :2])).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a + area_b - inter
    iou = inter / union.clamp(min=1e-9)
    wh = (torch.maximum(a[..., 2:], b[..., 2:])
          - torch.minimum(a[..., :2], b[..., :2])).clamp(min=0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area.clamp(min=1e-9)


def hungarian_cost_matrix(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                          tgt_labels: torch.Tensor, tgt_boxes: torch.Tensor,
                          cost_class: float = 2.0, cost_bbox: float = 5.0,
                          cost_giou: float = 2.0, focal_alpha: float = 0.25,
                          focal_gamma: float = 2.0) -> torch.Tensor:
    """DETR's matcher cost with DINO's focal class cost (reference
    dino/models/dino/matcher.py HungarianMatcher.forward; fastervit_tpu/
    ops/boxes.py:47): pred_logits (..., Q, C), pred_boxes (..., Q, 4)
    cxcywh; tgt_labels (..., T) int, tgt_boxes (..., T, 4) cxcywh. Returns
    (..., Q, T)."""
    prob = torch.sigmoid(pred_logits)
    neg = (1 - focal_alpha) * prob ** focal_gamma * (-torch.log1p(
        -prob + 1e-8))
    pos = focal_alpha * (1 - prob) ** focal_gamma * (-torch.log(prob + 1e-8))
    index = tgt_labels.long()[..., None, :].expand(
        *pred_logits.shape[:-1], tgt_labels.shape[-1])
    cost_cls = pos.gather(-1, index) - neg.gather(-1, index)
    cost_l1 = (pred_boxes[..., :, None, :]
               - tgt_boxes[..., None, :, :]).abs().sum(-1)
    cost_g = -generalized_box_iou(box_cxcywh_to_xyxy(pred_boxes),
                                  box_cxcywh_to_xyxy(tgt_boxes))
    return cost_class * cost_cls + cost_bbox * cost_l1 + cost_giou * cost_g


def hungarian_match(cost) -> Tuple[np.ndarray, np.ndarray]:
    """The optimal assignment of a (Q, T) cost matrix on the host (scipy's
    linear_sum_assignment, as the reference's matcher calls it): (row
    indices, column indices)."""
    from scipy.optimize import linear_sum_assignment
    if isinstance(cost, torch.Tensor):
        cost = cost.detach().cpu().numpy()
    return linear_sum_assignment(np.asarray(cost))


def _iou_terms(b1: torch.Tensor, b2: torch.Tensor):
    """The terms CIoU and DIoU share, for aligned box pairs in the
    reference's (sigmoid cx, sigmoid cy, exp w, exp h) parameterisation
    (dino/util/box_loss.py:7-56; fastervit_tpu/ops/boxes.py:72)."""
    b1, b2 = torch.sigmoid(b1), torch.sigmoid(b2)
    w1, h1 = torch.exp(b1[..., 2]), torch.exp(b1[..., 3])
    w2, h2 = torch.exp(b2[..., 2]), torch.exp(b2[..., 3])
    cx1, cy1 = b1[..., 0], b1[..., 1]
    cx2, cy2 = b2[..., 0], b2[..., 1]
    inter_w = (torch.minimum(cx1 + w1 / 2, cx2 + w2 / 2)
               - torch.maximum(cx1 - w1 / 2, cx2 - w2 / 2)).clamp(min=0)
    inter_h = (torch.minimum(cy1 + h1 / 2, cy2 + h2 / 2)
               - torch.maximum(cy1 - h1 / 2, cy2 - h2 / 2)).clamp(min=0)
    inter = inter_w * inter_h
    union = w1 * h1 + w2 * h2 - inter
    iou = inter / union
    c_w = (torch.maximum(cx1 + w1 / 2, cx2 + w2 / 2)
           - torch.minimum(cx1 - w1 / 2, cx2 - w2 / 2)).clamp(min=0)
    c_h = (torch.maximum(cy1 + h1 / 2, cy2 + h2 / 2)
           - torch.minimum(cy1 - h1 / 2, cy2 - h2 / 2)).clamp(min=0)
    inter_diag = (cx2 - cx1) ** 2 + (cy2 - cy1) ** 2
    c_diag = c_w ** 2 + c_h ** 2
    return iou, inter_diag / c_diag, (w1, h1, w2, h2)


def ciou_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Complete-IoU loss, 1 − CIoU per aligned pair (reference
    dino/util/box_loss.py ciou): the aspect-ratio term gated by IoU > 0.5,
    its alpha with no gradient."""
    iou, u, (w1, h1, w2, h2) = _iou_terms(pred, target)
    v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    s = (iou > 0.5).to(iou.dtype).detach()
    alpha = (s * v / (1 - iou + v)).detach()
    return 1.0 - (iou - u - alpha * v).clamp(-1.0, 1.0)


def diou_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Distance-IoU loss, 1 − DIoU per aligned pair (reference
    dino/util/box_loss.py diou, clamped to [−1, 1])."""
    iou, u, _ = _iou_terms(pred, target)
    return 1.0 - (iou - u).clamp(-1.0, 1.0)
