"""DINO detector on a FasterViT pyramid backbone, and its set criterion:
the PyTorch port of fastervit_tpu/detection/dino.py's DINODetector
(:28-100), build_dino_from_config (:103-122), sigmoid_focal_loss and
criterion (:235-295) and postprocess (:298-313); reference
downstream/object_detection/dino/models/dino/dino.py.

    import torch
    from fastervit_tpu_torch.detection.dino import (build_dino_from_config,
                                                    postprocess)
    from fastervit_tpu_torch.utils.pyconfig import PyConfig
    cfg = PyConfig.fromfile("configs/dino/dino_4scale_faster_vit_4_21k_224.py")
    det = build_dino_from_config(cfg, resolution=(800, 1333),
                                 dtype=torch.bfloat16).eval()
    with torch.no_grad():
        out = det(images)            # (B, 3, 800, 1333) on the card
        dets = postprocess(out, sizes, num_select=300)

Training goes through `detection/engine.py` (the criterion given
assignments, the matchers, AdamW with per-module learning rates).

The JAX detector reads its canvas from the input; the port's backbone and
transformer fix their geometry when they are built, so
`build_dino_from_config` takes the canvas (`resolution`), as `create_model`
does. Module names are
upstream DINO's (`backbone.0.*`, `input_proj.{i}.{0,1}`, `transformer.*`,
and the shared heads under both `transformer.decoder.{bbox,class}_embed.*`
and the top-level `{bbox,class}_embed.*`), so a reference DINO state_dict
loads with no converter (`detection/convert.py::load_dino_checkpoint`).

The input projections' GroupNorm keeps flax's default eps of 1e-6, as the
JAX detector has it (upstream's nn.GroupNorm(32, 256) takes 1e-5;
ROADMAP §3). Contrastive denoising and padding masks come with the next
detection slice.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from fastervit_tpu_torch.detection.transformer import (_LATER,
                                                       DeformableTransformer)
from fastervit_tpu_torch.models.config import FasterViTConfig
from fastervit_tpu_torch.models.fastervit import FasterViTPyramid, level_shapes
from fastervit_tpu_torch.models.registry import _init_weights, get_config
from fastervit_tpu_torch.ops.boxes import box_cxcywh_to_xyxy
from fastervit_tpu_torch.ops.msda import MSDeformAttnModule


def feature_shapes(height: int, width: int,
                   return_interm_indices: Sequence[int],
                   num_feature_levels: int) -> Tuple[Tuple[int, int], ...]:
    """The (H, W) of the transformer's levels for a height x width canvas:
    the backbone levels in `return_interm_indices`, then stride-2 extras
    (3x3, padding 1: ceil(n / 2)) up to num_feature_levels."""
    backbone = level_shapes(height, width)
    shapes = [backbone[i] for i in return_interm_indices][:num_feature_levels]
    while len(shapes) < num_feature_levels:
        h, w = shapes[-1]
        shapes.append((-(-h // 2), -(-w // 2)))
    return tuple(shapes)


class DINODetector(nn.Module):
    """Backbone pyramid -> input projections (1x1 conv + GroupNorm for the
    backbone levels, 3x3 stride-2 conv + GroupNorm for the extra levels, the
    first on the raw last backbone map) -> deformable transformer ->
    per-layer class and box predictions. Built for the canvas
    `backbone_cfg.resolution`; input (B, 3, H, W) at that canvas."""

    def __init__(self, backbone_cfg: FasterViTConfig, num_classes: int = 91,
                 dim: int = 256, num_queries: int = 900, enc_layers: int = 6,
                 dec_layers: int = 6, num_feature_levels: int = 4,
                 return_interm_indices: Sequence[int] = (1, 2, 3),
                 use_checkpoint: bool = False):
        super().__init__()
        self.canvas = tuple(backbone_cfg.resolution)
        self.num_classes, self.num_queries = num_classes, num_queries
        self.return_interm_indices = tuple(return_interm_indices)
        self.num_feature_levels = num_feature_levels
        self.backbone = nn.ModuleList([FasterViTPyramid(backbone_cfg)])
        proj = []
        for i in self.return_interm_indices[:num_feature_levels]:
            proj.append(nn.Sequential(
                nn.Conv2d(backbone_cfg.level_dim(i), dim, 1),
                nn.GroupNorm(32, dim, eps=1e-6)))
        in_dim = backbone_cfg.level_dim(self.return_interm_indices[-1])
        for _ in range(len(proj), num_feature_levels):
            proj.append(nn.Sequential(nn.Conv2d(in_dim, dim, 3, 2, 1),
                                      nn.GroupNorm(32, dim, eps=1e-6)))
            in_dim = dim
        self.input_proj = nn.ModuleList(proj)
        self.spatial_shapes = feature_shapes(
            *self.canvas, self.return_interm_indices, num_feature_levels)
        self.transformer = DeformableTransformer(
            self.spatial_shapes, dim=dim, enc_layers=enc_layers,
            dec_layers=dec_layers, num_queries=num_queries,
            num_classes=num_classes, use_checkpoint=use_checkpoint)
        # the shared heads, under upstream's top-level names too
        self.bbox_embed = self.transformer.decoder.bbox_embed
        self.class_embed = self.transformer.decoder.class_embed

    def features(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The backbone's normalised maps {"res2": ..., "res5": ...},
        NCHW."""
        if tuple(images.shape[-2:]) != self.canvas:
            raise ValueError(f"input of {tuple(images.shape[-2:])}: the "
                             f"detector was built for {self.canvas} (build "
                             "it with the input's resolution)")
        return self.backbone[0](images)

    def project(self, feats: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The input projections of the backbone maps, flattened and
        concatenated over the levels: (B, S, dim)."""
        keys = [f"res{i + 2}" for i in self.return_interm_indices]
        srcs = []
        for i, key in enumerate(keys[:self.num_feature_levels]):
            srcs.append(self.input_proj[i](feats[key]))
        prev = feats[keys[-1]]
        for i in range(len(srcs), self.num_feature_levels):
            prev = self.input_proj[i](prev)
            srcs.append(prev)
        return torch.cat([x.flatten(2).transpose(1, 2) for x in srcs], 1)

    def forward(self, images: torch.Tensor, dn: Optional[Dict] = None,
                pad_mask: Optional[torch.Tensor] = None) -> Dict:
        """images: (B, 3, H, W). Returns the transformer's outputs
        (`DeformableTransformer.decode`)."""
        if dn is not None:
            raise NotImplementedError(_LATER.format("contrastive denoising"))
        if pad_mask is not None:
            raise NotImplementedError(_LATER.format("a padding mask"))
        return self.transformer(self.project(self.features(images)))


def _focal_bias() -> float:
    """Class-head bias at prior probability 0.01 (dino.py:135-137)."""
    return -math.log((1 - 0.01) / 0.01)


@torch.no_grad()
def init_weights(det: DINODetector, generator: torch.Generator) -> None:
    """Random init drawn on the CPU from `generator`, so that one seed
    gives the same weights on every device, as the JAX detector initialises
    its parameters: the backbone as `create_model` does; every other Linear
    and Conv2d (and the decoder self-attention's projections) a truncated
    normal of std 1/sqrt(fan_in) (flax's lecun_normal) with zero bias;
    level_embed and tgt_embed N(0, 1); the class heads' bias the focal
    prior; the box heads' last layer zero; the MSDA offset and weight heads
    their own init."""
    def trunc_normal(p: torch.Tensor, std: float) -> None:
        w = torch.empty(p.shape, dtype=torch.float32)
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        p.copy_(w)

    _init_weights(det.backbone, generator)
    for name, m in det.named_modules():
        if name.startswith("backbone"):
            continue
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            trunc_normal(m.weight, 1.0 / math.sqrt(m.weight[0].numel()))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.MultiheadAttention):
            trunc_normal(m.in_proj_weight, 1.0 / math.sqrt(m.embed_dim))
            m.in_proj_bias.zero_()
    tr = det.transformer
    for p in (tr.level_embed, tr.tgt_embed.weight):
        p.copy_(torch.randn(p.shape, generator=generator))
    for head in (tr.enc_out_class_embed, tr.decoder.class_embed[0]):
        head.bias.fill_(_focal_bias())
    for mlp in (tr.enc_out_bbox_embed, tr.decoder.bbox_embed[0]):
        mlp.layers[-1].weight.zero_()
    for m in det.modules():
        if isinstance(m, MSDeformAttnModule):
            m.reset_offset_heads()


def build_dino_from_config(cfg, resolution: Tuple[int, int] = (800, 1333),
                           dtype: torch.dtype = torch.float32,
                           device: Any = "cuda",
                           generator: Optional[torch.Generator] = None
                           ) -> DINODetector:
    """Build a DINODetector from a PyConfig (configs/dino/*.py; the
    reference's build_dino(args)) for a canvas of `resolution` (H, W; the
    default is COCO evaluation's 800 short side and 1333 long side), on
    `device` (the card unless the caller asks for "cpu"), its weights drawn
    from `generator` (a CPU generator; seed 0 if None) and cast to `dtype`
    (but for the transformer's constant tables and level_embed, which stay
    f32 as in the JAX detector: `DeformableTransformer._apply`).
    Reads the keys that fastervit_tpu's build_dino_from_config reads
    (backbone, backbone_overrides, num_classes, hidden_dim, num_queries,
    enc_layers, dec_layers, num_feature_levels, return_interm_indices,
    use_checkpoint: each transformer layer recomputed in the backward, as
    the JAX detector's remat); like it, it keeps 8 heads, 4 points and an
    FFN of 2048. Returns the module in training mode; call `.eval()` for
    inference (and for training, which runs on frozen BatchNorm
    statistics: `detection/engine.py`)."""
    h, w = (resolution, resolution) if isinstance(resolution, int) \
        else resolution
    backbone_cfg = get_config(cfg["backbone"], resolution=(h, w),
                              **cfg.get("backbone_overrides", {}))
    device = torch.device(device)
    with device:
        det = DINODetector(
            backbone_cfg, num_classes=cfg.get("num_classes", 91),
            dim=cfg.get("hidden_dim", 256),
            num_queries=cfg.get("num_queries", 900),
            enc_layers=cfg.get("enc_layers", 6),
            dec_layers=cfg.get("dec_layers", 6),
            num_feature_levels=cfg.get("num_feature_levels", 4),
            return_interm_indices=tuple(cfg.get("return_interm_indices",
                                                [1, 2, 3])),
            use_checkpoint=bool(cfg.get("use_checkpoint", False)))
    if device.type != "meta":
        init_weights(det, generator if generator is not None
                     else torch.Generator().manual_seed(0))
    return det.to(dtype)


def postprocess(outputs: Dict, target_sizes: torch.Tensor,
                num_select: int = 300) -> Dict[str, torch.Tensor]:
    """Top-k detections of the last decoder layer (reference PostProcess,
    dino.py:655): target_sizes (B, 2) as (H, W). Returns {'scores' (B, k),
    'labels' (B, k), 'boxes' (B, k, 4) xyxy in absolute pixels}, scores and
    boxes in f32 whatever the model's dtype (bf16 would round a pixel
    coordinate near 1000 to a multiple of 4)."""
    logits = outputs["logits"][-1].float()
    boxes = outputs["boxes"][-1].float()
    b, q, k = logits.shape
    prob = torch.sigmoid(logits).reshape(b, q * k)
    scores, idx = prob.topk(num_select, dim=1)
    labels = idx % k
    qidx = idx // k
    xyxy = box_cxcywh_to_xyxy(torch.gather(boxes, 1,
                                           qidx[..., None].expand(-1, -1, 4)))
    sizes = target_sizes.to(xyxy)
    h, w = sizes[:, 0], sizes[:, 1]
    scale = torch.stack([w, h, w, h], -1)[:, None, :]
    return {"scores": scores, "labels": labels, "boxes": xyxy * scale}


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       alpha: float = 0.25, gamma: float = 2.0
                       ) -> torch.Tensor:
    """The focal loss of each logit against its 0/1 target, elementwise
    (fastervit_tpu/detection/dino.py::sigmoid_focal_loss)."""
    p = torch.sigmoid(logits)
    ce = -(targets * F.logsigmoid(logits)
           + (1 - targets) * F.logsigmoid(-logits))
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = loss * (alpha * targets + (1 - alpha) * (1 - targets))
    return loss


def criterion(outputs: Dict, targets: List[Dict], num_classes: int,
              weight_class: float = 1.0, weight_bbox: float = 5.0,
              weight_giou: float = 2.0) -> Dict[str, torch.Tensor]:
    """The Hungarian set criterion over every decoder layer and the
    encoder's interm layer (fastervit_tpu/detection/dino.py::criterion;
    reference SetCriterion), through the training engine's one loss path:
    the targets padded to the longest image's (`engine.pad_targets`), the
    matcher's cost of each layer (`compute_costs`, class weight 2) solved on
    the host by scipy (`solve_assignments`), then `detection_loss`: the
    focal class loss over every query and the L1 and GIoU box losses over
    the matched pairs, each divided by the number of target boxes.
    targets: per-image {'labels' (T,), 'boxes' (T, 4) cxcywh in [0, 1]},
    numpy or torch. Returns loss_ce, loss_bbox, loss_giou and their
    weighted sum, loss."""
    from fastervit_tpu_torch.detection import engine  # engine imports dino
    dev = outputs["logits"][0].device
    tgt = engine.targets_on(engine.pad_targets(
        targets, max([1] + [len(t["labels"]) for t in targets])), dev)
    logits_l, _ = engine.loss_layers(outputs)
    costs = engine.compute_costs(outputs, tgt, len(logits_l),
                                 cost_bbox=weight_bbox, cost_giou=weight_giou)
    assignment = torch.as_tensor(engine.solve_assignments(costs, tgt["mask"]),
                                 device=dev)
    loss, parts = engine.detection_loss(
        outputs, tgt, assignment, num_classes, weight_class=weight_class,
        weight_bbox=weight_bbox, weight_giou=weight_giou)
    return {**parts, "loss": loss}
