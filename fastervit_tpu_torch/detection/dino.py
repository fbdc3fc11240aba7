"""DINO detector on a FasterViT pyramid backbone, and its set criterion:
the PyTorch port of fastervit_tpu/detection/dino.py's DINODetector
(:28-100), build_dino_from_config (:103-122), contrastive denoising
(`prepare_cdn` and `cdn_loss`, :125-230), sigmoid_focal_loss and criterion
(:235-295) and postprocess (:298-313); reference downstream/
object_detection/dino/models/dino/dino.py and dn_components.py.

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

A batch of images of mixed sizes goes onto the canvas with its padding
mask (`detection/transforms.py::pad_to_canvas`, True at padded pixels):
`det(images, pad_mask=mask)`; each level's mask is the canvas mask resized
to the level by nearest neighbour at half-pixel centres, as
jax.image.resize(..., "nearest") takes it.

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
ROADMAP §3).

Contrastive denoising (DINO's CDN) in training: `prepare_cdn` draws noised
copies of the padded targets' labels and boxes from a torch.Generator
(`cdn_draws`, then the deterministic `cdn_from_draws`, so that the same
draws give the same queries), `det(images, dn=dn)` puts them in front of
the matching queries, and `cdn_loss` scores them with the known
assignment. The detector needs `label_enc` for them: build it with
`dn_labelbook_size` (the config's, when its use_dn is set).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from fastervit_tpu_torch.detection.transformer import DeformableTransformer
from fastervit_tpu_torch.models.config import FasterViTConfig
from fastervit_tpu_torch.models.fastervit import FasterViTPyramid, level_shapes
from fastervit_tpu_torch.models.registry import _init_weights, get_config
from fastervit_tpu_torch.ops.boxes import (aligned_generalized_box_iou,
                                           box_cxcywh_to_xyxy)
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


def level_padding_mask(pad_mask: torch.Tensor,
                       spatial_shapes: Sequence[Tuple[int, int]]
                       ) -> torch.Tensor:
    """The canvas mask (B, H, W) bool, True at padded pixels -> each level's
    mask, flattened and concatenated over the levels: (B, S). A level's
    mask is the canvas mask resized to it by nearest neighbour at
    half-pixel centres ("nearest-exact"), which is what the JAX detector's
    jax.image.resize(..., "nearest") takes (dino.py:64-71); "nearest"
    would sample the top-left neighbour and move the edge by a cell."""
    m = pad_mask[:, None].float()
    return torch.cat([
        F.interpolate(m, size=(h, w), mode="nearest-exact").flatten(1) > 0.5
        for h, w in spatial_shapes], 1)


class DINODetector(nn.Module):
    """Backbone pyramid -> input projections (1x1 conv + GroupNorm for the
    backbone levels, 3x3 stride-2 conv + GroupNorm for the extra levels, the
    first on the raw last backbone map) -> deformable transformer ->
    per-layer class and box predictions. Built for the canvas
    `backbone_cfg.resolution`; input (B, 3, H, W) at that canvas. With
    `dn_labelbook_size`, the transformer's denoising label embedding
    `label_enc`, also listed under upstream's top-level name."""

    def __init__(self, backbone_cfg: FasterViTConfig, num_classes: int = 91,
                 dim: int = 256, num_queries: int = 900, enc_layers: int = 6,
                 dec_layers: int = 6, num_feature_levels: int = 4,
                 return_interm_indices: Sequence[int] = (1, 2, 3),
                 use_checkpoint: bool = False,
                 dn_labelbook_size: Optional[int] = None):
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
            num_classes=num_classes, use_checkpoint=use_checkpoint,
            dn_labelbook_size=dn_labelbook_size)
        # the shared heads and the label embedding, under upstream's
        # top-level names too
        self.bbox_embed = self.transformer.decoder.bbox_embed
        self.class_embed = self.transformer.decoder.class_embed
        self.label_enc = self.transformer.label_enc

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
        """images: (B, 3, H, W); dn: `prepare_cdn`'s queries ({'labels',
        'boxes', 'attn_mask'}) or None; pad_mask: (B, H, W) bool, True at
        padded pixels, or None (no pixel padded). Returns the
        transformer's outputs (`DeformableTransformer.decode`), the dn
        queries' first."""
        mask = None
        if pad_mask is not None:
            if tuple(pad_mask.shape[-2:]) != self.canvas:
                raise ValueError(f"mask of {tuple(pad_mask.shape[-2:])}: the "
                                 f"detector was built for {self.canvas}")
            mask = level_padding_mask(pad_mask, self.spatial_shapes)
        dn = dn or {}
        return self.transformer(self.project(self.features(images)), mask,
                                dn.get("labels"), dn.get("boxes"),
                                dn.get("attn_mask"))


def _focal_bias() -> float:
    """Class-head bias at prior probability 0.01 (dino.py:135-137)."""
    return -math.log((1 - 0.01) / 0.01)


def trunc_normal_(p: torch.Tensor, std: float,
                  generator: torch.Generator) -> None:
    """p drawn on the CPU from a normal of std `std` truncated at 2 std
    (flax's lecun_normal and variance_scaling), then copied to its
    device."""
    w = torch.empty(p.shape, dtype=torch.float32)
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    p.copy_(w)


@torch.no_grad()
def lecun_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Every Linear and Conv2d of `module` outside its backbone (and the
    self-attention projections of every nn.MultiheadAttention) a truncated
    normal of std 1/sqrt(fan_in), flax's lecun_normal, with zero bias; the
    MSDA offset and weight heads their own init."""
    for name, m in module.named_modules():
        if name.startswith("backbone"):
            continue
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            trunc_normal_(m.weight, 1.0 / math.sqrt(m.weight[0].numel()),
                          generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.MultiheadAttention):
            trunc_normal_(m.in_proj_weight, 1.0 / math.sqrt(m.embed_dim),
                          generator)
            m.in_proj_bias.zero_()
    for m in module.modules():
        if isinstance(m, MSDeformAttnModule):
            m.reset_offset_heads()


@torch.no_grad()
def init_weights(det: DINODetector, generator: torch.Generator) -> None:
    """Random init drawn on the CPU from `generator`, so that one seed
    gives the same weights on every device, as the JAX detector initialises
    its parameters: the backbone as `create_model` does; the rest by
    `lecun_init_`; level_embed and tgt_embed N(0, 1); the class heads' bias
    the focal prior; the box heads' last layer zero."""
    _init_weights(det.backbone, generator)
    lecun_init_(det, generator)
    tr = det.transformer
    for p in (tr.level_embed, tr.tgt_embed.weight):
        p.copy_(torch.randn(p.shape, generator=generator))
    if tr.label_enc is not None:      # flax Embed's variance_scaling init
        trunc_normal_(tr.label_enc.weight, 1.0 / math.sqrt(tr.dim),
                      generator)
    for head in (tr.enc_out_class_embed, tr.decoder.class_embed[0]):
        head.bias.fill_(_focal_bias())
    for mlp in (tr.enc_out_bbox_embed, tr.decoder.bbox_embed[0]):
        mlp.layers[-1].weight.zero_()


def build_dino_from_config(cfg, resolution: Tuple[int, int] = (800, 1333),
                           dtype: torch.dtype = torch.float32,
                           device: Any = "cuda",
                           generator: Optional[torch.Generator] = None,
                           dn_labelbook_size: Optional[int] = None
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
    FFN of 2048. The dn settings are the caller's: `dn_labelbook_size`
    (the config's, where its use_dn is set) gives the detector `label_enc`
    for `prepare_cdn`'s queries. Returns the module in training mode; call
    `.eval()` for inference (and for training, which runs on frozen
    BatchNorm statistics: `detection/engine.py`)."""
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
            use_checkpoint=bool(cfg.get("use_checkpoint", False)),
            dn_labelbook_size=dn_labelbook_size)
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


# ------------- contrastive denoising (DINO's CDN, dn_components) -------------

def cdn_groups(t: int, dn_number: int = 100,
               dn_groups: Optional[int] = None) -> int:
    """The number of denoising groups for targets padded to t a image:
    dn_number // t (at least 1), so that the dn slots stay near
    2·dn_number (reference dn_components.py:35-47), unless given."""
    return dn_groups if dn_groups is not None else max(1, dn_number
                                                       // max(t, 1))


def cdn_draws(generator: torch.Generator, batch: int, groups: int, t: int,
              num_classes: int) -> Dict[str, torch.Tensor]:
    """The four random draws of `prepare_cdn`, on the generator's device,
    each of layout (B, G, 2, T[, 4]) (group-major, positives then
    negatives), as the JAX prepare_cdn draws them (dino.py:157-176):
    'rand_labels' uniform in [0, num_classes), 'flip' uniform in [0, 1)
    (a label is replaced where it is below label_noise_ratio / 2), 'signs'
    in {0, 1} for each box corner coordinate, and 'parts' uniform in
    [0, 1), the size of each corner's jitter."""
    shape = (batch, groups, 2, t)
    dev = generator.device
    return {"rand_labels": torch.randint(0, num_classes, shape,
                                         generator=generator, device=dev),
            "flip": torch.rand(shape, generator=generator, device=dev),
            "signs": torch.randint(0, 2, shape + (4,), generator=generator,
                                   device=dev),
            "parts": torch.rand(shape + (4,), generator=generator,
                                device=dev)}


def cdn_from_draws(draws: Dict[str, torch.Tensor], tgt_padded: Dict,
                   num_classes: int, num_queries: int,
                   label_noise_ratio: float = 0.5,
                   box_noise_scale: float = 1.0) -> Tuple[Dict, Dict]:
    """The denoising queries of padded targets (`engine.pad_targets`, as
    tensors or numpy) from `cdn_draws`' draws, with prepare_for_cdn's
    semantics (reference dn_components.py:20-137; JAX dino.py:127-196):
    - each group holds one positive and one negative copy of every target
      slot, layout (B, G, 2, T), the dn slots before the matching queries;
    - a label is replaced by a random class with probability
      label_noise_ratio / 2; padded slots take the 'no object' index
      num_classes;
    - each xyxy corner moves by part·sign·(w/2, h/2)·box_noise_scale, the
      negatives' part plus 1 (so they land further out), clamped to
      [0, 1], then back to cxcywh clamped to [1e-3, 1 - 1e-3];
    - the allow-mask (True: may attend): the matching queries see no dn
      slot, the dn groups do not see each other, and the dn slots see the
      matching queries.
    Returns (dn {'labels' (B, N_dn) long, 'boxes' (B, N_dn, 4) f32,
    'attn_mask' (N_dn + num_queries,)*2 bool}, meta {'n_dn', 'groups',
    't'}), on the targets' device."""
    labels = torch.as_tensor(tgt_padded["labels"])
    dev = labels.device
    boxes = torch.as_tensor(tgt_padded["boxes"], device=dev).float()
    mask = torch.as_tensor(tgt_padded["mask"], device=dev)
    draws = {k: v.to(dev) for k, v in draws.items()}
    b, g, _, t = draws["flip"].shape

    lbl = labels.long()[:, None, None, :].expand(b, g, 2, t)
    flip = draws["flip"] < (label_noise_ratio * 0.5)
    lbl = torch.where(flip, draws["rand_labels"].long(), lbl)
    lbl = torch.where(mask[:, None, None, :], lbl, num_classes)

    bx = boxes[:, None, None].expand(b, g, 2, t, 4)
    xyxy = torch.cat([bx[..., :2] - bx[..., 2:] / 2,
                      bx[..., :2] + bx[..., 2:] / 2], -1)
    diff = torch.cat([bx[..., 2:] / 2, bx[..., 2:] / 2], -1)
    sign = draws["signs"].float() * 2.0 - 1.0
    part = draws["parts"].float().clone()
    part[:, :, 1] += 1.0                      # negatives push further out
    xyxy = (xyxy + sign * part * diff * box_noise_scale).clamp(0.0, 1.0)
    bx = torch.cat([(xyxy[..., :2] + xyxy[..., 2:]) / 2,
                    xyxy[..., 2:] - xyxy[..., :2]], -1).clamp(1e-3,
                                                              1 - 1e-3)

    n_dn = g * 2 * t
    q_total = n_dn + num_queries
    allow = np.zeros((q_total, q_total), bool)
    allow[n_dn:, n_dn:] = True
    allow[:n_dn, n_dn:] = True
    for gi in range(g):
        s0 = gi * 2 * t
        allow[s0:s0 + 2 * t, s0:s0 + 2 * t] = True
    dn = {"labels": lbl.reshape(b, n_dn), "boxes": bx.reshape(b, n_dn, 4),
          "attn_mask": torch.from_numpy(allow).to(dev)}
    return dn, {"n_dn": n_dn, "groups": g, "t": t}


def prepare_cdn(generator: torch.Generator, tgt_padded: Dict,
                num_classes: int, num_queries: int, dn_number: int = 100,
                label_noise_ratio: float = 0.5, box_noise_scale: float = 1.0,
                dn_groups: Optional[int] = None) -> Tuple[Dict, Dict]:
    """DINO's denoising queries for padded targets (JAX dino.py::
    prepare_cdn): `cdn_groups` groups (dn_number // T), the draws from
    `generator` (`cdn_draws`), the queries from them (`cdn_from_draws`).
    Returns (dn, meta) for `DINODetector.forward(..., dn=dn)` and
    `cdn_loss`."""
    b, t = tuple(torch.as_tensor(tgt_padded["labels"]).shape)
    draws = cdn_draws(generator, b, cdn_groups(t, dn_number, dn_groups), t,
                      num_classes)
    return cdn_from_draws(draws, tgt_padded, num_classes, num_queries,
                          label_noise_ratio, box_noise_scale)


def cdn_loss(outputs: Dict, tgt: Dict[str, torch.Tensor], meta: Dict,
             num_classes: int, weight_bbox: float = 5.0,
             weight_giou: float = 2.0) -> Dict[str, torch.Tensor]:
    """The denoising loss with the known assignment (JAX dino.py::
    cdn_loss): over every decoder layer's first meta['n_dn'] slots, the
    positive slot (g, 0, k) regresses to target slot k, and the negatives
    and padded slots are background; the focal class loss, L1 and GIoU,
    each over max(1, valid targets)·groups. tgt: padded targets as
    tensors. Returns loss_ce_dn, loss_bbox_dn, loss_giou_dn and loss_dn
    (their sum at the box weights)."""
    labels, boxes, mask = tgt["labels"].long(), tgt["boxes"], tgt["mask"]
    b, t = labels.shape
    g, n_dn = meta["groups"], meta["n_dn"]
    num_boxes = mask.sum().clamp(min=1) * g
    pos_t = (F.one_hot(labels, num_classes).float()
             * mask[..., None])[:, None]                   # (B, 1, T, K)
    onehot = torch.stack([pos_t.expand(b, g, t, num_classes),
                          pos_t.new_zeros(b, g, t, num_classes)], 2)
    gt = box_cxcywh_to_xyxy(boxes)[:, None].expand(b, g, t, 4)
    total = {"loss_ce_dn": 0.0, "loss_bbox_dn": 0.0, "loss_giou_dn": 0.0}
    for logits, pred in zip(outputs["logits"], outputs["boxes"]):
        logits = logits[:, :n_dn].reshape(b, g, 2, t, -1)
        pb = pred[:, :n_dn].reshape(b, g, 2, t, 4)[:, :, 0]    # positives
        total["loss_ce_dn"] = total["loss_ce_dn"] + sigmoid_focal_loss(
            logits, onehot).sum() / num_boxes
        l1 = (pb - boxes[:, None]).abs().sum(-1)
        total["loss_bbox_dn"] = total["loss_bbox_dn"] + torch.where(
            mask[:, None], l1, 0.0).sum() / num_boxes
        giou = aligned_generalized_box_iou(box_cxcywh_to_xyxy(pb), gt)
        total["loss_giou_dn"] = total["loss_giou_dn"] + torch.where(
            mask[:, None], 1 - giou, 0.0).sum() / num_boxes
    total["loss_dn"] = (total["loss_ce_dn"]
                        + weight_bbox * total["loss_bbox_dn"]
                        + weight_giou * total["loss_giou_dn"])
    return total
