"""The checkpoint-exact MOTRv2 detector and its streaming loop: the PyTorch
port of fastervit_tpu/tracking/motr_exact.py (`sine_position_embedding`
:34-54, `QIMv2` :57-96, `MOTRDetectorExact` :99-161,
`empty_track_queries` :164-178, `exact_inference_sequence` :181-294).
Reference motrv2/models/motr.py MOTR in the shipped configuration
(configs/motrv2.args: with_box_refine, QIMv2, no memory bank).

Module names are upstream MOTR's, so that an upstream checkpoint loads as
it is (`tracking/convert.py::load_motr_checkpoint`): the detector's
`backbone.0.*`, `input_proj_fastervit.{i}.{0,1}`, `query_embed`,
`position`, `yolox_embed`, `transformer.*`, `class_embed.{i}` and the
refinement heads under both `transformer.decoder.bbox_embed.{i}` and
`bbox_embed.{i}`; the QIM's are upstream's `track_embed.*` without the
prefix.

`query_embed`, `position` and `yolox_embed` stay f32 under any cast (the
streaming loop reads them on the host between frames, as the JAX loop
reads its f32 parameters), and so do the position embeddings; the QIM
runs in f32, as JAX's QIMv2 computes in f32 on the model's outputs.

The streaming loop keeps its per-frame state on the host in numpy, as the
JAX loop does: the detector and the QIM run on the card, the tracker's
birth and death and the repacking of the slots between them.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from fastervit_tpu_torch.detection.dino import lecun_init_
from fastervit_tpu_torch.detection.transformer import KeepF32
from fastervit_tpu_torch.models.config import FasterViTConfig
from fastervit_tpu_torch.models.fastervit import FasterViTPyramid, level_shapes
from fastervit_tpu_torch.models.registry import _init_weights
from fastervit_tpu_torch.tracking.motr import (_cxcywh_to_xyxy, frame_tensor,
                                               pos2posemb)
from fastervit_tpu_torch.tracking.transformer import MOTRTransformer


def sine_position_embedding(h: int, w: int, num_pos_feats: int,
                            temperature: float = 10000.0) -> np.ndarray:
    """DETR's PositionEmbeddingSine, normalize=True, no padding
    (position_encoding.py:25-41): (h, w, 2·num_pos_feats) float32, the
    y-embedding first, each interleaved sin/cos."""
    scale = 2 * math.pi
    eps = 1e-6
    y = (np.arange(1, h + 1, dtype=np.float32) - 0.5) / (h + eps) * scale
    x = (np.arange(1, w + 1, dtype=np.float32) - 0.5) / (w + eps) * scale
    dim_t = temperature ** (2 * (np.arange(num_pos_feats) // 2)
                            / num_pos_feats)
    py = y[:, None] / dim_t
    px = x[:, None] / dim_t
    py = np.stack([np.sin(py[:, 0::2]), np.cos(py[:, 1::2])],
                  -1).reshape(h, num_pos_feats)
    px = np.stack([np.sin(px[:, 0::2]), np.cos(px[:, 1::2])],
                  -1).reshape(w, num_pos_feats)
    pos = np.concatenate([np.broadcast_to(py[:, None], (h, w, num_pos_feats)),
                          np.broadcast_to(px[None], (h, w, num_pos_feats))],
                         axis=-1)
    return pos.astype(np.float32)


class QIMv2(nn.Module):
    """QueryInteractionModulev2's track-embedding update (qim.py:147-175,
    update_query_pos=False, eval): self-attention over the track slots
    with q = k = pos2posemb(ref) + output_embedding, FFN (linear1,
    linear2, norm2), then a second FFN (linear_feat1, linear_feat2,
    norm_feat) whose output refreshes the query features of the positive
    slots (score > 0.5)."""

    def __init__(self, dim: int = 256, hidden: int = 1024):
        super().__init__()
        self.dim = dim
        self.self_attn = nn.MultiheadAttention(dim, 8, batch_first=True)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.linear1 = nn.Linear(dim, hidden)
        self.linear2 = nn.Linear(hidden, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.linear_feat1 = nn.Linear(dim, hidden)
        self.linear_feat2 = nn.Linear(hidden, dim)
        self.norm_feat = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, output_embedding: torch.Tensor,
                query_pos_feat: torch.Tensor, ref_pts: torch.Tensor,
                scores: torch.Tensor,
                active_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """All (B, T, ...), in f32 (a bf16 output_embedding is widened);
        ref_pts: the slots' anchors (positives' predicted boxes);
        active_mask (B, T) bool restricts the self-attention to the active
        slots, every slot keeping itself (the reference runs the QIM on
        exactly that subset, qim.py:136-145; the inactive slots' outputs
        are the caller's to drop). Returns the new query features."""
        output_embedding = output_embedding.float()
        b, t = output_embedding.shape[:2]
        is_pos = (scores > 0.5)[..., None]
        qp = pos2posemb(ref_pts.float(), self.dim // 4).reshape(b, t,
                                                                 self.dim)
        q = qp + output_embedding
        tgt = output_embedding
        blocked = None
        if active_mask is not None:
            eye = torch.eye(t, dtype=torch.bool, device=tgt.device)
            allow = active_mask[:, None, :] | eye
            blocked = ~allow.repeat_interleave(self.self_attn.num_heads, 0)
        sa = self.self_attn(q, q, tgt, need_weights=False,
                            attn_mask=blocked)[0]
        tgt = self.norm1(tgt + sa)
        tgt = self.norm2(tgt + self.linear2(F.relu(self.linear1(tgt))))
        f = self.linear_feat2(F.relu(self.linear_feat1(tgt)))
        feat = self.norm_feat(query_pos_feat + f)
        return torch.where(is_pos, feat, query_pos_feat)


class F32Embedding(KeepF32, nn.Embedding):
    """nn.Embedding whose table stays f32 under any cast."""

    _F32_TENSORS = ("weight",)


class MOTRDetectorExact(KeepF32):
    """Reference-weight-compatible MOTR forward of one frame
    (fastervit_tpu/tracking/motr_exact.py::MOTRDetectorExact): the
    pyramid's four strides -> 1x1 conv + GroupNorm(32, flax's eps 1e-6)
    each -> DETR sine position embeddings (N_steps = dim / 2, normalised)
    -> MOTRTransformer -> per-layer class heads; the per-layer boxes are
    the decoder's refinement values. Built for the canvas
    `backbone_cfg.resolution`; input (B, 3, H, W) at that canvas."""

    _F32_TENSORS = ("pos_sine",)

    def __init__(self, backbone_cfg: FasterViTConfig, num_classes: int = 1,
                 dim: int = 256, num_queries: int = 10, enc_layers: int = 6,
                 dec_layers: int = 6, ffn_dim: int = 1024,
                 lite_encoder: bool = False):
        super().__init__()
        self.canvas = tuple(backbone_cfg.resolution)
        self.dim, self.num_queries = dim, num_queries
        self.num_classes = num_classes
        # learned query and anchor tables (motr.py:395, 427, 438), read on
        # the host by empty_track_queries between frames
        self.query_embed = F32Embedding(num_queries, dim)
        self.position = F32Embedding(num_queries, 4)
        self.yolox_embed = F32Embedding(1, dim)
        self.backbone = nn.ModuleList([FasterViTPyramid(backbone_cfg)])
        self.input_proj_fastervit = nn.ModuleList(
            nn.Sequential(nn.Conv2d(backbone_cfg.level_dim(i), dim, 1),
                          nn.GroupNorm(32, dim, eps=1e-6))
            for i in range(backbone_cfg.num_levels))
        self.spatial_shapes = level_shapes(*self.canvas,
                                           backbone_cfg.num_levels)
        self.transformer = MOTRTransformer(
            self.spatial_shapes, dim=dim, enc_layers=enc_layers,
            dec_layers=dec_layers, ffn_dim=ffn_dim, lite_encoder=lite_encoder)
        self.class_embed = nn.ModuleList(nn.Linear(dim, num_classes)
                                         for _ in range(dec_layers))
        # the refinement heads are the box heads (motr.py:442-447)
        self.bbox_embed = self.transformer.decoder.bbox_embed
        pos = np.concatenate([sine_position_embedding(h, w, dim // 2).reshape(
            h * w, dim) for h, w in self.spatial_shapes], 0)
        self.register_buffer("pos_sine", torch.as_tensor(pos),
                             persistent=False)

    @property
    def device(self) -> torch.device:
        return self.input_proj_fastervit[0][0].weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.input_proj_fastervit[0][0].weight.dtype

    def forward(self, images: torch.Tensor, query_pos: torch.Tensor,
                ref_pts: torch.Tensor,
                self_attn_mask: Optional[torch.Tensor] = None) -> Dict:
        """images (B, 3, H, W); query_pos (B, T, dim) query features
        (upstream's 'query_pos': learned query_embed rows ++ proposal
        embeddings ++ the carried track slots); ref_pts (B, T, 4);
        self_attn_mask (T, T) bool, True where BLOCKED (the streaming loop
        blocks its padded track slots). Returns per-layer lists 'logits'
        (B, T, K), 'boxes' (B, T, 4) and 'hidden' (B, T, dim), and
        'init_ref'."""
        if tuple(images.shape[-2:]) != self.canvas:
            raise ValueError(f"input of {tuple(images.shape[-2:])}: the "
                             f"detector was built for {self.canvas}")
        feats = self.backbone[0](images)
        src = torch.cat([proj(feats[f"res{i + 2}"]).flatten(2).transpose(1, 2)
                         for i, proj in enumerate(self.input_proj_fastervit)],
                        1)
        out = self.transformer(src, self.pos_sine[None], query_pos, ref_pts,
                               self_attn_mask)
        return {"logits": [head(h) for head, h in zip(self.class_embed,
                                                      out["hidden"])],
                "boxes": out["refs"], "hidden": out["hidden"],
                "init_ref": out["init_ref"]}


@torch.no_grad()
def init_weights(det: MOTRDetectorExact, qim: Optional[QIMv2],
                 generator: torch.Generator) -> None:
    """Random init drawn on the CPU from `generator`, as the JAX modules
    initialise their parameters: the backbone as `create_model` does; every
    Linear, Conv2d and attention projection flax's lecun_normal with zero
    bias (`detection.dino.lecun_init_`); level_embed, query_embed and
    yolox_embed N(0, 1); position U(0, 1)."""
    _init_weights(det.backbone, generator)
    lecun_init_(det, generator)
    if qim is not None:
        lecun_init_(qim, generator)
    for p in (det.transformer.level_embed, det.query_embed.weight,
              det.yolox_embed.weight):
        p.copy_(torch.randn(p.shape, generator=generator))
    det.position.weight.copy_(torch.rand(det.position.weight.shape,
                                         generator=generator))


def build_motr_exact(resolution=(800, 1536),
                     backbone: str = "faster_vit_0_any_res",
                     dtype: torch.dtype = torch.float32,
                     device: Any = "cuda",
                     generator: Optional[torch.Generator] = None,
                     checkpoint: Optional[str] = None, **kw):
    """The exact detector and its QIMv2 for a canvas of `resolution` (H,
    W; the JAX submit CLI's 800x1536 by default) on `device` (the card
    unless the caller asks for "cpu"), their weights drawn from
    `generator` (seed 0 if None; `init_weights`), then an upstream MOTRv2
    checkpoint over them if given (`convert.load_motr_checkpoint`, which
    raises if the file was built for another query count, width or depth
    than `kw` builds); the
    detector cast to `dtype` (the QIM stays f32), both in eval mode. `kw`
    goes to MOTRDetectorExact (dim, num_queries, enc_layers, dec_layers,
    ffn_dim, lite_encoder, ...). Returns (det, qim)."""
    from fastervit_tpu_torch.models.registry import get_config
    from fastervit_tpu_torch.tracking.convert import load_motr_checkpoint
    cfg = get_config(backbone, resolution=tuple(resolution))
    with torch.device(device):
        det = MOTRDetectorExact(cfg, **kw)
        qim = QIMv2(dim=det.dim)
    init_weights(det, qim, generator if generator is not None
                 else torch.Generator().manual_seed(0))
    if checkpoint:
        load_motr_checkpoint(det, qim, checkpoint, fit=True)
    return det.to(dtype).eval(), qim.eval()


@torch.no_grad()
def empty_track_queries(det: MOTRDetectorExact,
                        proposals: Optional[np.ndarray] = None):
    """_generate_empty_tracks (motr.py:465-489): the learned query_embed
    rows and position anchors, then, given proposals (P, 5) (cxcywh
    normalised + score), a proposal query each: pos2posemb(score, dim) +
    yolox_embed, its box the anchor; computed on the detector's device.
    Returns ((1, Q[+P], dim), (1, Q[+P], 4)) float32 numpy."""
    qp, rp = det.query_embed.weight, det.position.weight
    if proposals is not None:
        props = torch.as_tensor(np.asarray(proposals, np.float32),
                                device=qp.device)
        qp = torch.cat([qp, pos2posemb(props[:, 4], det.dim)
                        + det.yolox_embed.weight[0]], 0)
        rp = torch.cat([rp, props[:, :4]], 0)
    return (qp.float().cpu().numpy()[None], rp.float().cpu().numpy()[None])


@torch.no_grad()
def exact_inference_sequence(det: MOTRDetectorExact, qim: QIMv2,
                             frames: Iterable, num_queries: int, dim: int,
                             proposals_per_frame=None,
                             num_proposals: int = 10,
                             track_capacity: int = 50,
                             score_thresh: float = 0.6,
                             filter_score_thresh: float = 0.5,
                             miss_tolerance: int = 10,
                             prob_threshold: Optional[float] = None
                             ) -> List[Dict]:
    """Streaming inference with the reference's per-frame semantics
    (motr.py inference_single_image + _post_process_single_image +
    RuntimeTrackerBase, eval), as fastervit_tpu/tracking/motr_exact.py::
    exact_inference_sequence runs it:
    - a frame's query set is [fresh detect queries ++ fresh proposal
      queries ++ the carried track slots] (the fresh ones first,
      motr.py:617-621); the track set rides in `track_capacity` padded
      slots, whose columns are blocked in the decoder's and the QIM's
      self-attention;
    - scores = sigmoid of the last layer's logits; RuntimeTrackerBase
      births at score_thresh, counts a miss below filter_score_thresh and
      kills after miss_tolerance misses (motr.py:302-326);
    - a frame writes its active tracks above prob_threshold (score_thresh
      if None);
    - QIMv2 refreshes the active tracks' query features, the positives
      anchored on their predicted boxes, and the actives are repacked into
      the slots for the next frame.
    frames: normalised (H, W, 3) numpy images or (3, H, W) tensors;
    proposals_per_frame: per-frame (num_proposals, 5) arrays or None.
    The detector's outputs come to the host in f32, where the tracker's
    arithmetic runs. Returns per frame {'ids', 'boxes' (xyxy,
    normalised), 'scores'}."""
    dev, dtype = det.device, det.dtype
    if proposals_per_frame is None and num_proposals:
        raise ValueError(f"num_proposals {num_proposals} without "
                         "proposals_per_frame (pass num_proposals=0)")
    cap = track_capacity
    fresh = num_queries + num_proposals
    total = fresh + cap
    t_valid = np.zeros(cap, bool)
    t_obj = np.full(cap, -1, np.int64)
    t_disappear = np.zeros(cap, np.int64)
    t_qp = np.zeros((cap, dim), np.float32)
    t_ref = np.full((cap, 4), 0.5, np.float32)
    next_id = 0
    results = []
    for fi, frame in enumerate(frames):
        props = None
        if proposals_per_frame is not None:
            props = np.asarray(proposals_per_frame[fi], np.float32)
        qp_new, rp_new = empty_track_queries(det, proposals=props)
        if qp_new.shape[1] != fresh:
            raise ValueError(f"frame {fi}: {qp_new.shape[1]} fresh queries, "
                             f"expected {num_queries} + {num_proposals}")
        qp = np.concatenate([qp_new[0], t_qp], 0)
        rp = np.concatenate([rp_new[0], t_ref], 0)
        valid = np.concatenate([np.ones(fresh, bool), t_valid])
        # torch's convention: True = BLOCKED; the padded columns blocked
        attn_mask = np.broadcast_to(~valid[None, :], (total, total)).copy()
        np.fill_diagonal(attn_mask, False)
        qp_t = torch.from_numpy(qp)[None].to(dev)
        out = det(frame_tensor(frame, dev, dtype), qp_t,
                  torch.from_numpy(rp)[None].to(dev),
                  torch.from_numpy(attn_mask).to(dev))
        logits = out["logits"][-1][0, :, 0].float().cpu().numpy()
        boxes = out["boxes"][-1][0].float().cpu().numpy()
        with np.errstate(over="ignore"):
            scores = 1.0 / (1.0 + np.exp(-logits))

        # RuntimeTrackerBase.update over the valid slots
        obj = np.concatenate([np.full(fresh, -1, np.int64), t_obj])
        disappear = np.concatenate([np.zeros(fresh, np.int64), t_disappear])
        disappear[scores >= score_thresh] = 0
        new_obj = valid & (obj == -1) & (scores >= score_thresh)
        obj[new_obj] = next_id + np.arange(new_obj.sum())
        next_id += int(new_obj.sum())
        gone = valid & (obj >= 0) & (scores < filter_score_thresh)
        disappear[gone] += 1
        obj[gone & (disappear >= miss_tolerance)] = -1

        active = valid & (obj >= 0)
        # written tracks also pass the per-frame score filter
        # (submit_dance.py:146); coasting tracks below it are carried, not
        # written; the area filter is the caller's, in pixels
        emit_thr = score_thresh if prob_threshold is None else prob_threshold
        emit = active & (scores > emit_thr)
        results.append({"ids": obj[emit].copy(),
                        "boxes": _cxcywh_to_xyxy(boxes[emit]),
                        "scores": scores[emit].copy()})

        # QIMv2 on the active set, positives anchored on their boxes
        refs_q = np.where((scores > 0.5)[:, None], boxes, rp).astype(
            np.float32)
        new_feat = qim(out["hidden"][-1], qp_t,
                       torch.from_numpy(refs_q)[None].to(dev),
                       torch.from_numpy(scores)[None].to(dev),
                       torch.from_numpy(active)[None].to(dev))
        new_feat = new_feat[0].cpu().numpy()

        # repack the actives into the carried slots
        idx = np.nonzero(active)[0][:cap]
        k = len(idx)
        t_valid = np.zeros(cap, bool)
        t_valid[:k] = True
        t_obj = np.full(cap, -1, np.int64)
        t_obj[:k] = obj[idx]
        t_disappear = np.zeros(cap, np.int64)
        t_disappear[:k] = disappear[idx]
        t_qp = np.zeros((cap, dim), np.float32)
        t_qp[:k] = new_feat[idx]
        t_ref = np.full((cap, 4), 0.5, np.float32)
        t_ref[:k] = refs_q[idx]
    return results
