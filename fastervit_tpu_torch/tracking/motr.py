"""MOTR-style tracking head: the PyTorch port of fastervit_tpu/tracking/
motr.py: `pos2posemb` (:32-44), `QueryInteractionModule` (:47-64),
`MOTRDetector` (:67-145), `MOTRTrackState` (:148-158) and
`motr_inference_sequence` (:161-237) for serving; `motr_clip_forward`
(:240-271), the clip-consistent matching (`clip_assignments`, from
:326-356), the clip loss and train step (:274-305), `motr_clip_train_epoch`
(:308-363) and `clip_matcher_loss` (:366-407) for training. Reference
downstream/object_tracking/motrv2/models/motr.py and qim.py.

`MOTRDetector` is the JAX package's own design, not upstream's: the port's
DINO `DeformableTransformer` (two-stage selection of `num_detect_queries`
queries) with the carried track queries, and MOTRv2's proposal queries,
in front of the selected ones, then a QIM over the last decoder layer's
normed hidden states. Its module names are the port's: `backbone.0.*`,
`input_proj.{i}.{0,1}`, `transformer.*` (DINO's), `yolox_embed` and
`qim.*`; `tracking/convert.py::motr_detector_state_dict_from_jax` maps the
JAX variables onto them.

Built for a fixed canvas (the backbone config's resolution), as the
port's DINO detector is; input (B, 3, H, W) at that canvas. The streaming
loop keeps its per-frame state on the host in numpy, as the JAX loop does.

Clip training runs the detector in eval mode with gradients on, as the
JAX step's `training=False`: BatchNorm on its running statistics, which
an epoch leaves as they were. A step is two passes over the clip: a
forward with no gradient whose outputs the host matches to the targets,
an identity keeping its first slot for the rest of the clip; then the
forward again with gradients, each frame under a non-reentrant
checkpoint (JAX's `jax.checkpoint`), the loss on the assignments fixed,
backward and one AdamW update. The QIM-refreshed track embeddings carry
their gradient from frame to frame; only the propagated boxes are
detached.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.utils.checkpoint

from fastervit_tpu_torch.detection.dino import sigmoid_focal_loss
from fastervit_tpu_torch.detection.engine import (DetectionTrainState,
                                                  create_detection_optimizer,
                                                  detection_loss, pad_targets)
from fastervit_tpu_torch.detection.transformer import (DeformableTransformer,
                                                       KeepF32, forward_ffn,
                                                       same_bits_with_grad)
from fastervit_tpu_torch.models.config import FasterViTConfig
from fastervit_tpu_torch.models.fastervit import FasterViTPyramid, level_shapes
from fastervit_tpu_torch.ops.boxes import (box_cxcywh_to_xyxy,
                                           generalized_box_iou,
                                           hungarian_cost_matrix,
                                           hungarian_match)
from fastervit_tpu_torch.train.steps import _autocast


def pos2posemb(pos: torch.Tensor, num_pos_feats: int = 64,
               temperature: float = 10000.0) -> torch.Tensor:
    """Scalar sine embedding (reference qim.py:184-191 /
    deformable_transformer_plus.py:392-399): (...,) -> (..., num_pos_feats)
    as [sin f0, cos f1, sin f2, ...]. As in the JAX function, pos·2π is
    taken in pos's dtype (2π rounded to it, as JAX casts a Python scalar),
    the rest in f32."""
    dim_t = torch.as_tensor(
        temperature ** (2 * (np.arange(num_pos_feats) // 2) / num_pos_feats),
        dtype=torch.float32, device=pos.device)
    scale = torch.tensor(2 * math.pi, dtype=pos.dtype, device=pos.device)
    p = (pos * scale)[..., None] / dim_t
    return torch.stack([torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])],
                       dim=-1).reshape(*pos.shape, num_pos_feats)


def frame_tensor(frame, device: torch.device,
                 dtype: torch.dtype) -> torch.Tensor:
    """One frame as the detectors take it, (1, 3, H, W) on `device` in
    `dtype`: a normalised (H, W, 3) numpy image (what `submit.py` loads) or
    a (3, H, W) tensor."""
    if isinstance(frame, np.ndarray):
        frame = torch.from_numpy(np.ascontiguousarray(
            frame.transpose(2, 0, 1)))
    return frame[None].to(device=device, dtype=dtype)


class QueryInteractionModule(nn.Module):
    """QIMv2 as the JAX MOTRDetector uses it (motr.py:47-64): self-attention
    of the track queries (q = k = track_embed + query_pos, v =
    track_embed), residual LayerNorm, then the FFN (linear1, linear2,
    norm2)."""

    def __init__(self, dim: int = 256, n_heads: int = 8,
                 ffn_dim: int = 1024):
        super().__init__()
        self.self_attn = nn.MultiheadAttention(dim, n_heads, batch_first=True)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, track_embed: torch.Tensor,
                query_pos: torch.Tensor) -> torch.Tensor:
        q = track_embed + query_pos
        with same_bits_with_grad():
            sa = self.self_attn(q, q, track_embed, need_weights=False)[0]
        x = self.norm1(track_embed + sa)
        return forward_ffn(x, self.linear1, self.linear2, self.norm2)


_EMPTY_BOX = (0.5, 0.5, 0.1, 0.1)


class MOTRDetector(KeepF32):
    """Per-frame forward (fastervit_tpu/tracking/motr.py::MOTRDetector):
    the pyramid's four strides -> 1x1 conv + GroupNorm(32, eps 1e-6, flax's)
    each -> the deformable transformer over [track queries ++ proposal
    queries ++ the selected detect queries] -> the last layer's logits and
    boxes, and the QIM-refreshed embeddings of every query. `yolox_embed`
    stays f32 under any cast, as JAX adds it in f32 and casts the sum."""

    _F32_TENSORS = ("yolox_embed",)

    def __init__(self, backbone_cfg: FasterViTConfig, num_classes: int = 1,
                 dim: int = 256, num_detect_queries: int = 60,
                 num_track_queries: int = 60, num_proposal_queries: int = 0,
                 enc_layers: int = 3, dec_layers: int = 3):
        super().__init__()
        self.canvas = tuple(backbone_cfg.resolution)
        self.dim, self.num_classes = dim, num_classes
        self.num_detect_queries = num_detect_queries
        self.num_track_queries = num_track_queries
        self.num_proposal_queries = num_proposal_queries
        self.backbone = nn.ModuleList([FasterViTPyramid(backbone_cfg)])
        self.input_proj = nn.ModuleList(
            nn.Sequential(nn.Conv2d(backbone_cfg.level_dim(i), dim, 1),
                          nn.GroupNorm(32, dim, eps=1e-6))
            for i in range(backbone_cfg.num_levels))
        self.spatial_shapes = level_shapes(*self.canvas,
                                           backbone_cfg.num_levels)
        self.transformer = DeformableTransformer(
            self.spatial_shapes, dim=dim, enc_layers=enc_layers,
            dec_layers=dec_layers, num_queries=num_detect_queries,
            num_classes=num_classes)
        # the shared heads under DINO's top-level names too
        self.bbox_embed = self.transformer.decoder.bbox_embed
        self.class_embed = self.transformer.decoder.class_embed
        self.yolox_embed = (nn.Parameter(torch.zeros(dim))
                            if num_proposal_queries else None)
        self.qim = QueryInteractionModule(dim)

    @property
    def device(self) -> torch.device:
        return self.input_proj[0][0].weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.input_proj[0][0].weight.dtype

    def forward(self, images: torch.Tensor,
                track_embed: Optional[torch.Tensor] = None,
                track_boxes: Optional[torch.Tensor] = None,
                proposals: Optional[torch.Tensor] = None) -> Dict:
        """images (B, 3, H, W); track_embed (B, T, dim); track_boxes (B, T,
        4) cxcywh in [0, 1]; proposals (B, P, 5) (cxcywh normalised +
        score), which become anchor queries (pos2posemb(score) +
        yolox_embed, the box as the anchor). Returns {'logits' (B, N, K),
        'boxes' (B, N, 4), 'query_embed' (B, N, dim), 'aux'} over the N =
        T + P + k queries, track slots first, then proposal slots."""
        if tuple(images.shape[-2:]) != self.canvas:
            raise ValueError(f"input of {tuple(images.shape[-2:])}: the "
                             f"detector was built for {self.canvas}")
        b, dev = images.shape[0], images.device
        feats = self.backbone[0](images)
        src = torch.cat([proj(feats[f"res{i + 2}"]).flatten(2).transpose(1, 2)
                         for i, proj in enumerate(self.input_proj)], 1)
        t = self.num_track_queries
        if track_embed is None:
            track_embed = torch.zeros(b, t, self.dim, dtype=src.dtype,
                                      device=dev)
        if track_boxes is None:
            track_boxes = torch.tensor(_EMPTY_BOX, device=dev).expand(b, t, 4)
        if self.num_proposal_queries:
            if proposals is None:   # zero-score centred padding proposals
                proposals = torch.tensor(_EMPTY_BOX + (0.0,),
                                         device=dev).expand(
                    b, self.num_proposal_queries, 5)
            prop_tgt = (pos2posemb(proposals[..., 4], self.dim)
                        + self.yolox_embed).to(src.dtype)
            track_embed = torch.cat([track_embed.to(src.dtype), prop_tgt], 1)
            track_boxes = torch.cat([track_boxes.float(),
                                     proposals[..., :4].float()], 1)
        out = self.transformer(src, track_tgt=track_embed,
                               track_boxes=track_boxes)
        hidden = out["hidden"][-1]
        refreshed = self.qim(hidden, torch.zeros_like(hidden))
        return {"logits": out["logits"][-1], "boxes": out["boxes"][-1],
                "query_embed": refreshed, "aux": out}


@torch.no_grad()
def init_weights(det: MOTRDetector, generator: torch.Generator) -> None:
    """Random init drawn on the CPU from `generator`: DINO's
    (`detection.dino.init_weights`: the backbone, the projections, the
    transformer and the QIM), then yolox_embed N(0, 1), as the JAX module
    draws it."""
    from fastervit_tpu_torch.detection import dino
    dino.init_weights(det, generator)
    if det.yolox_embed is not None:
        det.yolox_embed.copy_(torch.randn(det.yolox_embed.shape,
                                          generator=generator))


def build_motr_detector(resolution=(800, 1536),
                        backbone: str = "faster_vit_0_any_res",
                        dtype: torch.dtype = torch.float32,
                        device: Any = "cuda",
                        generator: Optional[torch.Generator] = None,
                        checkpoint: Optional[str] = None,
                        **kw) -> MOTRDetector:
    """MOTRDetector for a canvas of `resolution` (H, W) on `device` (the
    card unless the caller asks for "cpu"): its weights drawn from
    `generator` (seed 0 if None; `init_weights`), or, given `checkpoint`,
    read from the port's own file (a `torch.save` of its state_dict,
    possibly under 'model'; strict); cast to `dtype`, in eval mode. `kw`
    goes to MOTRDetector."""
    from fastervit_tpu_torch.models.registry import get_config
    from fastervit_tpu_torch.utils.convert import normalize_state_dict
    cfg = get_config(backbone, resolution=tuple(resolution))
    with torch.device(device):
        det = MOTRDetector(cfg, **kw)
    if checkpoint:
        det.load_state_dict(normalize_state_dict(torch.load(
            checkpoint, map_location="cpu", weights_only=True)), strict=True)
    else:
        init_weights(det, generator if generator is not None
                     else torch.Generator().manual_seed(0))
    return det.to(dtype).eval()


@dataclasses.dataclass
class MOTRTrackState:
    """Per-sequence streaming state (host side), slot-indexed over the
    track slots: identities, scores, misses, the query embeddings fed to
    the next frame and the reference boxes (cxcywh)."""
    ids: np.ndarray            # (T,) persistent identity or -1 if free
    scores: np.ndarray         # (T,)
    misses: np.ndarray         # (T,)
    embeds: np.ndarray         # (T, dim)
    boxes: np.ndarray          # (T, 4)
    next_id: int = 0


def _cxcywh_to_xyxy(b: np.ndarray) -> np.ndarray:
    cx, cy, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w,
                     cy + 0.5 * h], -1)


@torch.no_grad()
def motr_inference_sequence(det: MOTRDetector, frames: Iterable,
                            num_track_slots: int, dim: int,
                            score_thresh: float = 0.7,
                            filter_thresh: float = 0.6,
                            miss_tolerance: int = 5,
                            proposals_per_frame=None) -> List[Dict]:
    """Streaming inference (fastervit_tpu/tracking/motr.py::
    motr_inference_sequence; reference submit_dance.py Detector.detect):
    per frame, the detector on the carried track queries, then tracks
    updated, killed after miss_tolerance misses and born from the other
    slots in order into free track slots, by the score thresholds; the
    QIM-refreshed embeddings and predicted boxes carried to the next frame.
    frames: normalised (H, W, 3) numpy images or (3, H, W) tensors;
    proposals_per_frame: optional per-frame (P, 5) arrays. Returns per
    frame {'ids', 'boxes' (xyxy, normalised), 'scores'} of the tracks seen
    in that frame."""
    t = num_track_slots
    dev, dtype = det.device, det.dtype
    state = MOTRTrackState(
        ids=np.full(t, -1), scores=np.zeros(t), misses=np.zeros(t, int),
        embeds=np.zeros((t, dim), np.float32),
        boxes=np.tile(np.asarray(_EMPTY_BOX, np.float32), (t, 1)))
    results = []
    for fi, frame in enumerate(frames):
        props = None
        if proposals_per_frame is not None:
            props = torch.from_numpy(np.asarray(
                proposals_per_frame[fi], np.float32))[None].to(dev)
        out = det(frame_tensor(frame, dev, dtype),
                  torch.from_numpy(state.embeds)[None].to(dev),
                  torch.from_numpy(state.boxes)[None].to(dev), props)
        scores = torch.sigmoid(out["logits"][0]).max(-1).values.float()
        scores = scores.cpu().numpy()
        boxes = out["boxes"][0].float().cpu().numpy()
        embeds = out["query_embed"][0].float().cpu().numpy()

        for qi in range(t):                    # existing tracks
            if state.ids[qi] < 0:
                continue
            if scores[qi] >= filter_thresh:
                state.misses[qi] = 0
                state.scores[qi] = scores[qi]
                state.embeds[qi] = embeds[qi]
                state.boxes[qi] = boxes[qi]
            else:
                state.misses[qi] += 1
                if state.misses[qi] >= miss_tolerance:
                    state.ids[qi] = -1
                    state.embeds[qi] = 0.0
                    state.boxes[qi] = _EMPTY_BOX
        for qi in range(t, len(scores)):       # births into free slots
            if scores[qi] < score_thresh:
                continue
            free = np.where(state.ids < 0)[0]
            if not len(free):
                break
            slot = free[0]
            state.ids[slot] = state.next_id
            state.next_id += 1
            state.misses[slot] = 0
            state.scores[slot] = scores[qi]
            state.embeds[slot] = embeds[qi]
            state.boxes[slot] = boxes[qi]
        active = (state.ids >= 0) & (state.misses == 0)
        results.append({"ids": state.ids[active].copy(),
                        "boxes": _cxcywh_to_xyxy(state.boxes[active]),
                        "scores": state.scores[active].copy()})
    return results


# ------------------------------- training ---------------------------------

def motr_clip_forward(det: MOTRDetector, frames: torch.Tensor,
                      proposals: Optional[torch.Tensor] = None,
                      propagate_boxes: bool = True) -> List[Dict]:
    """Differentiable clip forward (fastervit_tpu/tracking/motr.py::
    motr_clip_forward; reference motr.py:646-700): the detector in eval
    mode on each frame with the QIM-refreshed embeddings of the previous
    frame's track slots as its track queries, their gradient carried, and
    its predicted track boxes, detached, as their anchors (the first
    frame's: zero embeddings at centred boxes). With gradients on, each
    frame runs under a non-reentrant checkpoint and is recomputed in the
    backward. frames (F, B, 3, H, W); proposals optional (F, B, P, 5).
    Returns each frame's output dict."""
    det.eval()
    b, dev = frames.shape[1], frames.device
    t = det.num_track_queries
    embed = torch.zeros(b, t, det.dim, device=dev)
    boxes = torch.tensor(_EMPTY_BOX, device=dev).expand(b, t, 4)
    outputs = []
    for f in range(frames.shape[0]):
        props = None if proposals is None else proposals[f]
        if torch.is_grad_enabled():
            out = torch.utils.checkpoint.checkpoint(
                det, frames[f], embed, boxes, props, use_reentrant=False)
        else:
            out = det(frames[f], embed, boxes, props)
        outputs.append(out)
        embed = out["query_embed"][:, :t]
        if propagate_boxes:
            boxes = out["boxes"][:, :t].detach()
    return outputs


def _match_new(assigned: Dict[int, int], ids: Sequence[int], labels,
               tgt_boxes, logits: torch.Tensor, boxes: torch.Tensor) -> None:
    """ClipMatcher's rule for one frame of one image (JAX motr.py:341-353,
    :381-391): the identities not in `assigned` are matched by the
    Hungarian cost among the slots that the frame's assigned identities do
    not hold, every slot of the frame a candidate; `assigned` (identity ->
    slot) gains them. logits (Q, K) and boxes (Q, 4) on the CPU, in f32."""
    new = [k for k, i in enumerate(ids) if i not in assigned]
    if not new:
        return
    free = np.setdiff1d(np.arange(logits.shape[0]),
                        [assigned[i] for i in ids if i in assigned])
    rows = torch.from_numpy(free)
    cost = hungarian_cost_matrix(
        logits[rows], boxes[rows],
        torch.as_tensor(np.asarray(labels)[new]),
        torch.as_tensor(np.asarray(tgt_boxes, np.float32)[new]))
    r, c = hungarian_match(cost.numpy())
    for ri, ci in zip(r, c):
        assigned[ids[new[ci]]] = int(free[ri])


def clip_assignments(outputs: Sequence[Dict], targets_per_frame,
                     max_targets: int) -> np.ndarray:
    """The clip-consistent matching of motr_clip_train_epoch (JAX
    motr.py:326-356): per image, an identity keeps the slot it first
    matched for the rest of the clip; each frame's new identities are
    matched among the other slots (`_match_new`). Every identity is
    matched, the first max_targets of each frame written. outputs: the
    clip's output dicts ('logits' (B, Q, K), 'boxes' (B, Q, 4));
    targets_per_frame[f][b]: {'labels', 'boxes', 'track_ids'}. Returns (F,
    B, max_targets) int32, -1 past a frame's identities."""
    logits = [o["logits"].detach().float().cpu() for o in outputs]
    boxes = [o["boxes"].detach().float().cpu() for o in outputs]
    f, b = len(outputs), logits[0].shape[0]
    out = np.full((f, b, max_targets), -1, np.int32)
    for bi in range(b):
        assigned: Dict[int, int] = {}
        for fi in range(f):
            tf = targets_per_frame[fi][bi]
            ids = [int(i) for i in tf["track_ids"]]
            _match_new(assigned, ids, tf["labels"], tf["boxes"],
                       logits[fi][bi], boxes[fi][bi])
            for k, i in enumerate(ids[:max_targets]):
                out[fi, bi, k] = assigned[i]
    return out


def clip_targets(targets_per_frame, max_targets: int,
                 device) -> Dict[str, torch.Tensor]:
    """Each frame's targets through pad_targets, stacked: labels (F, B, T),
    boxes (F, B, T, 4), mask (F, B, T), on `device`."""
    padded = [pad_targets(tf, max_targets) for tf in targets_per_frame]
    return {k: torch.from_numpy(np.stack([p[k] for p in padded])).to(device)
            for k in ("labels", "boxes", "mask")}


def motr_clip_loss(outputs: Sequence[Dict], tgt: Dict[str, torch.Tensor],
                   assignment: torch.Tensor,
                   num_classes: int = 1) -> torch.Tensor:
    """The clip loss of make_motr_clip_train_step (JAX motr.py:279-291):
    each frame's set criterion (`detection_loss`, focal + 5 L1 + 2 GIoU) on
    its last layer's logits and boxes in f32, given the frame's assignment
    (B, T) as a one-layer stack; summed over the frames, over F. tgt:
    `clip_targets`' tensors; assignment (F, B, T)."""
    total = 0.0
    for f, out in enumerate(outputs):
        loss, _ = detection_loss(
            {"logits": [out["logits"].float()],
             "boxes": [out["boxes"].float()]},
            {k: v[f] for k, v in tgt.items()}, assignment[f][None],
            num_classes)
        total = total + loss
    return total / len(outputs)


def create_motr_optimizer(det: nn.Module, lr: float = 2e-4,
                          weight_decay: float = 1e-4,
                          clip_max_norm: float = 0.1):
    """The JAX CLI's optax.chain(clip_by_global_norm(clip_max_norm),
    adamw(lr, weight_decay)) over every parameter (tracking/main.py:
    135-136): `create_detection_optimizer` with every group at lr and no
    drop step. A parameter the loss does not reach (the two-stage
    selection's encoder heads) gets a zero gradient and decays."""
    return create_detection_optimizer(
        det, lr=lr, lr_backbone=lr, weight_decay=weight_decay,
        clip_norm=clip_max_norm, lr_linear_proj_mult=1.0, drop_step=None)


def make_motr_clip_train_step(dtype: torch.dtype = torch.float32,
                              max_targets: int = 10):
    """train_step(state, frames, targets_per_frame, proposals=None,
    assignment=None) -> metrics, which updates `state` (a
    `DetectionTrainState` of the detector and `create_motr_optimizer`) in
    place (JAX motr.py::make_motr_clip_train_step with the epoch's
    matching pass). Without `assignment`, a clip forward with no gradient
    and `clip_assignments` on the host first; then the clip forward with
    gradients, `motr_clip_loss` on the assignments, backward and one
    update; the targets padded to the assignment's width (max_targets for
    the step's own). The detector stays in eval mode; under a bf16 `dtype` its
    forwards run under autocast over f32 weights, the loss in f32. frames
    (F, B, 3, H, W) and proposals (F, B, P, 5) on the model's device.
    metrics: 'loss' and 'grad_norm' (device scalars), the 'assignment'
    used, each frame's last-layer 'logits' of the gradient pass and, where
    it ran, of the matching pass ('match_logits')."""
    def train_step(state: DetectionTrainState, frames: torch.Tensor,
                   targets_per_frame, proposals: Optional[torch.Tensor] = None,
                   assignment=None) -> Dict:
        model = state.model.eval()
        device = frames.device
        match_logits = None
        if assignment is None:
            with torch.no_grad(), _autocast(device, dtype):
                outs = motr_clip_forward(model, frames, proposals)
            assignment = clip_assignments(outs, targets_per_frame,
                                          max_targets)
            match_logits = [o["logits"] for o in outs]
            del outs
        tgt = clip_targets(targets_per_frame, np.shape(assignment)[-1],
                           device)
        state.optimizer.zero_grad()
        with _autocast(device, dtype):
            outs = motr_clip_forward(model, frames, proposals)
        loss = motr_clip_loss(outs, tgt,
                              torch.as_tensor(assignment).to(device),
                              model.num_classes)
        loss.backward()
        grad_norm = state.optimizer.step(state.step)
        state.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm,
                "assignment": assignment,
                "logits": [o["logits"].detach() for o in outs],
                "match_logits": match_logits}
    return train_step


def motr_clip_train_epoch(state: DetectionTrainState, clips: Iterable,
                          max_targets: int = 10) -> Dict[str, float]:
    """One epoch over clips (JAX motr.py::motr_clip_train_epoch): each
    (frames (F, B, 3, H, W), targets_per_frame[f][b] with 'track_ids'[,
    proposals (F, B, P, 5) or None]), numpy or tensors, goes to the
    model's device for one f32 `make_motr_clip_train_step` step. BatchNorm's
    statistics are left as they were. Returns {'loss': the epoch's mean}."""
    device = next(state.model.parameters()).device
    step = make_motr_clip_train_step(max_targets=max_targets)
    losses = []
    for clip in clips:
        frames = torch.as_tensor(np.ascontiguousarray(clip[0])).to(device)
        props = clip[2] if len(clip) > 2 else None
        if props is not None:
            props = torch.as_tensor(np.ascontiguousarray(props)).to(device)
        losses.append(step(state, frames, clip[1], props)["loss"])
    return {"loss": float(np.mean([v.item() for v in losses])) if losses
            else float("nan")}


def clip_matcher_loss(per_frame_outputs: Sequence[Dict],
                      per_frame_targets: Sequence[Dict],
                      num_classes: int = 1) -> Dict[str, torch.Tensor]:
    """ClipMatcher (JAX motr.py::clip_matcher_loss; reference motr.py:36)
    on one image's clip: each frame's identities matched as
    `clip_assignments` matches them, then the focal loss over every slot
    and the L1 and GIoU losses of the matched boxes, each over the clip's
    number of targets (at least 1); 'loss' = ce + 5 bbox + 2 giou.
    per_frame_outputs[f]: {'logits' (1, Q, K), 'boxes' (1, Q, 4)};
    per_frame_targets[f]: {'labels', 'boxes', 'track_ids'}."""
    assigned: Dict[int, int] = {}
    total = {"loss_ce": 0.0, "loss_bbox": 0.0, "loss_giou": 0.0}
    num_boxes = max(1, sum(len(t["labels"]) for t in per_frame_targets))
    for out, tgt in zip(per_frame_outputs, per_frame_targets):
        logits, boxes = out["logits"][0], out["boxes"][0]
        ids = [int(i) for i in tgt["track_ids"]]
        _match_new(assigned, ids, tgt["labels"], tgt["boxes"],
                   logits.detach().float().cpu(),
                   boxes.detach().float().cpu())
        onehot = torch.zeros_like(logits)
        if ids:
            rows = torch.tensor([assigned[i] for i in ids],
                                device=logits.device)
            labels = torch.as_tensor(np.asarray(tgt["labels"])).long()
            onehot[rows] = nn.functional.one_hot(
                labels.to(logits.device), num_classes).to(onehot)
            pb = boxes[rows]
            tb = torch.as_tensor(np.asarray(tgt["boxes"], np.float32)).to(pb)
            total["loss_bbox"] = (total["loss_bbox"]
                                  + (pb - tb).abs().sum() / num_boxes)
            giou = generalized_box_iou(box_cxcywh_to_xyxy(pb),
                                       box_cxcywh_to_xyxy(tb))
            total["loss_giou"] = (total["loss_giou"]
                                  + (1 - torch.diag(giou)).sum() / num_boxes)
        total["loss_ce"] = (total["loss_ce"]
                            + sigmoid_focal_loss(logits, onehot).sum()
                            / num_boxes)
    total["loss"] = (total["loss_ce"] + 5.0 * total["loss_bbox"]
                     + 2.0 * total["loss_giou"])
    return total
