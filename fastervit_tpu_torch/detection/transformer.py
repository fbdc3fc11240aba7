"""Deformable-DETR transformer with DINO's two-stage query selection and
iterative box refinement: the PyTorch port of
fastervit_tpu/detection/transformer.py (reference downstream/
object_detection/dino/models/dino/deformable_transformer.py: encoder :446,
decoder :596, two-stage selection :327-431).

Numerics follow the JAX package (and through it the reference):
- sine embeddings use the (y, x, w, h) 128-feature interleaved sin/cos
  layout of gen_sineembed_for_position;
- the encoder's position embedding is PositionEmbeddingSineHW with
  temperature 20, plus the level embedding;
- two-stage proposals are inverse-sigmoid grid anchors with wh =
  0.05·2^level, +inf outside (0.01, 0.99), scored through enc_output +
  LayerNorm and the enc_out_{class,bbox}_embed heads;
- the decoder refines boxes from the *unnormed* layer output, while the
  reported per-layer boxes and logits come from the shared-LayerNorm hidden
  state.

Module names are upstream's, so that an upstream DINO state_dict loads as
it is: `encoder.layers.{i}` (self_attn, norm1, linear1, linear2, norm2),
`decoder.layers.{i}` (self_attn, an nn.MultiheadAttention, norm2,
cross_attn, norm1, linear1, linear2, norm3), `decoder.ref_point_head`,
`decoder.norm`, the shared heads `decoder.bbox_embed.{i}` and
`decoder.class_embed.{i}` (one module, listed once per layer),
`enc_output`, `enc_output_norm`, `enc_out_class_embed`,
`enc_out_bbox_embed`, `tgt_embed`, `level_embed`.

The port fixes the levels' spatial shapes when it is built (the detector's
canvas), so the constant tables (position embedding, reference points,
proposals) are non-persistent buffers made once on the build device.

Dtypes follow the JAX package's bf16 detector output by output: the three
tables and `level_embed` stay f32 whatever dtype the module is cast to
(`DeformableTransformer._apply`), so the sampling locations, `enc_unsig`,
the reference boxes and every reported box (`enc_boxes`, `interm_boxes`,
`init_proposals`, `boxes`) are f32 beside bf16 activations and logits;
the position embedding is summed in f32 and cast once.

With `use_checkpoint`, each encoder and decoder layer runs under
torch.utils.checkpoint (non-reentrant) while gradients are on, and its
activations are recomputed in the backward, as the JAX transformer wraps
its layers in nn.remat (transformer.py:406-407, 518-519).

Padding masks (COCO's mixed-size batches on one canvas): `encode` takes
the flattened mask (B, S), True at padded tokens, and then computes its
tables per batch from the mask, in f32 (`valid_ratios_from_mask`,
`encoder_reference_points_masked`, `position_embedding_sine_hw_masked`,
`output_proposals_masked`), zeroes the padded value rows of every MSDA
call, and `decode` scales the reference boxes by the valid ratios. With no
mask every path keeps the constant tables.

Contrastive denoising: `decode` takes dn_labels (B, N_dn), embedded by
`label_enc`, and dn_boxes (B, N_dn, 4) in front of the matching queries,
and the decoder self-attention's allow-mask dn_attn_mask (Q, Q);
`detection/dino.py::prepare_cdn` makes the three.

MOTR's track queries: `decode` takes track_tgt (B, T, C) and track_boxes
(B, T, 4) and puts them in front of the selected queries (and behind any
dn queries), as the JAX transformer does (transformer.py:463-468);
`tracking/motr.py::MOTRDetector` feeds them.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from fastervit_tpu_torch.ops.msda import MSDeformAttnModule, normalize_shapes


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """util/misc.py inverse_sigmoid: clamp to [eps, 1], then the logit."""
    x = x.clamp(0, 1)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def _interleaved_sincos(coord: torch.Tensor, num_feats: int,
                        temperature: float) -> torch.Tensor:
    """(...,) coordinates -> (..., num_feats) as [sin f0, cos f0, sin f1,
    ...] (utils.py:161, position_encoding.py:57-58)."""
    i = torch.arange(num_feats, dtype=torch.float64, device=coord.device)
    dim_t = (temperature ** (2 * (i // 2) / num_feats)).float()
    p = coord[..., None].float() / dim_t
    return torch.stack([torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])],
                       dim=-1).reshape(*coord.shape, num_feats)


def gen_sineembed(pos: torch.Tensor, num_feats: int = 128) -> torch.Tensor:
    """gen_sineembed_for_position (utils.py:151-177): (..., 2 or 4)
    normalised coordinates -> (..., 2 or 4 · num_feats), ordered
    (y, x[, w, h]); computed in f32, returned in pos's dtype."""
    scale = 2 * math.pi
    order = [1, 0] + ([2, 3] if pos.shape[-1] == 4 else [])
    return torch.cat([_interleaved_sincos(pos[..., i] * scale, num_feats,
                                          10000.0) for i in order],
                     dim=-1).to(pos.dtype)


def position_embedding_sine_hw(spatial_shapes: Sequence[Tuple[int, int]],
                               num_pos_feats: int = 128,
                               temperature_h: float = 20.0,
                               temperature_w: float = 20.0) -> np.ndarray:
    """PositionEmbeddingSineHW (position_encoding.py:64-135) of unpadded
    levels, flattened over all of them: (S, 2·num_pos_feats) float32, the
    y block then the x block, each interleaved sin/cos."""
    eps = 1e-6
    scale = 2 * math.pi
    dim_ty = temperature_h ** (2 * (np.arange(num_pos_feats) // 2)
                               / num_pos_feats)
    dim_tx = temperature_w ** (2 * (np.arange(num_pos_feats) // 2)
                               / num_pos_feats)
    out = []
    for h, w in spatial_shapes:
        y = (np.arange(h, dtype=np.float32) + 1.0) / (h + eps) * scale
        x = (np.arange(w, dtype=np.float32) + 1.0) / (w + eps) * scale
        py, px = y[:, None] / dim_ty, x[:, None] / dim_tx
        py = np.stack([np.sin(py[:, 0::2]), np.cos(py[:, 1::2])],
                      -1).reshape(h, num_pos_feats)
        px = np.stack([np.sin(px[:, 0::2]), np.cos(px[:, 1::2])],
                      -1).reshape(w, num_pos_feats)
        lvl = np.concatenate([np.repeat(py[:, None], w, 1),
                              np.repeat(px[None], h, 0)], -1)
        out.append(lvl.reshape(h * w, 2 * num_pos_feats))
    return np.concatenate(out, 0).astype(np.float32)


def encoder_reference_points(spatial_shapes: Sequence[Tuple[int, int]]
                             ) -> np.ndarray:
    """Each level's pixel centres, normalised: (S, L, 2) float32
    (get_reference_points with valid ratios of 1,
    deformable_transformer.py:489-503)."""
    pts = []
    for h, w in spatial_shapes:
        y, x = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5,
                           indexing="ij")
        pts.append(np.stack([x.ravel() / w, y.ravel() / h], -1))
    ref = np.concatenate(pts, 0)
    return np.tile(ref[:, None, :], (1, len(spatial_shapes), 1)).astype(
        np.float32)


def output_proposals(spatial_shapes: Sequence[Tuple[int, int]]
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """gen_encoder_output_proposals' anchors (utils.py:34-65), unpadded:
    (proposal logits (S, 4) float32, +inf on invalid rows; valid (S,)
    bool)."""
    props = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        gy, gx = np.meshgrid(np.arange(h, dtype=np.float32),
                             np.arange(w, dtype=np.float32), indexing="ij")
        grid = np.stack([(gx.ravel() + 0.5) / w, (gy.ravel() + 0.5) / h], -1)
        wh = np.full((h * w, 2), 0.05 * (2.0 ** lvl), np.float32)
        props.append(np.concatenate([grid, wh], -1))
    p = np.concatenate(props, 0)
    valid = ((p > 0.01) & (p < 0.99)).all(-1)
    with np.errstate(divide="ignore"):
        logit = np.log(p / (1 - p))
    logit[~valid] = np.inf
    return logit.astype(np.float32), valid


def _level_masks(padding_mask: torch.Tensor,
                 spatial_shapes: Sequence[Tuple[int, int]]
                 ) -> List[torch.Tensor]:
    """(B, S) flattened mask -> each level's (B, h, w) mask (True =
    padded)."""
    b = padding_mask.shape[0]
    out, start = [], 0
    for h, w in spatial_shapes:
        out.append(padding_mask[:, start:start + h * w].reshape(b, h, w))
        start += h * w
    return out


def valid_ratios_from_mask(padding_mask: torch.Tensor,
                           spatial_shapes: Sequence[Tuple[int, int]]
                           ) -> torch.Tensor:
    """get_valid_ratio of each level (deformable_transformer.py:252-259):
    (B, S) mask -> (B, L, 2) f32 as (valid width / w, valid height / h),
    counted along the first column and the first row."""
    out = []
    for m in _level_masks(padding_mask, spatial_shapes):
        not_m = ~m
        h, w = m.shape[1], m.shape[2]
        valid_h = not_m[:, :, 0].float().sum(1)
        valid_w = not_m[:, 0, :].float().sum(1)
        out.append(torch.stack([valid_w / w, valid_h / h], -1))
    return torch.stack(out, 1)


def _pixel_centres(h: int, w: int, device) -> torch.Tensor:
    """(h·w, 2) f32 (x + 0.5, y + 0.5) of a level's pixels, row-major."""
    y, x = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device) + 0.5,
        torch.arange(w, dtype=torch.float32, device=device) + 0.5,
        indexing="ij")
    return torch.stack([x.reshape(-1), y.reshape(-1)], -1)


def _level_scale(valid_ratios: torch.Tensor, lvl: int, h: int,
                 w: int) -> torch.Tensor:
    """(B, 1, 2) valid extent of level lvl in pixels, (w·ratio_w,
    h·ratio_h)."""
    return valid_ratios[:, None, lvl] * torch.tensor(
        [w, h], dtype=torch.float32, device=valid_ratios.device)


def encoder_reference_points_masked(spatial_shapes: Sequence[Tuple[int,
                                                                   int]],
                                    valid_ratios: torch.Tensor
                                    ) -> torch.Tensor:
    """get_reference_points with the true valid ratios
    (deformable_transformer.py:489-503): each level's pixel centres over
    its valid extent, then scaled by every level's ratios: (B, S, L, 2)
    f32."""
    pts = [_pixel_centres(h, w, valid_ratios.device)[None]
           / _level_scale(valid_ratios, lvl, h, w)
           for lvl, (h, w) in enumerate(spatial_shapes)]
    ref = torch.cat(pts, 1)                             # (B, S, 2)
    return ref[:, :, None, :] * valid_ratios[:, None]


def position_embedding_sine_hw_masked(padding_mask: torch.Tensor,
                                      spatial_shapes: Sequence[Tuple[int,
                                                                     int]],
                                      num_pos_feats: int = 128,
                                      temperature_h: float = 20.0,
                                      temperature_w: float = 20.0
                                      ) -> torch.Tensor:
    """PositionEmbeddingSineHW from the padding mask (position_encoding.py:
    81-135): each pixel's row and column counted over the valid pixels
    (cumsum), normalised by the valid extent: (B, S) -> (B, S,
    2·num_pos_feats) f32, the y block then the x block."""
    eps = 1e-6
    scale = 2 * math.pi
    out = []
    for m in _level_masks(padding_mask, spatial_shapes):
        nm = (~m).float()
        b, h, w = nm.shape
        y = nm.cumsum(1)
        x = nm.cumsum(2)
        y = y / (y[:, -1:, :] + eps) * scale
        x = x / (x[:, :, -1:] + eps) * scale
        out.append(torch.cat([
            _interleaved_sincos(y, num_pos_feats, temperature_h),
            _interleaved_sincos(x, num_pos_feats, temperature_w)],
            -1).reshape(b, h * w, 2 * num_pos_feats))
    return torch.cat(out, 1)


def output_proposals_masked(padding_mask: torch.Tensor,
                            spatial_shapes: Sequence[Tuple[int, int]],
                            valid_ratios: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """gen_encoder_output_proposals with a padding mask (utils.py:34-76):
    the grid centres over each image's valid extent, wh = 0.05·2^level.
    Returns (proposal logits (B, S, 4) f32, +inf at padded and
    out-of-range rows; valid (B, S) bool)."""
    b = padding_mask.shape[0]
    props = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        grid = (_pixel_centres(h, w, padding_mask.device)[None]
                / _level_scale(valid_ratios, lvl, h, w))    # (B, hw, 2)
        wh = torch.full((b, h * w, 2), 0.05 * (2.0 ** lvl),
                        dtype=torch.float32, device=padding_mask.device)
        props.append(torch.cat([grid, wh], -1))
    p = torch.cat(props, 1)
    in_range = ((p > 0.01) & (p < 0.99)).all(-1)
    valid = in_range & ~padding_mask
    logit = torch.where(valid[..., None], torch.log(p / (1 - p)),
                        torch.inf)
    return logit, valid


def forward_ffn(x: torch.Tensor, linear1: nn.Linear, linear2: nn.Linear,
                norm: nn.LayerNorm) -> torch.Tensor:
    """The FFN of fastervit_tpu's transformer.py (forward_ffn,
    deformable_transformer.py:831-835 and 909-913): linear1 -> relu ->
    linear2, residual, LayerNorm. Its layers sit in the encoder and decoder
    layers under upstream's names."""
    return norm(x + linear2(F.relu(linear1(x))))


class EncoderLayer(nn.Module):
    """DeformableTransformerEncoderLayer (deformable_transformer.py:
    796-850): MSDA self-attention (position on the query) -> norm1 -> FFN
    (norm2)."""

    def __init__(self, dim: int = 256, n_heads: int = 8, n_points: int = 4,
                 n_levels: int = 4, ffn_dim: int = 2048):
        super().__init__()
        self.self_attn = MSDeformAttnModule(dim, n_levels, n_heads, n_points)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, src: torch.Tensor, pos: torch.Tensor,
                ref_points: torch.Tensor, spatial_shapes: Sequence,
                padding_mask: Optional[torch.Tensor] = None,
                value: Optional[torch.Tensor] = None) -> torch.Tensor:
        """src: (B, S, C); pos: (B or 1, S, C); ref_points: (B, S, L, 2);
        padding_mask: (B, S) bool, True at padded tokens, or None; value:
        the (B, S_value, C) level maps to sample when the queries are a
        subset of them (MOTR's lite encoder), or None to sample src."""
        attn = self.self_attn(src + pos, ref_points,
                              src if value is None else value,
                              spatial_shapes, padding_mask)
        src = self.norm1(src + attn)
        return forward_ffn(src, self.linear1, self.linear2, self.norm2)


class DecoderLayer(nn.Module):
    """DeformableTransformerDecoderLayer (deformable_transformer.py:
    852-1014), module_seq ['sa', 'ca', 'ffn']: self-attention (q = k =
    tgt + query_pos, v = tgt; norm2) -> MSDA cross-attention on
    tgt + query_pos (norm1) -> FFN (norm3). The self-attention is
    nn.MultiheadAttention, upstream's module (in_proj_weight)."""

    def __init__(self, dim: int = 256, n_heads: int = 8, n_points: int = 4,
                 n_levels: int = 4, ffn_dim: int = 2048):
        super().__init__()
        self.self_attn = nn.MultiheadAttention(dim, n_heads, batch_first=True)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.cross_attn = MSDeformAttnModule(dim, n_levels, n_heads,
                                             n_points)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, tgt: torch.Tensor, query_pos: torch.Tensor,
                ref_input: torch.Tensor, memory: torch.Tensor,
                spatial_shapes: Sequence,
                padding_mask: Optional[torch.Tensor] = None,
                self_attn_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """tgt, query_pos: (B, Q, C); ref_input: the per-level reference
        boxes (B, Q, L, 4); memory: (B, S, C); padding_mask: memory's (B,
        S) mask, True at padded tokens, or None; self_attn_mask: (Q, Q)
        bool allow-mask (True: query i may attend to j), as the JAX layer
        takes it, or None."""
        q = tgt + query_pos
        # nn.MultiheadAttention's bool mask marks what is blocked
        sa = self.self_attn(q, q, tgt, need_weights=False,
                            attn_mask=None if self_attn_mask is None
                            else ~self_attn_mask)[0]
        tgt = self.norm2(tgt + sa)
        ca = self.cross_attn(tgt + query_pos, ref_input, memory,
                             spatial_shapes, padding_mask)
        tgt = self.norm1(tgt + ca)
        return forward_ffn(tgt, self.linear1, self.linear2, self.norm3)


class MLPHead(nn.Module):
    """The reference's MLP (dino.py): `layers` Linears with relu between,
    in_dim -> hidden -> ... -> out."""

    def __init__(self, in_dim: int, hidden: int, out: int, layers: int = 3):
        super().__init__()
        dims = [in_dim] + [hidden] * (layers - 1) + [out]
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class TransformerEncoder(nn.Module):
    """The encoder's layers (upstream DeformableTransformerEncoder)."""

    def __init__(self, layers: List[EncoderLayer]):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class TransformerDecoder(nn.Module):
    """The decoder's layers, the reference-point head, the shared final
    LayerNorm and the shared box and class heads (upstream
    TransformerDecoder; the heads are listed once per layer, as upstream
    lists its shared module)."""

    def __init__(self, layers: List[DecoderLayer], dim: int,
                 num_classes: int):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.ref_point_head = MLPHead(2 * dim, dim, dim, layers=2)
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        bbox, cls = MLPHead(dim, dim, 4, layers=3), nn.Linear(dim,
                                                              num_classes)
        self.bbox_embed = nn.ModuleList([bbox] * len(layers))
        self.class_embed = nn.ModuleList([cls] * len(layers))


class KeepF32(nn.Module):
    """A module whose tensors named in `_F32_TENSORS` stay f32 under any
    cast of it (`.to()`, `.cuda()`, `.bfloat16()`, ...): the JAX package
    keeps such tables and parameters in f32 and casts what it computes
    from them."""

    _F32_TENSORS: Tuple[str, ...] = ()

    def _apply(self, fn, recurse=True):
        """Module._apply that moves the _F32_TENSORS (those that are not
        None) to the new device but keeps them in f32: their f32 values
        are kept aside and put back after the cast, so no cast rounds
        them."""
        kept = {name: getattr(self, name).data for name in self._F32_TENSORS
                if getattr(self, name) is not None}
        super()._apply(fn, recurse)
        for name, old in kept.items():
            new = getattr(self, name)
            if new.dtype == torch.float32:
                continue
            value = old.to(device=new.device, dtype=torch.float32)
            if isinstance(new, nn.Parameter):
                new.data = value
            elif name in self._buffers:
                self._buffers[name] = value
            else:
                raise TypeError(f"{name} is neither a parameter nor a "
                                "buffer of this module")
        return self


class DeformableTransformer(KeepF32):
    """Encoder + two-stage query selection + box-refining decoder over the
    flattened multi-scale features of fixed `spatial_shapes`
    (fastervit_tpu/detection/transformer.py::DeformableTransformer, with
    DINO's defaults: shared decoder heads, embed_init_tgt).

    forward = decode(encode(srcs, padding_mask), select(...), dn_*); the
    three steps are methods so that a caller can hold two runs to one
    query selection. With `dn_labelbook_size`, the transformer has the
    denoising label embedding `label_enc` (dn_labelbook_size + 1
    entries), which the dn queries need."""

    # f32 under any cast of the module, as the JAX package keeps its tables
    # (transformer.py:99, 112-113, 204) and its level_embed parameter
    _F32_TENSORS = ("pos_sine", "ref_points", "proposals", "level_embed")

    def __init__(self, spatial_shapes: Sequence[Tuple[int, int]],
                 dim: int = 256, n_heads: int = 8, n_points: int = 4,
                 enc_layers: int = 6, dec_layers: int = 6,
                 ffn_dim: int = 2048, num_queries: int = 900,
                 num_classes: int = 91, use_checkpoint: bool = False,
                 dn_labelbook_size: Optional[int] = None):
        super().__init__()
        shapes = normalize_shapes(spatial_shapes)
        self.spatial_shapes, self.dim = shapes, dim
        self.num_queries = num_queries
        self.use_checkpoint = use_checkpoint
        n_levels = len(shapes)
        self.level_embed = nn.Parameter(torch.empty(n_levels, dim))
        self.encoder = TransformerEncoder(
            [EncoderLayer(dim, n_heads, n_points, n_levels, ffn_dim)
             for _ in range(enc_layers)])
        self.decoder = TransformerDecoder(
            [DecoderLayer(dim, n_heads, n_points, n_levels, ffn_dim)
             for _ in range(dec_layers)], dim, num_classes)
        self.enc_output = nn.Linear(dim, dim)
        self.enc_output_norm = nn.LayerNorm(dim, eps=1e-5)
        self.enc_out_class_embed = nn.Linear(dim, num_classes)
        self.enc_out_bbox_embed = MLPHead(dim, dim, 4, layers=3)
        self.tgt_embed = nn.Embedding(num_queries, dim)
        self.label_enc = (None if dn_labelbook_size is None
                          else nn.Embedding(dn_labelbook_size + 1, dim))
        logit, valid = output_proposals(shapes)
        level = np.repeat(np.arange(n_levels), [h * w for h, w in shapes])
        for name, table in (
                ("pos_sine", position_embedding_sine_hw(shapes, dim // 2)),
                ("ref_points", encoder_reference_points(shapes)),
                ("proposals", logit), ("proposal_valid", valid),
                ("level_index", level)):
            self.register_buffer(name, torch.as_tensor(table),
                                 persistent=False)

    def _run(self, layer: nn.Module, *args) -> torch.Tensor:
        """layer(*args), recomputed in the backward under use_checkpoint."""
        if self.use_checkpoint and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(layer, *args,
                                                     use_reentrant=False)
        return layer(*args)

    def encode(self, srcs: torch.Tensor,
               padding_mask: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
        """srcs: (B, S, C) flattened multi-scale features; padding_mask:
        (B, S) bool, True at padded tokens, or None. Returns the encoder
        memory, the projected two-stage memory `out_memory`, the class
        logits `enc_logits` (B, S, K), the unsigmoided boxes `enc_unsig`
        (B, S, 4) of every proposal, and, with a mask, the mask, the
        valid ratios (B, L, 2) and the proposal logits (B, S, 4), which
        `decode` reads."""
        b, s, _ = srcs.shape
        if s != len(self.level_index):
            raise ValueError(f"{s} tokens, the transformer was built for "
                             f"{len(self.level_index)} ({self.spatial_shapes})")
        shapes = self.spatial_shapes
        extra: Dict[str, torch.Tensor] = {}
        # the tables in f32, the position embedding summed in f32 and cast
        # once (JAX transformer.py:403); the reference points stay f32, so
        # MSDA's sampling locations are f32
        if padding_mask is None:
            pos_sine, ref = self.pos_sine[None], self.ref_points.expand(
                b, -1, -1, -1)
            proposals, valid = self.proposals[None], self.proposal_valid[
                None]
        else:
            padding_mask = padding_mask.to(torch.bool)
            vr = valid_ratios_from_mask(padding_mask, shapes)
            pos_sine = position_embedding_sine_hw_masked(padding_mask, shapes,
                                                         self.dim // 2)
            ref = encoder_reference_points_masked(shapes, vr)
            proposals, valid = output_proposals_masked(padding_mask, shapes,
                                                       vr)
            extra = {"padding_mask": padding_mask, "valid_ratios": vr,
                     "proposals": proposals}
        pos = (pos_sine + self.level_embed[self.level_index]).to(srcs.dtype)
        memory = srcs
        for layer in self.encoder.layers:
            memory = self._run(layer, memory, pos, ref, shapes, padding_mask)
        out_memory = memory * valid.to(memory.dtype)[..., None]
        out_memory = self.enc_output_norm(self.enc_output(out_memory))
        return {"memory": memory, "out_memory": out_memory,
                "enc_logits": self.enc_out_class_embed(out_memory),
                "enc_unsig": self.enc_out_bbox_embed(out_memory) + proposals,
                **extra}

    def select(self, enc: Dict[str, torch.Tensor]) -> torch.Tensor:
        """DINO's two-stage selection: the (B, k) indices of the k =
        min(num_queries, S) proposals of highest class score, best first.
        (Padded rows' scores tie; their proposals, +inf, give the same box
        whichever of them is taken.)"""
        k = min(self.num_queries, enc["enc_logits"].shape[1])
        scores = enc["enc_logits"].max(-1).values
        return scores.topk(k, dim=1).indices

    def decode(self, enc: Dict[str, torch.Tensor], topk: torch.Tensor,
               dn_labels: Optional[torch.Tensor] = None,
               dn_boxes: Optional[torch.Tensor] = None,
               dn_attn_mask: Optional[torch.Tensor] = None,
               track_tgt: Optional[torch.Tensor] = None,
               track_boxes: Optional[torch.Tensor] = None) -> Dict:
        """The decoder on the proposals `topk` (B, k) of `encode`'s output,
        with MOTR's track queries track_tgt (B, T, C) and track_boxes (B, T,
        4) (cxcywh in [0, 1]) in front of the k selected queries, and, for
        contrastive denoising, dn_labels (B, N_dn) (class ids, embedded by
        `label_enc`) and dn_boxes (B, N_dn, 4) in front of those, and the
        self-attention allow-mask dn_attn_mask (N_dn + T + k,)*2. Returns
        enc_logits, enc_boxes, interm_logits, interm_boxes,
        init_proposals, and per decoder layer lists of logits (B, N, K),
        boxes (B, N, 4) cxcywh in [0, 1] and hidden states (N = N_dn + T +
        k), the dn queries' first, then the track queries'."""
        memory, out_memory = enc["memory"], enc["out_memory"]
        padding_mask = enc.get("padding_mask")
        vr = enc.get("valid_ratios")
        proposals = enc.get("proposals", self.proposals[None])
        # enc_unsig is f32 (the bf16 head plus the f32 proposals), and so
        # are the reference boxes and every box derived from them
        b, k = topk.shape
        n_levels = len(self.spatial_shapes)

        def take(t):
            return torch.gather(t, 1, topk[..., None].expand(-1, -1,
                                                             t.shape[-1]))

        ref_undetach = take(enc["enc_unsig"])
        ref_boxes = torch.sigmoid(ref_undetach).detach()
        init_proposals = torch.sigmoid(take(proposals.expand(b, -1, -1)))
        tgt_undetach = take(out_memory)
        tgt = self.tgt_embed.weight[None, :k].expand(b, -1, -1)
        outputs: Dict = {
            "enc_logits": enc["enc_logits"],
            "enc_boxes": torch.sigmoid(enc["enc_unsig"]),
            "interm_logits": self.enc_out_class_embed(tgt_undetach),
            "interm_boxes": torch.sigmoid(ref_undetach),
            "init_proposals": init_proposals,
            "logits": [], "boxes": [], "hidden": []}
        if track_tgt is not None:
            tgt = torch.cat([track_tgt.to(tgt.dtype), tgt], 1)
            ref_boxes = torch.cat([track_boxes.to(ref_boxes.dtype),
                                   ref_boxes], 1)
        if dn_labels is not None:
            if self.label_enc is None:
                raise ValueError("dn queries need label_enc: build the "
                                 "transformer with dn_labelbook_size")
            tgt = torch.cat([self.label_enc(dn_labels.long()).to(tgt.dtype),
                             tgt], 1)
            ref_boxes = torch.cat([dn_boxes.to(ref_boxes.dtype), ref_boxes],
                                  1)
        dec = self.decoder
        report_ref = ref_boxes
        for i, layer in enumerate(dec.layers):
            # the per-level reference boxes, scaled by the valid ratios
            # under a mask (deformable_transformer.py:704-710); the query
            # embedding from level 0's
            if vr is None:
                ref_input = ref_boxes[:, :, None, :].expand(-1, -1, n_levels,
                                                            -1)
            else:
                ref_input = (ref_boxes[:, :, None, :]
                             * torch.cat([vr, vr], -1)[:, None])
            # the f32 embedding enters the head in its dtype, as flax's
            # Dense casts its input
            qp = dec.ref_point_head(gen_sineembed(
                ref_input[:, :, 0], self.dim // 2).to(tgt.dtype))
            tgt = self._run(layer, tgt, qp, ref_input, memory,
                            self.spatial_shapes, padding_mask, dn_attn_mask)
            hidden = dec.norm(tgt)
            # the refinement chain runs on the unnormed output
            # (deformable_transformer.py:761-765), the reported boxes on the
            # normed one and this layer's input reference (dino.py:280-291)
            new_ref = torch.sigmoid(dec.bbox_embed[i](tgt)
                                    + inverse_sigmoid(ref_boxes))
            outputs["boxes"].append(torch.sigmoid(
                dec.bbox_embed[i](hidden) + inverse_sigmoid(report_ref)))
            outputs["logits"].append(dec.class_embed[i](hidden))
            outputs["hidden"].append(hidden)
            report_ref = new_ref
            ref_boxes = new_ref.detach()
        return outputs

    def forward(self, srcs: torch.Tensor,
                padding_mask: Optional[torch.Tensor] = None,
                dn_labels: Optional[torch.Tensor] = None,
                dn_boxes: Optional[torch.Tensor] = None,
                dn_attn_mask: Optional[torch.Tensor] = None,
                track_tgt: Optional[torch.Tensor] = None,
                track_boxes: Optional[torch.Tensor] = None) -> Dict:
        """srcs: (B, S, C); padding_mask (B, S), the dn inputs and MOTR's
        track queries as `encode` and `decode` take them. Returns
        `decode`'s dict."""
        if (track_tgt is None) != (track_boxes is None):
            raise ValueError("track_tgt and track_boxes come together")
        enc = self.encode(srcs, padding_mask)
        return self.decode(enc, self.select(enc), dn_labels, dn_boxes,
                           dn_attn_mask, track_tgt, track_boxes)
