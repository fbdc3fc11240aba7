"""The exact MOTRv2 deformable transformer: the PyTorch port of
fastervit_tpu/tracking/transformer.py (reference motrv2/models/
deformable_transformer_plus.py in the shipped recipe's configuration:
self-cross decoder order, with_box_refine, no two-stage, no memory bank,
no extra track attention).

Against the port's DINO transformer (detection/transformer.py):
- the decoder's targets and reference boxes are given (learned queries,
  proposal queries and the carried track queries), not selected;
- each decoder layer's query position is pos2posemb of its current
  reference box, 4 coordinates x dim/4 features, coordinate-major (not
  DINO's ref_point_head);
- the refinement detaches the reference each layer, with MOTR's
  inverse_sigmoid eps of 1e-5; no final decoder LayerNorm;
- the refinement box heads `decoder.bbox_embed.{i}` are per layer, and
  are the model's box heads.

Dtypes follow the JAX module: the position embedding is summed in f32
(level_embed stays f32 under any cast) and cast to the model's dtype; the
encoder's reference grid, the reference boxes and every box are in the
model's dtype (bf16 in a bf16 model: MSDA's sampling locations are then
bf16, which K5's binding widens to f32 exactly).

`lite_encoder` (Lite-DETR's speed mode, not checkpoint-exact): the
stride-4 level leaves the encoder's query set but stays in the values it
samples, through `EncoderLayer(..., value=)`.

The levels' spatial shapes are fixed when the module is built.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from fastervit_tpu_torch.detection.transformer import (DecoderLayer,
                                                       EncoderLayer, KeepF32,
                                                       MLPHead,
                                                       TransformerEncoder,
                                                       inverse_sigmoid)
from fastervit_tpu_torch.ops.msda import normalize_shapes
from fastervit_tpu_torch.tracking.motr import pos2posemb


def encoder_reference_points(spatial_shapes: Sequence[Tuple[int, int]]
                             ) -> np.ndarray:
    """Each level's normalised pixel centres, unpadded (valid ratios 1),
    in f32 arithmetic as MOTR's JAX version computes them
    (deformable_transformer_plus.py:240-253): (S, L, 2) float32."""
    pts = []
    for (h, w) in spatial_shapes:
        ry = (np.arange(h, dtype=np.float32) + 0.5) / h
        rx = (np.arange(w, dtype=np.float32) + 0.5) / w
        gy, gx = np.meshgrid(ry, rx, indexing="ij")
        pts.append(np.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    ref = np.concatenate(pts, 0)
    return np.broadcast_to(ref[:, None, :],
                           (ref.shape[0], len(spatial_shapes), 2)).copy()


class MOTRDecoder(nn.Module):
    """The decoder's layers and its per-layer refinement box heads
    (upstream DeformableTransformerDecoder with with_box_refine)."""

    def __init__(self, layers, dim: int):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.bbox_embed = nn.ModuleList(MLPHead(dim, dim, 4, layers=3)
                                        for _ in layers)


class MOTRTransformer(KeepF32):
    """fastervit_tpu/tracking/transformer.py::MOTRTransformer over the
    flattened levels of fixed `spatial_shapes`. Module names are
    upstream's: `level_embed`, `encoder.layers.{i}`, `decoder.layers.{i}`,
    `decoder.bbox_embed.{i}`."""

    _F32_TENSORS = ("level_embed",)

    def __init__(self, spatial_shapes: Sequence[Tuple[int, int]],
                 dim: int = 256, n_heads: int = 8, n_points: int = 4,
                 enc_layers: int = 6, dec_layers: int = 6,
                 ffn_dim: int = 1024, lite_encoder: bool = False):
        super().__init__()
        shapes = normalize_shapes(spatial_shapes)
        self.spatial_shapes, self.dim = shapes, dim
        self.lite_encoder = lite_encoder
        n_levels = len(shapes)
        self.level_embed = nn.Parameter(torch.empty(n_levels, dim))
        self.encoder = TransformerEncoder(
            [EncoderLayer(dim, n_heads, n_points, n_levels, ffn_dim)
             for _ in range(enc_layers)])
        self.decoder = MOTRDecoder(
            [DecoderLayer(dim, n_heads, n_points, n_levels, ffn_dim)
             for _ in range(dec_layers)], dim)
        level = np.repeat(np.arange(n_levels), [h * w for h, w in shapes])
        # the grid is cast with the module, as JAX casts it to its dtype
        self.register_buffer("ref_grid", torch.as_tensor(
            encoder_reference_points(shapes)), persistent=False)
        self.register_buffer("level_index", torch.as_tensor(level),
                             persistent=False)

    def forward(self, srcs: torch.Tensor, pos_embeds: torch.Tensor,
                query_embed: torch.Tensor, ref_pts: torch.Tensor,
                self_attn_mask: Optional[torch.Tensor] = None) -> Dict:
        """srcs: (B, S, C) flattened levels in the model's dtype;
        pos_embeds: (B or 1, S, C) f32 sine embeddings (the level
        embedding is added here); query_embed: (B, Q, C) decoder targets;
        ref_pts: (B, Q, 4) initial reference boxes in [0, 1];
        self_attn_mask: (Q, Q) bool, True where attention is BLOCKED
        (torch's convention, as the JAX module takes it), or None.
        Returns {'hidden': per layer (B, Q, C), 'refs': per layer (B, Q,
        4) after the refinement, 'init_ref'}."""
        b, s, _ = srcs.shape
        if s != len(self.level_index):
            raise ValueError(f"{s} tokens, the transformer was built for "
                             f"{len(self.level_index)} ({self.spatial_shapes})")
        dtype = srcs.dtype
        shapes = self.spatial_shapes
        pos = (pos_embeds + self.level_embed[self.level_index]).to(dtype)
        ref_grid = self.ref_grid.to(dtype)
        memory = srcs
        if self.lite_encoder and len(shapes) > 1:
            s_lo = shapes[0][0] * shapes[0][1]
            lo, hi = memory[:, :s_lo], memory[:, s_lo:]
            pos_hi = pos[:, s_lo:]
            ref_hi = ref_grid[s_lo:].expand(b, -1, -1, -1)
            for layer in self.encoder.layers:
                hi = layer(hi, pos_hi, ref_hi, shapes, None,
                           torch.cat([lo, hi], 1))
            memory = torch.cat([lo, hi], 1)
        else:
            ref = ref_grid.expand(b, -1, -1, -1)
            for layer in self.encoder.layers:
                memory = layer(memory, pos, ref, shapes)

        n_levels = len(shapes)
        tgt = query_embed.to(dtype)
        refs = ref_pts.to(dtype).detach()
        init_ref = refs
        # the decoder layers take an allow-mask: the one inversion
        allow = None if self_attn_mask is None else ~self_attn_mask
        hidden_out, refs_out = [], []
        for layer, head in zip(self.decoder.layers, self.decoder.bbox_embed):
            qp = pos2posemb(refs, self.dim // 4).reshape(
                b, refs.shape[1], self.dim).to(dtype)
            ref_input = refs[:, :, None, :].expand(-1, -1, n_levels, -1)
            tgt = layer(tgt, qp, ref_input, memory, shapes, None, allow)
            refs = torch.sigmoid(head(tgt)
                                 + inverse_sigmoid(refs, eps=1e-5)).detach()
            hidden_out.append(tgt)
            refs_out.append(refs)
        return {"hidden": hidden_out, "refs": refs_out, "init_ref": init_ref}
