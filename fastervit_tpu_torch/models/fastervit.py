"""FasterViT model: 4-level hierarchical vision backbone in PyTorch (port of
fastervit_tpu/models/fastervit.py).

The model takes NCHW input, the torch and upstream convention. Levels 0-1 are
ConvBlocks on NCHW maps; levels 2-3 permute to NHWC, pad to a window
multiple, partition into token-major windows, run the HAT blocks and undo all
of it. The JAX model derives each level's geometry from the input shape at
trace time; here the geometry is fixed when the model is built, from the
config's resolution, and a level raises on an input whose padded geometry
differs.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from fastervit_tpu_torch.models.config import FasterViTConfig
from fastervit_tpu_torch.models.layers import (HAT, ConvBlock, Downsample,
                                               LayerNorm2d, PatchEmbed,
                                               TokenInitializer)
from fastervit_tpu_torch.ops.windows import window_partition, window_reverse


class FasterViTLayer(nn.Module):
    """One level: ConvBlocks (levels 0-1) or HAT blocks (levels 2-3) with
    window partition/reverse, the carrier-token initializer where the level
    has carriers, any-res pad/crop, and an optional Downsample."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 padded_resolution: Tuple[int, int], ct_size: int = 1,
                 conv: bool = False, downsample: bool = True,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None,
                 drop_path: Sequence[float] = (0.0,),
                 layer_scale: Optional[float] = None,
                 layer_scale_conv: Optional[float] = None,
                 only_local: bool = False, do_propagation: bool = False):
        super().__init__()
        self.conv = conv
        self.window_size = window_size
        self.only_local = only_local
        hp, wp = padded_resolution
        self.sr_ratio = ((1, 1) if only_local
                         else (hp // window_size, wp // window_size))
        if conv:
            self.blocks = nn.ModuleList(
                ConvBlock(dim, drop_path=drop_path[i],
                          layer_scale=layer_scale_conv) for i in range(depth))
        else:
            self.blocks = nn.ModuleList(
                HAT(dim, num_heads, sr_ratio=self.sr_ratio,
                    window_size=window_size, ct_size=ct_size,
                    mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, qk_scale=qk_scale,
                    drop_path=drop_path[i], layer_scale=layer_scale,
                    last=(i == depth - 1), do_propagation=do_propagation)
                for i in range(depth))
        self.global_tokenizer = (
            TokenInitializer(dim, (hp, wp), window_size, ct_size)
            if not conv and self.sr_ratio != (1, 1) else None)
        self.downsample = Downsample(dim) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv:
            for blk in self.blocks:
                x = blk(x)
        else:
            _, _, h, w = x.shape
            ws = self.window_size
            pad_b, pad_r = (ws - h % ws) % ws, (ws - w % ws) % ws
            hp, wp = h + pad_b, w + pad_r
            if not self.only_local and (hp // ws, wp // ws) != self.sr_ratio:
                raise ValueError(
                    f"input of {h}x{w} gives a {hp // ws}x{wp // ws} window "
                    f"grid; this level was built for {self.sr_ratio} (build "
                    "the model with the input's resolution)")
            if pad_b or pad_r:
                x = F.pad(x, (0, pad_r, 0, pad_b))
            ct = (self.global_tokenizer(x) if self.global_tokenizer is not None
                  else None)
            x = window_partition(x.permute(0, 2, 3, 1), ws)
            for blk in self.blocks:
                x, ct = blk(x, ct)
            x = window_reverse(x, ws, hp, wp).permute(0, 3, 1, 2)
            if pad_b or pad_r:
                x = x[:, :, :h, :w]
            x = x.contiguous()
        if self.downsample is not None:
            x = self.downsample(x)
        return x


def _build_levels(cfg: FasterViTConfig) -> nn.ModuleList:
    dpr = cfg.drop_path_schedule()
    levels = []
    for i in range(cfg.num_levels):
        start = sum(cfg.depths[:i])
        levels.append(FasterViTLayer(
            dim=cfg.level_dim(i), depth=cfg.depths[i],
            num_heads=cfg.num_heads[i], window_size=cfg.window_size[i],
            padded_resolution=cfg.level_padded_resolution(i),
            ct_size=cfg.ct_size, conv=(i < 2), downsample=(i < 3),
            mlp_ratio=cfg.mlp_ratio, qkv_bias=cfg.qkv_bias,
            qk_scale=cfg.qk_scale, drop_path=dpr[start:start + cfg.depths[i]],
            layer_scale=cfg.layer_scale,
            layer_scale_conv=cfg.layer_scale_conv, only_local=not cfg.hat[i],
            do_propagation=cfg.do_propagation))
    return nn.ModuleList(levels)


class FasterViT(nn.Module):
    """FasterViT classifier: stem -> 4 levels -> norm -> mean pool -> head.
    Input (B, C, H, W), output (B, num_classes) logits."""

    def __init__(self, cfg: FasterViTConfig):
        super().__init__()
        if cfg.drop_rate or cfg.attn_drop_rate:
            raise NotImplementedError("dropout (drop_rate, attn_drop_rate) "
                                      "is not ported")
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg.in_chans, cfg.in_dim, cfg.dim)
        self.levels = _build_levels(cfg)
        self.norm = (LayerNorm2d(cfg.num_features, eps=1e-6)
                     if cfg.layer_norm_last
                     else nn.BatchNorm2d(cfg.num_features, eps=1e-5))
        self.head = (nn.Linear(cfg.num_features, cfg.num_classes)
                     if cfg.num_classes > 0 else nn.Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x)
        for level in self.levels:
            x = level(x)
        x = self.norm(x).mean(dim=(2, 3))
        return self.head(x)
