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

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from fastervit_tpu_torch.models.config import FasterViTConfig
from fastervit_tpu_torch.models.layers import (HAT, BatchNorm2d, ConvBlock,
                                               Downsample, LayerNorm2d,
                                               PatchEmbed, TokenInitializer,
                                               checkpointed)
from fastervit_tpu_torch.ops.windows import window_partition, window_reverse


class FasterViTLayer(nn.Module):
    """One level: ConvBlocks (levels 0-1) or HAT blocks (levels 2-3) with
    window partition/reverse, the carrier-token initializer where the level
    has carriers, any-res pad/crop, and an optional Downsample. With
    `grad_checkpointing` set, each block runs under `checkpointed` while
    training with gradients on."""

    grad_checkpointing = False

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 padded_resolution: Tuple[int, int],
                 resolution: Optional[Tuple[int, int]] = None,
                 ct_size: int = 1,
                 conv: bool = False, downsample: bool = True,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None,
                 drop_path: Sequence[float] = (0.0,),
                 layer_scale: Optional[float] = None,
                 layer_scale_conv: Optional[float] = None,
                 only_local: bool = False, do_propagation: bool = False,
                 dynamic_mode: bool = False, drop: float = 0.0,
                 attn_drop: float = 0.0):
        super().__init__()
        self.conv = conv
        self.window_size = window_size
        self.only_local = only_local
        hp, wp = padded_resolution
        self.sr_ratio = ((1, 1) if only_local
                         else (hp // window_size, wp // window_size))
        # the input size the model is built for, and its window padding, as
        # constants: a tracer then records no arithmetic on the input's
        # shape (the ONNX graph would carry Mod nodes)
        self.resolution = resolution
        self.pads = (None if resolution is None else
                     tuple((window_size - r % window_size) % window_size
                           for r in resolution))
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
                    last=(i == depth - 1), do_propagation=do_propagation,
                    dynamic_mode=dynamic_mode, drop=drop,
                    attn_drop=attn_drop)
                for i in range(depth))
        self.global_tokenizer = (
            TokenInitializer(dim, (hp, wp), window_size, ct_size,
                             raster_output=dynamic_mode)
            if not conv and self.sr_ratio != (1, 1) else None)
        self.downsample = Downsample(dim) if downsample else None

    def _run(self, blk: nn.Module, *args):
        if (self.grad_checkpointing and self.training
                and torch.is_grad_enabled()):
            return checkpointed(blk, *args)
        return blk(*args)

    def forward(self, x: torch.Tensor, return_pre_downsample: bool = False):
        """x: (B, C, H, W). Returns the level's output, or with
        `return_pre_downsample` the pair (output, the map before the
        Downsample), as the pyramid needs."""
        if self.conv:
            for blk in self.blocks:
                x = self._run(blk, x)
        else:
            _, _, h, w = x.shape
            ws = self.window_size
            if (h, w) == self.resolution:
                (h, w), (pad_b, pad_r) = self.resolution, self.pads
            else:
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
                x, ct = self._run(blk, x, ct)
            x = window_reverse(x, ws, hp, wp).permute(0, 3, 1, 2)
            if pad_b or pad_r:
                x = x[:, :, :h, :w]
            x = x.contiguous()
        pre = x
        if self.downsample is not None:
            x = self.downsample(x)
        if return_pre_downsample:
            return x, pre
        return x


def _build_levels(cfg: FasterViTConfig, dynamic_mode: bool = False,
                  padded: Optional[Sequence[Tuple[int, int]]] = None
                  ) -> nn.ModuleList:
    """The four levels; `padded` gives each level's padded resolution
    (default: the config's)."""
    dpr = cfg.drop_path_schedule()
    shapes = level_shapes(*cfg.resolution, cfg.num_levels)
    levels = []
    for i in range(cfg.num_levels):
        start = sum(cfg.depths[:i])
        levels.append(FasterViTLayer(
            dim=cfg.level_dim(i), depth=cfg.depths[i],
            num_heads=cfg.num_heads[i], window_size=cfg.window_size[i],
            padded_resolution=(padded[i] if padded is not None
                               else cfg.level_padded_resolution(i)),
            resolution=shapes[i], ct_size=cfg.ct_size, conv=(i < 2),
            downsample=(i < 3),
            mlp_ratio=cfg.mlp_ratio, qkv_bias=cfg.qkv_bias,
            qk_scale=cfg.qk_scale, drop_path=dpr[start:start + cfg.depths[i]],
            layer_scale=cfg.layer_scale,
            layer_scale_conv=cfg.layer_scale_conv, only_local=not cfg.hat[i],
            do_propagation=cfg.do_propagation, dynamic_mode=dynamic_mode,
            drop=cfg.drop_rate, attn_drop=cfg.attn_drop_rate))
    return nn.ModuleList(levels)


class FasterViT(nn.Module):
    """FasterViT classifier: stem -> 4 levels -> norm -> mean pool -> head.
    Input (B, C, H, W), output (B, num_classes) logits."""

    def __init__(self, cfg: FasterViTConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg.in_chans, cfg.in_dim, cfg.dim)
        self.levels = _build_levels(cfg)
        self.norm = (LayerNorm2d(cfg.num_features, eps=1e-6)
                     if cfg.layer_norm_last
                     else BatchNorm2d(cfg.num_features, eps=1e-5))
        self.head = (nn.Linear(cfg.num_features, cfg.num_classes)
                     if cfg.num_classes > 0 else nn.Identity())

    def set_grad_checkpointing(self, enable: bool = True) -> None:
        """Recompute each block's activations in the backward instead of
        keeping them (timm's set_grad_checkpointing; the JAX package's
        TrainConfig.grad_checkpoint)."""
        for level in self.levels:
            level.grad_checkpointing = enable

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x)
        for level in self.levels:
            x = level(x)
        x = self.norm(x).mean(dim=(2, 3))
        return self.head(x)


def level_shapes(height: int, width: int, levels: int = 4
                 ) -> Tuple[Tuple[int, int], ...]:
    """Each level's (H, W) for an input of height x width: the stem's two
    stride-2 convolutions, then a stride-2 Downsample between levels, each
    taking ceil(n / 2) (3x3, padding 1). The config's `level_resolution`
    truncates instead, which is exact for the classifiers' square inputs
    but not for a detector's canvas (1333 / 16 = 83.3, and level 2 is 84
    wide)."""
    h, w = -(-(-(-height // 2)) // 2), -(-(-(-width // 2)) // 2)
    out = []
    for _ in range(levels):
        out.append((h, w))
        h, w = -(-h // 2), -(-w // 2)
    return tuple(out)


class FasterViTPyramid(nn.Module):
    """Feature-pyramid mode, the backbone of the detectors (fastervit_tpu/
    models/fastervit.py::FasterViTPyramid; reference downstream/
    object_detection/dino/models/dino/fastervit.py:705-707, 792-846): each
    level's map before its Downsample, through a per-level norm, for the
    levels in `out_indices`. `stage_norm` is "batchnorm" (the port's
    flax-style BatchNorm2d, eps 1e-5; the DINO default) or "layernorm"
    (LayerNorm2d, eps 1e-6); the norms are `norm{i}`, upstream's names.
    The levels run the runtime-dynamic HAT variant, as the downstream
    backbones do (the JAX pyramid's default `dynamic_mode=True`).

    Input (B, C, H, W) at the config's resolution, the canvas the model is
    built for (levels are sized with `level_shapes`); returns
    {"res2": (B, C0, H/4, W/4), ..., "res5": (B, C3, H/32, W/32)}, NCHW,
    for the levels asked for."""

    def __init__(self, cfg: FasterViTConfig,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 stage_norm: str = "batchnorm"):
        super().__init__()
        if stage_norm not in ("batchnorm", "layernorm"):
            raise ValueError(f"stage_norm {stage_norm!r}: 'batchnorm' or "
                             "'layernorm'")
        self.cfg = cfg
        self.out_indices = tuple(out_indices)
        shapes = level_shapes(*cfg.resolution, cfg.num_levels)
        padded = [(h + (-h) % ws, w + (-w) % ws)
                  for (h, w), ws in zip(shapes, cfg.window_size)]
        self.patch_embed = PatchEmbed(cfg.in_chans, cfg.in_dim, cfg.dim)
        self.levels = _build_levels(cfg, dynamic_mode=True, padded=padded)
        for i in self.out_indices:
            dim = cfg.level_dim(i)
            self.add_module(f"norm{i}",
                            BatchNorm2d(dim, eps=1e-5)
                            if stage_norm == "batchnorm"
                            else LayerNorm2d(dim, eps=1e-6))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.patch_embed(x)
        feats = {}
        for i, level in enumerate(self.levels):
            x, pre = level(x, return_pre_downsample=True)
            if i in self.out_indices:
                feats[f"res{i + 2}"] = getattr(self, f"norm{i}")(pre)
        return feats


def freeze_stages(model: nn.Module, frozen_stages: int = -1) -> nn.Module:
    """Stop the gradients of a backbone's first stages, as the DINO
    backbone's _freeze_stages does (reference fastervit.py:801-812; the
    JAX package's `frozen_param_labels`, fastervit.py:202-218):
    `patch_embed` when frozen_stages >= 0, and `levels.0` to
    `levels.{frozen_stages - 2}` when frozen_stages >= 2, get
    requires_grad False; every other parameter keeps its flag. Returns the
    model."""
    if frozen_stages >= 0:
        model.patch_embed.requires_grad_(False)
    if frozen_stages >= 2:
        for level in model.levels[:frozen_stages - 1]:
            level.requires_grad_(False)
    return model
