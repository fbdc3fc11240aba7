"""Model configuration for the FasterViT family (PyTorch port).

A copy of fastervit_tpu/models/config.py: the JAX package runs jax and flax
when any of its modules is imported, so the port keeps its own table.
tests/test_torch_config.py holds the two tables equal, field by field.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Eval-time preprocessing metadata (reference faster_vit.py:21-80)."""
    input_size: Tuple[int, int] = (224, 224)
    crop_pct: float = 0.875
    crop_mode: str = "center"  # 'center' | 'squash'
    interpolation: str = "bicubic"
    mean: Tuple[float, float, float] = IMAGENET_MEAN
    std: Tuple[float, float, float] = IMAGENET_STD


@dataclasses.dataclass(frozen=True)
class FasterViTConfig:
    """Architecture hyperparameters (reference FasterViT.__init__, faster_vit.py:852-928)."""
    name: str = "faster_vit_0_224"
    depths: Tuple[int, ...] = (2, 3, 6, 5)
    num_heads: Tuple[int, ...] = (2, 4, 8, 16)
    window_size: Tuple[int, ...] = (7, 7, 7, 7)
    ct_size: int = 2
    dim: int = 64
    in_dim: int = 64
    mlp_ratio: float = 4.0
    resolution: Tuple[int, int] = (224, 224)
    drop_path_rate: float = 0.2
    in_chans: int = 3
    num_classes: int = 1000
    qkv_bias: bool = True
    qk_scale: Optional[float] = None
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    layer_scale: Optional[float] = None
    layer_scale_conv: Optional[float] = None
    layer_norm_last: bool = False
    hat: Tuple[bool, ...] = (False, False, True, False)
    do_propagation: bool = False
    data: DataConfig = DataConfig()

    # ---- derived static geometry -------------------------------------------------
    @property
    def num_levels(self) -> int:
        return len(self.depths)

    @property
    def num_features(self) -> int:
        return int(self.dim * 2 ** (self.num_levels - 1))

    def level_dim(self, i: int) -> int:
        return int(self.dim * 2 ** i)

    def level_resolution(self, i: int) -> Tuple[int, int]:
        """Stage-i input resolution before window rounding (stride-4 stem, /2 per stage)."""
        return (
            int(2 ** (-2 - i) * self.resolution[0]),
            int(2 ** (-2 - i) * self.resolution[1]),
        )

    def level_padded_resolution(self, i: int) -> Tuple[int, int]:
        """Stage-i resolution rounded up to a window multiple (any-res semantics,
        reference faster_vit_any_res.py:806-808; a no-op for the square 224/384/...
        variants where every stage is already a multiple)."""
        h, w = self.level_resolution(i)
        ws = self.window_size[i]
        return (h + (ws - h % ws) % ws, w + (ws - w % ws) % ws)

    def sr_ratio(self, i: int) -> Tuple[int, int]:
        """Per-axis ratio of padded stage resolution to window size; (1, 1) disables HAT."""
        if not self.hat[i]:
            return (1, 1)
        h, w = self.level_padded_resolution(i)
        ws = self.window_size[i]
        return (h // ws, w // ws)

    def drop_path_schedule(self) -> Tuple[float, ...]:
        total = sum(self.depths)
        if total == 1:
            return (0.0,)
        return tuple(self.drop_path_rate * k / (total - 1) for k in range(total))


def _square(name, depths, num_heads, window, dim, in_dim, dpr, *, ct=2,
            layer_scale=None, hat=(False, False, True, False), prop=False,
            resolution=224, crop_pct=1.0, crop_mode="center"):
    return FasterViTConfig(
        name=name, depths=depths, num_heads=num_heads, window_size=window,
        ct_size=ct, dim=dim, in_dim=in_dim, resolution=(resolution, resolution),
        drop_path_rate=dpr, layer_scale=layer_scale, layer_scale_conv=None,
        hat=hat, do_propagation=prop,
        data=DataConfig(input_size=(resolution, resolution), crop_pct=crop_pct,
                        crop_mode=crop_mode),
    )


_H4 = (4, 8, 16, 32)
_H2 = (2, 4, 8, 16)
_W7 = (7, 7, 7, 7)
_HAT2 = (False, False, True, False)
_HAT0 = (False, False, False, False)

# Variant table: reference faster_vit.py:975-1418 (see SURVEY.md §2.1).
VARIANTS = {
    "faster_vit_0_224": _square("faster_vit_0_224", (2, 3, 6, 5), _H2, _W7, 64, 64, 0.2,
                                crop_pct=0.875),
    "faster_vit_1_224": _square("faster_vit_1_224", (1, 3, 8, 5), _H2, _W7, 80, 32, 0.2),
    "faster_vit_2_224": _square("faster_vit_2_224", (3, 3, 8, 5), _H2, _W7, 96, 64, 0.2),
    "faster_vit_3_224": _square("faster_vit_3_224", (3, 3, 12, 5), _H2, _W7, 128, 64, 0.3,
                                layer_scale=1e-5, prop=True),
    "faster_vit_4_224": _square("faster_vit_4_224", (3, 3, 12, 5), _H4, _W7, 196, 64, 0.3,
                                layer_scale=1e-5, prop=True),
    "faster_vit_5_224": _square("faster_vit_5_224", (3, 3, 12, 5), _H4, _W7, 320, 64, 0.3,
                                layer_scale=1e-5, prop=True),
    "faster_vit_6_224": _square("faster_vit_6_224", (3, 3, 16, 8), _H4, _W7, 320, 64, 0.5,
                                layer_scale=1e-5, prop=True),
    "faster_vit_4_21k_224": _square("faster_vit_4_21k_224", (3, 3, 12, 5), _H4,
                                    (7, 7, 14, 7), 196, 64, 0.42, layer_scale=1e-5,
                                    prop=True, crop_pct=0.95, crop_mode="squash"),
    "faster_vit_4_21k_384": _square("faster_vit_4_21k_384", (3, 3, 12, 5), _H4,
                                    (7, 7, 24, 12), 196, 64, 0.42, layer_scale=1e-5,
                                    prop=True, hat=_HAT0, resolution=384,
                                    crop_mode="squash"),
    "faster_vit_4_21k_512": _square("faster_vit_4_21k_512", (3, 3, 12, 5), _H4,
                                    (7, 7, 32, 16), 196, 64, 0.42, layer_scale=1e-5,
                                    prop=True, hat=_HAT0, resolution=512,
                                    crop_mode="squash"),
    "faster_vit_4_21k_768": _square("faster_vit_4_21k_768", (3, 3, 12, 5), _H4,
                                    (7, 7, 48, 24), 196, 64, 0.42, layer_scale=1e-5,
                                    prop=True, hat=_HAT0, resolution=768,
                                    crop_pct=0.93, crop_mode="squash"),
}
# NOTE: faster_vit_4_21k_224 keeps hat=[F,F,T,F] in the reference
# (faster_vit.py:1267) but stage-2 window (14) equals stage-2 resolution, so
# sr_ratio == 1 and HAT degenerates to plain windowed attention anyway.

# Any-resolution variants: same hyperparameters, rectangular default resolution,
# runtime pad/crop (reference faster_vit_any_res.py:1005-1448). Quirks preserved:
# faster_vit_2_any_res defaults to [541, 960] (faster_vit_any_res.py:1089) and the
# 21k any-res variants use drop_path 0.3, not 0.42 (faster_vit_any_res.py:1294+).
def _any_res(base_name: str, resolution=(576, 960), **overrides) -> None:
    base = VARIANTS[base_name]
    name = (base_name[: -len("_224")] if base_name.endswith("_224") and "21k" not in base_name
            else base_name) + "_any_res"
    VARIANTS[name] = dataclasses.replace(
        base, name=name, resolution=tuple(resolution),
        data=dataclasses.replace(base.data, input_size=tuple(resolution)),
        **overrides,
    )


for _v in range(7):
    _any_res(f"faster_vit_{_v}_224",
             resolution=(541, 960) if _v == 2 else (576, 960))
_any_res("faster_vit_4_21k_224", drop_path_rate=0.3, hat=_HAT0)
_any_res("faster_vit_4_21k_384", drop_path_rate=0.3)
_any_res("faster_vit_4_21k_512", drop_path_rate=0.3)
_any_res("faster_vit_4_21k_768", drop_path_rate=0.3)
