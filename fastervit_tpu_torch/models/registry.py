"""Model registry and factory (port of fastervit_tpu/models/registry.py).

`create_model(name, ...)` returns an `nn.Module`, as upstream's create_model
does, with random weights drawn from an explicit `torch.Generator`.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import math
import re
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from fastervit_tpu_torch.models.config import (VARIANTS, DataConfig,
                                               FasterViTConfig)
from fastervit_tpu_torch.models.fastervit import FasterViT
from fastervit_tpu_torch.models.layers import (PosEmbMLPSwinv1D,
                                               PosEmbMLPSwinv2D)


def _natural_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s.lower())]


def list_models(filter: str = "") -> list:
    names = list(VARIANTS)
    if filter:
        filters = filter if isinstance(filter, (tuple, list)) else [filter]
        selected = set()
        for f in filters:
            selected.update(fnmatch.filter(names, f))
        names = list(selected)
    return sorted(names, key=_natural_key)


def get_config(name: str, **overrides) -> FasterViTConfig:
    """The variant's config with overrides of any FasterViTConfig or
    DataConfig field; `resolution` also sets the data input size."""
    if name not in VARIANTS:
        raise KeyError(f"unknown model {name!r}; see list_models()")
    cfg = VARIANTS[name]
    if not overrides:
        return cfg
    data_keys = {f.name for f in dataclasses.fields(DataConfig)}
    cfg_keys = {f.name for f in dataclasses.fields(FasterViTConfig)}
    cfg_over: Dict[str, Any] = {}
    data_over: Dict[str, Any] = {}
    for k, v in overrides.items():
        if k == "resolution":
            v = (v, v) if isinstance(v, int) else tuple(v)
            data_over.setdefault("input_size", v)
        if k in cfg_keys:
            cfg_over[k] = tuple(v) if isinstance(v, list) else v
        elif k in data_keys:
            data_over[k] = tuple(v) if isinstance(v, list) else v
        else:
            raise ValueError(f"unknown config override {k!r} for model {name!r}")
    data = dataclasses.replace(cfg.data, **data_over) if data_over else cfg.data
    return dataclasses.replace(cfg, data=data, **cfg_over)


@torch.no_grad()
def _init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random init drawn on the CPU from `generator`, so that one seed gives
    the same weights on every device: Linear weights truncated normal with
    std 0.02 (as upstream), conv weights truncated normal with std
    1/sqrt(fan_in) (flax's lecun_normal), biases zero; norms and layer-scale
    gammas keep their constructor values."""
    def trunc_normal(p: torch.Tensor, std: float) -> None:
        w = torch.empty(p.shape, dtype=torch.float32)
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        p.copy_(w)

    for m in model.modules():
        if isinstance(m, nn.Linear):
            trunc_normal(m.weight, 0.02)
        elif isinstance(m, nn.Conv2d):
            trunc_normal(m.weight, 1.0 / math.sqrt(m.weight[0].numel()))
        else:
            continue
        if m.bias is not None:
            m.bias.zero_()


def create_model(name: str, dtype: torch.dtype = torch.float32,
                 device: Any = "cuda",
                 generator: Optional[torch.Generator] = None,
                 **overrides) -> FasterViT:
    """Build a FasterViT by name with random weights.

    The model is built on `device`, the card unless the caller asks for
    another ("cpu"; on "meta", no weights are allocated and none are drawn),
    its weights drawn from `generator` (a CPU generator;
    seed 0 if None), then cast to `dtype`. Overrides are config fields, as in
    `get_config`. Returns the module in training mode, as upstream does;
    call `.eval()` for inference."""
    cfg = get_config(name, **overrides)
    device = torch.device(device)
    with device:
        model = FasterViT(cfg)
    if device.type != "meta":
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        _init_weights(model, generator)
    return model.to(dtype)


@torch.no_grad()
def bake_posemb(model: nn.Module) -> nn.Module:
    """Deploy mode (upstream's switch_to_deploy; fastervit_tpu's
    `Model.bake_posemb`): store every position-embedding tensor, the
    PosEmbMLPSwinv1D additive embeddings and the PosEmbMLPSwinv2D dense
    (H, S, S) attention biases, in the modules' `relative_bias` buffers, so
    that forwards read them instead of running the CPB MLPs and the bias
    expansion in every block. The tensors are computed on the model's
    device and in its dtype, from its current parameters: any tensor baked
    before is dropped first. They are fixed to the model's resolution, and
    they cost device memory: about 2.1 GB in bf16 for faster_vit_4_21k_768.

    Returns the model. A module that holds a baked tensor no longer passes
    gradients to its MLP; bake again after any change to the weights."""
    modules = [m for m in model.modules()
               if isinstance(m, (PosEmbMLPSwinv1D, PosEmbMLPSwinv2D))]
    for m in modules:
        m.relative_bias = None
    for m in modules:
        m.relative_bias = m.compute()
    return model
