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
from fastervit_tpu_torch.models.fastervit import (FasterViT,
                                                  FasterViTPyramid)
from fastervit_tpu_torch.models.layers import is_bakeable
from fastervit_tpu_torch.utils.convert import load_checkpoint


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


def is_model(name: str) -> bool:
    """Whether `name` is a registered variant."""
    return name in VARIANTS


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
                 pretrained: bool = False, checkpoint_path: str = "",
                 pyramid: bool = False, quantized: bool = False,
                 **overrides) -> nn.Module:
    """Build a FasterViT by name (fastervit_tpu/models/registry.py::
    create_model; reference registry.py:195-205).

    The model is built on `device`, the card unless the caller asks for
    another ("cpu"; on "meta", no weights are allocated and none are drawn),
    its weights drawn from `generator` (a CPU generator; seed 0 if None).
    With `checkpoint_path`, a reference checkpoint (.pth.tar) is then loaded
    over them by `utils.convert.load_checkpoint`: keys it lacks or holds at
    another shape (a 21841-class head, say) keep their random values, with
    a warning. `pretrained=True` needs that path, since nothing is
    downloaded. With `quantized`, the int8 serving model: its eligible
    layers are then quantised from their f32 weights
    (`ops.quant.quantize_model`; a classifier only, as in the JAX package:
    a pyramid raises ValueError). The model is then cast to `dtype` (the
    int8 layers' scales and biases stay f32). Overrides are config
    fields, as in `get_config`. Returns the module in training mode, as
    upstream does; call `.eval()` for inference. (The JAX package returns a
    (model, variables) pair when given a checkpoint; a PyTorch module holds
    its weights.)"""
    if pretrained and not checkpoint_path:
        raise ValueError("pretrained=True needs checkpoint_path (nothing is "
                         "downloaded): fetch the reference .pth.tar first")
    if quantized and pyramid:
        raise ValueError("int8 serving covers the classifier path; "
                         "pyramid backbones run in float")
    cfg = get_config(name, **overrides)
    device = torch.device(device)
    with device:
        model = FasterViTPyramid(cfg) if pyramid else FasterViT(cfg)
    if device.type != "meta":
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        _init_weights(model, generator)
    if checkpoint_path:
        load_checkpoint(model, checkpoint_path)
    if quantized:
        from fastervit_tpu_torch.ops.quant import quantize_model
        quantize_model(model)
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
    gradients to its MLP; bake again after any change to the weights. The
    dynamic-mode embeddings of a pyramid (`norm_by_seq`) stay live, as the
    JAX package never bakes them."""
    modules = [m for m in model.modules() if is_bakeable(m)]
    for m in modules:
        m.relative_bias = None
    for m in modules:
        m.relative_bias = m.compute()
    return model


def export_for_deploy(model: nn.Module, batch_size: int,
                      dtype: torch.dtype = torch.float32) -> nn.Module:
    """Deploy mode, the counterpart of the JAX package's `Model.aot_compile`
    (fastervit_tpu/models/registry.py:127-137): the position biases baked
    (`bake_posemb`), then the forward exported at a fixed batch of
    `batch_size` inputs of `dtype` (`utils.export.export_program`), whose
    `.module()` is returned: a graph of the forward's operators, the
    hand-written kernels among them, with the weights and baked biases as
    its constants. Save it with `utils.export.save_program` on the program
    (`torch.export.export` of the returned module is that program again),
    or call it in this process."""
    from fastervit_tpu_torch.utils.export import export_program
    bake_posemb(model.eval())
    return export_program(model, batch_size, dtype).module()
