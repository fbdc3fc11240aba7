"""Weights bridge from the JAX package to the port.

`state_dict_from_jax(variables)` takes fastervit_tpu variables as a nested
mapping of numpy arrays (`jax.device_get(model.init(...))`) and returns a
state_dict that the port's model loads with `strict=True`. The key mapping
and the transposes are those of fastervit_tpu/utils/convert.py
(`torch_key_for_path`, `export_state_dict`); this module is plain Python and
numpy and imports nothing of the JAX package.

Deploy-mode variables (the 'baked' collection of `Model.bake_posemb`) are
not parameters: `state_dict_from_jax` leaves them out, `baked_from_jax`
maps them to the port's `relative_bias` buffers and `load_baked` stores them
there, as `fastervit_tpu_torch.bake_posemb` would.

Layout transforms:
  flax Dense kernel (in, out)        -> torch Linear weight (out, in)
  flax Conv kernel  (kh, kw, I/g, O) -> torch Conv2d weight (O, I/g, kh, kw)
  flax scale / mean / var            -> weight / running_mean / running_var
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from fastervit_tpu_torch.models.layers import (PosEmbMLPSwinv1D,
                                               PosEmbMLPSwinv2D)

# flax module names whose fc1/fc2 children are torch cpb_mlp Sequentials
_CPB_PARENTS = {"pos_embed", "hat_pos_embed", "pos_emb_funct"}
# patch_embed child -> index in the torch conv_down Sequential
_PATCH_EMBED_IDX = {"conv1": "0", "norm1": "1", "conv2": "3", "norm2": "4"}
_LEAF_NAME = {"kernel": "weight", "scale": "weight", "bias": "bias",
              "mean": "running_mean", "var": "running_var"}


def _torch_module_path(parts: Tuple[str, ...]) -> list:
    """A flax module path -> the upstream module path, as a list of names."""
    out = []
    i = 0
    while i < len(parts):
        p = parts[i]
        nxt = parts[i + 1] if i + 1 < len(parts) else None
        if p.startswith("levels_"):
            out.append("levels." + p[len("levels_"):])
        elif p.startswith("blocks_"):
            out.append("blocks." + p[len("blocks_"):])
        elif p == "patch_embed" and nxt in _PATCH_EMBED_IDX:
            out.append("patch_embed.conv_down." + _PATCH_EMBED_IDX[nxt])
            i += 1
        elif p == "global_tokenizer" and nxt == "pos_embed":
            out.append("global_tokenizer.to_global_feature.pos")
            i += 1
        elif p == "downsample" and nxt == "reduction":
            out.append("downsample.reduction.0")
            i += 1
        elif p in ("fc1", "fc2") and out and out[-1].split(".")[-1] in _CPB_PARENTS:
            out.append("cpb_mlp." + ("0" if p == "fc1" else "2"))
        else:
            out.append(p)
        i += 1
    return out


def torch_key_for_path(path: Tuple[str, ...]) -> str:
    """Map a flax variable path (collection stripped) to the upstream
    state_dict key (same mapping as fastervit_tpu.utils.convert)."""
    out = _torch_module_path(path[:-1])
    leaf = path[-1]
    if leaf.startswith("gamma"):
        return ".".join(out + [leaf])
    return ".".join(out + [_LEAF_NAME[leaf]])


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} of numpy arrays -> the port's
    state_dict (f32 tensors, plus an int64 num_batches_tracked of 0 for
    every BatchNorm, which a strict load requires)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, val in _leaves(variables):
        if path[0] == "baked":  # deploy-mode tensors: see baked_from_jax
            continue
        key = torch_key_for_path(path[1:])  # drop the collection name
        arr = np.array(val, dtype=np.float32)  # a writable copy
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
        if "global_tokenizer.to_global_feature.pos." in key:
            # upstream registers the tokenizer conv under two names
            sd[key.replace("to_global_feature.pos", "pos_embed")] = sd[key]
        if key.endswith(".running_mean"):
            sd[key[:-len("running_mean")] + "num_batches_tracked"] = \
                torch.tensor(0, dtype=torch.long)
    return sd


def baked_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The 'baked' collection of JAX variables (numpy arrays) -> f32 tensors
    keyed by the port's buffer names ("<module>.relative_bias"): the
    (S, dim) PosEmbMLPSwinv1D embeddings and the (H, S, S) PosEmbMLPSwinv2D
    biases, in the same layouts on both sides. Empty without the
    collection."""
    return {".".join(_torch_module_path(path[:-1]) + ["relative_bias"]):
            torch.from_numpy(np.array(val, dtype=np.float32))
            for path, val in _leaves(variables.get("baked", {}))}


def load_baked(model: torch.nn.Module,
               baked: Mapping[str, torch.Tensor]) -> torch.nn.Module:
    """Store `baked_from_jax`'s tensors in the model's `relative_bias`
    buffers, on the device and in the dtype of each module's parameters.
    Raises KeyError unless they cover exactly the model's position-embedding
    modules. Returns the model."""
    want = {f"{name}.relative_bias" for name, m in model.named_modules()
            if isinstance(m, (PosEmbMLPSwinv1D, PosEmbMLPSwinv2D))}
    if set(baked) != want:
        raise KeyError(f"baked tensors missing {sorted(want - set(baked))}, "
                       f"unexpected {sorted(set(baked) - want)}")
    for key, tensor in baked.items():
        module = model.get_submodule(key[:-len(".relative_bias")])
        ref = module.cpb_mlp[0].weight
        module.relative_bias = tensor.to(device=ref.device, dtype=ref.dtype)
    return model
