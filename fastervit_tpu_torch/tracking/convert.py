"""MOTR weights for the port: JAX variables across, and upstream MOTRv2
checkpoints in.

`motr_torch_key` and `motr_model_torch_key` are the port's own copies of
fastervit_tpu/tracking/convert.py's maps from a flax variable path inside
MOTRTransformer and MOTRDetectorExact (+ QIMv2 under 'qim') to upstream
MOTR's state_dict key.

`motr_state_dict_from_jax(variables)` takes the JAX exact detector's
variables as numpy ({'params': {..., 'qim': QIMv2's params}, 'batch_stats':
...}, the merged dict the JAX submit converts) and returns a state_dict in
upstream's layout: the QIM under `track_embed.*`, the refinement heads
under both `transformer.decoder.bbox_embed.{i}` and `bbox_embed.{i}`, the
decoder's and the QIM's flax attentions packed into nn.MultiheadAttention's
in_proj (`detection/convert.py::_mha_state`). `split_motr_state_dict`
parts it into the detector's and the QIM's, which load strictly.

`load_motr_checkpoint(model, qim, path)` loads an upstream MOTRv2 .pth
with the leniency of the JAX package's `convert_motr_checkpoint`: keys the
file lacks or holds at another shape keep their values, keys the port has
no use for are reported and skipped (`utils.convert.
load_state_dict_lenient`); the backbone's BatchNorm statistics
(`backbone.0.*.running_*`) load with it. With `fit=True` (the submit
CLI's) a file built for another query count, width or depth raises.

`motr_detector_state_dict_from_jax(variables)` maps the JAX package's own
MOTRDetector (tracking/motr.py) onto the port's: its backbone, input
projections and transformer as DINO's (`dino_state_dict_from_jax`), then
`yolox_embed` and `qim.*`.

Plain Python, numpy and torch; nothing of the JAX package is imported.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from fastervit_tpu_torch.detection.convert import (_mha_state,
                                                   dino_state_dict_from_jax)
from fastervit_tpu_torch.utils.convert import (LoadResult, _leaves,
                                               load_state_dict_lenient,
                                               normalize_state_dict,
                                               state_dict_from_jax,
                                               torch_key_for_path)

_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight",
         "embedding": "weight", "mean": "running_mean",
         "var": "running_var"}
# tables flax and torch store alike, (rows, features): no transpose
_UNTRANSPOSED = ("level_embed", "query_embed.weight", "position.weight",
                 "yolox_embed.weight")
_QIM = "track_embed."
_HEADS = ("transformer.decoder.bbox_embed.", "bbox_embed.")


def motr_torch_key(parts: Tuple[str, ...]) -> Optional[str]:
    """A flax path inside MOTRTransformer (collection stripped) -> the
    torch key without prefix; None for the decoder self-attention, packed
    apart."""
    parts = list(parts)
    leaf = parts.pop()
    if not parts:
        return "level_embed" if leaf == "level_embed" else None
    p0, rest = parts[0], parts[1:]
    if p0.startswith("encoder_"):
        base = f"encoder.layers.{p0[len('encoder_'):]}."
        if rest[0] == "self_attn":
            return base + f"self_attn.{rest[1]}.{_LEAF[leaf]}"
        if rest[0] == "norm1":
            return base + f"norm1.{_LEAF[leaf]}"
        if rest[0] == "ffn":
            name = "norm2" if rest[1] == "norm" else rest[1]
            return base + f"{name}.{_LEAF[leaf]}"
    if p0.startswith("decoder_"):
        base = f"decoder.layers.{p0[len('decoder_'):]}."
        if rest[0] == "self_attn":
            return None
        if rest[0] == "cross_attn":
            return base + f"cross_attn.{rest[1]}.{_LEAF[leaf]}"
        if rest[0] in ("norm1", "norm2"):
            return base + f"{rest[0]}.{_LEAF[leaf]}"
        if rest[0] == "ffn":
            name = "norm3" if rest[1] == "norm" else rest[1]
            return base + f"{name}.{_LEAF[leaf]}"
    if p0.startswith("bbox_embed_"):
        j = rest[0][len("layer_"):]
        return (f"decoder.bbox_embed.{p0[len('bbox_embed_'):]}.layers.{j}."
                f"{_LEAF[leaf]}")
    return None


def motr_model_torch_key(parts: Tuple[str, ...]) -> Optional[str]:
    """A flax path inside MOTRDetectorExact (+ 'qim') -> upstream MOTR's
    checkpoint key; None for the attentions packed apart."""
    parts = list(parts)
    leaf = parts.pop()
    if not parts:
        return {"query_embed": "query_embed.weight",
                "position": "position.weight",
                "yolox_embed": "yolox_embed.weight"}.get(leaf)
    head = parts[0]
    if head == "backbone":
        return "backbone.0." + torch_key_for_path(tuple(parts[1:] + [leaf]))
    if head.startswith("input_proj_norm_"):
        return (f"input_proj_fastervit.{head[len('input_proj_norm_'):]}.1."
                f"{_LEAF[leaf]}")
    if head.startswith("input_proj_"):
        return (f"input_proj_fastervit.{head[len('input_proj_'):]}.0."
                f"{_LEAF[leaf]}")
    if head.startswith("class_embed_"):
        return f"class_embed.{head[len('class_embed_'):]}.{_LEAF[leaf]}"
    if head == "qim":
        rest = parts[1:]
        if rest and rest[0] == "self_attn":
            return None
        return f"{_QIM}{rest[0] if rest else leaf}.{_LEAF[leaf]}"
    if head == "transformer":
        sub = motr_torch_key(tuple(parts[1:] + [leaf]))
        return None if sub is None else "transformer." + sub
    return None


def _tensors(sd: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: v if torch.is_tensor(v)
            else torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}


def motr_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX exact detector's variables (numpy; the QIM's params under
    params['qim'], optional) -> upstream MOTR's state_dict (f32 tensors,
    num_batches_tracked 0 for every BatchNorm)."""
    params = variables["params"]
    sd: Dict[str, Any] = {}
    backbone = {coll: tree["backbone"] for coll, tree in variables.items()
                if "backbone" in tree}
    for k, v in state_dict_from_jax(backbone).items():
        sd["backbone.0." + k] = v
    dec_layers = 0
    for path, val in _leaves(variables):
        parts = path[1:]                      # the collection stripped
        if parts[0] == "backbone":
            continue
        if parts[0] == "transformer" and parts[1].startswith("decoder_"):
            dec_layers = max(dec_layers,
                             int(parts[1][len("decoder_"):]) + 1)
            if parts[2] == "self_attn":
                continue
        if parts[:2] == ("qim", "self_attn"):
            continue
        key = motr_model_torch_key(parts)
        if key is None:
            raise KeyError(f"no MOTR key for {'/'.join(path)}")
        arr = np.array(val, dtype=np.float32)
        if key == "yolox_embed.weight":
            arr = arr.reshape(1, -1)          # upstream's nn.Embedding(1, C)
        elif not key.endswith(_UNTRANSPOSED):
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
        sd[key] = arr
    for i in range(dec_layers):
        tree = params["transformer"][f"decoder_{i}"]["self_attn"]
        for k, v in _mha_state(tree).items():
            sd[f"transformer.decoder.layers.{i}.self_attn.{k}"] = v
    if "qim" in params:
        for k, v in _mha_state(params["qim"]["self_attn"]).items():
            sd[f"{_QIM}self_attn.{k}"] = v
    for key in [k for k in sd if k.startswith(_HEADS[0])]:
        sd[_HEADS[1] + key[len(_HEADS[0]):]] = sd[key]
    return _tensors(sd)


def split_motr_state_dict(sd: Mapping[str, Any]
                          ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Upstream MOTR's state_dict -> (the detector's keys, the QIM's keys
    with `track_embed.` stripped); the refinement heads under both of their
    names, from whichever the source holds."""
    det = {k: v for k, v in sd.items() if not k.startswith(_QIM)}
    qim = {k[len(_QIM):]: v for k, v in sd.items() if k.startswith(_QIM)}
    for key in list(det):
        for a, b in (_HEADS, _HEADS[::-1]):
            if key.startswith(a):
                det.setdefault(b + key[len(a):], det[key])
    return det, qim


def _misfits(module: torch.nn.Module, res: LoadResult) -> List[str]:
    """What of a lenient load says the file was built for another model:
    keys at another shape (a query count, a width), and layers of a
    ModuleList (encoder and decoder layers, per-layer heads, backbone
    blocks) that only one of the file and the model has."""
    lists = [name for name, m in module.named_modules()
             if isinstance(m, torch.nn.ModuleList)]

    def layered(key: str) -> bool:
        return any(key.startswith(p + ".")
                   and key[len(p) + 1:].split(".")[0].isdigit()
                   for p in lists)

    return ([f"{k}: {s} in the file, {t} in the model"
             for k, s, t in res.mismatched_keys]
            + [f"{k}: not in the file" for k in res.missing_keys
               if layered(k)]
            + [f"{k}: not in the model" for k in res.unexpected_keys
               if layered(k)])


def load_motr_checkpoint(model: torch.nn.Module, qim: torch.nn.Module,
                         path: str, fit: bool = False
                         ) -> Tuple[LoadResult, LoadResult]:
    """Load an upstream MOTRv2 checkpoint (.pth: a state_dict, possibly
    inside `model` or `state_dict`, possibly with `module.` prefixes) into
    the port's MOTRDetectorExact and QIMv2 (its `track_embed.*`),
    leniently: keys the file lacks or holds at another shape keep their
    values, keys neither module uses are reported and skipped, each as a
    warning. With `fit`, a file built for another model raises ValueError
    instead: a key at another shape, or a layer that only one of the file
    and the model has (`_misfits`). Returns the detector's and the QIM's
    LoadResult. The file is unpickled in full (weights_only=False), as the
    JAX package's loader does: load only files you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if not isinstance(ckpt, dict):
        raise RuntimeError(f"no state_dict found in {path}")
    det_sd, qim_sd = split_motr_state_dict(normalize_state_dict(ckpt))
    res = (load_state_dict_lenient(model, det_sd),
           load_state_dict_lenient(qim, qim_sd))
    bad = _misfits(model, res[0]) + _misfits(qim, res[1])
    if fit and bad:
        raise ValueError(
            f"{path} was built for another model ({len(bad)} misfits: "
            + "; ".join(bad[:6]) + (" ..." if len(bad) > 6 else "")
            + "): build it with the file's query count, layer counts and "
            "width (the submit CLI's --num-queries, --enc-layers, "
            "--dec-layers, --dim; upstream MOTRv2's are 10, 6, 6, 256)")
    return res


def motr_detector_state_dict_from_jax(variables: Mapping
                                      ) -> Dict[str, torch.Tensor]:
    """The JAX package's MOTRDetector variables (numpy) -> the port's
    MOTRDetector state_dict, for a strict load."""
    params = dict(variables["params"])
    qim = params.pop("qim")
    yolox = params.pop("yolox_embed", None)
    sd = dino_state_dict_from_jax({**variables, "params": params})
    if yolox is not None:
        sd["yolox_embed"] = torch.from_numpy(np.array(yolox, np.float32))
    for k, v in _mha_state(qim["self_attn"]).items():
        sd[f"qim.self_attn.{k}"] = torch.from_numpy(np.ascontiguousarray(v))
    for name, sub in (("linear1", qim["ffn"]["linear1"]),
                      ("linear2", qim["ffn"]["linear2"]),
                      ("norm1", qim["norm1"]), ("norm2", qim["ffn"]["norm"])):
        for leaf, val in sub.items():
            arr = np.array(val, np.float32)
            sd[f"qim.{name}.{_LEAF[leaf]}"] = torch.from_numpy(
                np.ascontiguousarray(arr.T if arr.ndim == 2 else arr))
    return sd
