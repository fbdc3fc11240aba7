"""DINO weights for the port: JAX variables across, and reference
checkpoints in.

`dino_state_dict_from_jax(variables)` takes fastervit_tpu.detection's
DINODetector variables as a nested mapping of numpy arrays and returns a
state_dict that the port's DINODetector loads with `strict=True`. It is the
inverse of fastervit_tpu/detection/convert.py (`dino_torch_key`,
`_mha_getter`): flax's per-head query/key/value kernels of the decoder
self-attention are packed into nn.MultiheadAttention's in_proj_weight, and
the shared decoder heads are written under every name the port's (and
upstream's) module tree lists them: `transformer.decoder.{bbox,class}_embed.
{i}` and `{bbox,class}_embed.{i}` for each decoder layer i; so is the
denoising label embedding, JAX's `transformer/label_enc`, whose variables
a JAX init with dn queries holds: `label_enc.weight` (upstream's name) and
`transformer.label_enc.weight`, untransposed.

`load_dino_checkpoint(model, path)` loads a reference DINO checkpoint,
whose keys are the port's own, with the leniency of the JAX package's
`convert_dino_state_dict`: keys the file lacks or holds at another shape
keep their values, with a warning. The shared heads and the label
embedding load from whichever of their names the file has.

Plain Python, numpy and torch; nothing of the JAX package is imported.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from fastervit_tpu_torch.utils.convert import (LoadResult, _leaves,
                                               load_state_dict_lenient,
                                               normalize_state_dict,
                                               torch_key_for_path)

_LEAF_NAME = {"kernel": "weight", "scale": "weight", "bias": "bias",
              "embedding": "weight", "mean": "running_mean",
              "var": "running_var"}
_SHARED_HEADS = ("bbox_embed", "class_embed")
# tables flax and torch store alike, (rows, features): no transpose
_UNTRANSPOSED = ("level_embed", "tgt_embed.weight", "label_enc.weight")


def dino_torch_key(parts: Tuple[str, ...]) -> Optional[str]:
    """A flax variable path inside DINODetector (collection stripped) -> the
    port's (and upstream DINO's) state_dict key, as fastervit_tpu/detection/
    convert.py::dino_torch_key maps it; the shared heads map to their
    `transformer.decoder.*.0` name. None for the decoder self-attention,
    which `dino_state_dict_from_jax` packs itself."""
    parts = list(parts)
    leaf = parts.pop()
    name = _LEAF_NAME.get(leaf)
    if not parts:
        return None
    head = parts[0]
    if head == "backbone":
        return "backbone.0." + torch_key_for_path(tuple(parts[1:] + [leaf]))
    for prefix, sub in (("input_proj_norm_", "1"), ("input_proj_", "0")):
        if head.startswith(prefix):
            return f"input_proj.{head[len(prefix):]}.{sub}.{name}"
    if head != "transformer":
        return None
    parts = parts[1:]
    if not parts:
        return {"level_embed": "transformer.level_embed",
                "tgt_embed": "transformer.tgt_embed.weight"}.get(leaf)
    p0, rest = parts[0], parts[1:]
    if p0 == "label_enc":
        return f"label_enc.{name}"
    if p0.startswith("encoder_"):
        base = f"transformer.encoder.layers.{p0[len('encoder_'):]}."
        if rest[0] == "self_attn":
            return base + f"self_attn.{rest[1]}.{name}"
        if rest[0] == "ffn":
            return base + f"{'norm2' if rest[1] == 'norm' else rest[1]}.{name}"
        return base + f"{rest[0]}.{name}"
    if p0.startswith("decoder_"):
        base = f"transformer.decoder.layers.{p0[len('decoder_'):]}."
        if rest[0] == "self_attn":
            return None
        if rest[0] == "cross_attn":
            return base + f"cross_attn.{rest[1]}.{name}"
        if rest[0] == "ffn":
            return base + f"{'norm3' if rest[1] == 'norm' else rest[1]}.{name}"
        return base + f"{rest[0]}.{name}"
    layer = lambda: rest[0][len("layer_"):]                    # noqa: E731
    if p0 == "ref_point_head":
        return f"transformer.decoder.ref_point_head.layers.{layer()}.{name}"
    if p0 == "dec_norm":
        return f"transformer.decoder.norm.{name}"
    if p0 == "bbox_embed":
        return f"transformer.decoder.bbox_embed.0.layers.{layer()}.{name}"
    if p0 == "class_embed":
        return f"transformer.decoder.class_embed.0.{name}"
    if p0 == "enc_out_bbox_embed":
        return f"transformer.enc_out_bbox_embed.layers.{layer()}.{name}"
    if p0 in ("enc_output", "enc_output_norm", "enc_out_class_embed"):
        return f"transformer.{p0}.{name}"
    return None


def _mha_state(tree: Mapping[str, Mapping[str, np.ndarray]]
               ) -> Dict[str, np.ndarray]:
    """flax MultiHeadDotProductAttention's {query, key, value, out} ->
    nn.MultiheadAttention's in_proj_weight (3C, C), in_proj_bias (3C,),
    out_proj.weight (C, C) and out_proj.bias (the inverse of fastervit_tpu's
    `_mha_getter`)."""
    def kernel(which):
        k = np.asarray(tree[which]["kernel"], np.float32)  # (C, H, hd)
        return k.reshape(k.shape[0], -1).T

    out = np.asarray(tree["out"]["kernel"], np.float32)    # (H, hd, C)
    return {
        "in_proj_weight": np.concatenate([kernel(w) for w in
                                          ("query", "key", "value")], 0),
        "in_proj_bias": np.concatenate([
            np.asarray(tree[w]["bias"], np.float32).reshape(-1)
            for w in ("query", "key", "value")], 0),
        "out_proj.weight": out.reshape(-1, out.shape[-1]).T,
        "out_proj.bias": np.asarray(tree["out"]["bias"], np.float32)}


def dino_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} of a fastervit_tpu DINODetector,
    as numpy arrays -> the port's state_dict (f32 tensors, plus
    num_batches_tracked 0 for every BatchNorm), for a strict load."""
    sd: Dict[str, np.ndarray] = {}
    dec_layers = 0
    for path, val in _leaves(variables):
        parts = path[1:]  # drop the collection name
        if (len(parts) > 2 and parts[0] == "transformer"
                and parts[1].startswith("decoder_")):
            dec_layers = max(dec_layers,
                             int(parts[1][len("decoder_"):]) + 1)
            if parts[2] == "self_attn":
                continue
        key = dino_torch_key(parts)
        if key is None:
            raise KeyError(f"no port key for {'/'.join(path)}")
        arr = np.array(val, dtype=np.float32)
        if key == "label_enc.weight":
            # the transformer's module, under its own name too
            sd["transformer.label_enc.weight"] = arr
        if not key.endswith(_UNTRANSPOSED):
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
        sd[key] = arr
        if "global_tokenizer.to_global_feature.pos." in key:
            # upstream registers the tokenizer conv under two names
            sd[key.replace("to_global_feature.pos", "pos_embed")] = arr
        if key.endswith(".running_mean"):
            sd[key[:-len("running_mean")] + "num_batches_tracked"] = None
    for i in range(dec_layers):
        tree = variables["params"]["transformer"][f"decoder_{i}"]["self_attn"]
        for k, v in _mha_state(tree).items():
            sd[f"transformer.decoder.layers.{i}.self_attn.{k}"] = v
    for key in [k for k in sd if re.match(
            r"transformer\.decoder\.(bbox|class)_embed\.0\.", k)]:
        for i in range(dec_layers):
            for prefix in ("transformer.decoder.", ""):
                sd[prefix + key[len("transformer.decoder."):].replace(
                    ".0.", f".{i}.", 1)] = sd[key]
    return {k: (torch.tensor(0, dtype=torch.long) if v is None
                else torch.from_numpy(np.ascontiguousarray(v)))
            for k, v in sd.items()}


def _fill_shared_heads(model: torch.nn.Module,
                       sd: Dict[str, Any]) -> Dict[str, Any]:
    """`sd` with every name of the model's shared decoder heads filled from
    whichever of them `sd` holds (its transformer.decoder.*.0 name first,
    as the JAX converter reads it, then the top-level one, then any other
    layer's copy), and the label embedding's transformer name from
    upstream's top-level `label_enc.weight`."""
    sd = dict(sd)
    own = model.state_dict()
    if "transformer.label_enc.weight" in own and "label_enc.weight" in sd:
        sd.setdefault("transformer.label_enc.weight", sd["label_enc.weight"])
    pattern = re.compile(r"^(transformer\.decoder\.)?(bbox_embed|class_embed)"
                         r"\.(\d+)\.(.+)$")
    found: Dict[Tuple[str, str], Any] = {}
    order = sorted((k for k in sd if pattern.match(k)),
                   key=lambda k: (pattern.match(k).group(3) != "0",
                                  not k.startswith("transformer."),
                                  int(pattern.match(k).group(3))))
    for k in order:
        m = pattern.match(k)
        found.setdefault((m.group(2), m.group(4)), sd[k])
    for k in own:
        m = pattern.match(k)
        if m and k not in sd and (m.group(2), m.group(4)) in found:
            sd[k] = found[(m.group(2), m.group(4))]
    return sd


def load_dino_checkpoint(model: torch.nn.Module, path: str) -> LoadResult:
    """Load a reference DINO checkpoint (.pth: a state_dict, possibly
    inside `model` or `state_dict`, possibly with `module.` prefixes) into
    the port's DINODetector, leniently (`utils.convert.
    load_state_dict_lenient`): keys the file lacks or holds at another
    shape keep their values, with a warning, and keys the model has no
    use for are reported and skipped, as fastervit_tpu's
    convert_dino_state_dict does. Upstream's denoising label embedding
    `label_enc.weight` loads into a detector built with dn_labelbook_size
    (both of its names) and is reported and skipped by one without. The
    file is unpickled in full (weights_only=False), as the JAX package's
    loader does: load only files you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if not isinstance(ckpt, dict):
        raise RuntimeError(f"no state_dict found in {path}")
    sd = normalize_state_dict(ckpt)
    return load_state_dict_lenient(model, _fill_shared_heads(model, sd))
