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

`load_checkpoint(model, path)` loads a reference checkpoint (.pth.tar) with
the leniency of fastervit_tpu/utils/convert.py's `load_pytorch_checkpoint`:
containers unwrapped, DDP and encoder prefixes stripped, missing and
shape-mismatched keys kept at their initial values with a warning. That is
what lets a 21k-class checkpoint warm-start a model with another head, and
an any-res model start from 224² weights.

Layout transforms:
  flax Dense kernel (in, out)        -> torch Linear weight (out, in)
  flax Conv kernel  (kh, kw, I/g, O) -> torch Conv2d weight (O, I/g, kh, kw)
  flax scale / mean / var            -> weight / running_mean / running_var
"""
from __future__ import annotations

import logging
from typing import Any, Dict, Iterator, List, Mapping, NamedTuple, Tuple

import numpy as np
import torch

from fastervit_tpu_torch.models.layers import is_bakeable

# flax module names whose fc1/fc2 children are torch cpb_mlp Sequentials
_CPB_PARENTS = {"pos_embed", "hat_pos_embed", "pos_emb_funct"}
# patch_embed child -> index in the torch conv_down Sequential
_PATCH_EMBED_IDX = {"conv1": "0", "norm1": "1", "conv2": "3", "norm2": "4"}
_LEAF_NAME = {"kernel": "weight", "scale": "weight", "bias": "bias",
              "mean": "running_mean", "var": "running_var",
              "kernel_q": "weight_q", "kernel_scale": "weight_scale"}
# the two names upstream registers the carrier-token tokenizer's conv under
_TOKENIZER_NAMES = ("to_global_feature.pos", "pos_embed")
# buffers rebuilt from the config, never read from a checkpoint
_CONSTANT_TABLES = ("relative_coords_table", "relative_position_index",
                    "relative_bias")

log = logging.getLogger(__name__)


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
        elif p.startswith("norm_") and p[len("norm_"):].isdigit():
            # a pyramid's per-level norms: norm_0 -> norm0
            out.append("norm" + p[len("norm_"):])
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
        # a writable copy; int8 weights (quantize_variables) stay int8
        arr = np.array(val, dtype=np.int8 if path[-1] == "kernel_q"
                       else np.float32)
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


def quantized_state_dict_from_jax(variables: Mapping
                                  ) -> Dict[str, torch.Tensor]:
    """The variables of JAX `quantize_variables` (numpy) -> the state_dict
    of the port's int8 model (`create_model(..., quantized=True)`), which
    it loads with `strict=True`: each `kernel_q` (int8, (I, O) or HWIO) to
    `weight_q` in the port's layout ((O, I); (O, I, kh, kw)), each
    `kernel_scale` to `weight_scale` (f32), the rest as
    `state_dict_from_jax` maps it. Raises ValueError on variables that
    hold no int8 kernel."""
    if not any(path[-1] == "kernel_q" for path, _ in _leaves(variables)):
        raise ValueError("no kernel_q in the variables: quantise them with "
                         "the JAX package's quantize_variables first")
    return state_dict_from_jax(variables)


_HAT_MATRICES = ("qkv_w", "proj_w", "fc1_w", "fc2_w")


def hat_params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The params dict of the JAX package's `fused_hat_block` (numpy; Dense
    kernels as (in, out)) -> the port's (ops.hat_block.PARAM_ORDER; the
    matrices as nn.Linear holds them, (out, in)), each in its own dtype."""
    out = {}
    for key, val in params.items():
        arr = np.asarray(val)
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.astype(np.float32)).bfloat16()
        else:
            t = torch.from_numpy(np.array(arr))
        out[key] = t.T.contiguous() if key in _HAT_MATRICES else t
    return out


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
    modules that deploy mode bakes (not a pyramid's dynamic-mode ones).
    Returns the model."""
    want = {f"{name}.relative_bias" for name, m in model.named_modules()
            if is_bakeable(m)}
    if set(baked) != want:
        raise KeyError(f"baked tensors missing {sorted(want - set(baked))}, "
                       f"unexpected {sorted(set(baked) - want)}")
    for key, tensor in baked.items():
        module = model.get_submodule(key[:-len(".relative_bias")])
        ref = module.cpb_mlp[0].weight
        module.relative_bias = tensor.to(device=ref.device, dtype=ref.dtype)
    return model


def normalize_state_dict(ckpt: Mapping[str, Any], use_ema: bool = False
                         ) -> Dict[str, Any]:
    """Unwrap a checkpoint container (`state_dict_ema` with use_ema, then
    `state_dict`, then `model`) and strip the DDP `module.` and the
    detection backbones' `encoder.` prefixes (reference faster_vit.py:
    193-208, registry.py:161-181; fastervit_tpu/utils/convert.py)."""
    sd = ckpt
    if not hasattr(next(iter(ckpt.values()), None), "shape"):
        for key in (("state_dict_ema",) if use_ema else ()) + ("state_dict",
                                                               "model"):
            if key in ckpt:
                sd = ckpt[key]
                break
    sd = dict(sd)
    if next(iter(sd), "").startswith("module."):
        sd = {k[len("module."):]: v for k, v in sd.items()}
    if sorted(sd)[0].startswith("encoder."):
        sd = {k[len("encoder."):]: v for k, v in sd.items()
              if k.startswith("encoder.")}
    return sd


def _aliases(key: str) -> List[str]:
    """`key` and, for the tokenizer's conv, its other upstream name."""
    for a, b in (_TOKENIZER_NAMES, _TOKENIZER_NAMES[::-1]):
        if f"global_tokenizer.{a}." in key:
            return [key, key.replace(f"global_tokenizer.{a}.",
                                     f"global_tokenizer.{b}.")]
    return [key]


class LoadResult(NamedTuple):
    """What `load_state_dict_lenient` did, as torch's load_state_dict
    reports it: the model's keys the source lacks and the source's keys the
    model has no use for, plus the keys kept at init for their shape as
    (key, source shape, model shape)."""
    missing_keys: List[str]
    mismatched_keys: List[Tuple[str, Tuple[int, ...], Tuple[int, ...]]]
    unexpected_keys: List[str]


@torch.no_grad()
def load_state_dict_lenient(model: torch.nn.Module,
                            state_dict: Mapping[str, Any]) -> LoadResult:
    """Copy every entry of `state_dict` whose key and shape match the
    model's into it, cast to the model's dtype, on its device. The model's
    keys that the source lacks (BatchNorm's num_batches_tracked aside) or
    holds at another shape keep their values; the tokenizer's conv loads
    from either of its names. Each list of the result is logged as a
    warning, as fastervit_tpu/utils/convert.py::convert_state_dict does;
    unexpected keys leave out num_batches_tracked and the constant tables."""
    own = model.state_dict(keep_vars=True)
    used, missing, mismatched = set(), [], []
    for key, target in own.items():
        src = next((k for k in _aliases(key) if k in state_dict), None)
        if src is None:
            if not key.endswith("num_batches_tracked"):
                missing.append(key)
            continue
        used.update(_aliases(src))
        value = state_dict[src]
        if not torch.is_tensor(value):
            value = torch.from_numpy(np.asarray(value))
        if tuple(value.shape) != tuple(target.shape):
            mismatched.append((key, tuple(value.shape), tuple(target.shape)))
            continue
        target.copy_(value.to(target.dtype))
    unexpected = [k for k in state_dict if k not in used
                  and "num_batches_tracked" not in k
                  and not k.endswith(_CONSTANT_TABLES)]
    if missing:
        log.warning("missing keys in source state_dict: %s",
                    ", ".join(missing))
    if mismatched:
        log.warning("shape-mismatched keys kept at init: %s",
                    ", ".join(f"{k} {s}->{t}" for k, s, t in mismatched))
    if unexpected:
        log.warning("unexpected keys in source state_dict: %s",
                    ", ".join(unexpected))
    return LoadResult(missing, mismatched, unexpected)


def load_checkpoint(model: torch.nn.Module, path: str,
                    use_ema: bool = False) -> LoadResult:
    """Load a reference checkpoint file (.pth.tar: a state_dict, possibly
    inside `state_dict`/`state_dict_ema`/`model`, possibly with `module.`
    or `encoder.` prefixes) into `model`, leniently
    (`load_state_dict_lenient`). The file is unpickled in full
    (weights_only=False), as the JAX package's loader does, since reference
    checkpoints hold the training arguments beside the weights: load only
    files you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if not isinstance(ckpt, dict):
        raise RuntimeError(f"no state_dict found in {path}")
    return load_state_dict_lenient(model,
                                   normalize_state_dict(ckpt, use_ema=use_ema))


def main(argv=None) -> None:
    """CLI: convert a reference .pth.tar into the port's weights file
    (JAX convert.py's `main`, which writes an orbax tree; here
    `utils.checkpoint.save_variables`, which `restore_variables` reads).

        python -m fastervit_tpu_torch.utils.convert \\
            --model faster_vit_0_224 --checkpoint fv0.pth.tar --out fv0.pt

    The checkpoint is unwrapped and its prefixes stripped
    (`normalize_state_dict`, `--use-ema` for its EMA weights), its constant
    tables (which the model rebuilds from its config) left out, and the
    rest loaded strictly: a key missing or to spare, or a shape that
    differs, raises. The model is built on the CPU."""
    import argparse

    from fastervit_tpu_torch.models.registry import create_model
    from fastervit_tpu_torch.utils.checkpoint import save_variables

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--model", required=True)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--use-ema", action="store_true")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    model = create_model(args.model, device="cpu")
    ckpt = torch.load(args.checkpoint, map_location="cpu", weights_only=False)
    if not isinstance(ckpt, dict):
        raise RuntimeError(f"no state_dict found in {args.checkpoint}")
    sd = {k: v for k, v in normalize_state_dict(ckpt, args.use_ema).items()
          if not k.endswith(_CONSTANT_TABLES)}
    model.load_state_dict(sd, strict=True)
    save_variables(args.out, model)
    print(f"converted {args.checkpoint} -> {args.out}")


if __name__ == "__main__":
    main()
