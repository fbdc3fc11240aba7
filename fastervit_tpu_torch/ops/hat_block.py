"""The fused HAT sub-block: PyTorch port of
fastervit_tpu/ops/pallas_hat_block.py.

One pre-LN attention + MLP residual pair of a HAT block (reference
faster_vit.py:690-691), the carrier sub-block or the joint window one:

    x = x + γ3·proj(MHSA(LN1(x), bias))·dp1
    x = x + γ4·fc2(GELU(fc1(LN2(x))))·dp2

`fused_hat_block` and `fused_hat_block_dp` run it in one launch of K6, the
hand-written kernel csrc/hat_block.cu (through `cuda_hat_block`), on a CUDA
tensor, and through `hat_block_reference` on a CPU tensor; there is no
fallback from one to the other, and a shape K6 refuses raises. Only the
model's routing (`models.layers.HAT`, behind `set_fused_hat`) asks
`fused_block_supported` first and takes the composed path for a refused
shape, as the JAX model does (layers.py:619-631).

Both are autograd functions whose backward recomputes through
`hat_block_reference`, with the attention on `ops.attention.window_mhsa`
(K1 and K2 on the card), as JAX's `_bwd` and `_bwd_dp` recompute through
the reference with the Pallas attention. Gradients reach x, every entry of
the params dict, the bias and the DropPath scales dp1, dp2.

Params are the port's own layout: `hat_block_params` assembles the dict of
PARAM_ORDER from the modules, matrices as nn.Linear holds them (out, in),
cast to the compute dtype; a γ of None is ones (JAX layers.py:607-617).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from fastervit_tpu_torch.ops import cuda_hat_block
from fastervit_tpu_torch.ops.attention import (window_mhsa,
                                               window_mhsa_reference)

LN_EPS = 1e-5
PARAM_ORDER, MATRICES = cuda_hat_block.PARAM_ORDER, cuda_hat_block.MATRICES


def _ln(x32: torch.Tensor, scale: torch.Tensor,
        bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm in f32 as pallas_hat_block.py::_ln writes it."""
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + LN_EPS) * scale + bias


def _erf(x: torch.Tensor) -> torch.Tensor:
    """erf by Abramowitz-Stegun 7.1.26 (|error| < 1.5e-7), K6's erf."""
    ax = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741 + t * (
        -1.453152027 + t * 1.061405429))))
    return torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact-erf GELU with `_erf` (pallas_hat_block.py::_gelu)."""
    return 0.5 * x * (1.0 + _erf(x * 0.7071067811865476))


def _linear(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y @ wᵀ in y's dtype, then f32: JAX's `(y @ w).astype(f32)`."""
    return F.linear(y, w).float()


def hat_block_reference(x: torch.Tensor, params: Dict[str, torch.Tensor],
                        bias: torch.Tensor, num_heads: int, scale: float,
                        dp1: Optional[torch.Tensor] = None,
                        dp2: Optional[torch.Tensor] = None,
                        attn_impl: str = "kernel") -> torch.Tensor:
    """Plain version of K6, with the roundings of pallas_hat_block.py::
    hat_block_reference (:140-184): LN1 in f32; the product in x's dtype,
    then + qkv_b in f32, cast; softmax attention with f32 logits; proj, γ3
    and the dp1 row scale; the f32 residual; LN2, fc1, GELU, fc2, γ4 and
    dp2; one final cast. x: (B, S, C); bias: (H, S, S); dp1, dp2: optional
    (B,) residual-branch scales.

    attn_impl "kernel" sends the attention through `window_mhsa` (K1, or
    K3 beyond K1's limits, on the card; the plain version on the CPU),
    "plain" through `window_mhsa_reference`, K6's oracle on the card."""
    dt = x.dtype
    x32 = x.float()
    y = _ln(x32, params["ln1_scale"].float(), params["ln1_bias"].float())
    qkv = (_linear(y.to(dt), params["qkv_w"]) + params["qkv_b"].float()).to(dt)
    if attn_impl == "kernel":
        ctx = window_mhsa(qkv, bias, num_heads, scale)
    elif attn_impl == "plain":
        ctx = window_mhsa_reference(qkv, bias, num_heads, scale)
    else:
        raise ValueError(f"attn_impl {attn_impl!r}: 'kernel' or 'plain'")
    proj = _linear(ctx, params["proj_w"]) + params["proj_b"].float()
    delta = params["gamma3"].float() * proj
    if dp1 is not None:
        delta = delta * dp1.float()[:, None, None]
    x32 = x32 + delta
    y = _ln(x32, params["ln2_scale"].float(), params["ln2_bias"].float())
    h1 = _linear(y.to(dt), params["fc1_w"]) + params["fc1_b"].float()
    h1 = _gelu(h1).to(dt)
    h2 = _linear(h1, params["fc2_w"]) + params["fc2_b"].float()
    delta = params["gamma4"].float() * h2
    if dp2 is not None:
        delta = delta * dp2.float()[:, None, None]
    return (x32 + delta).to(dt)


@functools.lru_cache(maxsize=32)
def _ones(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A cached ones vector: a γ of None costs no launch a call."""
    return torch.ones(n, dtype=dtype, device=device)


def hat_block_params(norm1: nn.LayerNorm, attn: nn.Module,
                     norm2: nn.LayerNorm, mlp: nn.Module,
                     g_attn: Optional[torch.Tensor],
                     g_mlp: Optional[torch.Tensor],
                     dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The params dict of PARAM_ORDER from a sub-block's modules (the
    port's LayerNorms, WindowAttention and Mlp): the four matrices as the
    Linears hold them, (out, in), cast to `dtype`; vectors as they are; a
    γ of None ones. Differentiable back to the modules' parameters."""
    ref = norm1.weight
    if attn.qkv.bias is None:
        raise NotImplementedError("the fused HAT block needs qkv_bias")

    def gamma(g):
        return g if g is not None else _ones(ref.shape[0], ref.dtype,
                                             ref.device)

    return {"ln1_scale": norm1.weight, "ln1_bias": norm1.bias,
            "qkv_w": attn.qkv.weight.to(dtype), "qkv_b": attn.qkv.bias,
            "proj_w": attn.proj.weight.to(dtype), "proj_b": attn.proj.bias,
            "gamma3": gamma(g_attn),
            "ln2_scale": norm2.weight, "ln2_bias": norm2.bias,
            "fc1_w": mlp.fc1.weight.to(dtype), "fc1_b": mlp.fc1.bias,
            "fc2_w": mlp.fc2.weight.to(dtype), "fc2_b": mlp.fc2.bias,
            "gamma4": gamma(g_mlp)}


def fused_block_supported(x_shape: Sequence[int], c: int, hidden: int,
                          num_heads: int) -> bool:
    """Whether K6 takes a sub-block of x (B, S, C) with this MLP width and
    head count, in either dtype: S and head dim within its limits and its
    shared-memory plan within the 227 KB a block may have
    (`cuda_hat_block.plan`). Shapes it refuses take the composed path
    in the model."""
    return cuda_hat_block.unsupported(x_shape, c, hidden, num_heads) is None


def compute_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype the fused block computes in: the autocast dtype where
    autocast is on for x's device, as for F.linear, else x's."""
    dev = x.device.type
    if torch.is_autocast_enabled(dev):
        return torch.get_autocast_dtype(dev)
    return x.dtype


def _forward(x, params, bias, num_heads, scale, dp1, dp2):
    if x.device.type == "cuda":
        return cuda_hat_block.hat_block_cuda(x, params, bias, num_heads,
                                             scale, dp1, dp2)
    return hat_block_reference(x, params, bias, num_heads, scale, dp1, dp2)


class _FusedHATBlock(torch.autograd.Function):
    """K6 forward (the plain version on the CPU); the backward recomputes
    through `hat_block_reference` with the attention on `window_mhsa`.
    Inputs: x, bias, num_heads, scale, dp1, dp2 (None without DropPath),
    then the params in PARAM_ORDER."""

    @staticmethod
    def forward(ctx, x, bias, num_heads, scale, dp1, dp2, *values):
        params = dict(zip(PARAM_ORDER, values))
        ctx.save_for_backward(x, bias, dp1, dp2, *values)
        ctx.num_heads, ctx.scale = num_heads, scale
        return _forward(x, params, bias, num_heads, scale, dp1, dp2)

    @staticmethod
    def backward(ctx, g):
        x, bias, dp1, dp2, *values = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(t.is_floating_point())
                  if t is not None else None
                  for t in [x, bias, dp1, dp2] + values]
        x_, bias_, dp1_, dp2_, *vals = inputs
        with torch.enable_grad(), torch.autocast(x.device.type,
                                                 enabled=False):
            out = hat_block_reference(x_, dict(zip(PARAM_ORDER, vals)),
                                      bias_, ctx.num_heads, ctx.scale, dp1_,
                                      dp2_)
        wanted = [(i, t) for i, (t, need) in enumerate(
            zip(inputs, [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                         ctx.needs_input_grad[4], ctx.needs_input_grad[5]]
                + list(ctx.needs_input_grad[6:]))) if need and t is not None]
        grads = torch.autograd.grad(out, [t for _, t in wanted], g,
                                    allow_unused=True)
        result = [None] * len(inputs)
        for (i, _), gr in zip(wanted, grads):
            result[i] = gr
        dx, dbias, ddp1, ddp2, *dvals = result
        return (dx, dbias, None, None, ddp1, ddp2, *dvals)


def _apply(x, params, bias, num_heads, scale, dp1, dp2):
    if x.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"the fused HAT block has no path for "
                                  f"device {x.device}")
    missing = set(PARAM_ORDER) - set(params)
    if missing:
        raise KeyError(f"params lack {sorted(missing)}")
    dt = compute_dtype(x)
    values = [params[k].to(dt) if k in MATRICES else params[k]
              for k in PARAM_ORDER]
    with torch.autocast(x.device.type, enabled=False):
        return _FusedHATBlock.apply(x.to(dt).contiguous(), bias, num_heads,
                                    scale, dp1, dp2, *values)


def fused_hat_block(x: torch.Tensor, params: Dict[str, torch.Tensor],
                    bias: torch.Tensor, num_heads: int,
                    scale: float) -> torch.Tensor:
    """One HAT sub-block in one launch of K6 (pallas_hat_block.py::
    fused_hat_block). x: (B, S, C) f32 or bf16; params: PARAM_ORDER's
    dict (`hat_block_params`); bias: (H, S, S). Returns (B, S, C) in the
    compute dtype (`compute_dtype`). Differentiable."""
    return _apply(x, params, bias, num_heads, scale, None, None)


def fused_hat_block_dp(x: torch.Tensor, params: Dict[str, torch.Tensor],
                       bias: torch.Tensor, dp1: torch.Tensor,
                       dp2: torch.Tensor, num_heads: int,
                       scale: float) -> torch.Tensor:
    """`fused_hat_block` with per-row (B,) residual-branch scales, the
    DropPath-in-training entry point (pallas_hat_block.py::
    fused_hat_block_dp): K6's HAS_DP instantiation. Differentiable in dp1
    and dp2 too."""
    return _apply(x, params, bias, num_heads, scale, dp1, dp2)
