"""Bias-added window attention: the FasterViT hot path (PyTorch port of
fastervit_tpu/ops/attention.py and of the custom VJPs of
fastervit_tpu/ops/pallas_attention.py::fused_window_mhsa and
pallas_flash_attention.py::flash_window_mhsa).

Both attention sites in the model (the joint window+carrier MHSA and the
carrier-token global MHSA) are softmax(q kᵀ·scale + bias) v with a dense
per-head bias, read straight from the qkv projection output.

`window_mhsa` is the single dispatch point, through the autograd function
`WindowMHSA`; `bias_attention` is the same function on separate
(B, H, S, D) q, k and v. `attention_route` picks the forward by shape on
both devices: K1 for short windows and narrow heads, K3 for the rest. A
tensor on the CPU takes the route's plain PyTorch version, forward and
backward; a CUDA tensor takes the route's hand-written kernel in
`cuda_attention` (K1 or K3 forward, K2 backward) or raises. There is no
fallback from one to the other.
"""
from __future__ import annotations

from typing import Tuple

import torch

from fastervit_tpu_torch.ops import cuda_attention


def _split_heads(qkv: torch.Tensor, num_heads: int):
    """(B, S, 3C) -> q, k, v, each (B, H, S, hd)."""
    b, s, c3 = qkv.shape
    hd = c3 // 3 // num_heads
    return qkv.reshape(b, s, 3, num_heads, hd).permute(2, 0, 3, 1, 4).unbind(0)


def window_mhsa_reference(qkv: torch.Tensor, bias: torch.Tensor,
                          num_heads: int, scale: float) -> torch.Tensor:
    """Plain version of the window-attention kernel, with the semantics of
    fastervit_tpu/ops/pallas_attention.py::_mhsa_reference.

    qkv: (B, S, 3C), channels factored (3, H, hd); bias: (H, S, S).
    Logits and softmax are f32; the probabilities are cast to v's dtype
    before the PV product. Returns (B, S, C) in qkv's dtype."""
    b, s, c3 = qkv.shape
    q, k, v = _split_heads(qkv, num_heads)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    logits = logits + bias.float()[None]
    p = torch.softmax(logits, dim=-1)
    ctx = torch.matmul(p.to(v.dtype), v)                 # (B, H, S, hd)
    return ctx.transpose(1, 2).reshape(b, s, c3 // 3).to(qkv.dtype)


def window_mhsa_long_reference(qkv: torch.Tensor, bias: torch.Tensor,
                               num_heads: int, scale: float) -> torch.Tensor:
    """Plain version of the long-window kernel K3, with the numerics of
    fastervit_tpu/ops/pallas_flash_attention.py::_fwd_kernel: logits
    q kᵀ·scale + bias in f32, p = exp(logits - row max) in f32 and left
    unnormalised, p cast to v's dtype for the PV product, which accumulates
    in f32, then the context divided by Σp (f32). Returns (B, S, C) in
    qkv's dtype. Holds the (B, H, S, S) f32 logits, updated in place."""
    b, s, c3 = qkv.shape
    q, k, v = _split_heads(qkv, num_heads)
    p = torch.matmul(q.float(), k.float().transpose(-1, -2)).mul_(scale)
    p.add_(bias.float()[None])
    p.sub_(p.amax(-1, keepdim=True)).exp_()
    ctx = torch.matmul(p.to(v.dtype).float(), v.float())  # (B, H, S, hd)
    ctx.div_(p.sum(-1, keepdim=True))
    return ctx.transpose(1, 2).reshape(b, s, c3 // 3).to(qkv.dtype)


def attention_route(s: int, hd: int) -> str:
    """The forward kernel for windows of S tokens and head dim hd: "K1"
    (window_mhsa_cuda) within its limits, S <= 128 and hd <= 64, else "K3"
    (window_mhsa_long_cuda). The CPU takes the route's plain version."""
    if s <= cuda_attention.MAX_SEQ and hd <= cuda_attention.MAX_HEAD_DIM:
        return "K1"
    return "K3"


def window_mhsa_backward_reference(qkv: torch.Tensor, bias: torch.Tensor,
                                   g: torch.Tensor, num_heads: int,
                                   scale: float
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the window-attention backward kernel, with the
    semantics of fastervit_tpu/ops/pallas_attention.py::_mhsa_bwd_kernel:
    P recomputed in f32 (and, unlike the forward's PV product, not rounded
    to qkv's dtype), dP = g·vᵀ, dl = P∘(dP − rowsum(dP∘P)),
    dq = dl·k·scale, dk = dlᵀ·q·scale, dv = Pᵀ·g, all in f32.

    Returns dqkv (B, S, 3C) in qkv's dtype, laid out like qkv, and
    dbias (H, S, S) = Σ over windows of dl, summed in f32 and cast once to
    bias's dtype. (The TPU kernel accumulates dbias in bias's dtype; the f32
    sum here is the more exact one.)"""
    b, s, c3 = qkv.shape
    q, k, v = (t.float() for t in _split_heads(qkv, num_heads))
    gh = g.float().reshape(b, s, num_heads, -1).transpose(1, 2)  # (B,H,S,hd)
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    p = torch.softmax(logits + bias.float()[None], dim=-1)
    dp = torch.matmul(gh, v.transpose(-1, -2))
    dl = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.matmul(dl, k) * scale
    dk = torch.matmul(dl.transpose(-1, -2), q) * scale
    dv = torch.matmul(p.transpose(-1, -2), gh)
    dqkv = torch.stack([dq, dk, dv], dim=2)                 # (B, H, 3, S, hd)
    dqkv = dqkv.permute(0, 3, 2, 1, 4).reshape(b, s, c3)
    return dqkv.to(qkv.dtype), dl.sum(0).to(bias.dtype)


class WindowMHSA(torch.autograd.Function):
    """Window attention with a recomputing backward, the counterpart of
    the custom VJPs of `fused_window_mhsa` and `flash_window_mhsa`: the
    forward saves only (qkv, bias) and the backward recomputes P. Autocast
    is off inside, so the plain versions keep their f32 logits under
    torch.autocast; qkv and bias keep the dtypes they arrive in.

    On the card the backward is K2, which takes S <= 64 and hd <= 64;
    beyond that it raises, naming K4, the long-window backward that is
    not ported yet. The CPU backward takes any shape."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, bias: torch.Tensor, num_heads: int,
                scale: float) -> torch.Tensor:
        ctx.save_for_backward(qkv, bias)
        ctx.num_heads, ctx.scale = num_heads, scale
        route = attention_route(qkv.shape[1], qkv.shape[2] // 3 // num_heads)
        if qkv.device.type == "cpu":
            plain = (window_mhsa_reference if route == "K1"
                     else window_mhsa_long_reference)
            with torch.autocast("cpu", enabled=False):
                return plain(qkv, bias, num_heads, scale)
        if qkv.device.type == "cuda":
            kernel = (cuda_attention.window_mhsa_cuda if route == "K1"
                      else cuda_attention.window_mhsa_long_cuda)
            return kernel(qkv, bias, num_heads, scale)
        raise NotImplementedError(f"window attention has no path for device "
                                  f"{qkv.device}")

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        qkv, bias = ctx.saved_tensors
        g = g.contiguous()
        if qkv.device.type == "cuda":
            dqkv, dbias = cuda_attention.window_mhsa_backward_cuda(
                qkv, bias, g, ctx.num_heads, ctx.scale)
        else:
            with torch.autocast("cpu", enabled=False):
                dqkv, dbias = window_mhsa_backward_reference(
                    qkv, bias, g, ctx.num_heads, ctx.scale)
        return dqkv, dbias, None, None


def window_mhsa(qkv: torch.Tensor, bias: torch.Tensor, num_heads: int,
                scale: float) -> torch.Tensor:
    """Multi-head attention over per-window sequences, straight from the qkv
    projection. qkv: (B, S, 3C) (channel layout (3, H, hd)); bias: (H, S, S).
    Returns (B, S, C). Differentiable in qkv and bias.

    Under a bf16 qkv the K3 route streams the bias in bf16 too, as the JAX
    dispatch does (fastervit_tpu/ops/attention.py:83-84): it is the largest
    operand, and the logits are f32 either way."""
    if (qkv.dtype == torch.bfloat16
            and attention_route(qkv.shape[1],
                                qkv.shape[2] // 3 // num_heads) == "K3"):
        bias = bias.to(torch.bfloat16)
    return WindowMHSA.apply(qkv, bias, num_heads, scale)


def bias_attention_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, bias: torch.Tensor,
                             scale: float) -> torch.Tensor:
    """Plain softmax(q kᵀ·scale + bias) v on (B, H, S, D) q, k, v and an
    (H, S, S) bias, in the inputs' dtypes (fastervit_tpu/ops/attention.py::
    bias_attention_reference without its attention dropout, which the port
    does not take). Materialises the (B, H, S, S) logits."""
    attn = torch.matmul(q, k.transpose(-1, -2)) * scale + bias[None]
    return torch.matmul(torch.softmax(attn, dim=-1), v)


def bias_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: torch.Tensor, scale: float) -> torch.Tensor:
    """softmax(q kᵀ·scale + bias) v on (B, H, S, D) q, k, v and an (H, S, S)
    bias, through `window_mhsa` and so its route: q, k and v are packed into
    the (B, S, 3HD) qkv layout first. Returns (B, H, S, D); differentiable."""
    b, h, s, d = q.shape
    qkv = torch.stack([q, k, v], dim=0).permute(1, 3, 0, 2, 4)
    out = window_mhsa(qkv.reshape(b, s, 3 * h * d), bias, h, scale)
    return out.reshape(b, s, h, d).transpose(1, 2)
