"""Bias-added window attention: the FasterViT hot path (PyTorch port of
fastervit_tpu/ops/attention.py and of the custom VJP of
fastervit_tpu/ops/pallas_attention.py::fused_window_mhsa).

Both attention sites in the model (the joint window+carrier MHSA and the
carrier-token global MHSA) are softmax(q kᵀ·scale + bias) v with a dense
per-head bias, read straight from the qkv projection output.

`window_mhsa` is the single dispatch point, through the autograd function
`WindowMHSA`. A tensor on the CPU takes the plain PyTorch versions below,
forward and backward; a CUDA tensor takes the hand-written kernels in
`cuda_attention` (K1 forward, K2 backward) or raises. There is no fallback
from one to the other.
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
    `fused_window_mhsa`'s custom VJP: the forward saves only (qkv, bias)
    and the backward recomputes P. Autocast is off inside, so the plain
    versions keep their f32 logits under torch.autocast; qkv and bias keep
    the dtypes they arrive in."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, bias: torch.Tensor, num_heads: int,
                scale: float) -> torch.Tensor:
        ctx.save_for_backward(qkv, bias)
        ctx.num_heads, ctx.scale = num_heads, scale
        if qkv.device.type == "cpu":
            with torch.autocast("cpu", enabled=False):
                return window_mhsa_reference(qkv, bias, num_heads, scale)
        if qkv.device.type == "cuda":
            return cuda_attention.window_mhsa_cuda(qkv, bias, num_heads, scale)
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
    Returns (B, S, C). Differentiable in qkv and bias."""
    return WindowMHSA.apply(qkv, bias, num_heads, scale)
