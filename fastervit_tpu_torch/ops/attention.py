"""Bias-added window attention: the FasterViT hot path (PyTorch port of
fastervit_tpu/ops/attention.py).

Both attention sites in the model (the joint window+carrier MHSA and the
carrier-token global MHSA) are softmax(q kᵀ·scale + bias) v with a dense
per-head bias, read straight from the qkv projection output.

`window_mhsa` is the single dispatch point. A tensor on the CPU takes the
plain PyTorch version below; a CUDA tensor takes the hand-written kernel in
`cuda_attention` or raises. There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from fastervit_tpu_torch.ops import cuda_attention


def window_mhsa_reference(qkv: torch.Tensor, bias: torch.Tensor,
                          num_heads: int, scale: float) -> torch.Tensor:
    """Plain version of the window-attention kernel, with the semantics of
    fastervit_tpu/ops/pallas_attention.py::_mhsa_reference.

    qkv: (B, S, 3C), channels factored (3, H, hd); bias: (H, S, S).
    Logits and softmax are f32; the probabilities are cast to v's dtype
    before the PV product. Returns (B, S, C) in qkv's dtype."""
    b, s, c3 = qkv.shape
    hd = c3 // 3 // num_heads
    q, k, v = qkv.reshape(b, s, 3, num_heads, hd).permute(2, 0, 3, 1, 4).unbind(0)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    logits = logits + bias.float()[None]
    p = torch.softmax(logits, dim=-1)
    ctx = torch.matmul(p.to(v.dtype), v)                 # (B, H, S, hd)
    return ctx.transpose(1, 2).reshape(b, s, c3 // 3).to(qkv.dtype)


def window_mhsa(qkv: torch.Tensor, bias: torch.Tensor, num_heads: int,
                scale: float) -> torch.Tensor:
    """Multi-head attention over per-window sequences, straight from the qkv
    projection. qkv: (B, S, 3C) (channel layout (3, H, hd)); bias: (H, S, S).
    Returns (B, S, C)."""
    if qkv.device.type == "cpu":
        return window_mhsa_reference(qkv, bias, num_heads, scale)
    if qkv.device.type == "cuda":
        return cuda_attention.window_mhsa_cuda(qkv, bias, num_heads, scale)
    raise NotImplementedError(f"window attention has no path for device "
                              f"{qkv.device}")
