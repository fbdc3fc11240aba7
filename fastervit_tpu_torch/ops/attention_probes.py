"""The long-window attention probes' two functions, with their dispatch: the
PyTorch counterparts of the kernels of scripts/attn_online_probe.py
(`_online_kernel`, P1) and scripts/attn_vpu_probe.py (`_nobias_kernel`, P2).

Both are softmax(q kᵀ·scale [+ bias]) v on (B, H, S, hd) q, k and v:

- `online_attention` splits each key row into C chunks of S/C keys and
  keeps a running (max, sum, context) that is rescaled once a chunk; each
  chunk's p is taken against the running max after that chunk. Its bias is
  (H, S, S), f32 or bf16.
- `nobias_attention` takes the whole row at once and has no bias operand.

A tensor on the CPU takes the plain version here; a CUDA tensor takes the
hand-written kernel in `cuda_attention` (P1: csrc/attn_online.cu; P2: K3's
kernel without its bias, csrc/window_mhsa_long.cu) or raises. There is no
fallback from one to the other, and no gradient: inputs that require one
raise. A chunk count that does not divide S raises, where the TPU probe
drops the last S mod C keys. q, k and v may be separate (B, H, S, hd)
tensors or `qkv_views` of K3's packed qkv; the output keeps q's order of
axes.
"""
from __future__ import annotations

import torch

from fastervit_tpu_torch.ops import cuda_attention
from fastervit_tpu_torch.ops.cuda_attention import check_chunks


def online_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, bias: torch.Tensor,
                               scale: float, chunks: int) -> torch.Tensor:
    """Plain version of P1, in the order of roundings of
    scripts/attn_online_probe.py::_online_kernel: q in f32; per chunk the
    logits q·k_iᵀ in f32, times scale, plus the chunk's bias in f32;
    m_new = max(m, chunk row max), α = exp(m − m_new), p = exp(logits −
    m_new) in f32; den = den·α + Σp of the unrounded p; ctx = ctx·α +
    p (cast to v's dtype)·v, accumulated in f32; out = ctx / den in q's
    dtype. q, k, v: (B, H, S, hd); bias: (H, S, S). Holds one chunk's
    (B, H, S, S/C) f32 logits."""
    s = q.shape[2]
    check_chunks(s, chunks)
    cs = s // chunks
    qf = q.float()
    m = den = ctx = None
    for i in range(chunks):
        keys = slice(i * cs, (i + 1) * cs)
        logits = torch.matmul(qf, k[:, :, keys].float().transpose(-1, -2))
        logits.mul_(scale).add_(bias[:, :, keys].float()[None])
        m_new = logits.amax(-1, keepdim=True)
        if m is not None:
            m_new = torch.maximum(m, m_new)
        p = logits.sub_(m_new).exp_()
        pv = torch.matmul(p.to(v.dtype).float(), v[:, :, keys].float())
        if m is None:
            den, ctx = p.sum(-1, keepdim=True), pv
        else:
            alpha = torch.exp(m - m_new)
            den = den * alpha + p.sum(-1, keepdim=True)
            ctx = ctx * alpha + pv
        m = m_new
    return (ctx / den).to(q.dtype)


def nobias_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain version of P2, in the order of roundings of
    scripts/attn_vpu_probe.py's `_nobias_kernel`: logits q·kᵀ in f32 times
    scale; p = exp(logits − row max) in f32; the PV product of p cast to
    v's dtype, accumulated in f32; divided by the f32 sum of the unrounded
    p; out in q's dtype. q, k, v: (B, H, S, hd). Holds the (B, H, S, S) f32
    logits."""
    p = torch.matmul(q.float(), k.float().transpose(-1, -2)).mul_(scale)
    p.sub_(p.amax(-1, keepdim=True)).exp_()
    ctx = torch.matmul(p.to(v.dtype).float(), v.float())
    return ctx.div_(p.sum(-1, keepdim=True)).to(q.dtype)


def input_device(what: str, *tensors: torch.Tensor) -> str:
    """The one device type of the tensors; raise on a gradient or on
    tensors spread over devices."""
    if any(t.requires_grad for t in tensors):
        raise ValueError(f"{what} has no gradient: pass inputs that do not "
                         "require one")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{what}: inputs must be on one device, got "
                         f"{sorted(map(str, devices))}")
    return devices.pop().type


def online_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, scale: float,
                     chunks: int) -> torch.Tensor:
    """softmax(q kᵀ·scale + bias) v with the key row taken in `chunks`
    chunks (P1). q, k, v: (B, H, S, hd) f32 or bf16; bias (H, S, S) f32 or
    bf16; chunks divides S. Returns (B, H, S, hd) in q's dtype."""
    device = input_device("online_attention", q, k, v, bias)
    if device == "cpu":
        return online_attention_reference(q, k, v, bias, scale, chunks)
    if device == "cuda":
        return cuda_attention.online_attention_cuda(q, k, v, bias, scale,
                                                    chunks)
    raise NotImplementedError(f"online_attention has no path for device "
                              f"{device}")


def nobias_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """softmax(q kᵀ·scale) v with no bias (P2). q, k, v: (B, H, S, hd) f32
    or bf16. Returns (B, H, S, hd) in q's dtype."""
    device = input_device("nobias_attention", q, k, v)
    if device == "cpu":
        return nobias_attention_reference(q, k, v, scale)
    if device == "cuda":
        return cuda_attention.nobias_attention_cuda(q, k, v, scale)
    raise NotImplementedError(f"nobias_attention has no path for device "
                              f"{device}")


def pack_qkv(q: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor) -> torch.Tensor:
    """(B, H, S, hd) q, k, v -> the (B, S, 3·H·hd) qkv layout, channels
    (3, H, hd), that the window-attention kernels (K1, K3) read."""
    b, h, s, d = q.shape
    return torch.stack((q, k, v)).permute(1, 3, 0, 2, 4).reshape(
        b, s, 3 * h * d)


def qkv_views(qkv: torch.Tensor, heads: int):
    """Views (B, H, S, hd) of q, k and v in the packed (B, S, 3·H·hd) qkv,
    channels (3, H, hd), that K3 reads; no copy."""
    b, s, c3 = qkv.shape
    return qkv.view(b, s, 3, heads, c3 // 3 // heads).permute(
        2, 0, 3, 1, 4).unbind(0)

