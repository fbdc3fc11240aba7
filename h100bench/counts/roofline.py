"""The card's peaks and the least time of a window-attention call.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at the full
700 W power limit. The attention counts are those `chip_smoke.py` uses for
K1-K4 (its `bound_ms` and the byte and operation counts of its K1-K4
phases), kept here unchanged so that the yardstick does not move with the
program: every input byte read once and every output byte written once,
the (H, S, S) bias read once a call whatever the number of windows.
"""
from __future__ import annotations

from typing import Tuple

BF16_FLOP_PER_S = 989e12     # dense bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12    # HBM3 bandwidth


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: bytes over the memory rate or
    operations over the bf16 peak, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)


def attention_forward(windows: int, s: int, heads: int, head_dim: int,
                      itemsize: int = 2) -> Tuple[float, float]:
    """(bytes, operations) of softmax(q kᵀ·scale + bias) v over `windows`
    windows of s tokens (K1, K3): qkv read, the context written, the bias
    read; q kᵀ and p v at two operations a multiply-add."""
    c = heads * head_dim
    nbytes = itemsize * (windows * s * 3 * c + windows * s * c
                         + heads * s * s)
    flops = 4.0 * windows * heads * s * s * head_dim
    return nbytes, flops


def attention_backward(windows: int, s: int, heads: int, head_dim: int,
                       itemsize: int = 2) -> Tuple[float, float]:
    """(bytes, operations) of the attention's backward (K2, K4): qkv read
    and dqkv written, the output gradient read, the bias read and dbias
    written; q kᵀ recomputed, dp = g vᵀ, dq, dk and dv."""
    c = heads * head_dim
    nbytes = itemsize * (2 * windows * s * 3 * c + windows * s * c
                         + 2 * heads * s * s)
    flops = 10.0 * windows * heads * s * s * head_dim
    return nbytes, flops


def forward_bound_s(calls) -> float:
    """Summed least time of (windows, S, heads, head dim, count) calls."""
    return sum(n * bound_s(*attention_forward(b, s, h, d))
               for b, s, h, d, n in calls)


def backward_bound_s(calls) -> float:
    return sum(n * bound_s(*attention_backward(b, s, h, d))
               for b, s, h, d, n in calls)
