"""Binding and launch of K5, the hand-written multi-scale deformable
attention forward (csrc/msda_fwd.cu), the Hopper counterpart of
fastervit_tpu/ops/msda_pallas.py::fused_bilinear_gather.

The kernel is built with K1-K4 into one library by `cuda_attention.build()`
and loaded by its `_library()`. A failed build, an unsupported shape or
dtype, an input that needs a gradient, or a failed launch raises; nothing
falls back to the plain version (`ops.msda.msda_reference`). The module
imports on a machine with no nvcc and no card.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch

from fastervit_tpu_torch.ops import cuda_attention

MAX_CHANNELS = 64   # kMaxChannels in csrc/msda_fwd.cu
_WARPS_PER_BLOCK = 8  # kWarps in csrc/msda_fwd.cu
_DTYPES = (torch.float32, torch.bfloat16)


def check_supported(value_shape: Sequence[int], shapes: Tuple,
                    loc_shape: Sequence[int],
                    weights_shape: Sequence[int]) -> None:
    """Raise unless K5 takes these shapes: value (N, S, M, D) with
    D <= MAX_CHANNELS and S = Σ H·W over `shapes`, loc (N, Q, M, L, P, 2)
    and weights (N, Q, M, L, P) with L = len(shapes), and a grid CUDA can
    launch (one warp per (n, q, m), eight to a block)."""
    if len(value_shape) != 4:
        raise ValueError(f"value must be (N, S, M, D), got "
                         f"{tuple(value_shape)}")
    n, s, m, d = value_shape
    if not shapes or any(h <= 0 or w <= 0 for h, w in shapes):
        raise ValueError(f"spatial shapes must be positive (H, W) pairs, "
                         f"got {shapes}")
    if sum(h * w for h, w in shapes) != s:
        raise ValueError(f"spatial shapes {shapes} cover "
                         f"{sum(h * w for h, w in shapes)} tokens, value "
                         f"has {s}")
    if len(loc_shape) != 6 or loc_shape[-1] != 2:
        raise ValueError(f"sampling locations must be (N, Q, M, L, P, 2), "
                         f"got {tuple(loc_shape)}")
    q, p = loc_shape[1], loc_shape[4]
    want = (n, q, m, len(shapes), p)
    if tuple(loc_shape[:5]) != want or tuple(weights_shape) != want:
        raise ValueError(f"sampling locations {tuple(loc_shape)} and "
                         f"attention weights {tuple(weights_shape)} must be "
                         f"{want + (2,)} and {want}")
    if d > MAX_CHANNELS or d <= 0:
        raise NotImplementedError(f"K5 (ms_deform_attn_cuda) takes 1 to "
                                  f"{MAX_CHANNELS} channels a head, got {d}")
    if -(-n * q * m // _WARPS_PER_BLOCK) > 2 ** 31 - 1 or s > 2 ** 31 - 1:
        raise ValueError(f"N={n}, Q={q}, M={m}, S={s} exceed the launch "
                         "grid")


@functools.lru_cache(maxsize=64)
def _level_table(shapes: Tuple, device: torch.device) -> torch.Tensor:
    """The (L, 3) int32 table of (H, W, first token) on `device`, made once
    per shapes and device, so that a forward copies nothing to the card."""
    rows, start = [], 0
    for h, w in shapes:
        rows.append((h, w, start))
        start += h * w
    return torch.tensor(rows, dtype=torch.int32, device=device)


def ms_deform_attn_cuda(value: torch.Tensor, spatial_shapes: Sequence,
                        sampling_locations: torch.Tensor,
                        attention_weights: torch.Tensor) -> torch.Tensor:
    """MSDA forward on the card (K5). value (N, S, M, D), D <= 64;
    spatial_shapes: the levels' (H, W); sampling_locations
    (N, Q, M, L, P, 2); attention_weights (N, Q, M, L, P); value and
    weights both f32 or both bf16, the locations f32 (what the bf16 detector
    passes, as the JAX package's does) or, beside bf16 values, bf16, which
    is widened to f32 (exactly); contiguous, on one card.
    Returns (N, Q, M·D) in value's dtype. Counts its launches in
    `ms_deform_attn_cuda.launches`.

    Forward only: inputs that need a gradient raise NotImplementedError,
    since the MSDA backward (a col2im kernel) is the detection training
    slice's, and a forward that dropped gradients would train nothing."""
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    loc, weights = sampling_locations, attention_weights
    check_supported(value.shape, shapes, loc.shape, weights.shape)
    tensors = (value, loc, weights)
    if value.device.type != "cuda" or any(t.device != value.device
                                          for t in tensors):
        raise ValueError("inputs must be on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if (value.dtype not in _DTYPES or weights.dtype != value.dtype
            or loc.dtype not in (value.dtype, torch.float32)):
        raise TypeError("K5 takes value, sampling locations and attention "
                        "weights all float32, all bfloat16, or bfloat16 "
                        "value and weights with float32 locations; got "
                        f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "K5 is the MSDA forward only: its backward (a col2im kernel, the "
            "port of fastervit_tpu/ops/msda.py::_msda_core_bwd) comes with "
            "the detection training slice; run inference under "
            "torch.no_grad()")
    n, s, m, d = value.shape
    q, p = loc.shape[1], loc.shape[4]
    out = torch.empty((n, q, m * d), dtype=value.dtype, device=value.device)
    if n * q == 0:
        return out
    loc = loc.float()  # the kernel's locations are f32
    levels = _level_table(shapes, value.device)
    lib = cuda_attention._library()
    with torch.cuda.device(value.device):
        err = lib.msda_forward(
            value.data_ptr(), levels.data_ptr(), loc.data_ptr(),
            weights.data_ptr(), out.data_ptr(), n, q, s, m, d, len(shapes),
            p, int(value.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    cuda_attention._raise_on(err, "msda_forward")
    ms_deform_attn_cuda.launches += 1
    return out


ms_deform_attn_cuda.launches = 0
