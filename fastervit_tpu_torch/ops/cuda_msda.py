"""Binding and launch of K5, the hand-written multi-scale deformable
attention forward (csrc/msda_fwd.cu), the Hopper counterpart of
fastervit_tpu/ops/msda_pallas.py::fused_bilinear_gather, and of the MSDA
gather probes' kernels (csrc/msda_probe.cu): P3a `fused_gather_cuda`, P3b
`fused_gather_p4_cuda`, P3c `fused_gather_per_head_cuda` and P4a
`packed_gather_cuda`, the counterparts of scripts/msda_pallas_probe.py's
and scripts/msda_packed_probe.py's Pallas kernels.

The kernels are built with K1-K4 into one library by
`cuda_attention.build()` and loaded by its `_library()`. A failed build, an
unsupported shape or dtype, an input that needs a gradient, or a failed
launch raises; nothing falls back to the plain versions
(`ops.msda.msda_reference`, `ops.msda_probes`). The module imports on a
machine with no nvcc and no card.
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


# The MSDA gather probes' kernels, P3a-c and P4a (csrc/msda_probe.cu)
PROBE_MAX_CHANNELS = 64       # kMaxChannels in csrc/msda_probe.cu
PROBE_POINTS = (1, 2, 4)      # the instantiations of its P
_MAX_HEADS = 65535            # kMaxGridY: one grid row a head
_INT32_MAX = 2 ** 31 - 1      # its offsets are 32-bit


def _check_scalars(what: str, heads: int, indices: Sequence[torch.Tensor],
                   floats: Sequence[torch.Tensor]) -> int:
    """Raise unless the index tensors are int32 and the fractions and
    weights f32, all (M, QP); returns QP."""
    tensors = (*indices, *floats)
    if indices[0].dim() != 2 or indices[0].shape[0] != heads or any(
            t.shape != indices[0].shape for t in tensors):
        raise ValueError(f"{what}: indices, fractions and weights must all "
                         f"be (M, QP) with M = {heads}, got "
                         f"{[tuple(t.shape) for t in tensors]}")
    if any(t.dtype != torch.int32 for t in indices):
        raise TypeError(f"{what}: indices must be int32, got "
                        f"{[t.dtype for t in indices]}")
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError(f"{what}: fractions and weights must be float32, "
                        f"got {[t.dtype for t in floats]}")
    return indices[0].shape[1]


def _check_points(what: str, qp: int, points: int) -> None:
    if points not in PROBE_POINTS:
        raise NotImplementedError(f"{what} takes P in {PROBE_POINTS}, got "
                                  f"{points}")
    if qp % points:
        raise ValueError(f"{what}: QP = {qp} samples is not a multiple of "
                         f"P = {points}: each query has P consecutive "
                         "samples")


def _check_sizes(what: str, heads: int, d: int, *numels: int) -> None:
    if d < 1 or d > PROBE_MAX_CHANNELS:
        raise NotImplementedError(f"{what} takes 1 to {PROBE_MAX_CHANNELS} "
                                  f"channels, got {d}")
    if heads > _MAX_HEADS or max(numels) > _INT32_MAX:
        raise ValueError(f"{what}: M = {heads} heads (at most {_MAX_HEADS}) "
                         f"or a tensor of {max(numels)} elements (at most "
                         f"{_INT32_MAX}) past the kernel's 32-bit offsets")


def check_gather(vm: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
                 fy: torch.Tensor, fx: torch.Tensor, w: torch.Tensor,
                 points: int = 1, what: str = "fused_gather") -> None:
    """Raise unless P3a-c take these inputs: vm (M, Hp, Wp, D) float32 with
    Hp, Wp >= 2 and 1 <= D <= PROBE_MAX_CHANNELS; iy, ix (M, QP) int32;
    fy, fx, w (M, QP) float32; P in PROBE_POINTS dividing QP; M <= 65535
    and every tensor, the output (M, QP/P, D) too, under 2^31 elements.
    The JAX probes take an f32 map only (a bf16 one fails at their store),
    and so do these."""
    if vm.dim() != 4:
        raise ValueError(f"{what}: vm must be (M, Hp, Wp, D), got "
                         f"{tuple(vm.shape)}")
    if vm.dtype != torch.float32:
        raise TypeError(f"{what} takes a float32 map, as the JAX probe "
                        f"does, got {vm.dtype}")
    m, hp, wp, d = vm.shape
    if hp < 2 or wp < 2:
        raise ValueError(f"{what}: the padded map must be at least 2x2, got "
                         f"{hp}x{wp}")
    qp = _check_scalars(what, m, (iy, ix), (fy, fx, w))
    _check_points(what, qp, points)
    _check_sizes(what, m, d, vm.numel(), iy.numel(), m * (qp // points) * d)


def check_packed(pm: torch.Tensor, fl: torch.Tensor, fy: torch.Tensor,
                 fx: torch.Tensor, w: torch.Tensor, points: int) -> None:
    """Raise unless P4a takes these inputs: pm (M, cells, 4D) float32 or
    bfloat16 with cells >= 1 and 1 <= D <= PROBE_MAX_CHANNELS; fl (M, QP)
    int32; fy, fx, w (M, QP) float32; P in PROBE_POINTS dividing QP;
    M <= 65535 and every tensor, the output (M, QP/P, D) too, under 2^31
    elements."""
    what = "packed_gather"
    if pm.dim() != 3 or pm.shape[2] % 4:
        raise ValueError(f"{what}: pm must be (M, cells, 4D), got "
                         f"{tuple(pm.shape)}")
    if pm.dtype not in _DTYPES:
        raise TypeError(f"{what} takes a float32 or bfloat16 packed map, "
                        f"got {pm.dtype}")
    m, cells, d4 = pm.shape
    if cells < 1:
        raise ValueError(f"{what}: pm holds no cell (a map of at least 2x2 "
                         "packs into one)")
    qp = _check_scalars(what, m, (fl,), (fy, fx, w))
    _check_points(what, qp, points)
    _check_sizes(what, m, d4 // 4, pm.numel(), fl.numel(),
                 m * (qp // points) * (d4 // 4))


def _probe_output(what: str, tensors: Sequence[torch.Tensor], d: int,
                  points: int) -> torch.Tensor:
    """Check that a probe kernel's inputs (the map, then its (M, QP)
    scalars) lie contiguous on one card and need no gradient, and allocate
    its f32 output (M, QP/P, D)."""
    first = tensors[0]
    if first.device.type != "cuda" or any(t.device != first.device
                                          for t in tensors):
        raise ValueError(f"{what}: inputs must be on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: inputs must be contiguous")
    if any(t.requires_grad for t in tensors):
        raise ValueError(f"{what} has no gradient: pass inputs that do not "
                         "require one")
    m, qp = tensors[1].shape
    return torch.empty((m, qp // points, d), dtype=torch.float32,
                       device=first.device)


def _gather_output(what: str, vm: torch.Tensor,
                   scalars: Sequence[torch.Tensor],
                   points: int) -> torch.Tensor:
    """Check P3's inputs and allocate its output."""
    check_gather(vm, *scalars, points=points, what=what)
    return _probe_output(what, (vm, *scalars), vm.shape[-1], points)


def _gather_launch(vm: torch.Tensor, scalars: Sequence[torch.Tensor],
                   out: torch.Tensor, heads: int, points: int) -> None:
    """One launch of msda_probe_gather over `heads` heads, from the first
    elements of vm (.., Hp, Wp, D), the scalars (.., QP) and out."""
    hp, wp, d = vm.shape[-3:]
    lib = cuda_attention._library()
    with torch.cuda.device(vm.device):
        err = lib.msda_probe_gather(
            vm.data_ptr(), *(t.data_ptr() for t in scalars), out.data_ptr(),
            heads, scalars[0].shape[-1], hp, wp, d, points,
            torch.cuda.current_stream().cuda_stream)
    cuda_attention._raise_on(err, "msda_probe_gather")


def fused_gather_cuda(vm: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
                      fy: torch.Tensor, fx: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """P3a on the card: out[m, i] = w·bilinear(vm[m], iy, ix, fy, fx) for
    every sample i, (M, QP, D) f32 (see `check_gather`). Counts its
    launches in `fused_gather_cuda.launches`."""
    scalars = (iy, ix, fy, fx, w)
    out = _gather_output("fused_gather", vm, scalars, 1)
    if out.numel():
        _gather_launch(vm, scalars, out, vm.shape[0], 1)
        fused_gather_cuda.launches += 1
    return out


fused_gather_cuda.launches = 0


def fused_gather_p4_cuda(vm: torch.Tensor, iy: torch.Tensor,
                         ix: torch.Tensor, fy: torch.Tensor,
                         fx: torch.Tensor, w: torch.Tensor,
                         p: int = 4) -> torch.Tensor:
    """P3b on the card: P3a summed over each query's P consecutive samples
    in order, (M, QP/P, D) f32. Counts its launches in
    `fused_gather_p4_cuda.launches`."""
    scalars = (iy, ix, fy, fx, w)
    out = _gather_output("fused_gather_p4", vm, scalars, p)
    if out.numel():
        _gather_launch(vm, scalars, out, vm.shape[0], p)
        fused_gather_p4_cuda.launches += 1
    return out


fused_gather_p4_cuda.launches = 0


def fused_gather_per_head_cuda(vm: torch.Tensor, iy: torch.Tensor,
                               ix: torch.Tensor, fy: torch.Tensor,
                               fx: torch.Tensor,
                               w: torch.Tensor) -> torch.Tensor:
    """P3c on the card: P3a with one launch a head, each over that head's
    map and samples alone, into one (M, QP, D) f32 output. Counts its M
    launches a call in `fused_gather_per_head_cuda.launches`."""
    scalars = (iy, ix, fy, fx, w)
    out = _gather_output("fused_gather_per_head", vm, scalars, 1)
    if out.numel():
        for h in range(vm.shape[0]):
            _gather_launch(vm[h], [t[h] for t in scalars], out[h], 1, 1)
            fused_gather_per_head_cuda.launches += 1
    return out


fused_gather_per_head_cuda.launches = 0


def packed_gather_cuda(pm: torch.Tensor, fl: torch.Tensor, fy: torch.Tensor,
                       fx: torch.Tensor, w: torch.Tensor,
                       p: int = 4) -> torch.Tensor:
    """P4a on the card: the corner-packed sum over each query's P samples,
    (M, QP/P, D) f32 from an f32 or bf16 packed map (see `check_packed`).
    Counts its launches in `packed_gather_cuda.launches`."""
    check_packed(pm, fl, fy, fx, w, p)
    d = pm.shape[2] // 4
    out = _probe_output("packed_gather", (pm, fl, fy, fx, w), d, p)
    if out.numel():
        lib = cuda_attention._library()
        with torch.cuda.device(pm.device):
            err = lib.msda_probe_packed(
                pm.data_ptr(), fl.data_ptr(), fy.data_ptr(), fx.data_ptr(),
                w.data_ptr(), out.data_ptr(), pm.shape[0], fl.shape[1],
                pm.shape[1], d, p, int(pm.dtype == torch.bfloat16),
                torch.cuda.current_stream().cuda_stream)
        cuda_attention._raise_on(err, "msda_probe_packed")
        packed_gather_cuda.launches += 1
    return out


packed_gather_cuda.launches = 0
