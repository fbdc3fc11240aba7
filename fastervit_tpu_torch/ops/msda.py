"""Multi-scale deformable attention (MSDA), PyTorch port of
fastervit_tpu/ops/msda.py's forward and backward.

`ms_deform_attn` is the single dispatch point. It runs through
`MSDeformAttnFunction`, the counterpart of the JAX package's custom VJP
(`_msda_core`): a CUDA tensor goes forward through K5, the hand-written
kernel `csrc/msda_fwd.cu`, and backward through K7, `csrc/msda_bwd.cu`
(both bound in `cuda_msda`); a CPU tensor goes through the plain versions
`msda_reference` and `msda_backward_reference`. There is no fallback from
one to the other. The TPU package's backend switch (`set_msda_backend`,
its Pallas-below-4096-queries threshold), its query chunking and its GSPMD
query sharding are TPU workarounds and have no counterpart: on the card
every call is K5 forward and K7 backward.

Layouts are the JAX package's: value (N, S, M, D) with S = Σ H·W over the
levels; sampling locations (N, Q, M, L, P, 2) as normalised (x, y);
attention weights (N, Q, M, L, P); output (N, Q, M·D).

Sampling follows `_level_geometry` (msda.py:56-73), grid_sample's
align_corners=False with zero padding: x = loc_x·W − 0.5, y = loc_y·H −
0.5; a corner outside the map adds 0, and a sample whose top-left corner
(x0, y0) lies outside [−1, W−1] × [−1, H−1] adds exactly 0.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from fastervit_tpu_torch.ops import cuda_msda

Shapes = Tuple[Tuple[int, int], ...]


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 for low-precision inputs, f64 kept (msda.py::_compute_dtype)."""
    return torch.promote_types(dtype, torch.float32)


def _level_geometry(ll: torch.Tensor, h: int, w: int):
    """Sampling geometry of one level (msda.py::_level_geometry).
    ll: (N, Q, M, P, 2) normalised (x, y). Returns fx, fy, valid, each
    (N, Q, M, P, 1) in the compute dtype, and iy, ix (N, Q, M, P) int64:
    the start indices of each sample's 2×2 patch in the zero-padded
    (h + 2, w + 2) map."""
    cdt = _compute_dtype(ll.dtype)
    x = ll[..., 0].to(cdt) * w - 0.5          # align_corners=False
    y = ll[..., 1].to(cdt) * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    # a patch is representable iff its 2x2 corners fit the padded map;
    # farther-out samples contribute exactly zero
    valid = ((x0 >= -1) & (x0 <= w - 1) & (y0 >= -1)
             & (y0 <= h - 1)).to(cdt)[..., None]
    # clamp in floating point first: a far-out location is out of int range
    ix = (x0.clamp(-1, w) + 1).long().clamp(0, w)
    iy = (y0.clamp(-1, h) + 1).long().clamp(0, h)
    return fx, fy, valid, iy, ix


def _padded_level_map(v: torch.Tensor, n: int, h: int, w: int, m: int,
                      d: int) -> torch.Tensor:
    """(N, H·W, M, D) -> (N·M, H+2, W+2, D) with a zero border."""
    vm = v.reshape(n, h, w, m, d).permute(0, 3, 1, 2, 4)
    vm = F.pad(vm, (0, 0, 1, 1, 1, 1))
    return vm.reshape(n * m, h + 2, w + 2, d)


def _level_patches(v: torch.Tensor, ll: torch.Tensor, h: int, w: int):
    """One level's geometry and corner patches. v: the level's value
    (N, H·W, M, D); ll: its locations (N, Q, M, P, 2). Returns fx, fy,
    valid (`_level_geometry`), the flat index of each sample's four
    corners in the zero-padded (H+2)·(W+2) map of its (n, m),
    (N·M, Q·P, 4), and the corner rows (N, Q, M, P, 4, D) in the compute
    dtype, in the order (top left, top right, bottom left, bottom
    right)."""
    n, _, m, d = v.shape
    q, p = ll.shape[1], ll.shape[3]
    vm = _padded_level_map(v, n, h, w, m, d).reshape(
        n * m, (h + 2) * (w + 2), d)
    fx, fy, valid, iy, ix = _level_geometry(ll, h, w)
    base = (iy * (w + 2) + ix).permute(0, 2, 1, 3).reshape(n * m, q * p)
    corners = torch.stack([base, base + 1, base + w + 2, base + w + 3], -1)
    patches = torch.gather(vm, 1, corners.reshape(n * m, q * p * 4)[..., None]
                           .expand(-1, -1, d))
    patches = patches.reshape(n, m, q, p, 4, d).permute(0, 2, 1, 3, 4, 5)
    return fx, fy, valid, corners, patches.to(_compute_dtype(v.dtype))


def msda_reference(value: torch.Tensor, spatial_shapes: Sequence,
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: a port of fastervit_tpu/ops/msda.py::_msda_body
    (one gather of 2×2 corner patches per (query, level, point) from the
    zero-padded level map, the bilinear combine, the weighted sum over the
    points, levels added in order). Geometry and sums are in f32 for bf16
    inputs (f64 kept); the output is in value's dtype. Holds each level's
    (N·M, Q·P, 2, 2, D) patches in the compute dtype."""
    shapes = normalize_shapes(spatial_shapes)
    n, s, m, d = value.shape
    q = sampling_locations.shape[1]
    cdt = _compute_dtype(value.dtype)
    acc = torch.zeros((n, q, m, d), dtype=cdt, device=value.device)
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        fx, fy, valid, _, patches = _level_patches(
            value[:, start:start + h * w], sampling_locations[:, :, :, lvl],
            h, w)                                     # (N, Q, M, P, 4, D)
        start += h * w
        interp = ((1 - fy) * (1 - fx) * patches[..., 0, :]
                  + (1 - fy) * fx * patches[..., 1, :]
                  + fy * (1 - fx) * patches[..., 2, :]
                  + fy * fx * patches[..., 3, :]) * valid
        wl = attention_weights[:, :, :, lvl, :, None].to(cdt)
        acc = acc + (interp * wl).sum(3)              # (N, Q, M, D)
    if start != s:
        raise ValueError(f"spatial shapes {shapes} cover {start} tokens, "
                         f"value has {s}")
    return acc.reshape(n, q, m * d).to(value.dtype)


def msda_backward_reference(value: torch.Tensor, spatial_shapes: Sequence,
                            sampling_locations: torch.Tensor,
                            attention_weights: torch.Tensor,
                            grad_out: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain version of K7: a port of fastervit_tpu/ops/msda.py::
    _msda_core_bwd, the gradients of `msda_reference`'s output with
    respect to value, the sampling locations and the attention weights,
    given grad_out (N, Q, M·D).

    Per level, with the forward's geometry and corner patches:
    dweights = ⟨interp, g⟩; dloc = (Σ_D g·w·∂interp/∂x · W, the same in y
    · H), the chain rule through x = loc_x·W − 0.5; dvalue adds each
    corner's bilinear weight times g·w·valid into the zero-padded level map
    with `index_add_` (the JAX package's one-hot matmuls,
    `_scatter_as_matmuls`, stand in for a scatter the TPU lacks) and crops
    the border. Computed in f32 for bf16 inputs (f64 kept); returns dvalue
    in value's dtype, dloc in the locations' and dweights in the weights'
    dtype."""
    shapes = normalize_shapes(spatial_shapes)
    loc, w = sampling_locations, attention_weights
    n, s, m, d = value.shape
    q = loc.shape[1]
    cdt = _compute_dtype(value.dtype)
    g4 = grad_out.reshape(n, q, m, d).to(cdt)
    dval_parts, dloc_parts, dw_parts = [], [], []
    start = 0
    for lvl, (h, wd) in enumerate(shapes):
        fx, fy, valid, corners, patches = _level_patches(
            value[:, start:start + h * wd], loc[:, :, :, lvl], h, wd)
        start += h * wd
        fx, fy, valid = fx.to(cdt), fy.to(cdt), valid.to(cdt)
        c00, c01, c10, c11 = patches.unbind(4)
        # attention-weight gradient: dL/dw = <interp, g>
        interp = ((1 - fy) * (1 - fx) * c00 + (1 - fy) * fx * c01
                  + fy * (1 - fx) * c10 + fy * fx * c11) * valid
        dw_parts.append(torch.einsum("nqmpd,nqmd->nqmp", interp, g4))
        wl = w[:, :, :, lvl].to(cdt)                  # (N, Q, M, P)
        gq = g4[:, :, :, None, :] * wl[..., None]     # (N, Q, M, P, D)
        # sampling-location gradient, through x = loc_x·W − 0.5
        ddx = ((1 - fy) * (c01 - c00) + fy * (c11 - c10)) * valid
        ddy = ((1 - fx) * (c10 - c00) + fx * (c11 - c01)) * valid
        dloc_parts.append(torch.stack([(gq * ddx).sum(-1) * wd,
                                       (gq * ddy).sum(-1) * h], -1))
        # value gradient: each corner's weight times g·w·valid, added into
        # the padded map of its (n, m), then the border cropped
        rows = (gq * valid).permute(0, 2, 1, 3, 4)     # (N, M, Q, P, D)
        cw = torch.stack([(1 - fy) * (1 - fx), (1 - fy) * fx,
                          fy * (1 - fx), fy * fx], 4)  # (N, Q, M, P, 4, 1)
        cw = cw.permute(0, 2, 1, 3, 4, 5)              # (N, M, Q, P, 4, 1)
        terms = (rows[:, :, :, :, None, :] * cw).reshape(-1, d)
        hp, wp = h + 2, wd + 2
        offset = torch.arange(n * m, device=value.device) * (hp * wp)
        index = (corners + offset[:, None, None]).reshape(-1)
        dvm = torch.zeros((n * m * hp * wp, d), dtype=cdt,
                          device=value.device)
        dvm.index_add_(0, index, terms)
        dv = dvm.reshape(n, m, hp, wp, d)[:, :, 1:-1, 1:-1]
        dval_parts.append(dv.permute(0, 2, 3, 1, 4).reshape(n, h * wd, m, d))
    if start != s:
        raise ValueError(f"spatial shapes {shapes} cover {start} tokens, "
                         f"value has {s}")
    dvalue = torch.cat(dval_parts, 1).to(value.dtype)
    dloc = torch.stack(dloc_parts, 3).to(loc.dtype)
    dw = torch.stack(dw_parts, 3).to(w.dtype)
    return dvalue, dloc, dw


def dvalue_order_bound(value: torch.Tensor, spatial_shapes: Sequence,
                       sampling_locations: torch.Tensor,
                       attention_weights: torch.Tensor,
                       grad_out: torch.Tensor,
                       flushes: int = 0) -> Tuple[torch.Tensor, int]:
    """How far two summation orders of dvalue may lie apart, element by
    element: c·2⁻²⁴·Σ|terms|, with Σ|terms| the plain backward's dvalue on
    |g| and |w| (the corner weights are non-negative) in f32 and c the most
    (sample, corner) contributions any element of dvalue receives plus
    `flushes`, the partial sums added on top of them (K7's route "smem":
    the tiles of the runs that meet a head, `cuda_msda.msda_bwd_flushes`).
    Returns (the bound, f32, value's shape; c). K7 adds dvalue's terms with
    atomics, in an order that changes from run to run."""
    shapes = normalize_shapes(spatial_shapes)
    loc = sampling_locations
    n, _, m, _ = value.shape
    q, p = loc.shape[1], loc.shape[4]
    terms = msda_backward_reference(
        value.float(), shapes, loc, attention_weights.abs().float(),
        grad_out.abs().float())[0]
    if not n * q * p * m:
        return terms, 0
    counts = []
    for lvl, (h, w) in enumerate(shapes):
        _, _, valid, iy, ix = _level_geometry(loc[:, :, :, lvl], h, w)
        wp = w + 2
        base = iy * wp + ix                            # (N, Q, M, P)
        corners = torch.stack([base, base + 1, base + wp, base + wp + 1], -1)
        nm = (torch.arange(n, device=loc.device)[:, None] * m
              + torch.arange(m, device=loc.device)[None])   # (N, M)
        index = corners + nm[:, None, :, None, None] * ((h + 2) * wp)
        keep = valid[..., 0].bool()[..., None].expand_as(index)
        c = torch.bincount(index[keep], minlength=n * m * (h + 2) * wp)
        counts.append(int(c.reshape(n, m, h + 2, wp)[:, :, 1:-1, 1:-1].max()))
    c = max(counts) + flushes
    return c * 2.0 ** -24 * terms, c


def normalize_shapes(spatial_shapes: Sequence) -> Shapes:
    """The levels' (H, W) as a tuple of int pairs."""
    return tuple((int(h), int(w)) for h, w in spatial_shapes)


def _on_device(what: str, value: torch.Tensor, kernel, plain, *args):
    """`kernel` for a CUDA tensor, `plain` for a CPU one, else raise."""
    if value.device.type == "cuda":
        return kernel(value, *args)
    if value.device.type == "cpu":
        return plain(value, *args)
    raise NotImplementedError(f"{what} has no path for device "
                              f"{value.device}")


class MSDeformAttnFunction(torch.autograd.Function):
    """MSDA with its gradient, the counterpart of the JAX package's custom
    VJP `_msda_core` (msda.py:175-237). Forward: K5
    (`cuda_msda.ms_deform_attn_cuda`) on a CUDA tensor, `msda_reference` on
    a CPU one. Backward: K7 (`cuda_msda.ms_deform_attn_backward_cuda`) on a
    CUDA tensor, `msda_backward_reference` on a CPU one. Either kernel
    raises on what it does not take; nothing falls back to the plain
    versions. No gradient flows to the spatial shapes."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, sampling_locations,
                attention_weights):
        shapes = normalize_shapes(spatial_shapes)
        ctx.shapes = shapes
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        return _on_device("MSDA", value, cuda_msda.ms_deform_attn_cuda,
                          msda_reference, shapes, sampling_locations,
                          attention_weights)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, weights = ctx.saved_tensors
        dvalue, dloc, dweights = _on_device(
            "the MSDA backward", value,
            cuda_msda.ms_deform_attn_backward_cuda, msda_backward_reference,
            ctx.shapes, loc, weights, grad_out.contiguous())
        return dvalue, None, dloc, dweights


def ms_deform_attn(value: torch.Tensor, spatial_shapes: Sequence,
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """MSDA (fastervit_tpu/ops/msda.py::ms_deform_attn), differentiable in
    value, the locations and the weights. value: (N, S, M, D);
    spatial_shapes: the levels' (H, W), static; sampling_locations:
    (N, Q, M, L, P, 2) normalised (x, y); attention_weights:
    (N, Q, M, L, P). Returns (N, Q, M·D) in value's dtype. Runs through
    `MSDeformAttnFunction`: K5 and K7 on CUDA tensors (which raise on what
    they do not take), the plain versions on CPU tensors."""
    return MSDeformAttnFunction.apply(value, spatial_shapes,
                                      sampling_locations, attention_weights)


@functools.lru_cache(maxsize=64)
def _level_wh(shapes: Shapes, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """(L, 2) tensor of the levels' (W, H), made once per shapes, dtype and
    device, so that a forward on the card copies nothing to it."""
    return torch.tensor([[w, h] for h, w in shapes], dtype=dtype,
                        device=device)


def _sampling_offset_bias(n_heads: int, n_levels: int,
                          n_points: int) -> np.ndarray:
    """Directional bias of the sampling-offset head (msda.py::
    _sampling_offset_bias_init; reference ops/modules/ms_deform_attn.py:
    47-60): head h points along angle 2πh/n_heads, scaled by the point's
    index + 1. Flat (M·L·P·2,)."""
    thetas = np.arange(n_heads, dtype=np.float64) * (2.0 * np.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)     # (M, 2)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1).astype(np.float32)


class MSDeformAttnModule(nn.Module):
    """Deformable-attention layer (fastervit_tpu/ops/msda.py::
    MSDeformAttnModule; reference ops/modules/ms_deform_attn.py:30-126):
    value, offset and weight projections around `ms_deform_attn`. Parameter
    names are upstream's. Initialised as the JAX module is: the offset and
    weight heads' kernels zero, the offset bias directional, the value and
    output projections left to the caller's init."""

    def __init__(self, d_model: int = 256, n_levels: int = 4,
                 n_heads: int = 8, n_points: int = 4):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of "
                             f"n_heads {n_heads}")
        self.d_model, self.n_levels = d_model, n_levels
        self.n_heads, self.n_points = n_heads, n_points
        self.value_proj = nn.Linear(d_model, d_model)
        self.sampling_offsets = nn.Linear(d_model,
                                          n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model,
                                           n_heads * n_levels * n_points)
        self.output_proj = nn.Linear(d_model, d_model)
        self.reset_offset_heads()

    @torch.no_grad()
    def reset_offset_heads(self) -> None:
        """The offset and weight heads' init (zero kernels, directional
        offset bias, zero weight bias)."""
        self.sampling_offsets.weight.zero_()
        self.sampling_offsets.bias.copy_(torch.as_tensor(
            _sampling_offset_bias(self.n_heads, self.n_levels,
                                  self.n_points)))
        self.attention_weights.weight.zero_()
        self.attention_weights.bias.zero_()

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                input_flatten: torch.Tensor, spatial_shapes: Sequence,
                padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """query: (N, Q, C); reference_points: (N, Q, L, 2) or (N, Q, L, 4),
        normalised; input_flatten: (N, S, C); spatial_shapes: the levels'
        (H, W); padding_mask: (N, S) bool, True at padded tokens, whose
        value rows are zeroed before the sampling (so no sample reads a
        padded pixel, and their value gradient is zero). Returns
        (N, Q, C)."""
        n, q, _ = query.shape
        s = input_flatten.shape[1]
        m, l, p = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(input_flatten)
        if padding_mask is not None:
            value = torch.where(padding_mask[..., None], 0, value)
        value = value.reshape(n, s, m, self.d_model // m)
        offsets = self.sampling_offsets(query).reshape(n, q, m, l, p, 2)
        weights = F.softmax(self.attention_weights(query).reshape(
            n, q, m, l * p), dim=-1).reshape(n, q, m, l, p)
        if reference_points.shape[-1] == 2:
            wh = _level_wh(normalize_shapes(spatial_shapes), offsets.dtype,
                           offsets.device)              # (L, 2) as (W, H)
            loc = (reference_points[:, :, None, :, None, :]
                   + offsets / wh[None, None, None, :, None, :])
        elif reference_points.shape[-1] == 4:
            loc = (reference_points[:, :, None, :, None, :2]
                   + offsets / p * reference_points[:, :, None, :, None, 2:]
                   * 0.5)
        else:
            raise ValueError(f"reference points of shape "
                             f"{tuple(reference_points.shape)}")
        # in value's dtype, as JAX's bf16 module hands its MSDA bf16
        # weights: under autocast the softmax is f32 and the value bf16
        out = ms_deform_attn(value, spatial_shapes, loc.contiguous(),
                             weights.to(value.dtype).contiguous())
        return self.output_proj(out)
