"""The MSDA gather probes' functions, with their dispatch: the PyTorch
counterparts of the Pallas kernels of scripts/msda_pallas_probe.py (P3a
`fused_gather`, P3b `fused_gather_p4`, P3c `fused_gather_per_head`),
scripts/msda_packed_probe.py (P4a `packed_gather`) and
scripts/msda_packed_probe2.py (P4b `pair_staticr`, P4c `packed_coeff`,
P4d `packed_wide`).

Each is multi-scale deformable attention's bilinear gather for one level,
handed each sample's precomputed patch corner and fractions, on MOTR's
streaming geometry. Per head m and sample i, from the zero-padded level
map vm (M, Hp, Wp, D):

    top = vm[m, iy, ix]·(1−fx) + vm[m, iy, ix+1]·fx
    bot = vm[m, iy+1, ix]·(1−fx) + vm[m, iy+1, ix+1]·fx
    v[m, i] = w·(top·(1−fy) + bot·fy)

- `fused_gather` (P3a) returns v, (M, QP, D);
- `fused_gather_p4` (P3b) sums each query's P consecutive samples in
  order, (M, QP/P, D);
- `fused_gather_per_head` (P3c) is P3a with one launch a head on the card;
- `packed_gather` (P4a) is P3b over `pack_corners(vm)`, where one row of
  4·D holds a sample's four corners, fl = iy·(Wp−1) + ix, with the corner
  weights w·gy·gx, w·gy·fx, w·fy·gx and w·fy·fx (gy = 1−fy, gx = 1−fx);
  the map f32 or bf16, the output f32;
- `pair_staticr` (P4b) is P3b over an f32 or bf16 map (the JAX kernel's
  static row index has no counterpart on the card);
- `packed_coeff` (P4c) is P4a with the four corner weights c00, c01, c10,
  c11 given as (M, QP) f32 streams (`coeff_scalars` makes P4a's);
- `packed_wide` (P4d) takes a coefficient row cf (M, QP, 4D) f32 a sample
  (`coeff_wide` broadcasts P4a's weights to one) and returns
  Σ_p pm[fl]·cf lane by lane, (M, QP/P, 4D) with the four corner groups
  kept; the caller adds them.

P3a–c take an f32 map only, as the JAX functions do (a bf16 map fails at
their store). iy, ix and fl are int32; fy, fx, w and the corner weights
f32, all (M, QP). QP is any count for P3a and P3c and a multiple of P for
P3b and P4a–d; P is 1, 2 or 4. The TPU functions' tiling knobs (chunk,
unroll, vmem_cap, the (8, chunk/8) SMEM tiling, the chunk padding, P4b's
static row index) have no counterpart.

Out of range: a sample with iy outside [0, Hp−2] or ix outside [0, Wp−2]
(for P4a, P4c and P4d, fl outside [0, (Hp−1)(Wp−1))) gives NaN, on every
output lane, and so does its query's sum; nothing outside the map is read.
The JAX functions define nothing there (their `_reference` wraps a column
past the right edge into the next row).

A tensor on the CPU takes the plain version here; a CUDA tensor the
hand-written kernel in `cuda_msda` (csrc/msda_probe.cu) or raises. There
is no fallback from one to the other, and no gradient: inputs that
require one raise.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from fastervit_tpu_torch.ops import cuda_msda
from fastervit_tpu_torch.ops.attention_probes import input_device
from fastervit_tpu_torch.ops.cuda_msda import (check_coeff, check_gather,
                                               check_packed, check_pair,
                                               check_wide)

Coeffs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _bilinear(vm: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
              fy: torch.Tensor, fx: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """w·bilinear(vm, sample) a sample, (M, QP, D) f32, the corners widened
    to f32 (exact for bf16; nothing for f32); NaN rows where a sample is out
    of range. Holds four (M, QP, D) corner gathers."""
    m, hp, wp, d = vm.shape
    valid = (iy >= 0) & (iy <= hp - 2) & (ix >= 0) & (ix <= wp - 2)
    lin = torch.where(valid, iy.long() * wp + ix.long(), 0)
    flat = vm.reshape(m, hp * wp, d)

    def corner(offset: int) -> torch.Tensor:
        return torch.gather(flat, 1, (lin + offset)[..., None].expand(
            -1, -1, d)).float()

    gx, gy = (1 - fx)[..., None], (1 - fy)[..., None]
    fx, fy = fx[..., None], fy[..., None]
    top = corner(0) * gx + corner(1) * fx
    bot = corner(wp) * gx + corner(wp + 1) * fx
    out = w[..., None] * (top * gy + bot * fy)
    return out.masked_fill_(~valid[..., None], float("nan"))


def gather_reference(vm: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
                     fy: torch.Tensor, fx: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """Plain version of P3a and P3c, in the order of roundings of
    scripts/msda_pallas_probe.py::_reference (:236-245), all in f32: top =
    c00·(1−fx) + c01·fx, bot likewise, then w·(top·(1−fy) + bot·fy).
    Returns (M, QP, D); NaN rows where a sample is out of range. Holds four
    (M, QP, D) corner gathers."""
    check_gather(vm, iy, ix, fy, fx, w)
    return _bilinear(vm, iy, ix, fy, fx, w)


def _sum_points(v: torch.Tensor, p: int) -> torch.Tensor:
    """(M, QP, D) -> (M, QP/P, D): each query's P samples added in order,
    the first one not added to zero."""
    m, qp, d = v.shape
    v = v.view(m, qp // p, p, d)
    acc = v[:, :, 0]
    for i in range(1, p):
        acc = acc + v[:, :, i]
    return acc.contiguous()


def gather_p4_reference(vm: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
                        fy: torch.Tensor, fx: torch.Tensor, w: torch.Tensor,
                        p: int = 4) -> torch.Tensor:
    """Plain version of P3b: `gather_reference` summed over each query's P
    consecutive samples in the order p = 0 … P−1, as
    scripts/msda_pallas_probe.py::_p4_kernel (:124-140) adds them.
    Returns (M, QP/P, D)."""
    check_gather(vm, iy, ix, fy, fx, w, points=p, what="fused_gather_p4")
    return _sum_points(gather_reference(vm, iy, ix, fy, fx, w), p)


def pack_corners(vm: torch.Tensor) -> torch.Tensor:
    """(M, Hp, Wp, D) -> (M, (Hp−1)(Wp−1), 4D): row y·(Wp−1) + x holds
    [vm[y, x] | vm[y, x+1] | vm[y+1, x] | vm[y+1, x+1]], the layout of
    scripts/msda_packed_probe.py::pack_corners (:38-43)."""
    m, hp, wp, d = vm.shape
    pm = torch.cat([vm[:, :-1, :-1], vm[:, :-1, 1:], vm[:, 1:, :-1],
                    vm[:, 1:, 1:]], dim=-1)
    return pm.reshape(m, (hp - 1) * (wp - 1), 4 * d)


def pair_staticr_reference(vm: torch.Tensor, iy: torch.Tensor,
                           ix: torch.Tensor, fy: torch.Tensor,
                           fx: torch.Tensor, w: torch.Tensor,
                           p: int = 4) -> torch.Tensor:
    """Plain version of P4b, in the order of roundings of
    scripts/msda_packed_probe2.py::_pair_staticr_kernel (:43-68): the patch
    widened to f32, then P3b's products and sums. On an f32 map it is
    `gather_p4_reference`, bit for bit. Returns (M, QP/P, D) f32."""
    check_pair(vm, iy, ix, fy, fx, w, p)
    return _sum_points(_bilinear(vm, iy, ix, fy, fx, w), p)


def coeff_scalars(fy: torch.Tensor, fx: torch.Tensor,
                  w: torch.Tensor) -> Coeffs:
    """The corner weights of scripts/msda_packed_probe2.py::coeff_scalars
    (:211-213): with gy = 1−fy, gx = 1−fx, (w·gy)·gx, (w·gy)·fx,
    (w·fy)·gx and (w·fy)·fx, each product rounded left to right."""
    gy, gx = 1 - fy, 1 - fx
    return w * gy * gx, w * gy * fx, w * fy * gx, w * fy * fx


def coeff_wide(fy: torch.Tensor, fx: torch.Tensor, w: torch.Tensor,
               d: int) -> torch.Tensor:
    """The coefficient rows of scripts/msda_packed_probe2.py::coeff_wide
    (:216-219): each corner weight of `coeff_scalars` repeated over its
    D-wide group, (M, QP, 4D) f32."""
    return torch.cat([c[..., None].expand(*c.shape, d)
                      for c in coeff_scalars(fy, fx, w)], dim=-1)


def _packed_rows(pm: torch.Tensor, fl: torch.Tensor):
    """(each sample's packed row widened to f32 (M, QP, 4D), the in-range
    mask (M, QP)); an out-of-range sample reads row 0."""
    valid = (fl >= 0) & (fl < pm.shape[1])
    index = torch.where(valid, fl.long(), 0)[..., None].expand(
        -1, -1, pm.shape[2])
    return torch.gather(pm, 1, index).float(), valid


def _packed_sum(pm: torch.Tensor, fl: torch.Tensor, coeffs: Coeffs,
                p: int) -> torch.Tensor:
    """Each sample's four D-wide groups times its corner weights, added
    left to right, then each query's P samples in order; NaN for an
    out-of-range sample. Returns (M, QP/P, D) f32."""
    d = pm.shape[2] // 4
    rows, valid = _packed_rows(pm, fl)
    v = rows[..., :d] * coeffs[0][..., None]
    for k in range(1, 4):
        v = v + rows[..., k * d:(k + 1) * d] * coeffs[k][..., None]
    return _sum_points(v.masked_fill_(~valid[..., None], float("nan")), p)


def packed_gather_reference(pm: torch.Tensor, fl: torch.Tensor,
                            fy: torch.Tensor, fx: torch.Tensor,
                            w: torch.Tensor, p: int = 4) -> torch.Tensor:
    """Plain version of P4a, in the order of roundings of
    scripts/msda_packed_probe.py::_packed_kernel (:46-66): the map row
    widened to f32; gy = 1−fy, gx = 1−fx; the corner weights (w·gy)·gx,
    (w·gy)·fx, (w·fy)·gx, (w·fy)·fx; their products with the four D-wide
    groups added left to right; then each query's P samples in order.
    Returns (M, QP/P, D) f32."""
    check_packed(pm, fl, fy, fx, w, p)
    return _packed_sum(pm, fl, coeff_scalars(fy, fx, w), p)


def packed_coeff_reference(pm: torch.Tensor, fl: torch.Tensor,
                           c00: torch.Tensor, c01: torch.Tensor,
                           c10: torch.Tensor, c11: torch.Tensor,
                           p: int = 4) -> torch.Tensor:
    """Plain version of P4c, in the order of roundings of
    scripts/msda_packed_probe2.py::_packed_coeff_kernel (:102-124): the
    map row widened to f32, row[0:D]·c00 + row[D:2D]·c01 + row[2D:3D]·c10
    + row[3D:4D]·c11 added left to right, then each query's P samples in
    order. On `coeff_scalars(fy, fx, w)` it is `packed_gather_reference`,
    bit for bit. Returns (M, QP/P, D) f32."""
    check_coeff(pm, fl, c00, c01, c10, c11, p)
    return _packed_sum(pm, fl, (c00, c01, c10, c11), p)


def packed_wide_reference(pm: torch.Tensor, fl: torch.Tensor,
                          cf: torch.Tensor, p: int = 4) -> torch.Tensor:
    """Plain version of P4d, as scripts/msda_packed_probe2.py::
    _packed_wide_kernel (:157-179) rounds: the map row widened to f32 times
    the sample's cf row, lane by lane, then each query's P samples in
    order. Returns (M, QP/P, 4D) f32, the four corner groups kept; NaN on
    every lane of an out-of-range sample's query."""
    check_wide(pm, fl, cf, p)
    rows, valid = _packed_rows(pm, fl)
    v = (rows * cf).masked_fill_(~valid[..., None], float("nan"))
    return _sum_points(v, p)


def sample_case(hp: int, wp: int, qp: int, m: int, d: int,
                generator: torch.Generator, device: torch.device):
    """A probe case drawn as scripts/msda_pallas_probe.py::make_case draws
    it, from `generator` (on `device`): vm (m, hp, wp, d) standard normal
    f32; iy in [0, hp−2] and ix in [0, wp−2] uniform int32; fy, fx, w
    uniform in [0, 1) f32, each (m, qp). Returns (vm, iy, ix, fy, fx, w)."""
    kw = {"generator": generator, "device": device}
    vm = torch.randn(m, hp, wp, d, **kw)
    iy = torch.randint(0, hp - 1, (m, qp), dtype=torch.int32, **kw)
    ix = torch.randint(0, wp - 1, (m, qp), dtype=torch.int32, **kw)
    fy, fx, w = (torch.rand(m, qp, **kw) for _ in range(3))
    return vm, iy, ix, fy, fx, w


def _dispatch(what: str, plain: Callable, kernel: Callable,
              tensors: Sequence[torch.Tensor], *args) -> torch.Tensor:
    device = input_device(what, *tensors)
    if device == "cpu":
        return plain(*tensors, *args)
    if device == "cuda":
        return kernel(*tensors, *args)
    raise NotImplementedError(f"{what} has no path for device {device}")


def fused_gather(vm: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
                 fy: torch.Tensor, fx: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """P3a: w·bilinear(vm, iy, ix, fy, fx) a sample, (M, QP, D) f32."""
    return _dispatch("fused_gather", gather_reference,
                     cuda_msda.fused_gather_cuda, (vm, iy, ix, fy, fx, w))


def fused_gather_p4(vm: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
                    fy: torch.Tensor, fx: torch.Tensor, w: torch.Tensor,
                    p: int = 4) -> torch.Tensor:
    """P3b: P3a summed over each query's P consecutive samples,
    (M, QP/P, D) f32."""
    return _dispatch("fused_gather_p4", gather_p4_reference,
                     cuda_msda.fused_gather_p4_cuda, (vm, iy, ix, fy, fx, w),
                     p)


def fused_gather_per_head(vm: torch.Tensor, iy: torch.Tensor,
                          ix: torch.Tensor, fy: torch.Tensor,
                          fx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """P3c: P3a with one kernel launch a head on the card (M launches);
    the same function, (M, QP, D) f32."""
    return _dispatch("fused_gather_per_head", gather_reference,
                     cuda_msda.fused_gather_per_head_cuda,
                     (vm, iy, ix, fy, fx, w))


def packed_gather(pm: torch.Tensor, fl: torch.Tensor, fy: torch.Tensor,
                  fx: torch.Tensor, w: torch.Tensor,
                  p: int = 4) -> torch.Tensor:
    """P4a: the corner-packed gather summed over each query's P samples,
    (M, QP/P, D) f32 from an f32 or bf16 packed map."""
    return _dispatch("packed_gather", packed_gather_reference,
                     cuda_msda.packed_gather_cuda, (pm, fl, fy, fx, w), p)


def pair_staticr(vm: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
                 fy: torch.Tensor, fx: torch.Tensor, w: torch.Tensor,
                 p: int = 4) -> torch.Tensor:
    """P4b: P3b's sum over each query's P samples from an f32 or bf16 map,
    (M, QP/P, D) f32."""
    return _dispatch("pair_staticr", pair_staticr_reference,
                     cuda_msda.pair_staticr_cuda, (vm, iy, ix, fy, fx, w), p)


def packed_coeff(pm: torch.Tensor, fl: torch.Tensor, c00: torch.Tensor,
                 c01: torch.Tensor, c10: torch.Tensor, c11: torch.Tensor,
                 p: int = 4) -> torch.Tensor:
    """P4c: the corner-packed sum over each query's P samples with the
    corner weights given, (M, QP/P, D) f32 from an f32 or bf16 packed
    map."""
    return _dispatch("packed_coeff", packed_coeff_reference,
                     cuda_msda.packed_coeff_cuda,
                     (pm, fl, c00, c01, c10, c11), p)


def packed_wide(pm: torch.Tensor, fl: torch.Tensor, cf: torch.Tensor,
                p: int = 4) -> torch.Tensor:
    """P4d: Σ_p pm[fl]·cf lane by lane over each query's P samples,
    (M, QP/P, 4D) f32 with the four corner groups kept, from an f32 or bf16
    packed map."""
    return _dispatch("packed_wide", packed_wide_reference,
                     cuda_msda.packed_wide_cuda, (pm, fl, cf), p)
