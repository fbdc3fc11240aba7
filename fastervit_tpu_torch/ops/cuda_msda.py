"""Binding and launch of K5, the hand-written multi-scale deformable
attention forward (csrc/msda_fwd.cu), the Hopper counterpart of
fastervit_tpu/ops/msda_pallas.py::fused_bilinear_gather; of K7, its
backward (csrc/msda_bwd.cu), a col2im that computes fastervit_tpu/ops/
msda.py::_msda_core_bwd (XLA in the JAX package, so no Pallas kernel to
mirror); and of the MSDA gather probes' kernels (csrc/msda_probe.cu): P3a
`fused_gather_cuda`, P3b `fused_gather_p4_cuda`, P3c
`fused_gather_per_head_cuda`, P4a `packed_gather_cuda`, P4b
`pair_staticr_cuda`, P4c `packed_coeff_cuda` and P4d `packed_wide_cuda`,
the counterparts of scripts/msda_pallas_probe.py's,
scripts/msda_packed_probe.py's and scripts/msda_packed_probe2.py's Pallas
kernels. K5 runs the plan of `msda_plan`, K7 that of `msda_bwd_plan`,
P3a-c and P4a-c that of `probe_plan`; each C entry point checks its plan
and refuses one that no instance of its kernel runs.

The kernels are built with K1-K4 into one library by
`cuda_attention.build()` and loaded by its `_library()`. A failed build, an
unsupported shape or dtype, or a failed launch raises; nothing falls back
to the plain versions (`ops.msda.msda_reference`,
`ops.msda.msda_backward_reference`, `ops.msda_probes`). K5 and K7 are
called by `ops.msda.MSDeformAttnFunction`; K5 called directly on inputs
that need a gradient raises, since its output would drop it. The module
imports on a machine with no nvcc and no card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch

from fastervit_tpu_torch.ops import cuda_attention

MAX_CHANNELS = 64   # kMaxChannels in csrc/msda_fwd.cu
MAX_VECTOR_BYTES = 16  # the widest load a lane makes
_LANE_GROUPS = (4, 8, 16, 32)  # the group sizes csrc/msda_fwd.cu holds
_WARPS_PER_BLOCK = 8   # kMaxWarps in csrc/msda_fwd.cu
_DTYPES = (torch.float32, torch.bfloat16)
_INT32_MAX = 2 ** 31 - 1


class MsdaPlan(NamedTuple):
    """How K5 runs one head width D, dtype and `value` pointer
    (csrc/msda_fwd.cu): lanes a (n, q, m) row (G), channels a vector load
    (V), channels a lane holds (a multiple of V), rows a warp (32/G) and
    warps a block. The C entry point checks it and refuses what no
    instance of the kernel runs."""
    lanes: int
    vec: int
    channels: int
    rows_per_warp: int
    warps: int

    def as_c(self):
        """The five ints the C entry point takes (msda_fwd.cu::Plan)."""
        return (ctypes.c_int * 5)(*self)


def pointer_alignment(ptr: int) -> int:
    """The largest power of two, at most MAX_VECTOR_BYTES, that divides
    the address `ptr`."""
    return min(MAX_VECTOR_BYTES, ptr & -ptr) if ptr else MAX_VECTOR_BYTES


@functools.lru_cache(maxsize=None)
def msda_plan(d: int, dtype: torch.dtype,
              value_ptr_alignment: int) -> MsdaPlan:
    """The plan of K5 for heads of D channels in `dtype` (that of value,
    weights and output) and a `value` whose address is a multiple of
    value_ptr_alignment bytes.

    V is the widest vector, at most 16 bytes, that divides D and the
    alignment (bf16 D 32 at 16 bytes: V 8; D 33 or an odd element offset:
    V 1). G is the power of two, 4 to 32, that D's vectors fill best, one a
    lane (bf16 D 32: G 4, eight rows a warp; f32 D 32: G 8); past 32
    vectors (D > 32 with V 1) each of 32 lanes holds two. Eight warps a
    block."""
    if dtype not in _DTYPES:
        raise TypeError(f"K5 takes float32 or bfloat16, got {dtype}")
    if not 1 <= d <= MAX_CHANNELS:
        raise NotImplementedError(f"K5 takes 1 to {MAX_CHANNELS} channels a "
                                  f"head, got {d}")
    lanes, vec, per_lane = _lane_group(d, dtype, value_ptr_alignment)
    return MsdaPlan(lanes, vec, per_lane, 32 // lanes, _WARPS_PER_BLOCK)


def _lane_group(d: int, dtype: torch.dtype,
                ptr_alignment: int) -> Tuple[int, int, int]:
    """(G, V, channels a lane) of a group of lanes that holds D channels
    of `dtype` read from an address that is a multiple of ptr_alignment
    bytes: the widest vector of at most 16 bytes that divides D and the
    alignment, the fewest lanes (4 to 32, a power of two) that hold D's
    vectors one a lane, two a lane past 32 vectors."""
    elem = dtype.itemsize
    vec = MAX_VECTOR_BYTES // elem
    while vec > 1 and (d % vec or ptr_alignment % (vec * elem)):
        vec //= 2
    vectors = d // vec
    lanes = next(g for g in _LANE_GROUPS if g >= vectors or g == 32)
    return lanes, vec, -(-vectors // lanes) * vec


def check_supported(value_shape: Sequence[int], shapes: Tuple,
                    loc_shape: Sequence[int],
                    weights_shape: Sequence[int]) -> None:
    """Raise unless K5 takes these shapes: value (N, S, M, D) with
    D <= MAX_CHANNELS and S = Σ H·W over `shapes`, loc (N, Q, M, L, P, 2)
    and weights (N, Q, M, L, P) with L = len(shapes), and a grid CUDA can
    launch at one row a warp, the fewest rows a block any plan has (the C
    entry point checks the plan's own grid)."""
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
    if -(-n * q * m // _WARPS_PER_BLOCK) > _INT32_MAX or s > _INT32_MAX:
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
    `ms_deform_attn_cuda.launches` and keeps the latest launch's MsdaPlan
    (`msda_plan` of D, the dtype and value's address) in
    `ms_deform_attn_cuda.last_plan`.

    Called with gradients on and an input that needs one, it raises
    ValueError: its output would carry no gradient. `ops.msda.
    ms_deform_attn` runs it inside `MSDeformAttnFunction`, whose backward is
    K7 (`ms_deform_attn_backward_cuda`)."""
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
        raise ValueError(
            "K5 (ms_deform_attn_cuda) alone drops the gradient its inputs "
            "need: call fastervit_tpu_torch.ops.msda.ms_deform_attn, whose "
            "backward is K7")
    n, s, m, d = value.shape
    q, p = loc.shape[1], loc.shape[4]
    out = torch.empty((n, q, m * d), dtype=value.dtype, device=value.device)
    if n * q == 0:
        return out
    how = msda_plan(d, value.dtype, pointer_alignment(value.data_ptr()))
    loc = loc.float()  # the kernel's locations are f32, read as float2
    if loc.data_ptr() % 8:
        loc = loc.clone()
    levels = _level_table(shapes, value.device)
    lib = cuda_attention._library()
    with torch.cuda.device(value.device):
        err = lib.msda_forward(
            value.data_ptr(), levels.data_ptr(), loc.data_ptr(),
            weights.data_ptr(), out.data_ptr(), n, q, s, m, d, len(shapes),
            p, int(value.dtype == torch.bfloat16), how.as_c(),
            torch.cuda.current_stream().cuda_stream)
    cuda_attention._raise_on(err, "msda_forward")
    ms_deform_attn_cuda.launches += 1
    ms_deform_attn_cuda.last_plan = how
    return out


ms_deform_attn_cuda.launches = 0
ms_deform_attn_cuda.last_plan = None  # the MsdaPlan of the latest launch


# K7's launch (csrc/msda_bwd.cu): at most 16 warps a block and an SM, in
# one block or two (at most 128 registers a thread); a tile of at most a
# block's 232,448 bytes of shared memory less its static 7,168 (the level
# table, 1,024, and 12 bytes of results a thread)
_BWD_MAX_WARPS = 16
_BWD_STATIC_BYTES = 1_024 + 12 * 32 * _BWD_MAX_WARPS
BWD_MAX_TILE_BYTES = 232_448 - _BWD_STATIC_BYTES
_SMS = 132  # an H100's SMs, the plans' default card
# the plan's choices, measured at DINO-4scale's encoder and decoder calls
# (PERF.md, PR 18; probes/msda_turns.py --backward --sweep): the tile takes
# the coarsest levels that fit TILE_BLOCKS blocks an SM (2: level 3 at D
# 32, 35 KB, two blocks of 8 warps; Hopper adds a float into shared memory
# by a compare-and-swap loop, slower than L2's vector atomics, so a tile
# pays for a quarter of the adds and not for half: levels 2 and 3 in one
# block of 16 warps were slower than no tile), and only where a head's
# rows fill a round of the grid's chunks at least TILE_ROUNDS times (the
# decoder's 900 do not); a round of the grid's runs covers about
# HEADS_IN_FLIGHT heads, so that the maps the atomics reach stay in L2
_BWD_TILE_BLOCKS = 2
_BWD_TILE_ROUNDS = 1
_BWD_HEADS_IN_FLIGHT = 1


class MsdaBwdPlan(NamedTuple):
    """How K7 runs (csrc/msda_bwd.cu): K5's lanes a (n, q, m) row (G),
    channels a vector (V), channels a lane and rows a warp (32/G); warps a
    block; the persistent grid of `blocks`, which take the runs of `run`
    consecutive (n, m, q) rows in turn, `rounds` runs a block; the route,
    "smem" (an f32 tile of dvalue in shared memory for the `tiled` levels,
    a suffix of the coarsest, `tile_bytes` of one head's rows) or "l2"
    (every dvalue add a global atomic); and the blocks an SM that the tile
    and the warps allow. The C entry point checks it and refuses what no
    instance of the kernel runs."""
    lanes: int
    vec: int
    channels: int
    rows_per_warp: int
    warps: int
    blocks: int
    run: int
    rounds: int
    route: str
    tiled: Tuple[int, ...]
    tile_bytes: int
    blocks_per_sm: int

    def as_c(self):
        """The eleven ints the C entry point takes (msda_bwd.cu::Plan): the
        route as 0 ("l2") or 1 ("smem"), the tiled levels as a bit mask."""
        return (ctypes.c_int * 11)(
            *self[:8], int(self.route == "smem"),
            sum(1 << level for level in self.tiled), self.tile_bytes)


def _bwd_plan(d: int, dtype: torch.dtype, ptr_alignment: int,
              shapes: Tuple, queries: int, heads: int, sm_count: int,
              tile_blocks: int, tile_rounds: float,
              heads_in_flight: float) -> MsdaBwdPlan:
    """K7's plan with the choices given: the tile holds the longest suffix
    of the levels whose f32 rows fit tile_blocks blocks an SM, where a
    head's Q rows fill tile_rounds rounds of the grid's chunks (none at
    tile_rounds = inf); the grid, at most blocks-an-SM × sm_count blocks and
    a chunk of rows a warp, takes runs of whole chunks a warp, a round of
    them about heads_in_flight heads of Q rows."""
    lanes, vec, per_lane = _lane_group(d, dtype, ptr_alignment)
    rows_per_warp = 32 // lanes
    limit = min(BWD_MAX_TILE_BYTES, _SM_SMEM_BYTES // tile_blocks
                - _BLOCK_SMEM_RESERVE - _BWD_STATIC_BYTES)
    tiled, tile_bytes = (), 0
    for level in reversed(range(len(shapes))):
        h, w = shapes[level]
        if tile_bytes + h * w * d * 4 > limit:
            break
        tiled, tile_bytes = (level,) + tiled, tile_bytes + h * w * d * 4
    per_sm = 2
    if tiled:
        per_sm = min(2, _SM_SMEM_BYTES // (
            tile_bytes + _BWD_STATIC_BYTES + _BLOCK_SMEM_RESERVE))
    warps = _BWD_MAX_WARPS // per_sm
    if queries < tile_rounds * per_sm * sm_count * warps * rows_per_warp:
        tiled, tile_bytes, per_sm = (), 0, 2
        warps = _BWD_MAX_WARPS // per_sm
    rows, chunk = queries * heads, warps * rows_per_warp
    blocks = min(per_sm * sm_count, -(-rows // chunk))
    run = rounds = 0
    if blocks:
        # rounds of about heads_in_flight heads' rows, runs of whole
        # chunks a warp, the fewest blocks that then hold every row
        rounds = -(-rows // max(1, int(heads_in_flight * queries)))
        run = -(-rows // (rounds * blocks * chunk)) * chunk
        blocks = min(blocks, -(-rows // run))
        rounds = -(-rows // (blocks * run))
    if run > _INT32_MAX or rounds > _INT32_MAX:
        raise ValueError(f"{rows} rows exceed K7's 32-bit runs")
    return MsdaBwdPlan(lanes, vec, per_lane, rows_per_warp, warps, blocks,
                       run, rounds, "smem" if tiled else "l2", tiled,
                       tile_bytes, per_sm)


@functools.lru_cache(maxsize=None)
def msda_bwd_plan(d: int, dtype: torch.dtype, value_ptr_alignment: int,
                  grad_ptr_alignment: int, shapes: Tuple, queries: int,
                  heads: int, sm_count: int = _SMS) -> MsdaBwdPlan:
    """The plan of K7 for heads of D channels in `dtype` (that of value,
    weights, grad_out and dweights), a `value` and a `grad_out` whose
    addresses are multiples of the given alignments in bytes, the levels'
    (H, W) `shapes`, and N·M `heads` of Q `queries` rows each, on a card of
    sm_count SMs.

    Lanes, V and channels a lane are K5's (`msda_plan`) for the narrower of
    the two alignments, since K7 reads both in vectors of V elements (bf16
    D 32: G 4, V 8; f32: G 8, V 4). Its dvalue adds land on an f32 buffer
    in vectors of min(V, 4) floats: 16-byte vector atomics for V 4 and 8,
    8-byte for V 2, scalar for V 1 (csrc/msda_bwd.cu::add_f32).
    Route "smem" where the coarsest level's f32 rows of one head fit two
    blocks an SM and a head's rows fill a round of the grid's chunks: the
    tile takes the longest suffix of the levels that fits (DINO-4scale's
    encoder call at D 32: level 3, 34,944 bytes). Else route "l2" (the
    decoder's 900 queries a head). Two blocks of 8 warps an SM either way.
    The grid is at most the SMs' blocks and no more than gives each warp a
    chunk of 32/G rows; its runs hold whole chunks a warp, a round of them
    about one head's rows."""
    if dtype not in _DTYPES:
        raise TypeError(f"K7 takes float32 or bfloat16, got {dtype}")
    if not 1 <= d <= MAX_CHANNELS:
        raise NotImplementedError(f"K7 takes 1 to {MAX_CHANNELS} channels a "
                                  f"head, got {d}")
    return _bwd_plan(d, dtype, min(value_ptr_alignment, grad_ptr_alignment),
                     tuple(shapes), queries, heads, sm_count,
                     _BWD_TILE_BLOCKS, _BWD_TILE_ROUNDS, _BWD_HEADS_IN_FLIGHT)


def msda_bwd_flushes(plan: MsdaBwdPlan, queries: int) -> int:
    """The most tile flushes one element of dvalue receives under `plan`
    with Q queries a head: the runs that meet one head (its Q rows), at
    most ⌈Q / run⌉ + 1, on route "smem"; 0 on route "l2"."""
    if plan.route != "smem":
        return 0
    return min(plan.blocks, -(-queries // plan.run) + 1)


@functools.lru_cache(maxsize=64)
def _host_shapes(shapes: Tuple):
    """The levels' (H, W) as the C int array K7's entry point checks its
    plan against."""
    return (ctypes.c_int * (2 * len(shapes)))(*(x for hw in shapes
                                               for x in hw))


def ms_deform_attn_backward_cuda(value: torch.Tensor, spatial_shapes: Sequence,
                                 sampling_locations: torch.Tensor,
                                 attention_weights: torch.Tensor,
                                 grad_output: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """MSDA backward on the card (K7): the gradients (dvalue, dloc,
    dweights) of `ms_deform_attn_cuda`'s output with respect to its three
    inputs, given grad_output (N, Q, M·D) in value's dtype. It takes what
    K5 takes (value and weights both f32 or both bf16, the locations f32
    or, beside bf16 values, bf16; D <= 64; contiguous, on one card).
    Returns dvalue in value's dtype (summed in an f32 buffer with atomics,
    then rounded once), dloc in the locations' dtype and dweights in the
    weights'. Counts its launches in `ms_deform_attn_backward_cuda.
    launches` and keeps the latest launch's MsdaBwdPlan (`msda_bwd_plan`)
    in `ms_deform_attn_backward_cuda.last_plan`."""
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    loc, weights, g = sampling_locations, attention_weights, grad_output
    check_supported(value.shape, shapes, loc.shape, weights.shape)
    tensors = (value, loc, weights, g)
    if value.device.type != "cuda" or any(t.device != value.device
                                          for t in tensors):
        raise ValueError("inputs must be on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if (value.dtype not in _DTYPES or weights.dtype != value.dtype
            or g.dtype != value.dtype
            or loc.dtype not in (value.dtype, torch.float32)):
        raise TypeError("K7 takes value, attention weights and grad_output "
                        "all float32 or all bfloat16, with float32 "
                        "locations or locations in value's dtype; got "
                        f"{[t.dtype for t in tensors]}")
    n, s, m, d = value.shape
    q, p = loc.shape[1], loc.shape[4]
    if tuple(g.shape) != (n, q, m * d):
        raise ValueError(f"grad_output must be {(n, q, m * d)}, got "
                         f"{tuple(g.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")
    dvalue = torch.zeros(value.shape, dtype=torch.float32,
                         device=value.device)
    dloc = torch.zeros(loc.shape, dtype=torch.float32, device=value.device)
    dweights = torch.zeros_like(weights)
    if n * q:
        how = msda_bwd_plan(d, value.dtype,
                            pointer_alignment(value.data_ptr()),
                            pointer_alignment(g.data_ptr()), shapes, q,
                            n * m, _sm_count(value.device))
        loc32 = loc.float()  # the kernel's locations are f32, read as float2
        if loc32.data_ptr() % 8:
            loc32 = loc32.clone()
        levels = _level_table(shapes, value.device)
        lib = cuda_attention._library()
        with torch.cuda.device(value.device):
            err = lib.msda_backward(
                value.data_ptr(), levels.data_ptr(), loc32.data_ptr(),
                weights.data_ptr(), g.data_ptr(), dvalue.data_ptr(),
                dloc.data_ptr(), dweights.data_ptr(), n, q, s, m, d,
                len(shapes), p, int(value.dtype == torch.bfloat16),
                _host_shapes(shapes), how.as_c(),
                torch.cuda.current_stream().cuda_stream)
        cuda_attention._raise_on(err, "msda_backward")
        ms_deform_attn_backward_cuda.launches += 1
        ms_deform_attn_backward_cuda.last_plan = how
    return dvalue.to(value.dtype), dloc.to(loc.dtype), dweights


ms_deform_attn_backward_cuda.launches = 0
ms_deform_attn_backward_cuda.last_plan = None  # the latest MsdaBwdPlan


# The MSDA gather probes' kernels, P3a-c and P4a-d (csrc/msda_probe.cu)
PROBE_MAX_CHANNELS = 64       # kMaxChannels in csrc/msda_probe.cu
PROBE_POINTS = (1, 2, 4)      # the instantiations of its P
_MAX_HEADS = 65535            # kMaxGridY: P4d's grid row a head, the
#                               limit of every entry point
_INT32_MAX = 2 ** 31 - 1      # its offsets are 32-bit
PROBE_MODES = ("pair", "packed", "coeff")   # the modes that run a ProbePlan
PROBE_MAX_WARPS = 32          # kMaxWarps: warps a block, at most
PROBE_SMEM_BYTES = 232_448    # kMaxSmemBytes: a block's dynamic shared
#                               memory, at most (227 KB)
_SM_SMEM_BYTES = 233_472      # an SM's shared memory (228 KB) ...
_BLOCK_SMEM_RESERVE = 1_024   # ... of which the card keeps 1 KB a block
# 32 warps an SM at 64 registers a thread: route "l2" in four blocks of 8
# warps; route "smem" in as many blocks as their map copies fit, at most 4
_WARPS_PER_SM, _L2_BLOCKS_PER_SM, _SMEM_BLOCKS_PER_SM = 32, 4, 4


class ProbePlan(NamedTuple):
    """How P3a-c, P4a, P4b and P4c run (csrc/msda_probe.cu's pair, packed and
    coeff mode): lanes an output row (G), channels a vector load (V), channels
    a lane holds (a multiple of V), rows a warp (32/G), warps a block, blocks
    (the persistent grid; a launch takes no more than its rows need) and the
    route: "l2", the corners read from the map in device memory through L2,
    chunks of rows walked head-major by grid stride; or "smem", each block's
    run of chunks read from a copy of its head's map in shared memory. The C
    entry points check it and refuse what no instance of the kernel runs."""
    lanes: int
    vec: int
    channels: int
    rows_per_warp: int
    warps: int
    blocks: int
    route: str

    def as_c(self):
        """The seven ints the C entry points take (msda_probe.cu::Plan):
        the route as 0 ("l2") or 1 ("smem")."""
        return (ctypes.c_int * 7)(*self[:6], int(self.route == "smem"))


@functools.lru_cache(maxsize=None)
def probe_plan(mode: str, d: int, dtype: torch.dtype,
               map_bytes_per_head: int, ptr_alignment: int,
               sm_count: int) -> ProbePlan:
    """The plan of a pair-mode (P3a-c, P4b: `mode` "pair"), packed-mode
    (P4a: "packed") or coeff-mode (P4c: "coeff") launch on heads of D
    channels whose map, in `dtype`, holds map_bytes_per_head bytes a head
    from an address that is a multiple of ptr_alignment bytes, on a card
    of sm_count SMs.

    G, V and the channels a lane are K5's (`msda_plan`): f32 D 32 on a
    16-byte address G 8, V 4; bf16 G 4, V 8; an odd element offset V 1.
    A pair-mode map that fits a block's shared memory (PROBE_SMEM_BYTES;
    MOTR's level 3, 172.8 KB f32) takes route "smem": as many blocks an SM
    as their copies of the map fit, 1, 2 or 4, of 32 warps an SM between
    them (f32 level 3: one block of 32 warps; bf16: two of 16). Every other
    map, and every packed or coeff one, takes route "l2": four blocks of 8
    warps an SM."""
    if mode not in PROBE_MODES:
        raise ValueError(f"probe_plan's modes are {PROBE_MODES}, got {mode}")
    if dtype not in _DTYPES:
        raise TypeError(f"the probe kernels take a float32 or bfloat16 map, "
                        f"got {dtype}")
    if not 1 <= d <= PROBE_MAX_CHANNELS:
        raise NotImplementedError(f"the probe kernels take 1 to "
                                  f"{PROBE_MAX_CHANNELS} channels, got {d}")
    lanes, vec, per_lane = _lane_group(d, dtype, ptr_alignment)
    if mode == "pair" and map_bytes_per_head <= PROBE_SMEM_BYTES:
        fit = min(_SMEM_BLOCKS_PER_SM, _SM_SMEM_BYTES // (
            map_bytes_per_head + _BLOCK_SMEM_RESERVE))
        per_sm = 1 << (fit.bit_length() - 1)  # 1, 2 or 4: whole warps
        return ProbePlan(lanes, vec, per_lane, 32 // lanes,
                         _WARPS_PER_SM // per_sm, per_sm * sm_count, "smem")
    return ProbePlan(lanes, vec, per_lane, 32 // lanes,
                     _WARPS_PER_SM // _L2_BLOCKS_PER_SM,
                     _L2_BLOCKS_PER_SM * sm_count, "l2")


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _probe_plan_for(mode: str, vm: torch.Tensor, d: int) -> ProbePlan:
    """probe_plan for one head of the map vm (pair (.., Hp, Wp, D); packed
    and coeff (.., cells, 4D)) as it lies on its card."""
    per_head = vm.shape[-1] * vm.shape[-2] * vm.element_size()
    if mode == "pair":
        per_head *= vm.shape[-3]
    return probe_plan(mode, d, vm.dtype, per_head,
                      pointer_alignment(vm.data_ptr()), _sm_count(vm.device))


def _check_scalars(what: str, heads: int, indices: Sequence[torch.Tensor],
                   floats: Sequence[torch.Tensor],
                   floats_are: str = "fractions and weights") -> int:
    """Raise unless the index tensors are int32 and the float streams
    (fractions and weights, or corner weights) f32, all (M, QP); returns
    QP."""
    tensors = (*indices, *floats)
    if indices[0].dim() != 2 or indices[0].shape[0] != heads or any(
            t.shape != indices[0].shape for t in tensors):
        names = f"indices, {floats_are}" if floats else "indices"
        raise ValueError(f"{what}: {names} must all be (M, QP) with "
                         f"M = {heads}, got "
                         f"{[tuple(t.shape) for t in tensors]}")
    if any(t.dtype != torch.int32 for t in indices):
        raise TypeError(f"{what}: indices must be int32, got "
                        f"{[t.dtype for t in indices]}")
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError(f"{what}: {floats_are} must be float32, got "
                        f"{[t.dtype for t in floats]}")
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


def _check_unpacked(what: str, vm: torch.Tensor,
                    scalars: Sequence[torch.Tensor], points: int,
                    dtypes: Tuple[torch.dtype, ...], takes: str) -> None:
    """Raise unless vm (M, Hp, Wp, D) in `dtypes` (`takes` says which) and
    the samples' iy, ix, fy, fx, w fit a pair-mode kernel (P3a-c, P4b)."""
    if vm.dim() != 4:
        raise ValueError(f"{what}: vm must be (M, Hp, Wp, D), got "
                         f"{tuple(vm.shape)}")
    if vm.dtype not in dtypes:
        raise TypeError(f"{what} takes {takes}, got {vm.dtype}")
    m, hp, wp, d = vm.shape
    if hp < 2 or wp < 2:
        raise ValueError(f"{what}: the padded map must be at least 2x2, got "
                         f"{hp}x{wp}")
    iy, ix, fy, fx, w = scalars
    qp = _check_scalars(what, m, (iy, ix), (fy, fx, w))
    _check_points(what, qp, points)
    _check_sizes(what, m, d, vm.numel(), iy.numel(), m * (qp // points) * d)


def check_gather(vm: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
                 fy: torch.Tensor, fx: torch.Tensor, w: torch.Tensor,
                 points: int = 1, what: str = "fused_gather") -> None:
    """Raise unless P3a-c take these inputs: vm (M, Hp, Wp, D) float32 with
    Hp, Wp >= 2 and 1 <= D <= PROBE_MAX_CHANNELS; iy, ix (M, QP) int32;
    fy, fx, w (M, QP) float32; P in PROBE_POINTS dividing QP; M <= 65535
    and every tensor, the output (M, QP/P, D) too, under 2^31 elements.
    The JAX probes take an f32 map only (a bf16 one fails at their store),
    and so do these."""
    _check_unpacked(what, vm, (iy, ix, fy, fx, w), points,
                    (torch.float32,), "a float32 map, as the JAX probe does")


def check_pair(vm: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
               fy: torch.Tensor, fx: torch.Tensor, w: torch.Tensor,
               points: int) -> None:
    """Raise unless P4b takes these inputs: those of `check_gather`, but the
    map float32 or bfloat16, as the JAX `pair_staticr` widens its patch
    (msda_packed_probe2.py:54)."""
    _check_unpacked("pair_staticr", vm, (iy, ix, fy, fx, w), points,
                    _DTYPES, "a float32 or bfloat16 map")


def _check_packed_map(what: str, pm: torch.Tensor) -> Tuple[int, int]:
    """Raise unless pm is (M, cells, 4D) float32 or bfloat16 with cells >= 1;
    returns (M, D)."""
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
    return m, d4 // 4


def check_packed(pm: torch.Tensor, fl: torch.Tensor, fy: torch.Tensor,
                 fx: torch.Tensor, w: torch.Tensor, points: int) -> None:
    """Raise unless P4a takes these inputs: pm (M, cells, 4D) float32 or
    bfloat16 with cells >= 1 and 1 <= D <= PROBE_MAX_CHANNELS; fl (M, QP)
    int32; fy, fx, w (M, QP) float32; P in PROBE_POINTS dividing QP;
    M <= 65535 and every tensor, the output (M, QP/P, D) too, under 2^31
    elements."""
    what = "packed_gather"
    m, d = _check_packed_map(what, pm)
    qp = _check_scalars(what, m, (fl,), (fy, fx, w))
    _check_points(what, qp, points)
    _check_sizes(what, m, d, pm.numel(), fl.numel(), m * (qp // points) * d)


def check_coeff(pm: torch.Tensor, fl: torch.Tensor, c00: torch.Tensor,
                c01: torch.Tensor, c10: torch.Tensor, c11: torch.Tensor,
                points: int) -> None:
    """Raise unless P4c takes these inputs: those of `check_packed`, with
    the four corner weights c00, c01, c10, c11 (M, QP) float32 in place of
    fy, fx, w."""
    what = "packed_coeff"
    m, d = _check_packed_map(what, pm)
    qp = _check_scalars(what, m, (fl,), (c00, c01, c10, c11),
                        "corner weights")
    _check_points(what, qp, points)
    _check_sizes(what, m, d, pm.numel(), fl.numel(), m * (qp // points) * d)


def check_wide(pm: torch.Tensor, fl: torch.Tensor, cf: torch.Tensor,
               points: int) -> None:
    """Raise unless P4d takes these inputs: pm and fl as `check_packed`
    takes them and cf exactly (M, QP, 4D) float32, a coefficient row a
    sample; every tensor, cf and the output (M, QP/P, 4D) too, under 2^31
    elements."""
    what = "packed_wide"
    m, d = _check_packed_map(what, pm)
    qp = _check_scalars(what, m, (fl,), ())
    if tuple(cf.shape) != (m, qp, 4 * d):
        raise ValueError(f"{what}: cf must be (M, QP, 4D) = "
                         f"{(m, qp, 4 * d)}, got {tuple(cf.shape)}")
    if cf.dtype != torch.float32:
        raise TypeError(f"{what}: cf must be float32, got {cf.dtype}")
    _check_points(what, qp, points)
    _check_sizes(what, m, d, pm.numel(), fl.numel(), cf.numel(),
                 m * (qp // points) * 4 * d)


def _probe_output(what: str, tensors: Sequence[torch.Tensor], d: int,
                  points: int) -> torch.Tensor:
    """Check that a probe kernel's inputs (the map, then its per-sample
    streams, the first (M, QP)) lie contiguous on one card and need no
    gradient, and allocate its f32 output (M, QP/P, D), D the output
    row's width."""
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
                   out: torch.Tensor, heads: int, points: int) -> ProbePlan:
    """One launch of msda_probe_pair over `heads` heads, from the first
    elements of vm (.., Hp, Wp, D), f32 or bf16, the scalars (.., QP) and
    out; returns its plan."""
    hp, wp, d = vm.shape[-3:]
    how = _probe_plan_for("pair", vm, d)
    lib = cuda_attention._library()
    with torch.cuda.device(vm.device):
        err = lib.msda_probe_pair(
            vm.data_ptr(), *(t.data_ptr() for t in scalars), out.data_ptr(),
            heads, scalars[0].shape[-1], hp, wp, d, points,
            int(vm.dtype == torch.bfloat16), how.as_c(),
            torch.cuda.current_stream().cuda_stream)
    cuda_attention._raise_on(err, "msda_probe_pair")
    return how


def fused_gather_cuda(vm: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
                      fy: torch.Tensor, fx: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """P3a on the card: out[m, i] = w·bilinear(vm[m], iy, ix, fy, fx) for
    every sample i, (M, QP, D) f32 (see `check_gather`). Counts its
    launches in `fused_gather_cuda.launches` and keeps the latest one's
    ProbePlan in `fused_gather_cuda.last_plan`."""
    scalars = (iy, ix, fy, fx, w)
    out = _gather_output("fused_gather", vm, scalars, 1)
    if out.numel():
        fused_gather_cuda.last_plan = _gather_launch(vm, scalars, out,
                                                     vm.shape[0], 1)
        fused_gather_cuda.launches += 1
    return out


fused_gather_cuda.launches = 0
fused_gather_cuda.last_plan = None  # the ProbePlan of the latest launch


def fused_gather_p4_cuda(vm: torch.Tensor, iy: torch.Tensor,
                         ix: torch.Tensor, fy: torch.Tensor,
                         fx: torch.Tensor, w: torch.Tensor,
                         p: int = 4) -> torch.Tensor:
    """P3b on the card: P3a summed over each query's P consecutive samples
    in order, (M, QP/P, D) f32. Counts its launches in
    `fused_gather_p4_cuda.launches` and keeps the latest one's ProbePlan in
    `fused_gather_p4_cuda.last_plan`."""
    scalars = (iy, ix, fy, fx, w)
    out = _gather_output("fused_gather_p4", vm, scalars, p)
    if out.numel():
        fused_gather_p4_cuda.last_plan = _gather_launch(vm, scalars, out,
                                                        vm.shape[0], p)
        fused_gather_p4_cuda.launches += 1
    return out


fused_gather_p4_cuda.launches = 0
fused_gather_p4_cuda.last_plan = None  # the ProbePlan of the latest launch


def fused_gather_per_head_cuda(vm: torch.Tensor, iy: torch.Tensor,
                               ix: torch.Tensor, fy: torch.Tensor,
                               fx: torch.Tensor,
                               w: torch.Tensor) -> torch.Tensor:
    """P3c on the card: P3a with one launch a head, each over that head's
    map and samples alone, into one (M, QP, D) f32 output. Counts its M
    launches a call in `fused_gather_per_head_cuda.launches` and keeps the
    latest one's ProbePlan (its grid spreads the one head over every SM)
    in `fused_gather_per_head_cuda.last_plan`."""
    scalars = (iy, ix, fy, fx, w)
    out = _gather_output("fused_gather_per_head", vm, scalars, 1)
    if out.numel():
        for h in range(vm.shape[0]):
            fused_gather_per_head_cuda.last_plan = _gather_launch(
                vm[h], [t[h] for t in scalars], out[h], 1, 1)
            fused_gather_per_head_cuda.launches += 1
    return out


fused_gather_per_head_cuda.launches = 0
fused_gather_per_head_cuda.last_plan = None  # the latest launch's ProbePlan


def _packed_launch(entry: str, pm: torch.Tensor,
                   streams: Sequence[torch.Tensor], out: torch.Tensor,
                   points: int, *plan) -> None:
    """One launch of the C entry point `entry` (msda_probe_packed or
    msda_probe_coeff, with its plan's ints, or msda_probe_wide) on the
    packed map pm (f32 or bf16), fl and its float streams."""
    lib = cuda_attention._library()
    with torch.cuda.device(pm.device):
        err = getattr(lib, entry)(
            pm.data_ptr(), *(t.data_ptr() for t in streams), out.data_ptr(),
            pm.shape[0], streams[0].shape[1], pm.shape[1], pm.shape[2] // 4,
            points, int(pm.dtype == torch.bfloat16), *plan,
            torch.cuda.current_stream().cuda_stream)
    cuda_attention._raise_on(err, entry)


def packed_gather_cuda(pm: torch.Tensor, fl: torch.Tensor, fy: torch.Tensor,
                       fx: torch.Tensor, w: torch.Tensor,
                       p: int = 4) -> torch.Tensor:
    """P4a on the card: the corner-packed sum over each query's P samples,
    (M, QP/P, D) f32 from an f32 or bf16 packed map (see `check_packed`).
    Counts its launches in `packed_gather_cuda.launches` and keeps the
    latest one's ProbePlan in `packed_gather_cuda.last_plan`."""
    check_packed(pm, fl, fy, fx, w, p)
    streams = (fl, fy, fx, w)
    d = pm.shape[2] // 4
    out = _probe_output("packed_gather", (pm, *streams), d, p)
    if out.numel():
        how = _probe_plan_for("packed", pm, d)
        _packed_launch("msda_probe_packed", pm, streams, out, p, how.as_c())
        packed_gather_cuda.launches += 1
        packed_gather_cuda.last_plan = how
    return out


packed_gather_cuda.launches = 0
packed_gather_cuda.last_plan = None  # the ProbePlan of the latest launch


def pair_staticr_cuda(vm: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
                      fy: torch.Tensor, fx: torch.Tensor, w: torch.Tensor,
                      p: int = 4) -> torch.Tensor:
    """P4b on the card: P3b's sum over each query's P samples from an f32
    or bf16 map, (M, QP/P, D) f32 (see `check_pair`). Counts its launches
    in `pair_staticr_cuda.launches` and keeps the latest one's ProbePlan in
    `pair_staticr_cuda.last_plan`."""
    check_pair(vm, iy, ix, fy, fx, w, p)
    scalars = (iy, ix, fy, fx, w)
    out = _probe_output("pair_staticr", (vm, *scalars), vm.shape[-1], p)
    if out.numel():
        pair_staticr_cuda.last_plan = _gather_launch(vm, scalars, out,
                                                     vm.shape[0], p)
        pair_staticr_cuda.launches += 1
    return out


pair_staticr_cuda.launches = 0
pair_staticr_cuda.last_plan = None  # the ProbePlan of the latest launch


def packed_coeff_cuda(pm: torch.Tensor, fl: torch.Tensor, c00: torch.Tensor,
                      c01: torch.Tensor, c10: torch.Tensor, c11: torch.Tensor,
                      p: int = 4) -> torch.Tensor:
    """P4c on the card: the corner-packed sum over each query's P samples
    with the corner weights given, (M, QP/P, D) f32 from an f32 or bf16
    packed map (see `check_coeff`). Counts its launches in
    `packed_coeff_cuda.launches` and keeps the latest one's ProbePlan in
    `packed_coeff_cuda.last_plan`."""
    check_coeff(pm, fl, c00, c01, c10, c11, p)
    streams = (fl, c00, c01, c10, c11)
    d = pm.shape[2] // 4
    out = _probe_output("packed_coeff", (pm, *streams), d, p)
    if out.numel():
        how = _probe_plan_for("coeff", pm, d)
        _packed_launch("msda_probe_coeff", pm, streams, out, p, how.as_c())
        packed_coeff_cuda.launches += 1
        packed_coeff_cuda.last_plan = how
    return out


packed_coeff_cuda.launches = 0
packed_coeff_cuda.last_plan = None  # the ProbePlan of the latest launch


def packed_wide_cuda(pm: torch.Tensor, fl: torch.Tensor, cf: torch.Tensor,
                     p: int = 4) -> torch.Tensor:
    """P4d on the card: Σ_p pm[fl]·cf over each query's P samples, lane by
    lane, (M, QP/P, 4D) f32 with the four corner groups kept, from an f32
    or bf16 packed map (see `check_wide`). Counts its launches in
    `packed_wide_cuda.launches`."""
    check_wide(pm, fl, cf, p)
    out = _probe_output("packed_wide", (pm, fl, cf), pm.shape[2], p)
    if out.numel():
        _packed_launch("msda_probe_wide", pm, (fl, cf), out, p)
        packed_wide_cuda.launches += 1
    return out


packed_wide_cuda.launches = 0
