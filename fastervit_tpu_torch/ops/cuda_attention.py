"""Build, binding and launch of the hand-written window-attention kernels,
the Hopper counterparts of fastervit_tpu/ops/pallas_attention.py's
`_mhsa_kernel` (K1, csrc/window_mhsa.cu) and `_mhsa_bwd_kernel` (K2,
csrc/window_mhsa_bwd.cu), and of pallas_flash_attention.py's `_fwd_kernel`
(K3, csrc/window_mhsa_long.cu) and `_flash_backward` (K4,
csrc/window_mhsa_long_bwd.cu). The same library holds K5, the
multi-scale deformable attention forward (csrc/msda_fwd.cu), and the MSDA
gather probes' kernels P3a-c and P4a-d (csrc/msda_probe.cu), which
`ops/cuda_msda.py` binds, and K6, the fused HAT sub-block
(csrc/hat_block.cu), which `ops/cuda_hat_block.py` binds. The long-window
attention probes' kernels are bound here too: P1, the chunked online-softmax
attention of scripts/attn_online_probe.py (csrc/attn_online.cu), and P2,
the bias-free attention of scripts/attn_vpu_probe.py (K3's kernel without
its bias, csrc/window_mhsa_long.cu), both behind `ops/attention_probes.py`.
Every attention kernel takes bf16 on Hopper's tensor cores (wgmma) and f32
on scalar FMA, by a plan made here and checked by the kernel: K1 by
`short_plan`, K2 by `short_bwd_plan`, K3, P1 and P2 by `long_plan`, K4 by
`long_bwd_plan`.

The kernels are compiled by nvcc at first use, from the package's own
sources, into `fastervit_tpu_torch/_build/` (keyed on a hash of the sources
and the flags), and loaded with ctypes. A failed build, an unsupported shape
or a failed launch raises; nothing falls back to the plain PyTorch version.
Nothing here needs nvcc or a card until a CUDA tensor reaches a wrapper, so
the module imports on a machine without either.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

MAX_SEQ = 128       # kMaxSeq in csrc/window_mhsa.cu
MAX_HEAD_DIM = 64   # kMaxHeadDim in csrc/window_mhsa.cu
BWD_MAX_SEQ = 64       # kMaxSeq in csrc/window_mhsa_bwd.cu
BWD_MAX_HEAD_DIM = 64  # kMaxHeadDim in csrc/window_mhsa_bwd.cu
# kMaxHeadDim and kTile in csrc/attn_tiles.cuh, the tile plans of K3, P1
# and P2: (B, S/64, H) blocks at most (`long_plan`)
LONG_MAX_HEAD_DIM = 128
_LONG_TILE = 64
SMEM_LIMIT = 232448  # the most shared memory an H100 block may use
_MAX_GRID_YZ = 65535     # CUDA's limit on a grid's y and z
# K1's tensor-core route and K2 give each block one head and a run of
# windows; about this many blocks, two an SM of an H100's 132, measured
# fastest of 132 to 4,224 at fv0's calls (PERF.md; `probes/short_turns.py
# --sweep`): fewer windows a block read the bias and zero the padding more
# often.
_SMS = 132
_FWD_TARGET_BLOCKS = 2 * _SMS
_BWD_TARGET_BLOCKS = 2 * _SMS
# csrc/short_tiles.cuh: a warpgroup's tile (64 rows, 64 keys), its operand
# stages, warpgroups a block (K1 at S <= 64 and above, K2)
_SHORT_TILE = 64
_SHORT_STAGES = 2
_SHORT_FWD_WARPGROUPS = (2, 1)
_SHORT_BWD_WARPGROUPS = 2
# K4's dbias pass gives each block a run of windows for one (q-tile, head)
# and an f32 (H, S, S) slab of partial sums per run: at most this many bytes
# of slabs (one slab is 340 MB at S = 2304, H = 16), and where it can, at
# least three waves of blocks (one an SM)
_LONG_BWD_PARTIAL_BYTES = 2 ** 30
_LONG_BWD_TARGET_BLOCKS = 3 * _SMS

_PKG_DIR = Path(__file__).resolve().parent.parent
_SRC_DIR = _PKG_DIR / "csrc"
_BUILD_DIR = _PKG_DIR / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_DTYPES = (torch.float32, torch.bfloat16)

_lib: Optional[ctypes.CDLL] = None


class ShortPlan(NamedTuple):
    """How K1 or K2 runs one window length, head dim and dtype
    (csrc/short_tiles.cuh): the route ("wgmma": bf16 on the tensor cores;
    "scalar": f32 on scalar FMA), the head dim padded with zeros (the
    products' depth and width; hd itself on the scalar route), key tiles
    (and row slabs) of 64 a window, windows in flight a block (one a
    warpgroup), operand stages a warpgroup, and a block's dynamic shared
    memory in bytes. The C entry points check it against their own
    (`short_attention_smem_bytes`, `short_attention_bwd_smem_bytes` give
    theirs)."""
    route: str
    depth: int
    key_tiles: int
    windows: int
    stages: int
    smem_bytes: int

    def as_c(self):
        """The six ints the C entry points take (short_tiles.cuh::Plan)."""
        return (ctypes.c_int * 6)(int(self.route == "wgmma"), self.depth,
                                  self.key_tiles, self.windows, self.stages,
                                  self.smem_bytes)


def _short_checks(what: str, seq: int, head_dim: int, max_seq: int,
                  dtype: torch.dtype, bias_dtype: torch.dtype) -> None:
    if not (1 <= seq <= max_seq and 1 <= head_dim <= MAX_HEAD_DIM):
        raise NotImplementedError(f"{what} takes S <= {max_seq} and "
                                  f"head_dim <= {MAX_HEAD_DIM}, got S={seq}, "
                                  f"head_dim={head_dim}")
    if dtype not in _DTYPES or bias_dtype not in _DTYPES:
        raise TypeError(f"float32 or bfloat16 operands, got {dtype} and "
                        f"bias {bias_dtype}")


@functools.lru_cache(maxsize=None)
def short_plan(seq: int, head_dim: int, dtype: torch.dtype,
               bias_dtype: torch.dtype) -> ShortPlan:
    """The plan of K1 for windows of S tokens, this hd, operand dtype and
    bias dtype.

    bf16 takes the tensor cores: hd padded to 32 or 64; one key tile and
    two warpgroups a block for S <= 64, two key tiles (and row slabs) and
    one warpgroup for 64 < S <= 128; the block's bias as f32 (64 × 64 a
    tile pair, widened from bf16) and each warpgroup's two stages of q, k
    and v (bf16) in shared memory. f32 keeps scalar FMA (TF32 would move
    the logits by ~1e-3): a block per window and head, q, k, v and the
    logits as f32, S·(3·hd + 1 + S) floats."""
    _short_checks("K1 (window_mhsa_cuda)", seq, head_dim, MAX_SEQ, dtype,
                  bias_dtype)
    if dtype == torch.bfloat16:
        d = 32 if head_dim <= 32 else 64
        r = 1 if seq <= _SHORT_TILE else 2
        w = _SHORT_FWD_WARPGROUPS[r - 1]
        smem = (4 * r * r * _SHORT_TILE ** 2
                + 2 * w * _SHORT_STAGES * 3 * r * _SHORT_TILE * d)
        return ShortPlan("wgmma", d, r, w, _SHORT_STAGES, smem)
    return ShortPlan("scalar", head_dim, 1, 1, 1,
                     4 * seq * (3 * head_dim + 1 + seq))


@functools.lru_cache(maxsize=None)
def short_bwd_plan(seq: int, head_dim: int, dtype: torch.dtype,
                   bias_dtype: torch.dtype) -> ShortPlan:
    """The plan of K2 for windows of S tokens, this hd, operand dtype and
    bias dtype.

    bf16 takes the tensor cores: hd padded to 32 or 64, one key tile, two
    warpgroups a block; in shared memory the block's bias as f32 (64 × 64)
    and each warpgroup's two stages of q, k, v and g and its P and dl tiles
    (bf16). f32 keeps scalar FMA: q, k, v, g, P, dl and the dbias sum as
    f32, S·(4·hd + 2 + 3·S) floats."""
    _short_checks("K2 (window_mhsa_backward_cuda)", seq, head_dim,
                  BWD_MAX_SEQ, dtype, bias_dtype)
    if dtype == torch.bfloat16:
        d = 32 if head_dim <= 32 else 64
        w = _SHORT_BWD_WARPGROUPS
        smem = (4 * _SHORT_TILE ** 2
                + 2 * w * (_SHORT_STAGES * 4 * _SHORT_TILE * d
                           + 2 * _SHORT_TILE ** 2))
        return ShortPlan("wgmma", d, 1, w, _SHORT_STAGES, smem)
    return ShortPlan("scalar", head_dim, 1, 1, 1,
                     4 * seq * (4 * head_dim + 2 + 3 * seq))


class LongPlan(NamedTuple):
    """How K3, P1 and P2 run one head dim and dtype (csrc/attn_tiles.cuh):
    the route ("wgmma": bf16 on the tensor cores; "scalar": f32 on scalar
    FMA), q rows a block, the q·kᵀ depth and p·v width (hd padded with
    zeros in shared memory), K/V tiles in shared memory, and a block's
    dynamic shared memory in bytes. The C entry points check it against
    their own (`long_attention_smem_bytes` gives theirs)."""
    route: str
    rows_per_block: int
    qk_depth: int
    pv_width: int
    stages: int
    smem_bytes: int

    def as_c(self):
        """The six ints the C entry points take (attn_tiles.cuh::Plan)."""
        return (ctypes.c_int * 6)(int(self.route == "wgmma"),
                                  self.rows_per_block, self.qk_depth,
                                  self.pv_width, self.stages,
                                  self.smem_bytes)


def long_plan(head_dim: int, dtype: torch.dtype,
              bias_dtype: Optional[torch.dtype] = None) -> LongPlan:
    """The plan of K3, P1 (a bias of bias_dtype) and P2 (no bias) for this
    hd and operand dtype. bf16 takes the tensor cores: 128 q rows a block
    (two warpgroups of 64), hd padded to 32, 64, 80 or 128 for both
    products, two stages of K/V (and bias) tiles. f32 keeps scalar FMA
    (TF32 would move the logits by ~1e-3): 64 rows a block, q·kᵀ over hd
    itself, p·v over hd rounded up to 32, 64, 96 or 128."""
    if not 1 <= head_dim <= LONG_MAX_HEAD_DIM:
        raise NotImplementedError(f"the long-window attention kernels (K3, "
                                  f"P1, P2) take head_dim <= "
                                  f"{LONG_MAX_HEAD_DIM}, got {head_dim}")
    if dtype not in _DTYPES or bias_dtype not in (None, *_DTYPES):
        raise TypeError(f"float32 or bfloat16 operands, got {dtype} and "
                        f"bias {bias_dtype}")
    if dtype == torch.bfloat16:
        d = next(w for w in (32, 64, 80, 128) if head_dim <= w)
        bias = 0 if bias_dtype is None else bias_dtype.itemsize
        # q, 2 stages of k and vᵀ (bf16), 2 of bias (128 rows of 64 + 8)
        smem = 2 * d * (128 + 2 * 2 * 64) + 2 * 128 * 72 * bias
        return LongPlan("wgmma", 128, d, d, 2, smem)
    width = 32 * -(-head_dim // 32)
    smem = 4 * ((2 * head_dim + _LONG_TILE) * (_LONG_TILE + 1)
                + _LONG_TILE * width)
    return LongPlan("scalar", _LONG_TILE, head_dim, width, 1, smem)


class LongBwdPlan(NamedTuple):
    """How K4 runs one head dim, operand dtype and bias dtype
    (csrc/window_mhsa_long_bwd.cu): the route ("wgmma": bf16 on the tensor
    cores; "scalar": f32 on scalar FMA), the head dim padded with zeros
    (the products' depth and width), q rows a block of the statistics and
    dq passes, keys a block of the dk+dv pass (each streams 64-token tiles
    of the other side), and for each of the three passes (statistics, dq
    and dbias, dk and dv) the tile stages in shared memory and a block's
    dynamic shared memory in bytes. The C entry point checks it against
    its own (`long_attention_bwd_smem_bytes` gives its shared memory)."""
    route: str
    depth: int
    rows_per_block: int
    keys_per_block: int
    stages: Tuple[int, int, int]
    smem_bytes: Tuple[int, int, int]

    def as_c(self):
        """The ten ints the C entry point takes (window_mhsa_long_bwd.cu::
        BwdPlan)."""
        return (ctypes.c_int * 10)(int(self.route == "wgmma"), self.depth,
                                   self.rows_per_block, self.keys_per_block,
                                   *self.stages, *self.smem_bytes)


def long_bwd_plan(head_dim: int, dtype: torch.dtype,
                  bias_dtype: torch.dtype) -> LongBwdPlan:
    """The plan of K4 for this hd, operand dtype and bias dtype.

    bf16 takes the tensor cores: 128 q rows (statistics, dq) or 128 keys
    (dk+dv) a block, hd padded to 32, 64, 80 or 128. Each pass keeps two
    128-row operands and stages 2 (statistics: k, v), 3 (dq: k, v, kᵀ) or
    4 (dk+dv: q, g, qᵀ, gᵀ) 64-row tiles and a bias tile ((128 rows,
    64 + 8 keys), or (64 rows, 128 keys + 16 bytes) with the tile's f32 L
    and D for dk+dv); dq also one f32 (128, 64) buffer of dbias partial
    sums. Two stages where they fit a block's SMEM_LIMIT, else one (dq at
    D 128, dk+dv at D 128 with an f32 bias).

    f32 keeps scalar FMA (TF32 would move the logits by ~1e-3): 64 rows or
    keys a block, hd padded to 32, 64, 96 or 128 for the accumulators, f32
    tiles with rows of hd_pad + 1."""
    if not 1 <= head_dim <= LONG_MAX_HEAD_DIM:
        raise NotImplementedError(f"K4 (window_mhsa_long_backward_cuda) "
                                  f"takes head_dim <= {LONG_MAX_HEAD_DIM}, "
                                  f"got {head_dim}")
    if dtype not in _DTYPES or bias_dtype not in _DTYPES:
        raise TypeError(f"float32 or bfloat16 operands, got {dtype} and "
                        f"bias {bias_dtype}")
    bias = bias_dtype.itemsize
    if dtype == torch.bfloat16:
        d = next(w for w in (32, 64, 80, 128) if head_dim <= w)
        stages, smem = [], []
        for tiles, bias_stage, slab in (
                (2, 128 * 72 * bias, 0), (3, 128 * 72 * bias, 128 * 64 * 4),
                (4, 64 * (128 + 16 // bias) * bias + 2 * 64 * 4, 0)):
            def size(n):
                return (2 * d * (2 * 128 + n * tiles * 64) + n * bias_stage
                        + slab)
            n = 2 if size(2) <= SMEM_LIMIT else 1
            stages.append(n)
            smem.append(size(n))
        return LongBwdPlan("wgmma", d, 128, 128, tuple(stages), tuple(smem))
    width = 32 * -(-head_dim // 32)
    tile = 4 * _LONG_TILE * (width + 1)
    pl = 4 * _LONG_TILE * (_LONG_TILE + 1)
    return LongBwdPlan("scalar", width, _LONG_TILE, _LONG_TILE, (1, 1, 1),
                       (4 * tile, 4 * tile + pl, 4 * tile + 2 * pl))


def _nvcc() -> str:
    # PyTorch's lookup: $CUDA_HOME or $CUDA_PATH, then nvcc on PATH, then
    # the toolkit's default install prefix
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the CUDA kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _run_all(cmds: Sequence[Sequence[str]]) -> str:
    """Run the commands at once; raise if any fails. Returns their output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{out}")
    return "".join(outs)


def build() -> Path:
    """Compile csrc/*.cu into one shared library unless a library built from
    the same sources and flags exists; returns its path. Each source is
    compiled by its own nvcc, all started together, then linked. nvcc's
    output (ptxas' register and shared-memory report) is kept beside the
    library as .log."""
    sources = sorted(_SRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in sorted(_SRC_DIR.glob("*.cu*")):
        digest.update(src.name.encode() + src.read_bytes())
    lib = _BUILD_DIR / f"libfastervit_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    nvcc = _nvcc()
    log = _run_all([[nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(sources, objs)])
    log += _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    for obj in objs:
        obj.unlink()
    lib.with_suffix(".log").write_text(log)
    os.replace(tmp, lib)
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.window_mhsa_forward.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_void_p] + [ctypes.c_int] * 2
            + [ctypes.c_void_p])
        lib.window_mhsa_forward.restype = ctypes.c_int
        lib.window_mhsa_backward.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
        lib.window_mhsa_backward.restype = ctypes.c_int
        lib.window_mhsa_long_forward.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
        lib.window_mhsa_long_forward.restype = ctypes.c_int
        lib.window_mhsa_long_backward.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
        lib.window_mhsa_long_backward.restype = ctypes.c_int
        lib.msda_forward.argtypes = (  # K5, bound in ops/cuda_msda.py
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
            + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        lib.msda_forward.restype = ctypes.c_int
        # the MSDA probes, bound in ops/cuda_msda.py: all but P4d (wide
        # mode, the first walk) take a ProbePlan's seven ints
        lib.msda_probe_packed.argtypes = (  # P4a
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
            + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        lib.msda_probe_packed.restype = ctypes.c_int
        lib.msda_probe_pair.argtypes = (  # P3a-c, P4b
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
            + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        lib.msda_probe_pair.restype = ctypes.c_int
        lib.msda_probe_coeff.argtypes = (  # P4c
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
            + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
        lib.msda_probe_coeff.restype = ctypes.c_int
        lib.msda_probe_wide.argtypes = (  # P4d
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.msda_probe_wide.restype = ctypes.c_int
        lib.hat_block_forward.argtypes = (  # K6, in ops/cuda_hat_block.py
            [ctypes.POINTER(ctypes.c_void_p)] + [ctypes.c_int] * 5
            + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_void_p])
        lib.hat_block_forward.restype = ctypes.c_int
        lib.attn_online_forward.argtypes = (  # P1
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 2
            + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
        lib.attn_online_forward.restype = ctypes.c_int
        lib.attn_nobias_forward.argtypes = (  # P2
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
            + [ctypes.c_longlong] * 6 + [ctypes.c_int]
            + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
        lib.attn_nobias_forward.restype = ctypes.c_int
        lib.short_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.short_attention_smem_bytes.restype = ctypes.c_longlong
        lib.short_attention_bwd_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.short_attention_bwd_smem_bytes.restype = ctypes.c_longlong
        lib.long_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.long_attention_smem_bytes.restype = ctypes.c_longlong
        lib.long_attention_bwd_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.long_attention_bwd_smem_bytes.restype = ctypes.c_longlong
        lib.hat_block_smem_bytes.argtypes = [ctypes.c_int] * 6
        lib.hat_block_smem_bytes.restype = ctypes.c_longlong
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_shapes(qkv_shape: Sequence[int], bias_shape: Sequence[int],
                  num_heads: int) -> Tuple[int, int, int]:
    """Raise unless qkv is (B, S, 3C) with C a multiple of num_heads and
    bias is (H, S, S); returns (B, S, hd)."""
    if len(qkv_shape) != 3 or qkv_shape[2] % 3:
        raise ValueError(f"qkv must be (B, S, 3C), got {tuple(qkv_shape)}")
    b, s, c3 = qkv_shape
    c = c3 // 3
    if num_heads <= 0 or c % num_heads:
        raise ValueError(f"C={c} is not a multiple of num_heads={num_heads}")
    if tuple(bias_shape) != (num_heads, s, s):
        raise ValueError(f"bias must be {(num_heads, s, s)}, got "
                         f"{tuple(bias_shape)}")
    return b, s, c // num_heads


def check_supported(qkv_shape: Sequence[int], bias_shape: Sequence[int],
                    num_heads: int) -> None:
    """Raise unless K1 takes these shapes: qkv (B, S, 3C), bias (H, S, S),
    S <= MAX_SEQ and hd = C/H <= MAX_HEAD_DIM. Longer windows and wider
    heads are K3's (`ops.attention.attention_route`)."""
    b, s, hd = _check_shapes(qkv_shape, bias_shape, num_heads)
    if s > MAX_SEQ or hd > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"K1 (window_mhsa_cuda) takes S <= {MAX_SEQ} and head_dim <= "
            f"{MAX_HEAD_DIM}, got S={s}, head_dim={hd}: such windows go to "
            "K3 (window_mhsa_long_cuda)")
    if b * num_heads > 2 ** 31 - 1:
        raise ValueError(f"B*H={b * num_heads} exceeds the launch grid")


def check_supported_long(qkv_shape: Sequence[int], bias_shape: Sequence[int],
                         num_heads: int) -> None:
    """Raise unless K3 takes these shapes: qkv (B, S, 3C), bias (H, S, S),
    any S >= 1, hd = C/H <= LONG_MAX_HEAD_DIM, and a grid of (B, S/64, H)
    blocks that CUDA can launch. The kernel computes every offset in 64
    bits, so B·S·3C and H·S² may exceed 2^31."""
    b, s, hd = _check_shapes(qkv_shape, bias_shape, num_heads)
    if hd > LONG_MAX_HEAD_DIM:
        raise NotImplementedError(f"K3 (window_mhsa_long_cuda) takes "
                                  f"head_dim <= {LONG_MAX_HEAD_DIM}, got {hd}")
    if (b > 2 ** 31 - 1 or num_heads > _MAX_GRID_YZ
            or -(-s // _LONG_TILE) > _MAX_GRID_YZ):
        raise ValueError(f"B={b}, S={s}, H={num_heads} exceed the launch "
                         "grid")


def check_supported_backward(qkv_shape: Sequence[int],
                             bias_shape: Sequence[int],
                             num_heads: int) -> None:
    """Raise unless the backward kernel K2 takes these shapes: qkv
    (B, S, 3C), bias (H, S, S), S <= BWD_MAX_SEQ (64) and
    hd <= BWD_MAX_HEAD_DIM (64): a window in one 64-row tile and one
    64-key tile on the tensor cores, and on the scalar route q, k, v, g, P,
    dl and the dbias sum of one window and head in shared memory (115 KB at
    S = hd = 64). Longer windows and wider heads are K4's
    (`ops.attention.backward_route`)."""
    b, s, hd = _check_shapes(qkv_shape, bias_shape, num_heads)
    if s > BWD_MAX_SEQ or hd > BWD_MAX_HEAD_DIM:
        raise NotImplementedError(
            f"the window-attention backward K2 takes S <= {BWD_MAX_SEQ} and "
            f"head_dim <= {BWD_MAX_HEAD_DIM}, got S={s}, head_dim={hd}: such "
            "windows go to K4 (window_mhsa_long_backward_cuda, the port of "
            "fastervit_tpu/ops/pallas_flash_attention.py::_flash_backward)")
    if b * num_heads > 2 ** 31 - 1:
        raise ValueError(f"B*H={b * num_heads} exceeds the launch grid")


def check_supported_long_backward(qkv_shape: Sequence[int],
                                  bias_shape: Sequence[int],
                                  num_heads: int) -> None:
    """Raise unless K4 takes these shapes: K3's, qkv (B, S, 3C), bias
    (H, S, S), any S >= 1 and hd = C/H <= LONG_MAX_HEAD_DIM, with grids of
    (B, S/64, H) and (groups, S/64, H) blocks that CUDA can launch. Every
    offset is 64-bit."""
    b, s, hd = _check_shapes(qkv_shape, bias_shape, num_heads)
    if hd > LONG_MAX_HEAD_DIM:
        raise NotImplementedError(
            f"K4 (window_mhsa_long_backward_cuda) takes head_dim <= "
            f"{LONG_MAX_HEAD_DIM}, got {hd}")
    if (b > 2 ** 31 - 1 or num_heads > _MAX_GRID_YZ
            or -(-s // _LONG_TILE) > _MAX_GRID_YZ):
        raise ValueError(f"B={b}, S={s}, H={num_heads} exceed the launch "
                         "grid")


def _check_inputs(qkv: torch.Tensor, bias: torch.Tensor,
                  *more: torch.Tensor) -> None:
    """Device, dtype and contiguity of a wrapper's tensors (shapes are
    checked by check_supported*)."""
    tensors = (qkv, bias, *more)
    if qkv.device.type != "cuda" or any(t.device != qkv.device
                                        for t in tensors):
        raise ValueError("inputs must be on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if qkv.dtype not in _DTYPES or bias.dtype not in _DTYPES:
        raise TypeError(f"qkv and bias must be float32 or bfloat16, got "
                        f"{qkv.dtype} and {bias.dtype}")
    if any(t.dtype != qkv.dtype for t in more):
        raise TypeError(f"g must have qkv's dtype {qkv.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{_library().cuda_error_string(err).decode()} "
                           f"({err})")


def window_mhsa_cuda(qkv: torch.Tensor, bias: torch.Tensor, num_heads: int,
                     scale: float) -> torch.Tensor:
    """softmax(q kᵀ·scale + bias) v per window and head, on the card (K1).
    qkv: (B, S, 3C) f32 or bf16, channels (3, H, hd); bias: (H, S, S) f32 or
    bf16. Returns (B, S, C) in qkv's dtype. bf16 runs on the tensor cores,
    f32 on scalar FMA (`short_plan`). Counts its launches in
    `window_mhsa_cuda.launches` and keeps the latest launch's ShortPlan in
    `window_mhsa_cuda.last_plan`."""
    check_supported(qkv.shape, bias.shape, num_heads)
    _check_inputs(qkv, bias)
    b, s, c3 = qkv.shape
    out = torch.empty((b, s, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    if b == 0:
        return out
    how = short_plan(s, c3 // 3 // num_heads, qkv.dtype, bias.dtype)
    per_block, groups = forward_grid(b, num_heads)
    lib = _library()
    with torch.cuda.device(qkv.device):
        err = lib.window_mhsa_forward(
            qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), b, s, c3 // 3,
            num_heads, int(qkv.dtype == torch.bfloat16),
            int(bias.dtype == torch.bfloat16), float(scale), how.as_c(),
            per_block, groups, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "window_mhsa")
    window_mhsa_cuda.launches += 1
    window_mhsa_cuda.last_plan = how
    return out


window_mhsa_cuda.launches = 0
window_mhsa_cuda.last_plan = None  # the ShortPlan of the latest launch


def window_mhsa_long_cuda(qkv: torch.Tensor, bias: torch.Tensor,
                          num_heads: int, scale: float) -> torch.Tensor:
    """softmax(q kᵀ·scale + bias) v per window and head, on the card, for
    any S (K3). qkv: (B, S, 3C) f32 or bf16, channels (3, H, hd), hd <= 128;
    bias: (H, S, S) f32 or bf16. Returns (B, S, C) in qkv's dtype. bf16
    runs on the tensor cores, f32 on scalar FMA (`long_plan`). Counts its
    launches in `window_mhsa_long_cuda.launches` and keeps the latest
    launch's LongPlan in `window_mhsa_long_cuda.last_plan`."""
    check_supported_long(qkv.shape, bias.shape, num_heads)
    _check_inputs(qkv, bias)
    b, s, c3 = qkv.shape
    out = torch.empty((b, s, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    if b == 0:
        return out
    how = long_plan(c3 // 3 // num_heads, qkv.dtype, bias.dtype)
    lib = _library()
    with torch.cuda.device(qkv.device):
        err = lib.window_mhsa_long_forward(
            qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), b, s, c3 // 3,
            num_heads, int(qkv.dtype == torch.bfloat16),
            int(bias.dtype == torch.bfloat16), float(scale), how.as_c(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "window_mhsa_long")
    window_mhsa_long_cuda.launches += 1
    window_mhsa_long_cuda.last_plan = how
    return out


window_mhsa_long_cuda.launches = 0
window_mhsa_long_cuda.last_plan = None  # the LongPlan of the latest launch


@functools.lru_cache(maxsize=None)
def _run_grid(batch: int, num_heads: int, target: int) -> Tuple[int, int]:
    """(windows per block, groups) of a (heads, groups) grid of about
    `target` blocks, every group non-empty."""
    groups = min(batch, max(1, -(-target // num_heads)))
    per_block = -(-batch // groups)
    return per_block, -(-batch // per_block)


def forward_grid(batch: int, num_heads: int) -> Tuple[int, int]:
    """(windows per block, groups) of K1's (heads, groups) grid: about
    _FWD_TARGET_BLOCKS blocks, every group non-empty. (The scalar route
    runs a block per window and head and only checks it.)"""
    return _run_grid(batch, num_heads, _FWD_TARGET_BLOCKS)


def backward_grid(batch: int, num_heads: int) -> Tuple[int, int]:
    """(windows per block, groups) of K2's (heads, groups) grid: about
    _BWD_TARGET_BLOCKS blocks, every group non-empty."""
    return _run_grid(batch, num_heads, _BWD_TARGET_BLOCKS)


def window_mhsa_backward_cuda(qkv: torch.Tensor, bias: torch.Tensor,
                              g: torch.Tensor, num_heads: int, scale: float
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients of window attention on the card (K2): (dqkv, dbias) for
    the output gradient g (B, S, C), with qkv (B, S, 3C) and bias (H, S, S)
    as the forward took them. dqkv is in qkv's dtype, dbias in bias's; dbias
    is summed over the windows in f32, in a fixed order. bf16 runs on the
    tensor cores, f32 on scalar FMA (`short_bwd_plan`). Counts its launches
    in `window_mhsa_backward_cuda.launches` and keeps the latest launch's
    ShortPlan in `window_mhsa_backward_cuda.last_plan`."""
    check_supported_backward(qkv.shape, bias.shape, num_heads)
    _check_inputs(qkv, bias, g)
    b, s, c3 = qkv.shape
    if tuple(g.shape) != (b, s, c3 // 3):
        raise ValueError(f"g must be {(b, s, c3 // 3)}, got {tuple(g.shape)}")
    dqkv = torch.empty_like(qkv)
    if b == 0:
        return dqkv, torch.zeros_like(bias)
    how = short_bwd_plan(s, c3 // 3 // num_heads, qkv.dtype, bias.dtype)
    dbias = torch.empty_like(bias)
    per_block, groups = backward_grid(b, num_heads)
    partial = torch.empty((groups,) + tuple(bias.shape), dtype=torch.float32,
                          device=qkv.device)
    lib = _library()
    with torch.cuda.device(qkv.device):
        err = lib.window_mhsa_backward(
            qkv.data_ptr(), bias.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
            dbias.data_ptr(), partial.data_ptr(), b, s, c3 // 3, num_heads,
            per_block, groups, int(qkv.dtype == torch.bfloat16),
            int(bias.dtype == torch.bfloat16), float(scale), how.as_c(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "window_mhsa_backward")
    window_mhsa_backward_cuda.launches += 1
    window_mhsa_backward_cuda.last_plan = how
    return dqkv, dbias


window_mhsa_backward_cuda.launches = 0
# the ShortPlan of the latest launch
window_mhsa_backward_cuda.last_plan = None


def long_backward_grid(batch: int, seq: int, num_heads: int,
                       rows: int) -> Tuple[int, int]:
    """(windows per block, groups) of K4's dq and dbias pass, a grid of
    (groups, S/rows, H) blocks (`rows`: the plan's q rows a block), every
    group non-empty, with at most _LONG_BWD_PARTIAL_BYTES of f32 (H, S, S)
    partial sums. Of those grids it takes one of at least
    _LONG_BWD_TARGET_BLOCKS blocks where there is one, then the one whose
    waves of blocks (one an SM) are fullest, to a hundredth, then the one
    with the most windows a block (the fewest slabs to sum): 4 windows a
    block at the 21k-384 step's level-2 and level-3 calls, which measured
    2-3% faster there than 2 or 5 on an H100 (PERF.md)."""
    tiles = -(-seq // rows) * num_heads
    most = max(1, _LONG_BWD_PARTIAL_BYTES // (4 * num_heads * seq * seq))
    best = None
    for per_block in range(1, batch + 1):
        groups = -(-batch // per_block)
        if groups > most or (best and groups == best[2]):
            continue
        blocks = groups * tiles
        fill = blocks / (_SMS * -(-blocks // _SMS))
        key = (blocks >= _LONG_BWD_TARGET_BLOCKS, round(fill, 2), per_block)
        if best is None or key > best[0]:
            best = (key, per_block, groups)
    return best[1], best[2]


def window_mhsa_long_backward_cuda(qkv: torch.Tensor, bias: torch.Tensor,
                                   g: torch.Tensor, num_heads: int,
                                   scale: float
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients of window attention on the card for any S (K4): (dqkv,
    dbias) for the output gradient g (B, S, C), with qkv (B, S, 3C) and bias
    (H, S, S) as the forward took them, hd <= 128. dqkv is in qkv's dtype,
    dbias in bias's; dbias is summed over the windows in f32, in a fixed
    order. bf16 runs on the tensor cores, f32 on scalar FMA
    (`long_bwd_plan`). The scratch (row statistics (2, B, H, S) and dbias
    partial sums (groups, H, S, S), f32) is allocated here. Counts its
    launches in `window_mhsa_long_backward_cuda.launches` and keeps the
    latest launch's LongBwdPlan in
    `window_mhsa_long_backward_cuda.last_plan`."""
    check_supported_long_backward(qkv.shape, bias.shape, num_heads)
    _check_inputs(qkv, bias, g)
    b, s, c3 = qkv.shape
    if tuple(g.shape) != (b, s, c3 // 3):
        raise ValueError(f"g must be {(b, s, c3 // 3)}, got {tuple(g.shape)}")
    dqkv = torch.empty_like(qkv)
    if b == 0:
        return dqkv, torch.zeros_like(bias)
    how = long_bwd_plan(c3 // 3 // num_heads, qkv.dtype, bias.dtype)
    dbias = torch.empty_like(bias)
    per_block, groups = long_backward_grid(b, s, num_heads,
                                           how.rows_per_block)
    stats = torch.empty((2, b, num_heads, s), dtype=torch.float32,
                        device=qkv.device)
    partial = torch.empty((groups,) + tuple(bias.shape), dtype=torch.float32,
                          device=qkv.device)
    lib = _library()
    with torch.cuda.device(qkv.device):
        err = lib.window_mhsa_long_backward(
            qkv.data_ptr(), bias.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
            dbias.data_ptr(), stats.data_ptr(), partial.data_ptr(), b, s,
            c3 // 3, num_heads, per_block, groups,
            int(qkv.dtype == torch.bfloat16),
            int(bias.dtype == torch.bfloat16), float(scale), how.as_c(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "window_mhsa_long_backward")
    window_mhsa_long_backward_cuda.launches += 1
    window_mhsa_long_backward_cuda.last_plan = how
    return dqkv, dbias


window_mhsa_long_backward_cuda.launches = 0
# the LongBwdPlan of the latest launch
window_mhsa_long_backward_cuda.last_plan = None


def check_chunks(seq: int, chunks: int) -> None:
    """Raise unless `chunks` is a positive divisor of S."""
    if chunks < 1 or seq % chunks:
        raise ValueError(f"chunks={chunks} must be a positive divisor of "
                         f"S={seq}: every chunk holds S/chunks keys")


def check_supported_probe(q_shape: Sequence[int], k_shape: Sequence[int],
                          v_shape: Sequence[int],
                          bias_shape: Optional[Sequence[int]] = None,
                          chunks: int = 1) -> None:
    """Raise unless P1 (given a bias) or P2 (without) takes these shapes:
    q, k and v alike (B, H, S, hd) with hd <= LONG_MAX_HEAD_DIM, bias
    (H, S, S), chunks a positive divisor of S, and a grid of (B, S/64, H)
    blocks that CUDA can launch. Every offset is 64-bit."""
    if len(q_shape) != 4 or tuple(k_shape) != tuple(q_shape) or \
            tuple(v_shape) != tuple(q_shape):
        raise ValueError(f"q, k and v must be alike (B, H, S, hd), got "
                         f"{tuple(q_shape)}, {tuple(k_shape)}, "
                         f"{tuple(v_shape)}")
    b, h, s, hd = q_shape
    if bias_shape is not None and tuple(bias_shape) != (h, s, s):
        raise ValueError(f"bias must be {(h, s, s)}, got "
                         f"{tuple(bias_shape)}")
    check_chunks(s, chunks)
    if hd > LONG_MAX_HEAD_DIM:
        raise NotImplementedError(
            f"the attention probes' kernels (P1, P2) take head_dim <= "
            f"{LONG_MAX_HEAD_DIM}, got {hd}")
    if (b > 2 ** 31 - 1 or h > _MAX_GRID_YZ
            or -(-s // _LONG_TILE) > _MAX_GRID_YZ):
        raise ValueError(f"B={b}, S={s}, H={h} exceed the launch grid")


def _probe_output(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  *bias: torch.Tensor) -> torch.Tensor:
    """Check a probe kernel's tensors (one CUDA device; q, k and v of one
    dtype and one layout, hd contiguous, as views of K3's packed qkv or
    separate (B, H, S, hd) tensors are; the bias contiguous) and allocate
    its output: q's shape and dtype, dense, its axes in q's order of
    strides. Empty tensors have no layout to check."""
    tensors = (q, k, v, *bias)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("inputs must be on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if any(t.dtype not in _DTYPES for t in tensors):
        raise TypeError(f"inputs must be float32 or bfloat16, got "
                        f"{[t.dtype for t in tensors]}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"k and v must have q's dtype {q.dtype}")
    if q.numel() and (k.stride() != q.stride() or v.stride() != q.stride()
                      or q.stride(-1) != 1):
        raise ValueError(f"q, k and v must have one layout with hd "
                         f"contiguous, got strides {q.stride()}, "
                         f"{k.stride()}, {v.stride()}")
    if not all(t.is_contiguous() for t in bias):
        raise ValueError("bias must be contiguous")
    return torch.empty_like(q, memory_format=torch.preserve_format)


def online_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor, scale: float,
                          chunks: int) -> torch.Tensor:
    """softmax(q kᵀ·scale + bias) v on the card with the key row in
    `chunks` chunks and a running (max, sum, context) rescaled once a chunk
    (P1). q, k, v: (B, H, S, hd) f32 or bf16 of one layout, hd <= 128;
    bias: (H, S, S) f32 or bf16; chunks divides S. Returns (B, H, S, hd) in
    q's dtype and order of axes. bf16 runs on the tensor cores, f32 on
    scalar FMA (`long_plan`). Counts its launches in
    `online_attention_cuda.launches` and keeps the latest launch's
    LongPlan in `online_attention_cuda.last_plan`."""
    check_supported_probe(q.shape, k.shape, v.shape, bias.shape, chunks)
    out = _probe_output(q, k, v, bias)
    if out.numel() == 0:
        return out
    b, h, s, hd = q.shape
    how = long_plan(hd, q.dtype, bias.dtype)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.attn_online_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, h, s, hd, chunks, *q.stride()[:3],
            *out.stride()[:3], int(q.dtype == torch.bfloat16),
            int(bias.dtype == torch.bfloat16), float(scale), how.as_c(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "attn_online")
    online_attention_cuda.launches += 1
    online_attention_cuda.last_plan = how
    return out


online_attention_cuda.launches = 0
online_attention_cuda.last_plan = None  # the LongPlan of the latest launch


def nobias_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """softmax(q kᵀ·scale) v on the card, with no bias operand (P2, K3's
    kernel without its bias). q, k, v: (B, H, S, hd) f32 or bf16 of one
    layout, hd <= 128: views of K3's packed qkv make it K3 less the bias
    stream. Returns (B, H, S, hd) in q's dtype and order of axes. bf16
    runs on the tensor cores, f32 on scalar FMA (`long_plan`). Counts its
    launches in `nobias_attention_cuda.launches` and keeps the latest
    launch's LongPlan in `nobias_attention_cuda.last_plan`."""
    check_supported_probe(q.shape, k.shape, v.shape)
    out = _probe_output(q, k, v)
    if out.numel() == 0:
        return out
    b, h, s, hd = q.shape
    how = long_plan(hd, q.dtype)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.attn_nobias_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, s,
            hd, *q.stride()[:3], *out.stride()[:3],
            int(q.dtype == torch.bfloat16), float(scale), how.as_c(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "attn_nobias")
    nobias_attention_cuda.launches += 1
    nobias_attention_cuda.last_plan = how
    return out


nobias_attention_cuda.launches = 0
nobias_attention_cuda.last_plan = None  # the LongPlan of the latest launch
