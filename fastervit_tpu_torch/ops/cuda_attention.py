"""Build, binding and launch of the hand-written window-attention kernel
(csrc/window_mhsa.cu), the Hopper counterpart of
fastervit_tpu/ops/pallas_attention.py::_mhsa_kernel.

The kernel is compiled by nvcc at first use, from the package's own sources,
into `fastervit_tpu_torch/_build/` (keyed on a hash of the sources and the
flags), and loaded with ctypes. A failed build, an unsupported shape or a
failed launch raises; nothing falls back to the plain PyTorch version.
Nothing here needs nvcc or a card until a CUDA tensor reaches
`window_mhsa_cuda`, so the module imports on a machine without either.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import torch

MAX_SEQ = 128       # kMaxSeq in csrc/window_mhsa.cu
MAX_HEAD_DIM = 64   # kMaxHeadDim in csrc/window_mhsa.cu

_PKG_DIR = Path(__file__).resolve().parent.parent
_SRC_DIR = _PKG_DIR / "csrc"
_BUILD_DIR = _PKG_DIR / "_build"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_DTYPES = (torch.float32, torch.bfloat16)

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    # PyTorch's lookup: $CUDA_HOME or $CUDA_PATH, then nvcc on PATH, then
    # the toolkit's default install prefix
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the CUDA kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> Path:
    """Compile csrc/*.cu into one shared library unless a library built from
    the same sources and flags exists; returns its path. nvcc's output
    (ptxas' register and shared-memory report) is kept beside it as .log."""
    sources = sorted(_SRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in sorted(_SRC_DIR.glob("*.cu*")):
        digest.update(src.name.encode() + src.read_bytes())
    lib = _BUILD_DIR / f"libfastervit_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.window_mhsa_forward.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_void_p])
        lib.window_mhsa_forward.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_supported(qkv_shape: Sequence[int], bias_shape: Sequence[int],
                    num_heads: int) -> None:
    """Raise unless the kernel takes these shapes: qkv (B, S, 3C), bias
    (H, S, S), S <= MAX_SEQ and hd = C/H <= MAX_HEAD_DIM."""
    if len(qkv_shape) != 3 or qkv_shape[2] % 3:
        raise ValueError(f"qkv must be (B, S, 3C), got {tuple(qkv_shape)}")
    b, s, c3 = qkv_shape
    c = c3 // 3
    if num_heads <= 0 or c % num_heads:
        raise ValueError(f"C={c} is not a multiple of num_heads={num_heads}")
    if tuple(bias_shape) != (num_heads, s, s):
        raise ValueError(f"bias must be {(num_heads, s, s)}, got "
                         f"{tuple(bias_shape)}")
    if s > MAX_SEQ:
        raise NotImplementedError(
            f"window attention with S={s} > {MAX_SEQ} needs the Q-tiled "
            "long-window kernel (fastervit_tpu/ops/pallas_flash_attention.py"
            "::_fwd_kernel, K3 in ROADMAP.md), which is not ported yet")
    if c // num_heads > MAX_HEAD_DIM:
        raise NotImplementedError(f"head_dim={c // num_heads} > "
                                  f"{MAX_HEAD_DIM} is not supported")
    if b * num_heads > 2 ** 31 - 1:
        raise ValueError(f"B*H={b * num_heads} exceeds the launch grid")


def window_mhsa_cuda(qkv: torch.Tensor, bias: torch.Tensor, num_heads: int,
                     scale: float) -> torch.Tensor:
    """softmax(q kᵀ·scale + bias) v per window and head, on the card.
    qkv: (B, S, 3C) f32 or bf16, channels (3, H, hd); bias: (H, S, S) f32 or
    bf16. Returns (B, S, C) in qkv's dtype. Counts its launches in
    `window_mhsa_cuda.launches`."""
    if qkv.device.type != "cuda" or bias.device != qkv.device:
        raise ValueError(f"qkv and bias must be on one CUDA device, got "
                         f"{qkv.device} and {bias.device}")
    if qkv.dtype not in _DTYPES or bias.dtype not in _DTYPES:
        raise TypeError(f"qkv and bias must be float32 or bfloat16, got "
                        f"{qkv.dtype} and {bias.dtype}")
    check_supported(qkv.shape, bias.shape, num_heads)
    if not (qkv.is_contiguous() and bias.is_contiguous()):
        raise ValueError("qkv and bias must be contiguous")
    b, s, c3 = qkv.shape
    out = torch.empty((b, s, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    if b == 0:
        return out
    lib = _library()
    with torch.cuda.device(qkv.device):
        err = lib.window_mhsa_forward(
            qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), b, s, c3 // 3,
            num_heads, int(qkv.dtype == torch.bfloat16),
            int(bias.dtype == torch.bfloat16), float(scale),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("window_mhsa kernel launch failed: "
                           f"{lib.cuda_error_string(err).decode()} ({err})")
    window_mhsa_cuda.launches += 1
    return out


window_mhsa_cuda.launches = 0
