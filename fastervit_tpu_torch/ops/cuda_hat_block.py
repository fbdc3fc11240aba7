"""Binding and launch of K6, the hand-written fused HAT sub-block
(csrc/hat_block.cu), the Hopper counterpart of
fastervit_tpu/ops/pallas_hat_block.py's `_hat_block_kernel` and
`_hat_block_kernel_dp`.

The kernel is built with K1-K5 into one library by `cuda_attention.build()`
and loaded by its `_library()`. A failed build, a shape K6 refuses, a wrong
dtype or a failed launch raises; nothing falls back to the plain version
(`ops.hat_block.hat_block_reference`). The module imports on a machine with
no nvcc and no card.

K6's limits are its own, not the TPU's VMEM: a window of S <= MAX_SEQ
tokens, a head dim <= MAX_HEAD_DIM, and a shared-memory plan within the
227 KB a block may use. Two routes (`plan`): bf16 at widths that are
multiples of 32 on the tensor cores (wgmma, the weight tiles streamed
through a ring of shared-memory slots), where its plan fits; f32, and bf16
at other widths, on scalar FMA (the f32 residual of the block's windows,
one head's qkv and logits, two staged GEMM tiles). The plan is made here,
once: the kernel takes it as five ints, checks it against its own formulas
and refuses one it cannot run.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Sequence

import torch

from fastervit_tpu_torch.ops import cuda_attention

MAX_SEQ = 64          # kMaxSeq in csrc/hat_block.cu
MAX_HEAD_DIM = 64     # kMaxHeadDim
SMEM_LIMIT = 232448   # kSmemLimit: 227 KB, the most an H100 block may use
_MAX_ROWS = 64        # kMaxRows: tokens a block holds, whole windows
_KT, _TILE_STRIDE = 32, 65  # kKT, kTileStride (the scalar route)
# the tensor-core route (namespace tcr): a ring slot holds a weight tile of
# _NT output columns × _KT_TC of depth in bf16; C and hidden are multiples
# of _WIDTH; the MLP runs in chunks of _HC hidden columns; each of the
# _WARPGROUPS consumer warpgroups keeps _ATTN_STAGES stages of q, k, v,
# each 64 rows × _ATTN_DEPTH (hd padded with zeros)
_NT, _KT_TC = 128, 64         # kNt, kKt
_SLOT_BYTES = _NT * _KT_TC * 2  # kSlotBytes
MIN_STAGES, MAX_STAGES = 3, 8   # kMinStages, kMaxStages
_WARPGROUPS = 2       # kWarpgroups
_HC = 128             # kHc
_ATTN_STAGES = 2      # kAttnStages
_ATTN_DEPTH = 64      # kD
_WIDTH = 32           # kWidth
_DTYPES = (torch.float32, torch.bfloat16)
# The fused block's params, in the order K6 takes them (the JAX package's
# _PARAM_ORDER), and the four matrices among them
PARAM_ORDER = ("ln1_scale", "ln1_bias", "qkv_w", "qkv_b", "proj_w", "proj_b",
               "gamma3", "ln2_scale", "ln2_bias", "fc1_w", "fc1_b", "fc2_w",
               "fc2_b", "gamma4")
MATRICES = ("qkv_w", "proj_w", "fc1_w", "fc2_w")


class Plan(NamedTuple):
    """How K6 runs a shape: the route ("wgmma": bf16 on the tensor cores,
    "scalar": scalar FMA), whole windows a block holds, the weight tiles
    the ring holds and the consumer warpgroups (both 0 on the scalar
    route), and the block's dynamic shared memory in bytes."""
    route: str
    windows_per_block: int
    stages: int
    warpgroups: int
    smem_bytes: int

    @property
    def tensor_cores(self) -> bool:
        return self.route == "wgmma"

    def as_c(self) -> tuple:
        """The five ints the C entry point takes."""
        return (int(self.tensor_cores), self.windows_per_block, self.stages,
                self.warpgroups, self.smem_bytes)


def _smem(seq: int, c: int, num_heads: int, wpb: int,
          route: str = "scalar", stages: int = 0) -> int:
    """hat_block_smem_bytes in csrc/hat_block.cu: the scalar route's
    layout, or the tensor-core route's with a ring of `stages` slots."""
    rows = wpb * seq
    if route == "wgmma":
        x_region = max(rows * c * 4,
                       _WARPGROUPS * _ATTN_STAGES * 3 * 64 * _ATTN_DEPTH * 2)
        return (stages * _SLOT_BYTES + 64 * c * 2 + 64 * _HC * 2 + x_region
                + 2 * 64 * 4 + 2 * stages * 8)
    floats = (rows * c + 2 * _MAX_ROWS + 2 * c + 2 * _KT * _TILE_STRIDE
              + rows * ((3 * (c // num_heads)) | 1) + rows * seq)
    return 4 * floats


def _tc_plan(b: int, seq: int, c: int, num_heads: int) -> Optional[Plan]:
    """The tensor-core plan: windows a block to fill the card (at least one
    block an SM where the batch allows, at most 64 tokens), then fewer
    while the ring's MIN_STAGES slots do not fit; the ring as deep as fits,
    up to MAX_STAGES. None if one window with MIN_STAGES does not fit."""
    blocks_per_card = cuda_attention._SMS
    wpb = max(1, min(_MAX_ROWS // seq, b, -(-b // blocks_per_card)))
    for w in range(wpb, 0, -1):
        free = SMEM_LIMIT - _smem(seq, c, num_heads, w, "wgmma", 0)
        stages = min(MAX_STAGES, free // (_SLOT_BYTES + 16))
        if stages >= MIN_STAGES:
            return Plan("wgmma", w, stages, _WARPGROUPS,
                        _smem(seq, c, num_heads, w, "wgmma", stages))
    return None


def _scalar_plan(b: int, seq: int, c: int, num_heads: int) -> Plan:
    """As many whole windows a block as fit in 64 tokens, the batch and
    SMEM_LIMIT, at least one."""
    wpb = max(1, min(_MAX_ROWS // seq, b))
    while wpb > 1 and _smem(seq, c, num_heads, wpb) > SMEM_LIMIT:
        wpb -= 1
    return Plan("scalar", wpb, 0, 0, _smem(seq, c, num_heads, wpb))


def plan(b: int, seq: int, c: int, hidden: int, num_heads: int,
         bf16: bool) -> Plan:
    """K6's plan for x (b, seq, c): the tensor cores for bf16 where C and
    hidden are multiples of 32 and a plan of theirs fits (`_tc_plan`),
    scalar FMA otherwise (`_scalar_plan`)."""
    if bf16 and c % _WIDTH == 0 and hidden % _WIDTH == 0:
        how = _tc_plan(b, seq, c, num_heads)
        if how is not None:
            return how
    return _scalar_plan(b, seq, c, num_heads)


def unsupported(x_shape: Sequence[int], c: int, hidden: int,
                num_heads: int) -> Optional[str]:
    """Why K6 refuses a sub-block of x (B, S, C) with this MLP width and
    head count, or None if it takes it."""
    if len(x_shape) != 3 or x_shape[2] != c:
        return f"x must be (B, S, {c}), got {tuple(x_shape)}"
    b, s, _ = x_shape
    if num_heads <= 0 or c % num_heads:
        return f"C={c} is not a multiple of num_heads={num_heads}"
    if hidden <= 0:
        return f"hidden width {hidden}"
    if not 1 <= s <= MAX_SEQ:
        return f"K6 takes 1 <= S <= {MAX_SEQ}, got S={s}"
    if c // num_heads > MAX_HEAD_DIM:
        return (f"K6 takes head_dim <= {MAX_HEAD_DIM}, got "
                f"{c // num_heads}")
    smem = _smem(s, c, num_heads, 1)
    if smem > SMEM_LIMIT:
        return (f"K6's shared-memory plan needs {smem} bytes at S={s}, "
                f"C={c}, H={num_heads}, over the {SMEM_LIMIT} a block may use")
    if -(-b // _scalar_plan(b, s, c, num_heads).windows_per_block) \
            > 2 ** 31 - 1 or num_heads * s * s > 2 ** 31 - 1:
        return f"B={b}, S={s}, H={num_heads} exceed the launch grid"
    return None


def check_supported(x_shape: Sequence[int], c: int, hidden: int,
                    num_heads: int) -> None:
    """Raise NotImplementedError, naming the limit, unless K6 takes it."""
    why = unsupported(x_shape, c, hidden, num_heads)
    if why is not None:
        raise NotImplementedError(why)


def _check(x: torch.Tensor, params: Dict[str, torch.Tensor],
           bias: torch.Tensor, num_heads: int) -> None:
    b, s, c = x.shape
    hidden = params["fc1_w"].shape[0]
    want = {"qkv_w": (3 * c, c), "proj_w": (c, c), "fc1_w": (hidden, c),
            "fc2_w": (c, hidden), "qkv_b": (3 * c,), "fc1_b": (hidden,)}
    for k in PARAM_ORDER:
        shape = tuple(params[k].shape)
        if shape != want.get(k, (c,)):
            raise ValueError(f"{k} must be {want.get(k, (c,))}, got {shape}")
    if tuple(bias.shape) != (num_heads, s, s):
        raise ValueError(f"bias must be {(num_heads, s, s)}, got "
                         f"{tuple(bias.shape)}")
    tensors = [x, bias] + [params[k] for k in PARAM_ORDER]
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError("inputs must be on one CUDA device, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    if x.dtype not in _DTYPES or bias.dtype not in _DTYPES:
        raise TypeError(f"x and bias must be float32 or bfloat16, got "
                        f"{x.dtype} and {bias.dtype}")
    if any(params[k].dtype != x.dtype for k in MATRICES):
        raise TypeError(f"the matrices must be in x's dtype {x.dtype}, got "
                        f"{[params[k].dtype for k in MATRICES]}")
    vec_dtypes = {params[k].dtype for k in PARAM_ORDER if k not in MATRICES}
    if len(vec_dtypes) != 1 or not vec_dtypes <= set(_DTYPES):
        raise TypeError(f"the vectors must be all float32 or all bfloat16, "
                        f"got {sorted(map(str, vec_dtypes))}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")


def hat_block_cuda(x: torch.Tensor, params: Dict[str, torch.Tensor],
                   bias: torch.Tensor, num_heads: int, scale: float,
                   dp1: Optional[torch.Tensor] = None,
                   dp2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One HAT sub-block on the card (K6). x (B, S, C) f32 or bf16; params:
    ops.hat_block.PARAM_ORDER's dict, matrices as nn.Linear holds them
    (out, in) in x's dtype, vectors all f32 or all bf16; bias (H, S, S) f32 or
    bf16; dp1, dp2: both None or both (B,) residual-branch scales (the
    HAS_DP instantiation). All contiguous, on one card. Returns (B, S, C)
    in x's dtype. Counts its launches in `hat_block_cuda.launches` and
    keeps the latest launch's Plan in `hat_block_cuda.last_plan`."""
    c = x.shape[-1]
    check_supported(x.shape, c, params["fc1_w"].shape[0], num_heads)
    _check(x, params, bias, num_heads)
    if (dp1 is None) != (dp2 is None):
        raise ValueError("dp1 and dp2 come together")
    b, s, _ = x.shape
    hidden = params["fc1_w"].shape[0]
    out = torch.empty_like(x)
    if b == 0:
        return out
    has_dp = dp1 is not None
    if has_dp:
        dp1, dp2 = (t.to(device=x.device, dtype=torch.float32).contiguous()
                    for t in (dp1, dp2))
        if dp1.shape != (b,) or dp2.shape != (b,):
            raise ValueError(f"dp1 and dp2 must be ({b},), got "
                             f"{tuple(dp1.shape)} and {tuple(dp2.shape)}")
    how = plan(b, s, c, hidden, num_heads, x.dtype == torch.bfloat16)
    scratch, ptrs = _scratch(x, out, hidden, how)
    ptrs += [bias.data_ptr(), dp1.data_ptr() if has_dp else 0,
             dp2.data_ptr() if has_dp else 0]
    ptrs += [params[k].data_ptr() for k in PARAM_ORDER]
    # the tensor-core route reads x, out, the scratch and the matrices in
    # 16-byte units
    operands = [0, 1, 3] + [7 + PARAM_ORDER.index(k) for k in MATRICES]
    if how.tensor_cores and any(ptrs[i] % 16 for i in operands):
        how = _scalar_plan(b, s, c, num_heads)
        scratch, ptrs[:4] = _scratch(x, out, hidden, how)
    lib = cuda_attention._library()
    with torch.cuda.device(x.device):
        err = lib.hat_block_forward(
            (ctypes.c_void_p * len(ptrs))(*ptrs), b, s, c, hidden, num_heads,
            (ctypes.c_int * 5)(*how.as_c()), int(x.dtype == torch.bfloat16),
            int(params["ln1_scale"].dtype == torch.bfloat16),
            int(bias.dtype == torch.bfloat16), int(has_dp), float(scale),
            torch.cuda.current_stream().cuda_stream)
    cuda_attention._raise_on(err, "hat_block")
    hat_block_cuda.launches += 1
    hat_block_cuda.last_plan = how
    return out


def _scratch(x: torch.Tensor, out: torch.Tensor, hidden: int, how: Plan):
    """The scratch a plan needs and the first four of the kernel's
    pointers (x, out, ctx, the wide part). Scalar route:
    ctx, then the wide part for h1, each with _MAX_ROWS rows of padding;
    tensor-core route: qkv (B·S, 3C) alone, as both."""
    b, s, c = x.shape
    if how.tensor_cores:
        scratch = torch.empty(b * s * 3 * c, dtype=x.dtype, device=x.device)
        return scratch, [x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                         scratch.data_ptr()]
    rows = b * s + _MAX_ROWS
    scratch = torch.empty(rows * (c + max(3 * c, hidden)), dtype=x.dtype,
                          device=x.device)
    return scratch, [x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                     scratch.data_ptr() + rows * c * x.element_size()]


hat_block_cuda.launches = 0
hat_block_cuda.last_plan = None  # the Plan of the latest launch
