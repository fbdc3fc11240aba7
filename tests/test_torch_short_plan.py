"""The launch plans of the short-window attention kernels K1 and K2
(`ops.cuda_attention.short_plan`, `short_bwd_plan`) and K1's grid, on the
CPU: the route each dtype takes, the head-dim padding, the key tiles and
windows a block, the stages and shared memory, for every head dim and
window length the kernels take, and their agreement with the constants of
csrc/short_tiles.cuh and the scalar kernels' shared-memory formulas in
csrc/window_mhsa.cu and csrc/window_mhsa_bwd.cu, which the kernels check
the plans against on the card."""
import re
from pathlib import Path

import pytest
import torch

from fastervit_tpu_torch.ops import cuda_attention
from fastervit_tpu_torch.ops.cuda_attention import (
    BWD_MAX_SEQ, MAX_HEAD_DIM, MAX_SEQ, SMEM_LIMIT, forward_grid,
    short_bwd_plan, short_plan)

CSRC = Path(cuda_attention.__file__).resolve().parent.parent / "csrc"
DTYPES = [torch.float32, torch.bfloat16]
FWD_SEQS = [1, 2, 15, 16, 49, 53, 63, 64, 65, 100, 127, 128]
BWD_SEQS = [1, 2, 15, 16, 49, 53, 63, 64]


def _constants():
    """The tensor-core tile constants of short_tiles.cuh."""
    text = (CSRC / "short_tiles.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    return {name: const(name) for name in (
        "kTile", "kStages", "kFwdWarpgroups", "kFwdLongWarpgroups",
        "kBwdWarpgroups")}


def _scalar_floats(source):
    """The scalar kernel's shared memory in floats, as a function of S and
    hd: smem_floats of its source, `size_t(seq) * (...)`."""
    text = (CSRC / source).read_text()
    expr = re.search(r"return size_t\(seq\) \* \(([^;]*)\);", text)[1]
    return lambda seq, head_dim: seq * eval(  # noqa: S307 (the source's)
        expr, {}, {"seq": seq, "head_dim": head_dim})


def _want_fwd(seq, hd, dtype):
    c = _constants()
    if dtype == torch.float32:
        return ("scalar", hd, 1, 1, 1,
                4 * _scalar_floats("window_mhsa.cu")(seq, hd))
    d = 32 if hd <= 32 else 64
    r = 1 if seq <= c["kTile"] else 2
    w = c["kFwdWarpgroups"] if r == 1 else c["kFwdLongWarpgroups"]
    # the f32 bias of r × r tiles, then each warpgroup's stages of q, k, v
    smem = (4 * r * r * c["kTile"] ** 2
            + 2 * w * c["kStages"] * 3 * r * c["kTile"] * d)
    return ("wgmma", d, r, w, c["kStages"], smem)


def _want_bwd(seq, hd, dtype):
    c = _constants()
    if dtype == torch.float32:
        return ("scalar", hd, 1, 1, 1,
                4 * _scalar_floats("window_mhsa_bwd.cu")(seq, hd))
    d = 32 if hd <= 32 else 64
    w, t = c["kBwdWarpgroups"], c["kTile"]
    # the f32 bias tile, then each warpgroup's stages of q, k, v, g and its
    # P and dl tiles
    smem = 4 * t * t + 2 * w * (c["kStages"] * 4 * t * d + 2 * t * t)
    return ("wgmma", d, 1, w, c["kStages"], smem)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("bias", DTYPES, ids=str)
@pytest.mark.parametrize("seq", FWD_SEQS)
def test_short_plan_at_every_head_dim(dtype, bias, seq):
    """K1: wgmma exactly for bf16; the depth covers hd, a multiple of 16 on
    wgmma (k16 steps); one key tile to S = 64, two to 128; the shared
    memory is the sources' and fits a block."""
    for hd in range(1, MAX_HEAD_DIM + 1):
        plan = short_plan(seq, hd, dtype, bias)
        assert tuple(plan) == _want_fwd(seq, hd, dtype), hd
        assert plan.route == ("wgmma" if dtype == torch.bfloat16
                              else "scalar"), hd
        assert plan.depth >= hd, hd
        if plan.route == "wgmma":
            assert plan.depth % 16 == 0, hd
            assert plan.key_tiles * 64 >= seq, hd
        assert 0 < plan.smem_bytes <= SMEM_LIMIT, hd


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("bias", DTYPES, ids=str)
@pytest.mark.parametrize("seq", BWD_SEQS)
def test_short_bwd_plan_at_every_head_dim(dtype, bias, seq):
    """K2: wgmma exactly for bf16; the depth covers hd, a multiple of 16 on
    wgmma; one key tile; the shared memory is the sources' and fits a
    block."""
    for hd in range(1, MAX_HEAD_DIM + 1):
        plan = short_bwd_plan(seq, hd, dtype, bias)
        assert tuple(plan) == _want_bwd(seq, hd, dtype), hd
        assert plan.route == ("wgmma" if dtype == torch.bfloat16
                              else "scalar"), hd
        assert plan.depth >= hd, hd
        if plan.route == "wgmma":
            assert plan.depth % 16 == 0 and plan.key_tiles == 1, hd
        assert 0 < plan.smem_bytes <= SMEM_LIMIT, hd


def test_plans_as_the_c_entry_points_take_them():
    plan = short_plan(53, 32, torch.bfloat16, torch.float32)
    assert list(plan.as_c()) == [1, 32, 1, 2, 2, plan.smem_bytes]
    plan = short_bwd_plan(64, 49, torch.bfloat16, torch.bfloat16)
    assert list(plan.as_c()) == [1, 64, 1, 2, 2, plan.smem_bytes]
    assert list(short_plan(100, 64, torch.float32, torch.float32).as_c())[
        :5] == [0, 64, 1, 1, 1]


@pytest.mark.parametrize("plan,seq,hd", [
    (short_plan, 53, 0), (short_plan, 53, MAX_HEAD_DIM + 1),
    (short_plan, 0, 32), (short_plan, MAX_SEQ + 1, 32),
    (short_bwd_plan, 53, MAX_HEAD_DIM + 1), (short_bwd_plan, 53, 128),
    (short_bwd_plan, BWD_MAX_SEQ + 1, 32)])
def test_shapes_past_the_kernels_raise(plan, seq, hd):
    with pytest.raises(NotImplementedError, match="head_dim <= 64"):
        plan(seq, hd, torch.bfloat16, torch.bfloat16)


@pytest.mark.parametrize("plan", [short_plan, short_bwd_plan])
def test_other_dtypes_raise(plan):
    with pytest.raises(TypeError):
        plan(53, 32, torch.float16, torch.float32)
    with pytest.raises(TypeError):
        plan(53, 32, torch.bfloat16, torch.float16)


@pytest.mark.parametrize("b,h", [(1024, 8), (256, 8), (256, 16), (3, 4),
                                 (1, 1), (1000, 1)])
def test_forward_grid_covers_every_window_once(b, h):
    per_block, groups = forward_grid(b, h)
    assert per_block * groups >= b > per_block * (groups - 1)
    assert groups <= 65535
