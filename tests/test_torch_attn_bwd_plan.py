"""The launch plan of the long-window attention backward K4
(`ops.cuda_attention.long_bwd_plan`), on the CPU: the route each dtype
takes, the head-dim padding, the rows and keys a block, each pass's
stages and shared memory, for every head dim the kernel takes, and their
agreement with the constants of csrc/window_mhsa_long_bwd.cu and
csrc/attn_tiles.cuh, which the kernel checks the plan against on the
card."""
import re
from pathlib import Path

import pytest
import torch

from fastervit_tpu_torch.ops import cuda_attention
from fastervit_tpu_torch.ops.cuda_attention import (LONG_MAX_HEAD_DIM,
                                                    SMEM_LIMIT, long_bwd_plan)

CSRC = Path(cuda_attention.__file__).resolve().parent.parent / "csrc"
BIASES = [torch.float32, torch.bfloat16]
DTYPES = [torch.float32, torch.bfloat16]


def _constants():
    """The tensor-core route's tile constants, as the sources define them:
    kRows, kKeys and kBiasLd of attn_tiles.cuh, K4's shared-memory limit,
    and the scalar route's kTile and kLd."""
    tiles = (CSRC / "attn_tiles.cuh").read_text()
    tc = tiles[tiles.index("namespace tc {"):]
    k4 = (CSRC / "window_mhsa_long_bwd.cu").read_text()

    def const(text, name):
        return int(re.search(rf"constexpr int {name} = (\d+)", text)[1])

    keys = const(tc, "kKeys")
    return {"kRows": const(tc, "kRows"), "kKeys": keys,
            "kBiasLd": keys + int(re.search(
                r"constexpr int kBiasLd = kKeys \+ (\d+)", tc)[1]),
            "kSmemLimit": const(k4, "kSmemLimit"),
            "kTile": const(k4, "kTile")}


def _want(hd, dtype, bias):
    """The plan from the sources' constants: stats, dq and dk+dv keep two
    128-row operands and 2, 3 and 4 64-row tiles a stage, and a bias
    stage of (128, kBiasLd) values or, for dk+dv, (64, 128 keys + 16
    bytes) values and the tile's f32 L and D; dq one f32 (128, 64) buffer
    of dbias partial sums; two stages where they fit."""
    c = _constants()
    bb = bias.itemsize
    if dtype == torch.float32:
        t = c["kTile"]
        width = 32 * -(-hd // 32)
        tile = 4 * t * (width + 1)
        pl = 4 * t * (t + 1)
        return ("scalar", width, t, t, (1, 1, 1),
                (4 * tile, 4 * tile + pl, 4 * tile + 2 * pl))
    d = next(w for w in (32, 64, 80, 128) if hd <= w)
    rows, keys = c["kRows"], c["kKeys"]
    bias_stage = (rows * c["kBiasLd"] * bb, rows * c["kBiasLd"] * bb,
                  keys * (rows + 16 // bb) * bb + 2 * keys * 4)
    stages, smem = [], []
    slab = (0, rows * keys * 4, 0)
    for p in range(3):
        def size(n):
            return (2 * d * (2 * rows + n * (p + 2) * keys)
                    + n * bias_stage[p] + slab[p])
        n = 2 if size(2) <= c["kSmemLimit"] else 1
        stages.append(n)
        smem.append(size(n))
    return ("wgmma", d, rows, rows, tuple(stages), tuple(smem))


def test_the_kernels_limit_is_the_bindings():
    assert _constants()["kSmemLimit"] == SMEM_LIMIT


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("bias", BIASES, ids=str)
def test_plan_at_every_head_dim(dtype, bias):
    """The route is wgmma exactly for bf16; the depth covers hd (a
    multiple of 16 on wgmma, which takes k16 steps); rows and keys a block
    are whole 64-row warpgroup tiles; each pass's stages and shared memory
    are the sources' and fit a block."""
    for hd in range(1, LONG_MAX_HEAD_DIM + 1):
        plan = long_bwd_plan(hd, dtype, bias)
        assert tuple(plan) == _want(hd, dtype, bias), hd
        assert plan.route == ("wgmma" if dtype == torch.bfloat16
                              else "scalar"), hd
        assert plan.depth >= hd, hd
        if plan.route == "wgmma":
            assert plan.depth % 16 == 0, hd
            assert plan.rows_per_block % 64 == 0, hd
            assert plan.keys_per_block % 64 == 0, hd
        assert all(n in (1, 2) for n in plan.stages), hd
        assert all(0 < m <= SMEM_LIMIT for m in plan.smem_bytes), hd


@pytest.mark.parametrize("hd,bias,stages", [
    (49, torch.bfloat16, (2, 2, 2)), (80, torch.float32, (2, 2, 2)),
    (128, torch.bfloat16, (2, 1, 2)), (128, torch.float32, (2, 1, 1))])
def test_one_stage_only_where_two_do_not_fit(hd, bias, stages):
    """dq at D 128 and dk+dv at D 128 with an f32 bias take one stage;
    the served head dims (49 of the 21k family, 80 of fv5) take two."""
    assert long_bwd_plan(hd, torch.bfloat16, bias).stages == stages


def test_plan_as_the_c_entry_point_takes_it():
    plan = long_bwd_plan(49, torch.bfloat16, torch.bfloat16)
    assert list(plan.as_c()) == [1, 64, 128, 128, 2, 2, 2,
                                 *plan.smem_bytes]
    assert list(long_bwd_plan(49, torch.float32, torch.float32).as_c())[
        :7] == [0, 64, 64, 64, 1, 1, 1]


@pytest.mark.parametrize("hd", [0, LONG_MAX_HEAD_DIM + 1, 256])
def test_head_dims_past_the_kernel_raise(hd):
    with pytest.raises(NotImplementedError, match="head_dim <= 128"):
        long_bwd_plan(hd, torch.bfloat16, torch.bfloat16)


def test_other_dtypes_raise():
    with pytest.raises(TypeError):
        long_bwd_plan(49, torch.float16, torch.float32)
    with pytest.raises(TypeError):
        long_bwd_plan(49, torch.bfloat16, torch.float16)
