"""The launch plan of the long-window attention kernels K3, P1 and P2
(`ops.cuda_attention.long_plan`), on the CPU: the route each dtype takes,
the head-dim padding of both products, the rows a block, the stages and
the shared memory, for every head dim the kernels take, and its
agreement with the constants of csrc/attn_tiles.cuh, which the kernels
check the plan against on the card."""
import re
from pathlib import Path

import pytest
import torch

from fastervit_tpu_torch.ops import cuda_attention
from fastervit_tpu_torch.ops.cuda_attention import (LONG_MAX_HEAD_DIM,
                                                    SMEM_LIMIT, long_plan)

TILES = (Path(cuda_attention.__file__).resolve().parent.parent / "csrc"
         / "attn_tiles.cuh")
BIASES = [None, torch.float32, torch.bfloat16]


def _constants():
    """kRows, kKeys, kStages, kBiasLd of the tensor-core route and kTile
    of the scalar one, as csrc/attn_tiles.cuh defines them."""
    src = TILES.read_text()
    tc = src[src.index("namespace tc {"):]

    def const(text, name):
        return int(re.search(rf"constexpr int {name} = (\d+)", text)[1])

    return {name: const(tc, name) for name in ("kRows", "kKeys", "kStages")
            } | {"kBiasLd": const(tc, "kKeys") + int(re.search(
                r"constexpr int kBiasLd = kKeys \+ (\d+)", tc)[1]),
                 "kTile": const(src, "kTile")}


@pytest.mark.parametrize("bias", BIASES, ids=str)
def test_bf16_takes_the_tensor_cores_at_every_head_dim(bias):
    for hd in range(1, LONG_MAX_HEAD_DIM + 1):
        plan = long_plan(hd, torch.bfloat16, bias)
        assert plan.route == "wgmma", hd
        assert plan.rows_per_block == 128, hd
        assert plan.qk_depth % 16 == 0 and plan.qk_depth >= hd, hd
        assert plan.pv_width % 8 == 0 and plan.pv_width >= hd, hd
        assert plan.qk_depth in (32, 64, 80, 128), hd
        assert plan.stages == 2, hd
        assert 0 < plan.smem_bytes <= SMEM_LIMIT, hd


@pytest.mark.parametrize("bias", BIASES, ids=str)
def test_f32_stays_on_scalar_fma_at_every_head_dim(bias):
    for hd in range(1, LONG_MAX_HEAD_DIM + 1):
        plan = long_plan(hd, torch.float32, bias)
        assert plan.route == "scalar", hd
        assert plan.rows_per_block == 64, hd
        # the scalar q·kᵀ loops over hd itself, unpadded
        assert plan.qk_depth == hd, hd
        assert plan.pv_width % 8 == 0 and plan.pv_width >= hd, hd
        assert plan.pv_width in (32, 64, 96, 128), hd
        assert plan.stages == 1, hd
        assert 0 < plan.smem_bytes <= SMEM_LIMIT, hd


@pytest.mark.parametrize("hd,depth,waste", [(32, 32, 0.0), (49, 64, 15 / 64),
                                            (80, 80, 0.0), (128, 128, 0.0)])
def test_padding_of_the_head_dims_on_a_path(hd, depth, waste):
    """The any-res carriers (32), the 21k family (49), faster_vit_5 (80)
    and hd 128: the depth and width each pads to, and the share of the
    products spent on zeros."""
    plan = long_plan(hd, torch.bfloat16)
    assert (plan.qk_depth, plan.pv_width) == (depth, depth)
    assert 1 - hd / plan.qk_depth == pytest.approx(waste)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("bias", BIASES, ids=str)
def test_shared_memory_is_the_kernels_own(dtype, bias):
    """The bytes the plan names are those the C side computes from
    attn_tiles.cuh's constants (smem_bytes, smem_floats), so its check
    of the plan passes; the largest fits a block."""
    c = _constants()
    bias_bytes = 0 if bias is None else bias.itemsize
    for hd in range(1, LONG_MAX_HEAD_DIM + 1):
        plan = long_plan(hd, dtype, bias)
        if dtype == torch.bfloat16:
            d = plan.qk_depth
            want = (2 * d * (c["kRows"] + 2 * c["kStages"] * c["kKeys"])
                    + c["kStages"] * c["kRows"] * c["kBiasLd"] * bias_bytes)
            assert plan.stages == c["kStages"]
            assert plan.rows_per_block == c["kRows"]
        else:
            t = c["kTile"]
            want = 4 * ((2 * hd + t) * (t + 1) + t * plan.pv_width)
            assert plan.rows_per_block == t
        assert plan.smem_bytes == want, hd


def test_plan_as_the_c_entry_points_take_it():
    plan = long_plan(49, torch.bfloat16, torch.bfloat16)
    assert list(plan.as_c()) == [1, 128, 64, 64, 2, plan.smem_bytes]
    assert list(long_plan(49, torch.float32).as_c())[:5] == [0, 64, 49, 64, 1]


@pytest.mark.parametrize("hd", [0, LONG_MAX_HEAD_DIM + 1, 256])
def test_head_dims_past_the_kernels_raise(hd):
    with pytest.raises(NotImplementedError, match="head_dim <= 128"):
        long_plan(hd, torch.bfloat16)


def test_other_dtypes_raise():
    with pytest.raises(TypeError):
        long_plan(49, torch.float16)
    with pytest.raises(TypeError):
        long_plan(49, torch.bfloat16, torch.float16)
