"""The launch plan of K6, the fused HAT sub-block (`ops.cuda_hat_block.plan`),
on the CPU: the route each dtype takes, the windows a block, the ring's
stages and the shared memory, for every window length S 1-64 and every head
dim K6 takes at the (C, hidden) of the sites `set_fused_hat` admits in the
FasterViT family, held to the constants and the shared-memory formulas of
csrc/hat_block.cu, which the kernel checks the plan against on the card;
and K6's admission (`unsupported`) held to its formula before the
tensor-core route was redesigned, so that no shape it took is refused."""
import re
from pathlib import Path

import pytest
import torch

from fastervit_tpu_torch.ops import cuda_attention, cuda_hat_block
from fastervit_tpu_torch.ops.cuda_hat_block import (MAX_HEAD_DIM, MAX_SEQ,
                                                     SMEM_LIMIT, plan)

SOURCE = (Path(cuda_hat_block.__file__).resolve().parent.parent / "csrc"
          / "hat_block.cu").read_text()
# (C, hidden) of the HAT sub-blocks a bf16 b256 forward of the family sends
# to K6 with set_fused_hat(True) (tests/test_torch_hat_block.py::ADMITTED):
# FasterViT-0 to -3's levels 2 and 3 and FasterViT-4's (hd 49)
FAMILY = [(256, 1024), (320, 1280), (384, 1536), (512, 2048), (640, 2560),
          (768, 3072), (784, 3136)]
# (S, C, H) of those sites that K6's earlier wmma route took at batch 256,
# all of which stay on the tensor cores; and the one site that moves there
# from scalar FMA (FasterViT-3's level-2 carriers, hd 64)
WMMA_SITES = [(16, 256, 8), (16, 320, 8), (16, 384, 8), (49, 512, 16),
              (53, 256, 8), (53, 320, 8), (53, 384, 8)]
NEW_SITES = [(16, 512, 8)]
BATCHES = (1, 7, 256, 1024)


def _const(name: str) -> int:
    value = re.search(rf"constexpr (?:int|long long) {name} = (\d+)",
                      SOURCE)
    assert value, name
    return int(value[1])


def _tcr(name: str) -> int:
    """A constant of the tensor-core route's namespace tcr."""
    ns = SOURCE[SOURCE.index("namespace tcr {"):]
    value = re.search(rf"constexpr int {name} = (\d+)", ns)
    assert value, name
    return int(value[1])


def _scalar_smem(seq, c, heads, wpb):
    """The scalar route's smem_floats, in bytes, from the source's
    constants."""
    rows = wpb * seq
    floats = (rows * c + 2 * _const("kMaxRows") + 2 * c
              + 2 * _const("kKT") * _const("kTileStride")
              + rows * ((3 * (c // heads)) | 1) + rows * seq)
    return 4 * floats


def _tc_smem(seq, c, wpb, stages):
    """tcr::smem_bytes from the source's constants: the ring, A (64 rows),
    one h1 chunk, the x32 region (or the two warpgroups' q, k, v stages at
    depth kD), the LayerNorm statistics and the ring's two barriers a
    slot."""
    slot = _tcr("kNt") * _tcr("kKt") * 2
    ops = _tcr("kWarpgroups") * _tcr("kAttnStages") * 3 * 64 * _tcr("kD") * 2
    return (stages * slot + 64 * c * 2 + 64 * _tcr("kHc") * 2
            + max(wpb * seq * c * 4, ops) + 2 * 64 * 4 + 2 * stages * 8)


def _old_smem(seq, c, heads, wpb, tc):
    """K6's shared memory before the redesign, with the wmma route's bf16
    LayerNorm output and cp.async stage (tc) or the scalar route's tiles."""
    rows = wpb * seq
    floats = (rows * c + 2 * 64 + 2 * c + rows * ((3 * (c // heads)) | 1)
              + rows * seq)
    if tc:
        y16 = -(-rows // 16) * 16 * (c + 8) * 2
        floats += -(-y16 // 32) * 8 + 2 * 2 * 64 * 40 // 2 + 8 * 256
    else:
        floats += 2 * 32 * 65
    return 4 * floats


def _old_route(b, seq, c, hidden, heads):
    """The route K6 took for a bf16 shape before the redesign: "wmma" or
    "scalar"."""
    wpb = max(1, min(64 // seq, b))
    while wpb > 1 and _old_smem(seq, c, heads, wpb, False) > SMEM_LIMIT:
        wpb -= 1
    fits = _old_smem(seq, c, heads, wpb, True) <= SMEM_LIMIT
    return "wmma" if c % 32 == 0 and hidden % 32 == 0 and fits else "scalar"


def _head_counts(c):
    return [h for h in range(1, c + 1)
            if c % h == 0 and c // h <= MAX_HEAD_DIM]


def _want(b, seq, c, hidden, heads, dtype):
    """The plan the rules of csrc/hat_block.cu give: the tensor cores for
    bf16 at widths that are multiples of kWidth where one window and
    kMinStages slots fit, windows a block to fill the card and the ring as
    deep as fits; scalar FMA otherwise, as many windows as fit."""
    if (dtype == torch.bfloat16 and c % _tcr("kWidth") == 0
            and hidden % _tcr("kWidth") == 0):
        wpb = max(1, min(64 // seq, b, -(-b // cuda_attention._SMS)))
        for w in range(wpb, 0, -1):
            free = SMEM_LIMIT - _tc_smem(seq, c, w, 0)
            stages = min(_tcr("kMaxStages"),
                         free // (_tcr("kNt") * _tcr("kKt") * 2 + 16))
            if stages >= _tcr("kMinStages"):
                return ("wgmma", w, stages, _tcr("kWarpgroups"),
                        _tc_smem(seq, c, w, stages))
    wpb = max(1, min(64 // seq, b))
    while wpb > 1 and _scalar_smem(seq, c, heads, wpb) > SMEM_LIMIT:
        wpb -= 1
    return ("scalar", wpb, 0, 0, _scalar_smem(seq, c, heads, wpb))


def test_constants_agree_with_the_source():
    assert SMEM_LIMIT == _const("kSmemLimit")
    assert MAX_SEQ == _const("kMaxSeq")
    assert MAX_HEAD_DIM == _const("kMaxHeadDim")
    assert (cuda_hat_block.MIN_STAGES, cuda_hat_block.MAX_STAGES) == (
        _tcr("kMinStages"), _tcr("kMaxStages"))
    # two consumer warpgroups and the producer warp
    assert _tcr("kWarpgroups") == 2
    assert "constexpr int kThreads = kConsumers + 32;" in SOURCE


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("c,hidden", FAMILY)
def test_plan_at_every_window_and_head_dim(c, hidden, dtype):
    """Every S 1-64 and head count K6 takes at a family width: the route by
    dtype and width, the shared memory within a block's and equal to the
    source's formula, the ring at least kMinStages deep, whole windows of
    at most 64 tokens covering the batch."""
    for heads in _head_counts(c):
        for seq in range(1, MAX_SEQ + 1):
            for b in BATCHES:
                if cuda_hat_block.unsupported((b, seq, c), c, hidden, heads):
                    continue
                got = plan(b, seq, c, hidden, heads, dtype == torch.bfloat16)
                want = _want(b, seq, c, hidden, heads, dtype)
                assert tuple(got) == want, (b, seq, heads)
                assert got.smem_bytes <= SMEM_LIMIT
                assert got.windows_per_block * seq <= 64
                if dtype == torch.float32:
                    assert got.route == "scalar"
                if got.tensor_cores:
                    assert got.stages >= cuda_hat_block.MIN_STAGES
                    assert got.smem_bytes == cuda_hat_block._smem(
                        seq, c, heads, got.windows_per_block, "wgmma",
                        got.stages)
                else:
                    assert got.smem_bytes == cuda_hat_block._smem(
                        seq, c, heads, got.windows_per_block)


@pytest.mark.parametrize("c,hidden", FAMILY)
def test_admission_is_unchanged(c, hidden):
    """K6 takes every shape it took before the redesign, and no other: the
    scalar route's plan of one window within a block's shared memory."""
    for heads in range(1, c + 1):
        if c % heads:
            continue
        for seq in range(1, MAX_SEQ + 1):
            took = (c // heads <= MAX_HEAD_DIM
                    and _old_smem(seq, c, heads, 1, False) <= SMEM_LIMIT)
            why = cuda_hat_block.unsupported((256, seq, c), c, hidden, heads)
            assert (why is None) == took, (seq, heads, why)


@pytest.mark.parametrize("seq,c,heads", WMMA_SITES + NEW_SITES)
def test_family_sites_run_on_the_tensor_cores(seq, c, heads):
    """The family's admitted sites that the wmma route took at batch 256
    stay on the tensor cores, and FasterViT-3's carriers join them."""
    site = (256, seq, c, 4 * c, heads)
    assert _old_route(*site) == ("scalar" if (seq, c, heads) in NEW_SITES
                                 else "wmma")
    assert plan(*site, True).route == "wgmma"
    assert plan(*site, False).route == "scalar"


def test_fv0_sites_plan():
    """FasterViT-0's batch-256 bf16 sites: two carrier windows a block (128
    blocks for 132 SMs), one joint or level-3 window, the ring as deep as
    the shared memory allows."""
    assert tuple(plan(256, 16, 256, 1024, 8, True))[:4] == ("wgmma", 2, 5, 2)
    assert tuple(plan(1024, 53, 256, 1024, 8, True))[:4] == (
        "wgmma", 1, 5, 2)
    assert tuple(plan(256, 49, 512, 2048, 16, True))[:4] == (
        "wgmma", 1, 3, 2)


def test_plan_as_the_c_entry_point_takes_it():
    got = plan(1024, 53, 256, 1024, 8, True)
    assert got.as_c() == (1, 1, 5, 2, got.smem_bytes)
    got = plan(1024, 53, 256, 1024, 8, False)
    assert got.as_c() == (0, 1, 0, 0, got.smem_bytes)
