"""The launch plan of K5, the MSDA forward (`ops.cuda_msda.msda_plan`), and
its grid check, on the CPU: for every head width D the kernel takes, both
dtypes and every alignment of `value`'s address, the plan covers each
channel exactly once, loads vectors that D and the address allow, names an
instance of csrc/msda_fwd.cu (which checks the plan on the card) and has
at least eight rows a block; and `check_supported` still takes every shape
that it took with one warp a row, eight rows a block, the grid limit that
holds for every plan."""
import re
from pathlib import Path

import pytest
import torch

from fastervit_tpu_torch.ops import cuda_msda
from fastervit_tpu_torch.ops.cuda_msda import (MAX_CHANNELS, MsdaPlan,
                                               check_supported, msda_plan,
                                               pointer_alignment)

SOURCE = (Path(cuda_msda.__file__).resolve().parent.parent / "csrc"
          / "msda_fwd.cu")
DTYPES = [torch.float32, torch.bfloat16]
ALIGNMENTS = (16, 8, 4, 2)
INT32_MAX = 2 ** 31 - 1
SERVED_LEVELS = ((100, 167), (50, 84), (25, 42), (13, 21))


def _source_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         SOURCE.read_text())[1])


def _lane_channels(plan, lane, d):
    """The channels lane `lane` of a row's group holds."""
    first = lane * plan.channels
    return range(min(first, d), min(first + plan.channels, d))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", range(1, MAX_CHANNELS + 1))
def test_plan_covers_each_channel_once_with_allowed_vectors(d, dtype):
    elem = dtype.itemsize
    for align in ALIGNMENTS:
        plan = msda_plan(d, dtype, align)
        assert isinstance(plan, MsdaPlan)
        g, v = plan.lanes, plan.vec
        # a group of 4 to 32 lanes a row, whole rows a warp
        assert g in (4, 8, 16, 32) and plan.rows_per_warp * g == 32
        # whole vectors of at most 16 bytes that D and the address allow
        # (an f32 tensor's address is a multiple of 4: below that only V 1)
        assert v * elem <= 16 and d % v == 0 and plan.channels % v == 0
        if align >= elem:
            assert align % (v * elem) == 0
        # the widest such vector ...
        assert v == max(w for w in (1, 2, 4, 8)
                        if w * elem <= 16 and d % w == 0
                        and (w == 1 or align % (w * elem) == 0))
        # ... and the fewest lanes that hold D's vectors one a lane (two
        # past 32 vectors), never fewer than 4
        vectors = d // v
        assert g == max(4, min(32, 1 << (vectors - 1).bit_length()))
        assert plan.channels == v * (2 if vectors > 32 else 1)
        # every channel exactly once over the group's lanes
        held = [c for lane in range(g)
                for c in _lane_channels(plan, lane, d)]
        assert held == list(range(d))
        # an instance of msda_fwd.cu: G·V at most D's largest, two vectors
        # a lane only at G 32 and V 1; eight warps
        assert g * v <= _source_const("kMaxChannels")
        assert plan.channels == v or (g == 32 and v == 1)
        assert plan.warps == _source_const("kMaxWarps")
        assert list(plan.as_c()) == list(plan)


def test_served_plans():
    """DINO-4scale's heads (D 32) on a 16-byte-aligned value: bf16 in
    16-byte loads, four lanes a row, eight rows a warp; f32 in 16-byte
    loads, eight lanes a row; a value at an odd element offset on scalar
    loads."""
    assert msda_plan(32, torch.bfloat16, 16) == (4, 8, 8, 8, 8)
    assert msda_plan(32, torch.float32, 16) == (8, 4, 4, 4, 8)
    assert msda_plan(32, torch.bfloat16, 2) == (32, 1, 1, 1, 8)
    assert msda_plan(33, torch.float32, 16) == (32, 1, 2, 1, 8)
    assert msda_plan(64, torch.bfloat16, 16) == (8, 8, 8, 4, 8)


@pytest.mark.parametrize("ptr,want", [
    (0x7f0000000000, 16), (0x7f0000000008, 8), (0x7f0000000004, 4),
    (0x7f0000000002, 2), (0x7f0000000001, 1), (48, 16)])
def test_pointer_alignment(ptr, want):
    assert pointer_alignment(ptr) == want
    t = torch.zeros(9, dtype=torch.bfloat16)
    assert pointer_alignment(t[1:].data_ptr()) == 2


def _shapes(n, q, m, d, levels=SERVED_LEVELS, p=4):
    s = sum(h * w for h, w in levels)
    return ((n, s, m, d), levels, (n, q, m, len(levels), p, 2),
            (n, q, m, len(levels), p))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("n,q,m,d", [
    (2, 22223, 8, 32), (2, 900, 8, 32), (1, 37, 3, 4), (3, 41, 5, 33),
    (0, 10, 8, 32), (2, 0, 8, 32), (1, 1, 1, 1), (1, 64, 4, 64)])
def test_check_supported_takes_what_it_took(n, q, m, d, dtype):
    """The shapes K5 took, and every plan for them has at least the eight
    rows a block that check_supported's grid limit counts."""
    check_supported(*_shapes(n, q, m, d))
    for align in ALIGNMENTS:
        plan = msda_plan(d, dtype, align)
        assert plan.rows_per_warp * plan.warps >= 8


def test_grid_limit_is_eight_rows_a_block():
    """N·Q·M rows in 2^31 − 1 blocks of eight are taken, one more row is
    refused."""
    levels = ((1, 1),)
    most = 8 * INT32_MAX
    check_supported((1, 1, 8, 32), levels, (1, most // 8, 8, 1, 1, 2),
                    (1, most // 8, 8, 1, 1))
    with pytest.raises(ValueError, match="grid"):
        check_supported((1, 1, 1, 32), levels, (1, most + 1, 1, 1, 1, 2),
                        (1, most + 1, 1, 1, 1))


def test_plan_refuses_what_k5_refuses():
    with pytest.raises(NotImplementedError, match="channels"):
        msda_plan(65, torch.float32, 16)
    with pytest.raises(NotImplementedError, match="channels"):
        msda_plan(0, torch.bfloat16, 16)
    with pytest.raises(TypeError):
        msda_plan(32, torch.float16, 16)
