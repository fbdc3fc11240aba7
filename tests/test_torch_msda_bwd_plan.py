"""The launch plan of K7, the MSDA backward (`ops.cuda_msda.msda_bwd_plan`),
on the CPU: for every head width D the kernel takes, both dtypes and the
alignments of value's and grad_out's addresses, the plan is K5's for the
narrower alignment, loads vectors that D and both addresses allow, covers
each channel once, names an instance of csrc/msda_bwd.cu, and its dvalue
adds (V floats a vector into the f32 buffer, at offsets that are multiples
of V) land on addresses that the vector atomics need: 16 bytes for V 4
and 8, 8 bytes for V 2."""
import re
from pathlib import Path

import pytest
import torch

from fastervit_tpu_torch.ops import cuda_msda
from fastervit_tpu_torch.ops.cuda_msda import (MAX_CHANNELS, msda_bwd_plan,
                                               msda_plan)

SOURCE = (Path(cuda_msda.__file__).resolve().parent.parent / "csrc"
          / "msda_bwd.cu")
DTYPES = [torch.float32, torch.bfloat16]
ALIGNMENTS = (16, 8, 4, 2)


def _source_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         SOURCE.read_text())[1])


def _atomic_bytes(vec: int) -> int:
    """The width of one dvalue add (csrc/msda_bwd.cu::add_f32)."""
    return 16 if vec % 4 == 0 else 4 * vec


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", range(1, MAX_CHANNELS + 1))
def test_plan_is_k5s_for_the_narrower_alignment(d, dtype):
    elem = dtype.itemsize
    for va in ALIGNMENTS:
        for ga in ALIGNMENTS:
            plan = msda_bwd_plan(d, dtype, va, ga)
            assert plan == msda_plan(d, dtype, min(va, ga))
            v = plan.vec
            # vectors both reads allow
            for align in (va, ga):
                if align >= elem:
                    assert align % (v * elem) == 0
            # each channel once over the group's lanes
            held = [c for lane in range(plan.lanes)
                    for c in range(lane * plan.channels,
                                   min((lane + 1) * plan.channels, d))]
            assert held == list(range(d))
            # an instance of msda_bwd.cu
            assert plan.lanes * v <= _source_const("kMaxChannels")
            assert plan.channels == v or (plan.lanes == 32 and v == 1)
            assert plan.warps <= _source_const("kMaxWarps")
            # the dvalue adds: element offsets ((n·S + token)·M + m)·D + c0
            # + t·V are multiples of V (V divides D and the lane's first
            # channel), so a 16-byte-aligned buffer puts every add on its
            # width
            assert d % v == 0 and plan.channels % v == 0
            assert 4 * v % _atomic_bytes(v) == 0


def test_served_plans():
    """DINO-4scale's heads (D 32): bf16 on 16-byte loads, four lanes a row,
    two 16-byte atomics a vector; f32 on 16-byte loads, eight lanes, one
    16-byte atomic; a grad_out one element into its storage puts both
    reads on scalars."""
    assert msda_bwd_plan(32, torch.bfloat16, 16, 16) == (4, 8, 8, 8, 8)
    assert msda_bwd_plan(32, torch.float32, 16, 16) == (8, 4, 4, 4, 8)
    assert msda_bwd_plan(32, torch.bfloat16, 16, 2).vec == 1
    assert msda_bwd_plan(32, torch.float32, 4, 16).vec == 1


def test_plan_refuses_what_k7_refuses():
    with pytest.raises(NotImplementedError, match="channels"):
        msda_bwd_plan(65, torch.float32, 16, 16)
    with pytest.raises(TypeError):
        msda_bwd_plan(32, torch.float16, 16, 16)
