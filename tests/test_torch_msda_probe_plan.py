"""The launch plan of the MSDA gather probes' pair, packed and coeff kernels
(P3a-c, P4a, P4b, P4c: `ops.cuda_msda.probe_plan`), on the CPU: for every
head width D the kernels take, both map dtypes, the three modes and every
alignment of the map's address, the plan covers each channel exactly once,
loads vectors that D and the address allow, names an instance of
csrc/msda_probe.cu and passes the checks of its C entry points (which
refuse any other plan on the card); DINO's and MOTR's width D 32 gets
16-byte vectors; coeff mode gets packed mode's plan; the shared-memory route
is taken at MOTR's level 3 and refused at levels 0-2 and for every packed
or coeff map; and every shape that `_check_*` takes still gets a plan."""
import re
from pathlib import Path

import pytest
import torch

from fastervit_tpu_torch.ops import cuda_msda, msda_probes
from fastervit_tpu_torch.ops.cuda_msda import (PROBE_MAX_CHANNELS,
                                               PROBE_MAX_WARPS,
                                               PROBE_SMEM_BYTES, ProbePlan,
                                               probe_plan)

SOURCE = (Path(cuda_msda.__file__).resolve().parent.parent / "csrc"
          / "msda_probe.cu")
DTYPES = [torch.float32, torch.bfloat16]
MODES = ("pair", "packed", "coeff")
ALIGNMENTS = (16, 8, 4, 2)
SMS = 132   # an H100 SXM's
# MOTR's padded levels (Hp, Wp), level 0 first
LEVELS = ((202, 386), (102, 194), (52, 98), (27, 50))


def _source_const(name):
    return int(re.search(rf"constexpr int {name} = ([^;]+);",
                         SOURCE.read_text())[1].replace("1 << 20",
                                                        str(1 << 20)))


def _map_bytes(mode, hp, wp, d, dtype):
    cells = hp * wp if mode == "pair" else (hp - 1) * (wp - 1) * 4
    return cells * d * dtype.itemsize


def _passes_the_c_checks(plan, d, dtype, align, mode, map_bytes):
    """msda_probe.cu::bad_plan, read as the conditions a plan must meet."""
    elem = dtype.itemsize
    return (1 <= plan.vec and plan.vec * elem <= 16 and d % plan.vec == 0
            and (plan.channels == plan.vec
                 or (plan.channels, plan.vec, plan.lanes) == (2, 1, 32))
            and plan.lanes in (4, 8, 16, 32)
            and plan.lanes * plan.rows_per_warp == 32
            and plan.lanes * plan.channels >= d
            and 1 <= plan.warps <= _source_const("kMaxWarps")
            and 1 <= plan.blocks <= _source_const("kMaxBlocks")
            and (align < elem or align % (plan.vec * elem) == 0)
            and plan.route in ("l2", "smem")
            and (plan.route == "l2" or (
                mode == "pair"
                and map_bytes <= _source_const("kMaxSmemBytes"))))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", range(1, PROBE_MAX_CHANNELS + 1))
def test_plan_covers_each_channel_once_with_allowed_vectors(d, dtype):
    elem = dtype.itemsize
    for mode in MODES:
        for hp, wp in (LEVELS[0], LEVELS[3], (3, 3)):
            map_bytes = _map_bytes(mode, hp, wp, d, dtype)
            for align in ALIGNMENTS:
                plan = probe_plan(mode, d, dtype, map_bytes, align, SMS)
                assert isinstance(plan, ProbePlan)
                g, v = plan.lanes, plan.vec
                # the widest vector of at most 16 bytes that D and the
                # address allow (an f32 map's address is a multiple of 4)
                assert v == max(w for w in (1, 2, 4, 8)
                                if w * elem <= 16 and d % w == 0
                                and (w == 1 or align % (w * elem) == 0))
                # the fewest lanes that hold D's vectors one a lane (two
                # past 32 vectors), never fewer than 4
                vectors = d // v
                assert g == max(4, min(32, 1 << (vectors - 1).bit_length()))
                held = [c for lane in range(g)
                        for c in range(min(lane * plan.channels, d),
                                       min((lane + 1) * plan.channels, d))]
                assert held == list(range(d))
                # a group's P <= 4 samples a row fit the warp's 32 lanes
                assert plan.rows_per_warp * 4 <= 32
                # 32 warps an SM, in whole blocks
                assert plan.warps * plan.blocks == 32 * SMS
                assert _passes_the_c_checks(plan, d, dtype, align, mode,
                                            map_bytes)
                assert len(plan.as_c()) == 7
                assert list(plan.as_c()) == [*plan[:6],
                                             int(plan.route == "smem")]


@pytest.mark.parametrize("align", ALIGNMENTS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", range(1, PROBE_MAX_CHANNELS + 1))
def test_coeff_plan_is_packed_plan(d, dtype, align):
    """P4c's plan is P4a's (the same lane group, route l2, four blocks of
    8 warps an SM) at every MOTR level, covers each channel once and passes
    the C checks of coeff mode."""
    for hp, wp in LEVELS:
        map_bytes = _map_bytes("coeff", hp, wp, d, dtype)
        plan = probe_plan("coeff", d, dtype, map_bytes, align, SMS)
        assert plan == probe_plan("packed", d, dtype, map_bytes, align, SMS)
        assert plan.route == "l2"
        assert (plan.warps, plan.blocks) == (8, 4 * SMS)
        held = [c for lane in range(plan.lanes)
                for c in range(min(lane * plan.channels, d),
                               min((lane + 1) * plan.channels, d))]
        assert held == list(range(d))
        assert _passes_the_c_checks(plan, d, dtype, align, "coeff",
                                    map_bytes)
    # a map small enough for a block's shared memory still takes route l2
    assert probe_plan("coeff", d, dtype, 1024, align, SMS).route == "l2"


@pytest.mark.parametrize("mode", MODES)
def test_d32_plans_load_16_bytes(mode):
    """MOTR's width on a 16-byte-aligned map: f32 G 8, V 4 (four rows a
    warp); bf16 G 4, V 8 (eight rows); one element off, V 1."""
    for level in LEVELS:
        f32 = probe_plan(mode, 32, torch.float32,
                         _map_bytes(mode, *level, 32, torch.float32), 16,
                         SMS)
        bf16 = probe_plan(mode, 32, torch.bfloat16,
                          _map_bytes(mode, *level, 32, torch.bfloat16), 16,
                          SMS)
        assert f32[:4] == (8, 4, 4, 4)
        assert bf16[:4] == (4, 8, 8, 8)
    assert probe_plan(mode, 32, torch.float32, 10 ** 7, 4, SMS)[:3] == (
        32, 1, 1)
    assert probe_plan(mode, 32, torch.bfloat16, 10 ** 7, 2, SMS)[:3] == (
        32, 1, 1)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_shared_memory_route_at_level_3_only(dtype):
    """A pair-mode head map at MOTR's level 3 (172.8 KB f32, 86.4 KB bf16)
    fits a block's shared memory and takes route smem, in as many blocks an
    SM as its copies fit; levels 0-2 do not, and no packed or coeff map
    takes it."""
    for index, (hp, wp) in enumerate(LEVELS):
        pair_bytes = _map_bytes("pair", hp, wp, 32, dtype)
        pair = probe_plan("pair", 32, dtype, pair_bytes, 16, SMS)
        for mode in ("packed", "coeff"):
            packed = probe_plan(mode, 32, dtype,
                                _map_bytes(mode, hp, wp, 32, dtype), 16, SMS)
            assert packed.route == "l2" and packed.warps == 8
            assert packed.blocks == 4 * SMS
        if index < 3:
            assert pair_bytes > PROBE_SMEM_BYTES
            assert pair.route == "l2" and pair.blocks == 4 * SMS
        else:
            assert pair.route == "smem"
            per_sm = pair.blocks // SMS
            assert per_sm == (1 if dtype == torch.float32 else 2)
            assert per_sm * (pair_bytes + 1024) <= 228 * 1024
            assert pair.warps == 32 // per_sm
    # the largest map that fits, and one byte more
    assert probe_plan("pair", 32, dtype, PROBE_SMEM_BYTES, 16,
                      SMS).route == "smem"
    assert probe_plan("pair", 32, dtype, PROBE_SMEM_BYTES + 1, 16,
                      SMS).route == "l2"
    # P3c's one-head launch spreads its head over every SM: the grid is
    # the card's, whatever the heads
    assert probe_plan("pair", 32, dtype, 10 ** 7, 16, 1).blocks == 4


def test_c_constants_match():
    assert _source_const("kMaxWarps") == PROBE_MAX_WARPS
    assert _source_const("kMaxSmemBytes") == PROBE_SMEM_BYTES
    assert _source_const("kMaxChannels") == PROBE_MAX_CHANNELS
    assert "__launch_bounds__(32 * kMaxWarps, kMinBlocks)" in (
        SOURCE.read_text())
    assert _source_const("kMinBlocks") == 1   # 64 registers a thread


# (Hp, Wp, QP, M, D) that the probes' wrappers take: MOTR's levels at a
# small QP, a 3x3 map, one head, D 1, 33, 64
ADMITTED = [(202, 386, 8, 8, 32), (27, 50, 4, 8, 32), (3, 3, 4, 8, 32),
            (27, 50, 4, 1, 32), (7, 9, 4, 3, 33), (5, 6, 4, 2, 1),
            (52, 98, 4, 2, 64)]


@pytest.mark.parametrize("hp,wp,qp,m,d", ADMITTED)
def test_admitted_shapes_get_a_plan(hp, wp, qp, m, d):
    """What check_gather, check_pair, check_packed and check_coeff take, on
    any map address, gets a plan that the C entry points run."""
    gen = torch.Generator().manual_seed(0)
    case = list(msda_probes.sample_case(hp, wp, qp, m, d, gen, "cpu"))
    pm = msda_probes.pack_corners(case[0])
    fl = case[1] * (wp - 1) + case[2]
    for dtype in DTYPES:
        vm = case[0].to(dtype)
        if dtype == torch.float32:
            cuda_msda.check_gather(vm, *case[1:], points=4)
        cuda_msda.check_pair(vm, *case[1:], 4)
        cuda_msda.check_packed(pm.to(dtype), fl, *case[3:], 4)
        cuda_msda.check_coeff(pm.to(dtype), fl,
                              *msda_probes.coeff_scalars(*case[3:]), 4)
        for mode, per_head in (("pair", vm[0].numel()),
                               ("packed", pm[0].numel()),
                               ("coeff", pm[0].numel())):
            for align in ALIGNMENTS:
                if align < dtype.itemsize:
                    continue
                plan = probe_plan(mode, d, dtype,
                                  per_head * dtype.itemsize, align, SMS)
                assert _passes_the_c_checks(plan, d, dtype, align, mode,
                                            per_head * dtype.itemsize)


def test_plan_refuses_what_the_kernels_refuse():
    with pytest.raises(ValueError, match="modes"):
        probe_plan("wide", 32, torch.float32, 1000, 16, SMS)
    with pytest.raises(NotImplementedError, match="channels"):
        probe_plan("pair", 65, torch.float32, 1000, 16, SMS)
    with pytest.raises(NotImplementedError, match="channels"):
        probe_plan("packed", 0, torch.bfloat16, 1000, 16, SMS)
    with pytest.raises(TypeError):
        probe_plan("pair", 32, torch.float16, 1000, 16, SMS)
