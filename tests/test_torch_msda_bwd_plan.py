"""The launch plan of K7, the MSDA backward (`ops.cuda_msda.msda_bwd_plan`),
on the CPU, arithmetic only: for every head width D the kernel takes, both
dtypes and the alignments of value's and grad_out's addresses, the lanes
are K5's for the narrower alignment, load vectors that D and both
addresses allow, cover each channel once and name an instance of
csrc/msda_bwd.cu, and the dvalue adds (V floats a vector into the f32
buffer, at offsets that are multiples of V) land on addresses that the
vector atomics need: 16 bytes for V 4 and 8, 8 bytes for V 2. The route
and grid: the tiled levels are a suffix of the coarsest whose f32 tile
fits two blocks an SM (DINO-4scale's level 3 at D 32, at the encoder call
only), route "l2" where none fits or a head's rows are too few, and the
runs cover every row exactly once, meeting each head no more often than
`msda_bwd_flushes` says."""
import re
from pathlib import Path

import pytest
import torch

from fastervit_tpu_torch.ops import cuda_msda
from fastervit_tpu_torch.ops.cuda_msda import (BWD_MAX_TILE_BYTES,
                                               MAX_CHANNELS, msda_bwd_flushes,
                                               msda_bwd_plan, msda_plan)

SOURCE = (Path(cuda_msda.__file__).resolve().parent.parent / "csrc"
          / "msda_bwd.cu")
DTYPES = [torch.float32, torch.bfloat16]
ALIGNMENTS = (16, 8, 4, 2)
# DINO-4scale at 800x1333, batch 2, 8 heads: the encoder (Q = S) and
# decoder (Q = 900) calls' rows
DINO = ((100, 167), (50, 84), (25, 42), (13, 21))
ENCODER = (2, sum(h * w for h, w in DINO), 8)
DECODER = (2, 900, 8)
# MOTR at 800x1536, batch 1, 8 heads: the encoder (Q = S = 102,000) and
# the training decoder's (60 track, 10 proposal and 60 detect queries)
MOTR = ((200, 384), (100, 192), (50, 96), (25, 48))
MOTR_ENCODER = (1, sum(h * w for h, w in MOTR), 8)
MOTR_DECODER = (1, 130, 8)
# level sets: DINO's, MOTR's four (level 3 alone fits up to D 48), one wide
# level (none fits), a 1x1 level beside a wider one, many small levels
LEVEL_SETS = {
    "dino": DINO,
    "motr": MOTR,
    "one_wide": ((120, 200),),
    "one_by_one": ((30, 40), (1, 1)),
    "small": ((9, 4), (5, 3), (3, 2), (2, 2), (1, 1)),
}
# (N, Q, M) of the runs' check: the encoder and decoder calls, odd row
# counts, an empty query set and batch
ROW_CASES = [ENCODER, DECODER, MOTR_ENCODER, MOTR_DECODER, (1, 37, 3),
             (3, 41, 5), (1, 1, 1), (2, 5000, 1), (1, 0, 8), (0, 10, 8)]
SMEM_LIMIT = 232_448  # a Hopper block's shared memory


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
            plan = msda_bwd_plan(d, dtype, va, ga, DINO, ENCODER[1], 16)
            assert plan[:4] == msda_plan(d, dtype, min(va, ga))[:4]
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
            assert plan.warps * plan.blocks_per_sm == 16  # 128 registers
            # the dvalue adds: element offsets ((n·S + token)·M + m)·D + c0
            # + t·V are multiples of V (V divides D and the lane's first
            # channel), so a 16-byte-aligned buffer puts every add, and
            # every flush of the tile, on its width
            assert d % v == 0 and plan.channels % v == 0
            assert 4 * v % _atomic_bytes(v) == 0


# (blocks, run, rounds) of the served plans at the encoder and decoder calls
SERVED_GRIDS = {torch.bfloat16: ((264, 128, 11), (225, 64, 1)),
                torch.float32: ((264, 96, 15), (264, 32, 2))}
# a block's share of an SM's shared memory, two blocks an SM: the SM's
# 233,472 bytes halved, less the card's 1 KB a block and the kernel's
# static 7,168 (the level table and each thread's results)
STATIC = 1_024 + 12 * 32 * 16
TWO_BLOCK_TILE = 233_472 // 2 - 1_024 - STATIC


def test_served_plans():
    """DINO-4scale's heads (D 32): bf16 on 16-byte loads, four lanes a
    row, f32 eight; two blocks of 8 warps an SM, their runs a head a round.
    The encoder call tiles level 3 (34,944 bytes of f32 a head); the
    decoder's 900 queries a head do not fill a round of the grid's chunks
    and take route l2. A grad_out one element into its storage puts both
    reads on scalars."""
    for dtype in DTYPES:
        lanes = (4, 8, 8, 8) if dtype == torch.bfloat16 else (8, 4, 4, 4)
        for (n, q, m), grid in zip((ENCODER, DECODER), SERVED_GRIDS[dtype]):
            plan = msda_bwd_plan(32, dtype, 16, 16, DINO, q, n * m)
            assert plan[:4] == lanes
            assert (plan.warps, plan.blocks_per_sm) == (8, 2)
            assert (plan.blocks, plan.run, plan.rounds) == grid
            tile = (("smem", (3,), 13 * 21 * 32 * 4) if q == ENCODER[1]
                    else ("l2", (), 0))
            assert (plan.route, plan.tiled, plan.tile_bytes) == tile
        assert msda_bwd_plan(32, dtype, 16, 2, DINO, 900, 16).vec == 1
        assert msda_bwd_plan(32, dtype, 2, 16, DINO, 900, 16).vec == 1


# (blocks, run, rounds) of MOTR's encoder and decoder calls
MOTR_GRIDS = {torch.bfloat16: ((264, 448, 7), (17, 64, 1)),
              torch.float32: ((264, 416, 8), (33, 32, 1))}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("call", ["encoder", "decoder"])
def test_motr_plans(call, dtype):
    """MOTR's heads (D 32) at its 800x1536 levels: K5's lanes and vectors,
    two blocks of 8 warps an SM, and route l2 at both calls. Level 3's f32
    rows a head (25x48x32x4 = 153,600 bytes) overflow two blocks' share of
    an SM, so nothing is tiled even at the encoder's 102,000 rows a head."""
    n, q, m = MOTR_ENCODER if call == "encoder" else MOTR_DECODER
    plan = msda_bwd_plan(32, dtype, 16, 16, MOTR, q, n * m)
    lanes = (4, 8, 8, 8) if dtype == torch.bfloat16 else (8, 4, 4, 4)
    assert plan[:4] == lanes
    assert (plan.warps, plan.blocks_per_sm) == (8, 2)
    assert (plan.blocks, plan.run, plan.rounds) == \
        MOTR_GRIDS[dtype][call == "decoder"]
    assert (plan.route, plan.tiled, plan.tile_bytes) == ("l2", (), 0)
    assert 25 * 48 * 32 * 4 > TWO_BLOCK_TILE
    assert msda_bwd_flushes(plan, q) == 0


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("levels", list(LEVEL_SETS), ids=str)
def test_tile_is_the_coarsest_suffix_that_fits(levels, dtype):
    """At every D 1-64, with heads of rows enough for a tile: the tiled
    levels are a suffix of the levels, their f32 rows of one head are the
    tile's bytes, within a block's shared memory with the level table
    (232,448 bytes, what the C entry point allows) and within two blocks an
    SM, and the next finer level would not have fit; route "l2" (nothing
    tiled, the parent's adds) exactly where the coarsest level alone does
    not fit; two blocks of 8 warps an SM."""
    shapes = LEVEL_SETS[levels]
    for d in range(1, MAX_CHANNELS + 1):
        plan = msda_bwd_plan(d, dtype, 16, 16, shapes, 50_000, 2)
        n = len(shapes)
        tiled = plan.tiled
        assert tiled == tuple(range(n - len(tiled), n))
        rows_bytes = [h * w * d * 4 for h, w in shapes]
        assert plan.tile_bytes == sum(rows_bytes[l] for l in tiled)
        assert plan.tile_bytes <= min(BWD_MAX_TILE_BYTES, TWO_BLOCK_TILE)
        assert plan.tile_bytes + STATIC <= SMEM_LIMIT
        c_plan = list(plan.as_c())
        assert c_plan[8:] == [int(bool(tiled)),
                              sum(1 << l for l in tiled), plan.tile_bytes]
        if tiled:
            assert plan.route == "smem"
            if tiled[0] > 0:
                assert (plan.tile_bytes + rows_bytes[tiled[0] - 1]
                        > TWO_BLOCK_TILE)
        else:
            assert plan.route == "l2" and plan.tile_bytes == 0
            assert rows_bytes[-1] > TWO_BLOCK_TILE
        assert (plan.warps, plan.blocks_per_sm) == (8, 2)


@pytest.mark.parametrize("n,q,m", ROW_CASES,
                         ids=[f"{n}x{q}x{m}" for n, q, m in ROW_CASES])
@pytest.mark.parametrize("levels", ["dino", "one_by_one", "motr"])
def test_runs_cover_every_row_once(n, q, m, levels):
    """Run r holds rows [r·run, min((r+1)·run, rows)) and block b takes
    runs b, b + blocks, … for `rounds` rounds, as the kernel walks them:
    every row in one run, every block and every round a run (what the C
    entry point checks), runs of whole chunks of 32/G rows a warp, at most
    the card's blocks; the tile visits of a head (a block's stretch of runs
    on it) no more than msda_bwd_flushes counts, each run meeting at most
    two heads where a head holds more rows than a run."""
    shapes = LEVEL_SETS[levels]
    rows = n * q * m
    for sms in (132, 114, 1):
        plan = msda_bwd_plan(32, torch.bfloat16, 16, 16, shapes, q, n * m,
                             sms)
        if not rows:
            assert plan.blocks == 0
            continue
        per_round = plan.blocks * plan.run
        assert (plan.blocks - 1) * plan.run < rows
        assert (plan.rounds - 1) * per_round < rows <= plan.rounds * per_round
        walked, visits = [], [0] * (n * m)
        for b in range(plan.blocks):
            last = None
            for k in range(plan.rounds):
                lo = (k * plan.blocks + b) * plan.run
                if lo >= rows:
                    break
                run = range(lo, min(lo + plan.run, rows))
                walked += run
                heads = sorted({i // q for i in run})
                if q >= plan.run:
                    assert len(heads) <= 2
                for head in heads:
                    visits[head] += head != last
                    last = head
        assert sorted(walked) == list(range(rows))
        assert plan.run % (plan.rows_per_warp * plan.warps) == 0
        assert plan.blocks <= plan.blocks_per_sm * sms
        assert max(plan.run, plan.rounds) <= 2 ** 31 - 1
        if plan.route == "smem":
            assert max(visits) <= msda_bwd_flushes(plan, q)
        else:
            assert msda_bwd_flushes(plan, q) == 0


def test_plan_refuses_what_k7_refuses():
    with pytest.raises(NotImplementedError, match="channels"):
        msda_bwd_plan(65, torch.float32, 16, 16, DINO, 100, 1)
    with pytest.raises(TypeError):
        msda_bwd_plan(32, torch.float16, 16, 16, DINO, 100, 1)


@pytest.mark.parametrize("tree", ["this", "first"])
def test_split_probe_finds_the_add_site(tree):
    """probes/msda_bwd_split.py cuts K7's dvalue adds at a line it knows:
    this tree's kernel and the first K7's (PR 17) each have exactly one of
    them, and the cut leaves every other line as it was."""
    from fastervit_tpu_torch.probes import msda_bwd_split
    line, _ = msda_bwd_split.SITES[tree == "this"]
    src = SOURCE.read_text() if tree == "this" else (
        "#include <x>\n" + line + "\n")
    cut = msda_bwd_split.masked_source(src)
    assert cut.count("ADD_MASK >>") == 1
    kept = [ln for ln in cut.splitlines()[3:] if "ADD_MASK" not in ln]
    assert kept == [ln for ln in src.splitlines() if ln != line]
