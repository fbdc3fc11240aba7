"""The MSDA gather probes' kernels (csrc/msda_probe.cu) against their plain
PyTorch versions on the card: P3a `fused_gather_cuda`, P3b
`fused_gather_p4_cuda`, P3c `fused_gather_per_head_cuda` and P4a
`packed_gather_cuda` (f32 and bf16 packed maps), at MOTR's levels and odd
shapes, with out-of-range samples; every route and vector width of their
launch plans (`cuda_msda.probe_plan`) bit for bit, maps at element offsets
included, and the C entry points' refusal of wrong plans; their launch
counters, bit-identical launches and the probe modules' timed runs. Every
test here needs a CUDA device and skips without one. On a machine with an
H100 (which need not have jax, so tests/conftest.py is not loaded):

    python -m pytest --noconftest -q tests/test_torch_cuda_msda_probes.py
"""
import json

import pytest
import torch

from fastervit_tpu_torch.ops import cuda_msda, msda_probes
from fastervit_tpu_torch.probes import msda_packed_probe, msda_pallas_probe

# (Hp, Wp, QP, M, D): MOTR's padded levels at a tenth of the probes' QP,
# then a 3x3 map, QP 4 and 4,004, one head, D 64 and 33, and QP 0
CASES = [(202, 386, 40_800, 8, 32), (102, 194, 40_800, 8, 32),
         (52, 98, 40_800, 8, 32), (27, 50, 40_800, 8, 32),
         (3, 3, 4_004, 8, 32), (27, 50, 4, 8, 32), (27, 50, 4_004, 1, 32),
         (52, 98, 4_004, 2, 64), (7, 9, 1_000, 3, 33), (27, 50, 0, 8, 32)]
POINTS = (1, 2, 4)
# The kernels repeat the plain versions' f32 roundings in the same order
# (every product and sum rounded alone; a bf16 map widened exactly), so
# they should agree to the bit; they are held to this, and NaN at the same
# places.
TOL = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(hp, wp, qp, m, d, device, seed=0, out_of_range=False):
    gen = torch.Generator(device=device).manual_seed(seed)
    case = list(msda_probes.sample_case(hp, wp, qp, m, d, gen, device))
    if out_of_range and qp:
        # a sixteenth of the samples a row or column past either edge, or
        # far outside
        bad = torch.tensor([-1, -2 ** 31, 2 ** 31 - 1], device=device,
                           dtype=torch.int32)
        for k, edge in ((1, hp - 1), (2, wp - 1)):
            pick = torch.rand(m, qp, generator=gen, device=device) < 1 / 32
            values = torch.cat([bad, bad.new_tensor([edge])])
            which = torch.randint(0, len(values), (m, qp), generator=gen,
                                  device=device)
            case[k] = torch.where(pick, values[which], case[k])
    return case


def _compare(got, want):
    """max |got − want| where want is a number; NaN at the same places."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    return (got - want)[~nan].abs().max().item() if (~nan).any() else 0.0


def _packed(case, wp):
    pm = msda_probes.pack_corners(case[0])
    return pm, case[1] * (wp - 1) + case[2]


def _fl_out_of_range(fl, cells, gen):
    pick = torch.rand(fl.shape, generator=gen, device=fl.device) < 1 / 32
    values = fl.new_tensor([-1, cells, 2 ** 31 - 1])
    which = torch.randint(0, 3, fl.shape, generator=gen, device=fl.device)
    return torch.where(pick, values[which], fl)


@pytest.mark.cuda
@pytest.mark.parametrize("out_of_range", [False, True])
@pytest.mark.parametrize("hp,wp,qp,m,d", CASES)
def test_gather_kernels_match_plain(cuda, hp, wp, qp, m, d, out_of_range):
    case = _case(hp, wp, qp, m, d, cuda, out_of_range=out_of_range)
    want = msda_probes.gather_reference(*case)
    for kernel in (cuda_msda.fused_gather_cuda,
                   cuda_msda.fused_gather_per_head_cuda):
        got = kernel(*case)
        torch.cuda.synchronize()
        assert got.shape == (m, qp, d) and got.dtype == torch.float32
        assert _compare(got, want) <= TOL
    for p in POINTS:
        if qp % p:
            continue
        got = cuda_msda.fused_gather_p4_cuda(*case, p)
        want_p = msda_probes.gather_p4_reference(*case, p)
        torch.cuda.synchronize()
        assert got.shape == (m, qp // p, d)
        assert _compare(got, want_p) <= TOL
    if out_of_range and qp:
        assert torch.isnan(want).any() and not torch.isnan(want).all()


@pytest.mark.cuda
@pytest.mark.parametrize("out_of_range", [False, True])
@pytest.mark.parametrize("hp,wp,qp,m,d", CASES)
def test_packed_kernel_matches_plain(cuda, hp, wp, qp, m, d, out_of_range):
    case = _case(hp, wp, qp, m, d, cuda, seed=1)
    pm, fl = _packed(case, wp)
    if out_of_range and qp:
        gen = torch.Generator(device=cuda).manual_seed(2)
        fl = _fl_out_of_range(fl, pm.shape[1], gen)
    for packed in (pm, pm.bfloat16()):
        for p in POINTS:
            if qp % p:
                continue
            got = cuda_msda.packed_gather_cuda(packed, fl, *case[3:], p)
            want = msda_probes.packed_gather_reference(packed, fl, *case[3:],
                                                       p)
            torch.cuda.synchronize()
            assert got.shape == (m, qp // p, d) and got.dtype == torch.float32
            assert _compare(got, want) <= TOL


@pytest.mark.cuda
def test_launches_are_counted_and_bit_identical(cuda):
    """The dispatch sends CUDA tensors to the kernels; P3a, P3b and P4a
    count one launch a call, P3c one a head; two launches give the same
    bits (one owner per output row, no atomics); QP 0 launches nothing."""
    case = _case(52, 98, 40_800, 8, 32, cuda)
    pm, fl = _packed(case, 98)
    calls = {
        cuda_msda.fused_gather_cuda: lambda: msda_probes.fused_gather(*case),
        cuda_msda.fused_gather_p4_cuda:
            lambda: msda_probes.fused_gather_p4(*case, 4),
        cuda_msda.fused_gather_per_head_cuda:
            lambda: msda_probes.fused_gather_per_head(*case),
        cuda_msda.packed_gather_cuda:
            lambda: msda_probes.packed_gather(pm.bfloat16(), fl, *case[3:],
                                              4),
    }
    for kernel, call in calls.items():
        before = kernel.launches
        first, second = call(), call()
        per_call = 8 if kernel is cuda_msda.fused_gather_per_head_cuda else 1
        assert kernel.launches == before + 2 * per_call
        assert torch.equal(first, second)
    empty = _case(27, 50, 0, 8, 32, cuda)
    before = [k.launches for k in calls]
    assert msda_probes.fused_gather(*empty).shape == (8, 0, 32)
    assert msda_probes.fused_gather_per_head(*empty).shape == (8, 0, 32)
    assert [k.launches for k in calls] == before


@pytest.mark.cuda
def test_refusals_on_the_card(cuda):
    case = _case(27, 50, 400, 8, 32, cuda)
    with pytest.raises(TypeError, match="float32 map"):
        cuda_msda.fused_gather_cuda(case[0].bfloat16(), *case[1:])
    with pytest.raises(ValueError, match="multiple of"):
        cuda_msda.fused_gather_p4_cuda(*case[:1], *(t[:, :398]
                                                    for t in case[1:]), 4)
    with pytest.raises(NotImplementedError, match="channels"):
        cuda_msda.fused_gather_cuda(torch.zeros(8, 27, 50, 65, device=cuda),
                                    *case[1:])
    with pytest.raises(ValueError, match="contiguous"):
        cuda_msda.fused_gather_cuda(case[0], case[1].t().contiguous().t(),
                                    *case[2:])
    with pytest.raises(ValueError, match="one CUDA device"):
        cuda_msda.fused_gather_cuda(case[0], case[1].cpu(), *case[2:])


@pytest.mark.cuda
@pytest.mark.parametrize("probe", [msda_pallas_probe, msda_packed_probe],
                         ids=lambda m: m.__name__)
def test_probe_times_every_row_on_the_card(cuda, probe, tmp_path, capsys):
    out = tmp_path / "probe.json"
    argv = ["--out", str(out)]
    if probe is msda_pallas_probe:
        argv.append("--e2e-only")  # the levels are phase 27's
    result = probe.main(argv)
    assert json.loads(out.read_text()) == result
    assert result["device"]["type"] == "cuda"
    assert all(err <= 1e-4 for err in result["correctness_max_err"].values())
    for level in result["levels"]:
        rows = [r for r in level.values() if isinstance(r, dict)]
        assert rows and all(r["ms"] > 0 and r["bound_ms"] > 0 for r in rows)
    if probe is msda_pallas_probe:
        enc = result["encoder_call"]
        assert enc["S"] == 102_000 and enc["ms_k5"] > 0
        assert enc["parity_max_abs_diff"] <= 1e-5


def _at_offset(t, elems):
    """A contiguous copy of t `elems` elements into its storage."""
    buf = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    out = buf[elems:].view(t.shape)
    out.copy_(t)
    return out


def _bits_match(got, want):
    """The plain version's f32 bits wherever it is a number, and NaN at its
    NaN places (the kernels' NaN is 0x7fffffff, torch's 0x7fc00000)."""
    nan = torch.isnan(want)
    return (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan].view(torch.int32),
                            want[~nan].view(torch.int32)))


# (kernel, map dtype, the map's element offset, its vector bytes, (Hp, Wp),
# route): every route and vector width of the pair kernel (P3b on f32,
# P4b on bf16 maps) and the packed one (P4a), with MOTR's level 2 (52x98,
# route l2 for the pair kernel) and level 3 (27x50, route smem)
OFFSETS = {torch.float32: ((0, 16), (2, 8), (1, 4)),
           torch.bfloat16: ((0, 16), (4, 8), (2, 4), (1, 2))}
PLAN_CASES = [
    (kind, dtype, offset, vec_bytes, level, route)
    for kind in ("pair", "packed")
    for dtype, offsets in OFFSETS.items()
    for offset, vec_bytes in offsets
    for level, route in (((52, 98), "l2"),
                         ((27, 50), "smem" if kind == "pair" else "l2"))]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,dtype,offset,vec_bytes,level,route",
                         PLAN_CASES, ids=str)
def test_every_plan_route_and_vector_bit_for_bit(cuda, kind, dtype, offset,
                                                 vec_bytes, level, route):
    """Each route and vector width against the plain version, bit for bit,
    with some samples out of range; two launches give the same bits."""
    hp, wp = level
    case = _case(hp, wp, 40_800, 8, 32, cuda, seed=3, out_of_range=True)
    if kind == "pair":
        kernel, plain = ((cuda_msda.fused_gather_p4_cuda,
                          msda_probes.gather_p4_reference)
                         if dtype == torch.float32 else
                         (cuda_msda.pair_staticr_cuda,
                          msda_probes.pair_staticr_reference))
        args = [_at_offset(case[0].to(dtype), offset), *case[1:], 4]
    else:
        kernel, plain = (cuda_msda.packed_gather_cuda,
                         msda_probes.packed_gather_reference)
        pm, fl = _packed(case, wp)
        fl = torch.where((case[1] >= 0) & (case[1] <= hp - 2)
                         & (case[2] >= 0) & (case[2] <= wp - 2), fl, -1)
        args = [_at_offset(pm.to(dtype), offset), fl, *case[3:], 4]
    got = kernel(*args)
    plan = kernel.last_plan
    again = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    assert plan.route == route
    assert plan.vec * dtype.itemsize == vec_bytes
    assert torch.isnan(want).any()
    assert _bits_match(got, want)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("level", [(52, 98), (27, 50)])
def test_per_head_launches_spread_one_head(cuda, level):
    """P3c launches one head at a time; each launch's grid is the card's
    (its head over every SM), on route l2 or smem, with P3a's bits."""
    hp, wp = level
    case = _case(hp, wp, 40_800, 8, 32, cuda, seed=4, out_of_range=True)
    kernel = cuda_msda.fused_gather_per_head_cuda
    before = kernel.launches
    got = kernel(*case)
    plan = kernel.last_plan
    torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert kernel.launches == before + 8
    assert plan.route == ("smem" if hp == 27 else "l2")
    assert plan.warps * plan.blocks == 32 * sms
    assert _bits_match(got, msda_probes.gather_reference(*case))
    assert _bits_match(got, cuda_msda.fused_gather_cuda(*case))


@pytest.mark.cuda
def test_c_entry_points_refuse_wrong_plans(cuda, monkeypatch):
    """msda_probe_pair, msda_probe_packed and msda_probe_coeff, handed a
    plan that no instance runs on their pointers in place of probe_plan's,
    refuse it: the call raises and counts no launch."""
    level3 = _case(27, 50, 400, 8, 32, cuda)
    level0 = _case(202, 386, 400, 8, 32, cuda)
    d20 = _case(27, 50, 400, 8, 20, cuda)
    pm, fl = _packed(level3, 50)
    cs = msda_probes.coeff_scalars(*level3[3:])
    plan = cuda_msda.ProbePlan
    wrong = [  # (kernel, arguments, plan, what is wrong)
        (cuda_msda.fused_gather_p4_cuda,
         [_at_offset(level3[0], 1), *level3[1:], 4],
         plan(8, 4, 4, 4, 8, 528, "l2"), "misaligned vectors"),
        (cuda_msda.pair_staticr_cuda,
         [d20[0].bfloat16(), *d20[1:], 4],
         plan(4, 8, 8, 8, 8, 528, "l2"), "a V that does not divide D"),
        (cuda_msda.fused_gather_p4_cuda, [*level0, 4],
         plan(8, 4, 4, 4, 32, 132, "smem"), "a map that does not fit"),
        (cuda_msda.fused_gather_cuda, level3,
         plan(8, 4, 4, 4, 33, 132, "l2"), "too many warps"),
        (cuda_msda.packed_gather_cuda, [pm, fl, *level3[3:], 4],
         plan(8, 4, 4, 4, 32, 132, "smem"), "packed on route smem"),
        (cuda_msda.fused_gather_p4_cuda, [*level3, 4],
         plan(8, 4, 4, 2, 8, 528, "l2"), "rows that are no whole warp"),
        (cuda_msda.packed_coeff_cuda, [pm.bfloat16(), fl, *cs, 4],
         plan(4, 8, 8, 8, 32, 132, "smem"), "coeff on route smem"),
        (cuda_msda.packed_coeff_cuda, [_at_offset(pm, 1), fl, *cs, 4],
         plan(8, 4, 4, 4, 8, 528, "l2"), "coeff on misaligned vectors"),
        (cuda_msda.packed_coeff_cuda, [pm, fl, *cs, 4],
         plan(8, 2, 2, 4, 8, 528, "l2"), "coeff on 16 of D's 32 channels"),
    ]
    for kernel, args, bad, what in wrong:
        monkeypatch.setattr(cuda_msda, "probe_plan", lambda *_: bad)
        before = kernel.launches
        with pytest.raises(RuntimeError, match="msda_probe_"):
            kernel(*args)
        assert kernel.launches == before, what
    monkeypatch.undo()
    torch.cuda.synchronize()
