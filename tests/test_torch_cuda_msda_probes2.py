"""The second MSDA gather probe's kernels (csrc/msda_probe.cu) against their
plain PyTorch versions on the card: P4b `pair_staticr_cuda`, P4c
`packed_coeff_cuda` and P4d `packed_wide_cuda`, on f32 and bf16 maps, at P
1, 2 and 4, at MOTR's levels and odd shapes, with out-of-range samples;
P4b on an f32 map against P3b and P4c on `coeff_scalars` against P4a, bit
for bit; their launch counters, refusals, bit-identical launches and the
probe module's timed run. Every test here needs a CUDA device and skips
without one. On a machine with an H100 (which need not have jax, so
tests/conftest.py is not loaded):

    python -m pytest --noconftest -q tests/test_torch_cuda_msda_probes2.py
"""
import json

import pytest
import torch

from fastervit_tpu_torch.ops import cuda_msda, msda_probes
from fastervit_tpu_torch.probes import msda_packed_probe2

# (Hp, Wp, QP, M, D): MOTR's padded levels 0 and 3 at a tenth of the
# probes' QP, then a 3x3 map, QP 4 and 4,004, one head, D 64 and 33, and
# QP 0
CASES = [(202, 386, 40_800, 8, 32), (27, 50, 40_800, 8, 32),
         (3, 3, 4_004, 8, 32), (27, 50, 4, 8, 32), (27, 50, 4_004, 1, 32),
         (52, 98, 4_004, 2, 64), (7, 9, 1_000, 3, 33), (27, 50, 0, 8, 32)]
POINTS = (1, 2, 4)
MAPS = (torch.float32, torch.bfloat16)
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
    """(P3 case, pm, fl, four random corner weights, a random cf row), the
    indices broken at about a thirty-second of the samples if asked."""
    gen = torch.Generator(device=device).manual_seed(seed)
    case = list(msda_probes.sample_case(hp, wp, qp, m, d, gen, device))
    pm = msda_probes.pack_corners(case[0])
    fl = case[1] * (wp - 1) + case[2]
    if out_of_range and qp:
        for k, edge in ((1, hp - 1), (2, wp - 1)):
            case[k] = _broken(case[k], edge, gen)
        fl = _broken(fl, pm.shape[1], gen)
    kw = {"generator": gen, "device": device}
    coeffs = [torch.rand(m, qp, **kw) * 0.5 - 0.25 for _ in range(4)]
    cf = torch.rand(m, qp, 4 * d, **kw) * 0.5 - 0.25
    return case, pm, fl, coeffs, cf


def _broken(t, edge, gen):
    """A copy of an int32 (M, QP) index tensor with about a thirty-second
    of its entries, and its first column, out of range: -1, `edge` (one
    past the last valid index), -2^31 or 2^31 - 1."""
    values = t.new_tensor([-1, edge, -2 ** 31, 2 ** 31 - 1])
    pick = torch.rand(t.shape, generator=gen, device=t.device) < 1 / 32
    pick[:, :1] = True
    which = torch.randint(0, 4, t.shape, generator=gen, device=t.device)
    return torch.where(pick, values[which], t)


def _bits_equal(a, b):
    """The same f32 bits, NaN's too."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _compare(got, want):
    """max |got − want| where want is a number; NaN at the same places."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    return (got - want)[~nan].abs().max().item() if (~nan).any() else 0.0


def _runs(case, pm, fl, coeffs, cf, qp):
    """(kernel, plain version, arguments) for every map type and P."""
    fy, fx, w = case[3:]
    d = case[0].shape[-1]
    out = []
    for dtype in MAPS:
        vm, pmt = case[0].to(dtype), pm.to(dtype)
        for p in POINTS:
            if qp % p:
                continue
            out += [
                (cuda_msda.pair_staticr_cuda,
                 msda_probes.pair_staticr_reference, [vm, *case[1:], p]),
                (cuda_msda.packed_coeff_cuda,
                 msda_probes.packed_coeff_reference,
                 [pmt, fl, *msda_probes.coeff_scalars(fy, fx, w), p]),
                (cuda_msda.packed_coeff_cuda,
                 msda_probes.packed_coeff_reference, [pmt, fl, *coeffs, p]),
                (cuda_msda.packed_wide_cuda,
                 msda_probes.packed_wide_reference,
                 [pmt, fl, msda_probes.coeff_wide(fy, fx, w, d), p]),
                (cuda_msda.packed_wide_cuda,
                 msda_probes.packed_wide_reference, [pmt, fl, cf, p])]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("out_of_range", [False, True])
@pytest.mark.parametrize("hp,wp,qp,m,d", CASES)
def test_kernels_match_plain(cuda, hp, wp, qp, m, d, out_of_range):
    inputs = _case(hp, wp, qp, m, d, cuda, out_of_range=out_of_range)
    nans = 0
    for kernel, plain, args in _runs(*inputs, qp):
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        p = args[-1]
        width = 4 * d if kernel is cuda_msda.packed_wide_cuda else d
        assert got.shape == (m, qp // p, width) and got.dtype == torch.float32
        assert _compare(got, want) <= TOL
        nans += int(torch.isnan(want).any())
    assert bool(nans) == (out_of_range and qp > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("hp,wp,qp,m,d", CASES[:2] + CASES[5:7])
def test_cross_checks(cuda, hp, wp, qp, m, d):
    """P4b on an f32 map is P3b, P4c on coeff_scalars is P4a, bit for bit;
    P4d on coeff_wide, its groups summed, is P4a to within the order bound
    of the same 4P rounded products' sums."""
    case, pm, fl = _case(hp, wp, qp, m, d, cuda, seed=3,
                         out_of_range=True)[:3]
    fy, fx, w = case[3:]
    cs = msda_probes.coeff_scalars(fy, fx, w)
    cw = msda_probes.coeff_wide(fy, fx, w, d)
    for p in POINTS:
        assert _bits_equal(cuda_msda.pair_staticr_cuda(*case, p),
                           cuda_msda.fused_gather_p4_cuda(*case, p))
        for dtype in MAPS:
            pmt = pm.to(dtype)
            p4a = cuda_msda.packed_gather_cuda(pmt, fl, fy, fx, w, p)
            assert _bits_equal(cuda_msda.packed_coeff_cuda(pmt, fl, *cs, p),
                               p4a)
            grouped = msda_packed_probe2.group_sum(
                cuda_msda.packed_wide_cuda(pmt, fl, cw, p))
            bound = 2 * (4 * p - 1) * 2.0 ** -24 * cuda_msda.packed_coeff_cuda(
                pmt.abs(), fl, *(c.abs() for c in cs), p)
            nan = torch.isnan(p4a)
            assert torch.equal(torch.isnan(grouped), nan)
            assert ((grouped - p4a).abs() <= bound * (1 + 1e-6))[~nan].all()


@pytest.mark.cuda
def test_launches_are_counted_and_bit_identical(cuda):
    """The dispatch sends CUDA tensors to the kernels, one launch a call;
    two launches give the same bits (one owner per output row, no
    atomics); QP 0 launches nothing."""
    case, pm, fl, coeffs, cf = _case(52, 98, 40_800, 8, 32, cuda)
    pm16 = pm.bfloat16()
    calls = {
        cuda_msda.pair_staticr_cuda:
            lambda: msda_probes.pair_staticr(case[0].bfloat16(), *case[1:],
                                             4),
        cuda_msda.packed_coeff_cuda:
            lambda: msda_probes.packed_coeff(pm16, fl, *coeffs, 2),
        cuda_msda.packed_wide_cuda:
            lambda: msda_probes.packed_wide(pm16, fl, cf, 4),
    }
    for kernel, call in calls.items():
        before = kernel.launches
        first, second = call(), call()
        assert kernel.launches == before + 2
        assert torch.equal(first, second)
    case, pm, fl, coeffs, cf = _case(27, 50, 0, 8, 32, cuda)
    before = [k.launches for k in calls]
    assert msda_probes.pair_staticr(*case, 4).shape == (8, 0, 32)
    assert msda_probes.packed_coeff(pm, fl, *coeffs, 4).shape == (8, 0, 32)
    assert msda_probes.packed_wide(pm, fl, cf, 4).shape == (8, 0, 128)
    assert [k.launches for k in calls] == before


@pytest.mark.cuda
def test_refusals_on_the_card(cuda):
    case, pm, fl, coeffs, cf = _case(27, 50, 400, 8, 32, cuda)
    before = [k.launches for k in (cuda_msda.pair_staticr_cuda,
                                   cuda_msda.packed_coeff_cuda,
                                   cuda_msda.packed_wide_cuda)]
    with pytest.raises(TypeError, match="float32 map"):
        cuda_msda.fused_gather_p4_cuda(case[0].bfloat16(), *case[1:], 4)
    with pytest.raises(TypeError, match="fractions and weights"):
        cuda_msda.pair_staticr_cuda(*case[:5], case[5].bfloat16(), 4)
    with pytest.raises(TypeError, match="corner weights"):
        cuda_msda.packed_coeff_cuda(pm, fl, *coeffs[:3],
                                    coeffs[3].bfloat16(), 4)
    with pytest.raises(ValueError, match="cf must be"):
        cuda_msda.packed_wide_cuda(pm, fl, cf[..., :64], 4)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_msda.packed_wide_cuda(pm, fl, cf.transpose(0, 1).contiguous()
                                   .transpose(0, 1), 4)
    with pytest.raises(NotImplementedError, match="P in"):
        cuda_msda.packed_coeff_cuda(pm, fl, *coeffs, 3)
    with pytest.raises(ValueError, match="one CUDA device"):
        cuda_msda.packed_wide_cuda(pm, fl.cpu(), cf, 4)
    with pytest.raises(ValueError, match="no gradient"):
        cuda_msda.packed_wide_cuda(pm, fl, cf.requires_grad_(), 4)
    assert [k.launches for k in (cuda_msda.pair_staticr_cuda,
                                 cuda_msda.packed_coeff_cuda,
                                 cuda_msda.packed_wide_cuda)] == before


@pytest.mark.cuda
def test_probe_times_every_row_on_the_card(cuda, tmp_path, capsys):
    out = tmp_path / "probe.json"
    result = msda_packed_probe2.main(["--out", str(out), "--levels", "1"])
    assert json.loads(out.read_text()) == result
    assert result["device"]["type"] == "cuda"
    assert all(err <= 1e-4 for err in result["correctness_max_err"].values())
    (level,) = result["levels"]
    rows = {n: r for n, r in level.items() if isinstance(r, dict)}
    assert set(rows) == {"pair_staticr", "packed_coeff", "packed_wide",
                         "packed_wide_sum", "pair_p4", "packed",
                         "grid_sample_p4"}
    assert all(r["ms"] > 0 and r["bound_ms"] > 0 for r in rows.values())
