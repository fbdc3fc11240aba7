"""The second MSDA gather probe's functions (fastervit_tpu_torch/ops/
msda_probes.py: P4b `pair_staticr`, P4c `packed_coeff`, P4d `packed_wide`)
against scripts/msda_packed_probe2.py on the CPU: the plain versions
against the Pallas kernels run in interpret mode on the same numpy arrays,
f32 and bf16 maps, P 1, 2 and 4, the corner weights of the script's
`coeff_scalars` / `coeff_wide` and random ones; the two helpers bit for
bit; the probe's whole check against the script's own pipeline; the
bitwise cross-checks with P3b and P4a; the out-of-range rule; the
refusals; and the probe module's `main` with --device cpu."""
import functools
import importlib.util
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastervit_tpu_torch.ops import cuda_msda, msda_probes
from fastervit_tpu_torch.ops.msda_probes import (
    coeff_scalars, coeff_wide, fused_gather, fused_gather_p4,
    fused_gather_per_head, gather_p4_reference, gather_reference,
    pack_corners, packed_coeff, packed_coeff_reference, packed_gather,
    packed_gather_reference, packed_wide, packed_wide_reference,
    pair_staticr, pair_staticr_reference)
from fastervit_tpu_torch.probes import msda_packed_probe2
from torch_parity import few_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TPU_RECORDS = [REPO / "MSDA_PALLAS_PROBE.json",
               REPO / "MSDA_PACKED_PROBE.json"]
TPU_RECORD2 = REPO / "MSDA_PACKED_PROBE2.json"   # the JAX script's output
# f32 arithmetic on both sides, the same products and sums; XLA may
# contract a product and a sum into one FMA where PyTorch rounds both
TOL = 1e-6
# the interpret-mode size: the script's check map, M 2, QP 128, chunk 64
# (qp % chunk == 0 and chunk % (8p) == 0 at P 1, 2, 4)
HP, WP, M, QP, CHUNK = 27, 50, 2, 128, 64
U = 2.0 ** -24   # f32's unit roundoff


@functools.lru_cache(maxsize=None)
def _jax_probe2():
    """scripts/msda_packed_probe2.py as a module, leaving sys.path as it
    was (the script puts the repo in front of it and imports
    msda_pallas_probe and msda_packed_probe by name from scripts/)."""
    path = list(sys.path)
    try:
        sys.path.insert(0, str(REPO / "scripts"))
        for name in ("msda_pallas_probe", "msda_packed_probe",
                     "msda_packed_probe2"):
            spec = importlib.util.spec_from_file_location(
                name, REPO / "scripts" / f"{name}.py")
            module = importlib.util.module_from_spec(spec)
            sys.modules[name] = module
            spec.loader.exec_module(module)
    finally:
        sys.path[:] = path
    return module


def _case(hp, wp, qp, m=M, d=32, seed=0):
    """As the JAX script's make_case draws: numpy arrays (vm, iy, ix, fy,
    fx, w)."""
    rs = np.random.RandomState(seed)
    return (rs.randn(m, hp, wp, d).astype(np.float32),
            rs.randint(0, hp - 1, (m, qp)).astype(np.int32),
            rs.randint(0, wp - 1, (m, qp)).astype(np.int32),
            *(rs.rand(m, qp).astype(np.float32) for _ in range(3)))


def _torch(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _random_coeffs(m, qp, d, seed):
    """Corner weights and a coefficient row no `coeff_*` could give: of
    either sign, independent, unequal across a group's lanes; uniform in
    [−1/4, 1/4), so that |c00| + … + |c11| < 1 as the corner weights' sum w
    is, the scale TOL is stated for (XLA's contractions move the last bit
    of a product, so the differences grow with the outputs)."""
    rs = np.random.RandomState(seed)
    return ([rs.uniform(-0.25, 0.25, (m, qp)).astype(np.float32)
             for _ in range(4)],
            rs.uniform(-0.25, 0.25, (m, qp, 4 * d)).astype(np.float32))


KINDS = ["pair", "coeff_scalars", "coeff_random", "wide", "wide_random"]
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _both(kind, arrays, wp, p, dtype, seed=0):
    """(JAX kernel in interpret mode, port's plain version) on one case."""
    mod = _jax_probe2()
    tdt, jdt = DTYPES[dtype]
    vm, iy, ix, fy, fx, w = arrays
    m, qp, d = iy.shape[0], iy.shape[1], vm.shape[-1]
    j = [jnp.asarray(a) for a in arrays]
    t = _torch(arrays)
    kw = dict(p=p, chunk=CHUNK, interpret=True)
    if kind == "pair":
        want = mod.pair_staticr(j[0].astype(jdt), *j[1:], **kw)
        got = pair_staticr_reference(t[0].to(tdt), *t[1:], p)
        return want, got
    pm_j = mod.pack_corners(j[0]).astype(jdt)
    fl_j = j[1] * (wp - 1) + j[2]
    pm_t = pack_corners(t[0]).to(tdt)
    fl_t = t[1] * (wp - 1) + t[2]
    coeffs, rows = _random_coeffs(m, qp, d, seed)
    if kind == "coeff_scalars":
        want = mod.packed_coeff(pm_j, fl_j, *mod.coeff_scalars(*j[3:]), **kw)
        got = packed_coeff_reference(pm_t, fl_t, *coeff_scalars(*t[3:]), p)
    elif kind == "coeff_random":
        want = mod.packed_coeff(pm_j, fl_j, *map(jnp.asarray, coeffs), **kw)
        got = packed_coeff_reference(pm_t, fl_t, *_torch(coeffs), p)
    elif kind == "wide":
        want = mod.packed_wide(pm_j, fl_j, mod.coeff_wide(*j[3:], d), **kw)
        got = packed_wide_reference(pm_t, fl_t, coeff_wide(*t[3:], d), p)
    else:
        want = mod.packed_wide(pm_j, fl_j, jnp.asarray(rows), **kw)
        got = packed_wide_reference(pm_t, fl_t, torch.from_numpy(rows), p)
    return want, got


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", KINDS)
def test_plain_versions_match_the_jax_kernels_in_interpret_mode(kind, dtype,
                                                                p):
    arrays = _case(HP, WP, QP, seed=1)
    want, got = _both(kind, arrays, WP, p, dtype, seed=2)
    width = 4 * 32 if kind.startswith("wide") else 32
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert got.shape == tuple(want.shape) == (M, QP // p, width)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", KINDS)
def test_plain_versions_match_the_jax_kernels_at_d8(kind, dtype):
    """D 8: 4D = 32, one lane group of P4d's output per warp lane."""
    arrays = _case(HP, WP, QP, d=8, seed=3)
    want, got = _both(kind, arrays, WP, 2, dtype, seed=4)
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


def test_coeff_helpers_are_the_scripts_bit_for_bit():
    mod = _jax_probe2()
    fy, fx, w = _case(3, 3, 999, seed=5)[3:]
    want = mod.coeff_scalars(*map(jnp.asarray, (fy, fx, w)))
    got = coeff_scalars(*_torch((fy, fx, w)))
    for g, wt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wt))
    cw = coeff_wide(*_torch((fy, fx, w)), 8)
    assert cw.shape == (M, 999, 32) and cw.is_contiguous()
    np.testing.assert_array_equal(
        cw.numpy(), np.asarray(mod.coeff_wide(*map(jnp.asarray, (fy, fx, w)),
                                              8)))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_the_probes_check_matches_the_scripts_pipeline(dtype):
    """The slice as a whole: the probe's `variants` (P4b, P4c on
    coeff_scalars, P4d on coeff_wide with its groups summed) against the
    JAX script's `main` pipeline in interpret mode (:230-242: M 8, QP 256,
    chunk 128, the 27x50 map), on the same arrays; both against the
    script's `_reference` summed over P under its 1e-4."""
    mod = _jax_probe2()
    pallas = sys.modules["msda_pallas_probe"]
    tdt, jdt = DTYPES[dtype]
    mq, qp, d, p = 8, 256, 32, 4
    arrays = list(_case(HP, WP, qp, m=mq, d=d, seed=6))
    arrays[0] = np.asarray(jnp.asarray(arrays[0], jdt), np.float32)
    vm, iy, ix, fy, fx, w = j = [jnp.asarray(a) for a in arrays]
    vm = vm.astype(jdt)
    pm = mod.pack_corners(vm)
    fl = iy * (WP - 1) + ix
    kw = dict(chunk=128, interpret=True)
    want = {"pair_staticr": mod.pair_staticr(vm, iy, ix, fy, fx, w, **kw),
            "packed_coeff": mod.packed_coeff(pm, fl, *mod.coeff_scalars(
                fy, fx, w), **kw),
            "packed_wide": mod.packed_wide(pm, fl, mod.coeff_wide(
                fy, fx, w, d), **kw).reshape(mq, qp // p, 4, d).sum(2)}
    case = _torch(arrays)
    case[0] = case[0].to(tdt)
    got = msda_packed_probe2.variants(case, WP)
    ref = np.asarray(pallas._reference(*j)).reshape(mq, qp // p, p, d).sum(2)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=TOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(got[name].numpy(), ref, atol=1e-4,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("p", [1, 2, 4])
def test_bitwise_cross_checks(p):
    """P4b on an f32 map is P3b, and P4c on coeff_scalars is P4a, bit for
    bit; P4d on coeff_wide, its groups summed, is P4a up to the order of
    the same 4P rounded products' sums (each order within γ_{4P−1} of the
    exact sum)."""
    hp, wp, qp = 7, 9, 64
    t = _torch(_case(hp, wp, qp, seed=7))
    assert torch.equal(pair_staticr(*t, p), gather_p4_reference(*t, p))
    for dtype in (torch.float32, torch.bfloat16):
        pm, fl = pack_corners(t[0]).to(dtype), t[1] * (wp - 1) + t[2]
        p4a = packed_gather(pm, fl, *t[3:], p)
        assert torch.equal(packed_coeff(pm, fl, *coeff_scalars(*t[3:]), p),
                           p4a)
        wide = packed_wide(pm, fl, coeff_wide(*t[3:], 32), p)
        grouped = msda_packed_probe2.group_sum(wide)
        bound = 2 * (4 * p - 1) * U * packed_coeff(
            pm.abs(), fl, *(c.abs() for c in coeff_scalars(*t[3:])), p)
        assert ((grouped - p4a).abs() <= bound * (1 + 1e-6)).all()


def _nan_rows(got, bad, p):
    """The (M, QP/P) queries that hold an out-of-range sample: all NaN
    there and nowhere else."""
    bad_q = bad.reshape(bad.shape[0], -1, p).any(-1)
    g = got.numpy()
    assert np.isnan(g[bad_q]).all() and not np.isnan(g[~bad_q]).any()
    return bad_q


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_out_of_range_samples_give_nan(dtype):
    """NaN on every lane of a query with an out-of-range sample, the other
    queries as in range: P4b on (iy, ix), P4c and P4d on fl."""
    hp, wp, qp, p = 7, 9, 64, 4
    arrays = _case(hp, wp, qp, seed=8)
    t = _torch(arrays)
    vm = t[0].to(dtype)
    iy, ix = t[1].clone(), t[2].clone()
    iy[0, :4] = torch.tensor([-1, hp - 1, -2 ** 31, 2 ** 31 - 1])
    ix[1, 9:13] = torch.tensor([-1, wp - 1, -2 ** 31, 2 ** 31 - 1])
    bad = np.zeros((M, qp), bool)
    bad[0, :4] = bad[1, 9:13] = True
    got = pair_staticr(vm, iy, ix, *t[3:], p)
    bad_q = _nan_rows(got, bad, p)
    clean = pair_staticr(vm, *t[1:], p).numpy()
    np.testing.assert_array_equal(got.numpy()[~bad_q], clean[~bad_q])

    pm = pack_corners(t[0]).to(dtype)
    fl = t[1] * (wp - 1) + t[2]
    broken = fl.clone()
    broken[0, 5:8] = torch.tensor([-1, pm.shape[1], 2 ** 31 - 1])
    bad = np.zeros((M, qp), bool)
    bad[0, 5:8] = True
    coeffs, rows = _random_coeffs(M, qp, 32, seed=9)
    for fn, extra in ((packed_coeff, _torch(coeffs)),
                      (packed_wide, [torch.from_numpy(rows)])):
        got = fn(pm, broken, *extra, p)
        bad_q = _nan_rows(got, bad, p)
        clean = fn(pm, fl, *extra, p).numpy()
        np.testing.assert_array_equal(got.numpy()[~bad_q], clean[~bad_q])


def _inputs(hp=7, wp=9, qp=64, seed=0):
    """(P3 case, pm, fl, four random corner weights, a random cf row)."""
    t = _torch(_case(hp, wp, qp, seed=seed))
    pm, fl = pack_corners(t[0]), t[1] * (wp - 1) + t[2]
    coeffs, rows = _random_coeffs(M, qp, 32, seed)
    return t, pm, fl, _torch(coeffs), torch.from_numpy(rows)


def test_refusals():
    t, pm, fl, cs, cf = _inputs()
    for bad in (torch.bfloat16, torch.float64):
        with pytest.raises(TypeError, match="fractions and weights"):
            pair_staticr(*t[:3], t[3].to(bad), *t[4:], 4)
        with pytest.raises(TypeError, match="corner weights"):
            packed_coeff(pm, fl, *cs[:3], cs[3].to(bad), 4)
        with pytest.raises(TypeError, match="cf must be float32"):
            packed_wide(pm, fl, cf.to(bad), 4)
    for shape in ((M, 64, 64), (M, 63, 128), (1, 64, 128), (M, 64 * 128)):
        with pytest.raises(ValueError, match=r"cf must be \(M, QP, 4D\)"):
            packed_wide(pm, fl, torch.zeros(shape), 4)
    for call in (lambda p: pair_staticr(*t, p),
                 lambda p: packed_coeff(pm, fl, *cs, p),
                 lambda p: packed_wide(pm, fl, cf, p)):
        for p in (3, 8):
            with pytest.raises(NotImplementedError, match="P in"):
                call(p)
    with pytest.raises(TypeError, match="float32 or bfloat16 map"):
        pair_staticr(t[0].half(), *t[1:], 4)
    for fn, args in ((packed_coeff, cs), (packed_wide, [cf])):
        with pytest.raises(TypeError, match="packed map"):
            fn(pm.half(), fl, *args, 4)
        with pytest.raises(TypeError, match="int32"):
            fn(pm, fl.long(), *args, 4)
    with pytest.raises(ValueError, match="multiple of P"):
        pair_staticr(t[0], *(x[:, :62] for x in t[1:]), 4)
    with pytest.raises(ValueError, match="M = 2"):
        packed_coeff(pm, fl, *cs[:3], cs[3][:1], 4)
    with pytest.raises(NotImplementedError, match="channels"):
        pair_staticr(torch.zeros(M, 7, 9, 65), *t[1:], 4)


GATHERS = [(fused_gather, ()), (fused_gather_p4, (4,)),
           (fused_gather_per_head, ()), (gather_reference, ()),
           (gather_p4_reference, (4,))]


@pytest.mark.parametrize("fn,extra", GATHERS, ids=lambda f: getattr(
    f, "__name__", ""))
def test_p3_still_refuses_a_bf16_map_that_p4b_takes(fn, extra):
    """check_gather is not loosened: P3a-c refuse the bf16 map that P4b,
    which widens its patch to f32 as the JAX `pair_staticr` does, takes."""
    t = _inputs()[0]
    with pytest.raises(TypeError, match="float32 map"):
        fn(t[0].bfloat16(), *t[1:], *extra)
    assert pair_staticr(t[0].bfloat16(), *t[1:], 4).dtype == torch.float32


@pytest.mark.parametrize("name", ["pair_staticr", "packed_coeff",
                                  "packed_wide"])
def test_inputs_that_need_a_gradient_raise(name):
    t, pm, fl, cs, cf = _inputs()
    args = {"pair_staticr": list(t), "packed_coeff": [pm, fl, *cs],
            "packed_wide": [pm, fl, cf]}[name]
    args[-1] = args[-1].clone().requires_grad_()
    with pytest.raises(ValueError, match="no gradient"):
        getattr(msda_probes, name)(*args, 4)


def test_32_bit_offsets_are_checked():
    """Every tensor of a call, cf and the output too, must hold fewer than
    2^31 elements (meta tensors: nothing is allocated). cf at MOTR's level
    0 holds 417.8 M and passes."""
    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    fl = meta(8, 408_000, dtype=torch.int32)
    cuda_msda.check_wide(meta(8, 201 * 385, 128), fl, meta(8, 408_000, 128),
                         4)
    big = meta(8, 2_200_000, dtype=torch.int32)
    with pytest.raises(ValueError, match="32-bit"):
        cuda_msda.check_wide(meta(8, 100, 128), big, meta(8, 2_200_000, 128),
                             4)
    floats = [meta(8, 2_200_000)] * 4
    with pytest.raises(ValueError, match="32-bit"):
        cuda_msda.check_coeff(meta(8, 3_000_000, 128), big, *floats, 4)
    with pytest.raises(ValueError, match="32-bit"):
        cuda_msda.check_pair(meta(8, 2_100, 2_100, 64, dtype=torch.bfloat16),
                             big, big, *floats[:3], 4)
    cuda_msda.check_pair(meta(8, 202, 386, 32, dtype=torch.bfloat16), big,
                         big, *floats[:3], 4)


COUNTERS = (cuda_msda.pair_staticr_cuda, cuda_msda.packed_coeff_cuda,
            cuda_msda.packed_wide_cuda)


def test_cpu_dispatch_takes_the_plain_versions():
    t, pm, fl, cs, cf = _inputs(seed=10)
    pm16 = pm.bfloat16()
    before = [f.launches for f in COUNTERS]
    assert torch.equal(pair_staticr(t[0].bfloat16(), *t[1:], 2),
                       pair_staticr_reference(t[0].bfloat16(), *t[1:], 2))
    assert torch.equal(packed_coeff(pm16, fl, *cs, 4),
                       packed_coeff_reference(pm16, fl, *cs, 4))
    assert torch.equal(packed_wide(pm16, fl, cf, 1),
                       packed_wide_reference(pm16, fl, cf, 1))
    assert [f.launches for f in COUNTERS] == before


def test_cuda_wrappers_refuse_cpu_tensors():
    t, pm, fl, cs, cf = _inputs()
    before = [f.launches for f in COUNTERS]
    for call in (lambda: cuda_msda.pair_staticr_cuda(*t, 4),
                 lambda: cuda_msda.packed_coeff_cuda(pm, fl, *cs, 4),
                 lambda: cuda_msda.packed_wide_cuda(pm, fl, cf, 4)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert [f.launches for f in COUNTERS] == before


def test_p4d_keeps_the_four_groups():
    """P4d's output is (M, QP/P, 4D); a cf that is zero outside one corner
    group leaves the other groups zero, and that group is P4a's sum of its
    corner alone."""
    t, pm, fl = _inputs(seed=11)[:3]
    for k in range(4):
        cs = [c if i == k else torch.zeros_like(c)
              for i, c in enumerate(coeff_scalars(*t[3:]))]
        cf = torch.cat([c[..., None].expand(-1, -1, 32) for c in cs], -1)
        wide = packed_wide(pm, fl, cf, 4)
        assert wide.shape == (M, 16, 128)
        groups = wide.view(M, 16, 4, 32)
        others = [i for i in range(4) if i != k]
        assert not groups[:, :, others].any()
        np.testing.assert_allclose(groups[:, :, k].numpy(),
                                   packed_coeff(pm, fl, *cs, 4).numpy(),
                                   atol=TOL, rtol=0)


def test_probe_main_on_the_cpu(tmp_path, monkeypatch, capsys):
    """--device cpu runs the check case (27x50, QP 400) through the plain
    versions, untimed, prints one JSON line and writes no file: not in the
    working directory, not over the JAX package's TPU records, and not the
    JAX script's MSDA_PACKED_PROBE2.json."""
    records = [p.read_bytes() for p in TPU_RECORDS]
    monkeypatch.chdir(tmp_path)
    result = msda_packed_probe2.main(["--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == result
    assert result["device"] == {"type": "cpu", "timed": False}
    assert result["geometry"]["QP"] == 408_000
    assert result["geometry"]["levels"] == [[202, 386], [102, 194]]
    assert set(result["correctness_max_err"]) == {"pair_staticr",
                                                  "packed_coeff",
                                                  "packed_wide"}
    assert all(0 <= e <= 1e-4 for e in result["correctness_max_err"].values())
    assert "levels" not in result
    assert list(tmp_path.iterdir()) == []
    assert [p.read_bytes() for p in TPU_RECORDS] == records
    assert not TPU_RECORD2.exists()


def test_probe_writes_only_at_out(tmp_path, capsys):
    out = tmp_path / "probe.json"
    result = msda_packed_probe2.main(["--device", "cpu", "--seed", "3",
                                      "--levels", "4", "--out", str(out)])
    assert json.loads(out.read_text()) == result
    assert len(result["geometry"]["levels"]) == 4
    assert sorted(tmp_path.iterdir()) == [out]


@pytest.mark.parametrize("argv", [["--out", str(p)] for p in
                                  (*TPU_RECORDS, TPU_RECORD2)]
                         + [["--levels", "0"], ["--levels", "5"]])
def test_probe_refuses(argv, capsys):
    """The JAX package's TPU records (and the JAX script's own output) as
    --out, and a level count outside 1-4."""
    with pytest.raises(SystemExit) as exc:
        msda_packed_probe2.main(["--device", "cpu", *argv])
    assert exc.value.code != 0
    assert not TPU_RECORD2.exists()


def test_probe_without_a_card_exits_nonzero(monkeypatch, capsys):
    """The default device is the card; without one the probe stops and
    prints no result, and never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        msda_packed_probe2.main([])
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""
