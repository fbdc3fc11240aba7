"""The MSDA gather probes' functions (fastervit_tpu_torch/ops/
msda_probes.py) against the JAX probes, on the CPU: the plain versions of
P3a, P3b, P3c and P4a against scripts/msda_pallas_probe.py's
`fused_gather`, `fused_gather_p4`, `fused_gather_per_head` and
scripts/msda_packed_probe.py's `packed_gather`, the Pallas kernels run in
interpret mode, and against the JAX script's `_reference`; then the
dispatch, the refusals, the out-of-range rule, the grid_sample yardstick,
and both probe modules' `main` with --device cpu."""
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
    fused_gather, fused_gather_p4, fused_gather_per_head, gather_p4_reference,
    gather_reference, pack_corners, packed_gather, packed_gather_reference)
from fastervit_tpu_torch.probes import (gather_grid, gather_grid_sample,
                                        msda_packed_probe, msda_pallas_probe)
from torch_parity import few_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TPU_RECORDS = [REPO / "MSDA_PALLAS_PROBE.json",
               REPO / "MSDA_PACKED_PROBE.json"]
M, D, P = 8, 32, 4
# f32 arithmetic on both sides, the same products and sums; XLA may
# contract a product and a sum into one FMA where PyTorch rounds both
TOL = 1e-6


@functools.lru_cache(maxsize=None)
def _jax_probes():
    """scripts/msda_pallas_probe.py and scripts/msda_packed_probe.py as
    modules, leaving sys.path as it was (each script puts the repo in front
    of it, and the second imports the first by name from scripts/)."""
    path = list(sys.path)
    try:
        sys.path.insert(0, str(REPO / "scripts"))
        modules = []
        for name in ("msda_pallas_probe", "msda_packed_probe"):
            spec = importlib.util.spec_from_file_location(
                name, REPO / "scripts" / f"{name}.py")
            module = importlib.util.module_from_spec(spec)
            sys.modules[name] = module
            spec.loader.exec_module(module)
            modules.append(module)
    finally:
        sys.path[:] = path
    return tuple(modules)


def _case(hp, wp, qp, m=M, d=D, seed=0):
    """As the JAX script's make_case draws: numpy arrays."""
    rs = np.random.RandomState(seed)
    return (rs.randn(m, hp, wp, d).astype(np.float32),
            rs.randint(0, hp - 1, (m, qp)).astype(np.int32),
            rs.randint(0, wp - 1, (m, qp)).astype(np.int32),
            *(rs.rand(m, qp).astype(np.float32) for _ in range(3)))


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _packed(arrays, wp, dtype):
    """(pm in dtype, fl) of a case, as torch tensors."""
    vm, iy, ix = _torch(arrays[:3])
    return pack_corners(vm).to(dtype), iy * (wp - 1) + ix


KINDS = ["p3a", "p3b", "p3c", "p4a_f32", "p4a_bf16"]


def _port(kind, arrays, wp):
    t = _torch(arrays)
    if kind == "p3a":
        return gather_reference(*t)
    if kind == "p3b":
        return gather_p4_reference(*t, P)
    if kind == "p3c":
        return fused_gather_per_head(*t)
    dtype = torch.bfloat16 if kind == "p4a_bf16" else torch.float32
    return packed_gather_reference(*_packed(arrays, wp, dtype), *t[3:], P)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_versions_match_the_jax_kernels_in_interpret_mode(kind):
    pallas, packed = _jax_probes()
    hp, wp, qp = 7, 9, 256
    arrays = _case(hp, wp, qp, seed=1)
    j = [jnp.asarray(a) for a in arrays]
    if kind == "p3a":
        want = pallas.fused_gather(*j, chunk=64, interpret=True)
    elif kind == "p3b":
        want = pallas.fused_gather_p4(*j, chunk=64, interpret=True)
    elif kind == "p3c":
        want = pallas.fused_gather_per_head(*j, chunk=64, interpret=True)
    else:
        pm = packed.pack_corners(j[0])
        if kind == "p4a_bf16":
            pm = pm.astype(jnp.bfloat16)
        want = packed.packed_gather(pm, j[1] * (wp - 1) + j[2], *j[3:],
                                    chunk=64, interpret=True)
    got = _port(kind, arrays, wp)
    assert got.dtype == torch.float32
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_versions_match_the_jax_reference(kind):
    """At the JAX script's check map (27x50), QP 4,096: against its
    `_reference`, summed over P for P3b and P4a (for a bf16 packed map, on
    the map rounded to bf16)."""
    pallas, _ = _jax_probes()
    hp, wp, qp = 27, 50, 4096
    arrays = _case(hp, wp, qp, seed=2)
    ref = list(arrays)
    if kind == "p4a_bf16":
        ref[0] = np.asarray(jnp.asarray(ref[0], jnp.bfloat16), np.float32)
    want = np.asarray(pallas._reference(*(jnp.asarray(a) for a in ref)))
    if kind not in ("p3a", "p3c"):
        want = want.reshape(M, qp // P, P, D).sum(2)
    np.testing.assert_allclose(_port(kind, arrays, wp).numpy(), want,
                               atol=TOL, rtol=0)


def test_pack_corners_is_the_jax_layout():
    _, packed = _jax_probes()
    vm = _case(5, 6, 1, seed=3)[0]
    np.testing.assert_array_equal(
        pack_corners(torch.from_numpy(vm)).numpy(),
        np.asarray(packed.pack_corners(jnp.asarray(vm))))


def test_sample_case_draws_as_make_case():
    gen = torch.Generator().manual_seed(0)
    vm, iy, ix, fy, fx, w = msda_probes.sample_case(5, 7, 999, 2, 16, gen,
                                                    torch.device("cpu"))
    assert vm.shape == (2, 5, 7, 16) and vm.dtype == torch.float32
    assert iy.dtype == ix.dtype == torch.int32
    assert int(iy.min()) == 0 and int(iy.max()) == 3
    assert int(ix.min()) == 0 and int(ix.max()) == 5
    for t in (fy, fx, w):
        assert t.shape == (2, 999) and 0 <= t.min() and t.max() < 1


def _out_of_range(arrays, hp, wp):
    """A copy with some samples past each edge, or far outside."""
    vm, iy, ix, fy, fx, w = (a.copy() for a in arrays)
    iy[0, :4] = [-1, hp - 1, -2 ** 31, 2 ** 31 - 1]
    ix[1, 4:8] = [-1, wp - 1, -2 ** 31, 2 ** 31 - 1]
    return vm, iy, ix, fy, fx, w


def test_out_of_range_samples_give_nan():
    """NaN for each out-of-range sample and for its query's P sum, and the
    other samples as in range: P3a, P3c and P3b on (iy, ix), P4a on fl."""
    pallas, _ = _jax_probes()
    hp, wp, qp = 7, 9, 64
    arrays = _case(hp, wp, qp, seed=4)
    broken = _out_of_range(arrays, hp, wp)
    bad = np.zeros((M, qp), bool)
    bad[0, :4] = bad[1, 4:8] = True
    want = np.asarray(pallas._reference(*(jnp.asarray(a) for a in arrays)))
    t = _torch(broken)
    for got in (gather_reference(*t), fused_gather(*t),
                fused_gather_per_head(*t)):
        got = got.numpy()
        assert np.isnan(got[bad]).all() and not np.isnan(got[~bad]).any()
        np.testing.assert_array_equal(got[~bad], want[~bad])
    p4 = gather_p4_reference(*t, P).numpy()
    bad_q = bad.reshape(M, qp // P, P).any(-1)
    assert np.isnan(p4[bad_q]).all() and not np.isnan(p4[~bad_q]).any()
    np.testing.assert_allclose(
        p4[~bad_q], want.reshape(M, qp // P, P, D).sum(2)[~bad_q], atol=TOL,
        rtol=0)
    pm, fl = _packed(arrays, wp, torch.float32)
    fl[2, :3] = torch.tensor([-1, pm.shape[1], 2 ** 31 - 1])
    got = packed_gather(pm, fl, *t[3:], P).numpy()
    assert np.isnan(got[2, 0]).all()
    assert not np.isnan(got[2, 1:]).any() and not np.isnan(got[:2]).any()


@pytest.mark.parametrize("p", [1, 2])
def test_other_point_counts(p):
    """P3b and P4a at P 1 and 2 sum the P samples of each query in
    order: P3a's rows added left to right."""
    hp, wp, qp = 7, 9, 64
    arrays = _case(hp, wp, qp, seed=5)
    t = _torch(arrays)
    flat = gather_reference(*t).view(M, qp // p, p, D)
    want = flat[:, :, 0]
    for i in range(1, p):
        want = want + flat[:, :, i]
    assert torch.equal(fused_gather_p4(*t, p), want)
    pm, fl = _packed(arrays, wp, torch.float32)
    np.testing.assert_allclose(packed_gather(pm, fl, *t[3:], p).numpy(),
                               want.numpy(), atol=TOL, rtol=0)


def test_grid_sample_yardstick_is_the_gather():
    """The grid_sample form the probes and chip_smoke.py time computes
    P3a's function (to 1e-4: grid_sample recomputes the sample's position
    from the normalised grid), and P3b's summed over P."""
    hp, wp, qp = 27, 50, 400
    t = _torch(_case(hp, wp, qp, seed=6))
    vm, iy, ix, fy, fx, w = t
    grid = gather_grid(iy, ix, fy, fx, hp, wp)
    vm_nchw = vm.permute(0, 3, 1, 2).contiguous()
    np.testing.assert_allclose(
        gather_grid_sample(vm_nchw, grid, w, 1).transpose(1, 2).numpy(),
        gather_reference(*t).numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        gather_grid_sample(vm_nchw, grid, w, P).transpose(1, 2).numpy(),
        gather_p4_reference(*t, P).numpy(), atol=1e-4, rtol=0)


GATHERS = [(fused_gather, ()), (fused_gather_p4, (P,)),
           (fused_gather_per_head, ()), (gather_reference, ()),
           (gather_p4_reference, (P,))]


@pytest.mark.parametrize("fn,extra", GATHERS, ids=lambda f: getattr(
    f, "__name__", ""))
def test_bf16_map_is_refused_by_p3(fn, extra):
    """The JAX P3a-c take an f32 map only (a bf16 one fails at their
    store); the port refuses it."""
    vm, *rest = _torch(_case(7, 9, 64))
    with pytest.raises(TypeError, match="float32 map"):
        fn(vm.bfloat16(), *rest, *extra)


def test_refusals():
    hp, wp, qp = 7, 9, 66
    t = _torch(_case(hp, wp, qp))
    pm, fl = _packed(_case(hp, wp, qp), wp, torch.float32)
    for call in (lambda: fused_gather_p4(*t, P),
                 lambda: packed_gather(pm, fl, *t[3:], P)):
        with pytest.raises(ValueError, match="multiple of P"):
            call()
    for call in (lambda: fused_gather(t[0], t[1].long(), *t[2:]),
                 lambda: fused_gather_per_head(*t[:2], t[2].short(), *t[3:]),
                 lambda: packed_gather(pm, fl.long(), *t[3:], 2)):
        with pytest.raises(TypeError, match="int32"):
            call()
    with pytest.raises(TypeError, match="float32"):
        fused_gather(*t[:5], t[5].double())
    for p in (3, 8):
        with pytest.raises(NotImplementedError, match="P in"):
            fused_gather_p4(*t[:1], *(x[:, :48] for x in t[1:]), p)
    with pytest.raises(NotImplementedError, match="channels"):
        fused_gather(torch.zeros(M, hp, wp, 65), *t[1:])
    with pytest.raises(TypeError, match="packed map"):
        packed_gather(pm.half(), fl, *t[3:], 2)
    with pytest.raises(ValueError, match="at least 2x2"):
        fused_gather(torch.zeros(M, 1, wp, D), *t[1:])
    with pytest.raises(ValueError, match="M = 8"):
        fused_gather(t[0], t[1][:4], *t[2:])


@pytest.mark.parametrize("name", ["fused_gather", "fused_gather_p4",
                                  "fused_gather_per_head", "packed_gather"])
def test_inputs_that_need_a_gradient_raise(name):
    hp, wp, qp = 7, 9, 64
    t = _torch(_case(hp, wp, qp))
    pm, fl = _packed(_case(hp, wp, qp), wp, torch.float32)
    w = t[5].requires_grad_()
    with pytest.raises(ValueError, match="no gradient"):
        if name == "packed_gather":
            packed_gather(pm, fl, *t[3:5], w, P)
        else:
            getattr(msda_probes, name)(*t[:5], w)


def test_32_bit_offsets_are_checked():
    """Every tensor of a call, the output too, must hold fewer than 2^31
    elements (meta tensors: nothing is allocated)."""
    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    scalars = [meta(8, 9_000_000, dtype=torch.int32)] * 2 + [
        meta(8, 9_000_000)] * 3
    with pytest.raises(ValueError, match="32-bit"):
        cuda_msda.check_gather(meta(8, 27, 50, 32), *scalars)
    cuda_msda.check_gather(meta(8, 27, 50, 32), *scalars, points=4)
    with pytest.raises(ValueError, match="32-bit"):
        cuda_msda.check_packed(meta(8, 3_000_000, 128), *scalars[1:], 4)


def test_cpu_dispatch_takes_the_plain_versions():
    hp, wp, qp = 7, 9, 64
    arrays = _case(hp, wp, qp, seed=7)
    t = _torch(arrays)
    pm, fl = _packed(arrays, wp, torch.bfloat16)
    counters = (cuda_msda.fused_gather_cuda, cuda_msda.fused_gather_p4_cuda,
                cuda_msda.fused_gather_per_head_cuda,
                cuda_msda.packed_gather_cuda)
    before = [f.launches for f in counters]
    assert torch.equal(fused_gather(*t), gather_reference(*t))
    assert torch.equal(fused_gather_p4(*t, 2), gather_p4_reference(*t, 2))
    assert torch.equal(fused_gather_per_head(*t), gather_reference(*t))
    assert torch.equal(packed_gather(pm, fl, *t[3:], 4),
                       packed_gather_reference(pm, fl, *t[3:], 4))
    assert [f.launches for f in counters] == before


def test_cuda_wrappers_refuse_cpu_tensors():
    hp, wp, qp = 7, 9, 64
    t = _torch(_case(hp, wp, qp))
    pm, fl = _packed(_case(hp, wp, qp), wp, torch.float32)
    counters = (cuda_msda.fused_gather_cuda, cuda_msda.fused_gather_p4_cuda,
                cuda_msda.fused_gather_per_head_cuda,
                cuda_msda.packed_gather_cuda)
    before = [f.launches for f in counters]
    for call in (lambda: cuda_msda.fused_gather_cuda(*t),
                 lambda: cuda_msda.fused_gather_p4_cuda(*t, 4),
                 lambda: cuda_msda.fused_gather_per_head_cuda(*t),
                 lambda: cuda_msda.packed_gather_cuda(pm, fl, *t[3:], 4)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert [f.launches for f in counters] == before


def test_tensors_on_two_devices_raise():
    t = _torch(_case(7, 9, 64))
    with pytest.raises(ValueError, match="one device"):
        fused_gather(*t[:5], t[5].to("meta"))


PROBES = {msda_pallas_probe: {"flat", "p4", "perhead", "grid_sample"},
          msda_packed_probe: {"packed", "packed_bf16"}}


@pytest.mark.parametrize("probe", list(PROBES), ids=lambda m: m.__name__)
def test_probe_main_on_the_cpu(probe, tmp_path, monkeypatch, capsys):
    """--device cpu runs the check case (27x50, QP 400) through the plain
    versions, untimed, prints one JSON line and writes no file: not in the
    working directory and not over the JAX package's TPU records."""
    records = [p.read_bytes() for p in TPU_RECORDS]
    monkeypatch.chdir(tmp_path)
    result = probe.main(["--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == result
    assert result["device"] == {"type": "cpu", "timed": False}
    assert result["geometry"]["QP"] == 408_000
    assert set(result["correctness_max_err"]) == PROBES[probe]
    assert all(0 <= e <= 1e-4 for e in result["correctness_max_err"].values())
    assert "levels" not in result and "encoder_call" not in result
    assert list(tmp_path.iterdir()) == []
    assert [p.read_bytes() for p in TPU_RECORDS] == records


@pytest.mark.parametrize("probe", list(PROBES), ids=lambda m: m.__name__)
def test_probe_writes_only_at_out(probe, tmp_path, capsys):
    out = tmp_path / "probe.json"
    result = probe.main(["--device", "cpu", "--seed", "3", "--out",
                         str(out)])
    assert json.loads(out.read_text()) == result
    assert sorted(tmp_path.iterdir()) == [out]


@pytest.mark.parametrize("probe", list(PROBES), ids=lambda m: m.__name__)
def test_probe_refuses_the_tpu_records_as_out(probe, capsys):
    for path in TPU_RECORDS:
        with pytest.raises(SystemExit) as exc:
            probe.main(["--device", "cpu", "--out", str(path)])
        assert exc.value.code != 0


@pytest.mark.parametrize("probe", list(PROBES), ids=lambda m: m.__name__)
def test_probe_without_a_card_exits_nonzero(probe, monkeypatch, capsys):
    """The default device is the card; without one the probe stops and
    prints no result, and never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        probe.main([])
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_e2e_only_is_a_flag_of_the_pallas_probe_alone(capsys):
    """As in the JAX scripts: msda_pallas_probe takes --e2e-only (on the
    CPU it stops after the check all the same), msda_packed_probe does
    not."""
    assert "levels" not in msda_pallas_probe.main(["--device", "cpu",
                                                   "--e2e-only"])
    with pytest.raises(SystemExit):
        msda_packed_probe.main(["--device", "cpu", "--e2e-only"])
