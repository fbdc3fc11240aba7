"""The long-window attention probes' functions (fastervit_tpu_torch/ops/
attention_probes.py) against the JAX probes, on the CPU: P1's plain version
against scripts/attn_online_probe.py::online_forward, the Pallas kernel run
in TPU interpret mode; P2's plain version against the JAX package's plain
references at zero bias (`_nobias_kernel` is nested in the JAX probe's
`main` and cannot be imported): `_flash_forward` in interpret mode and
`_mhsa_reference`. Then the dispatch, the refusals, and both probe
modules' `main` with --device cpu."""
import functools
import importlib.util
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fastervit_tpu.ops import pallas_flash_attention as F
from fastervit_tpu.ops.pallas_attention import _mhsa_reference
from fastervit_tpu_torch.ops import cuda_attention
from fastervit_tpu_torch.ops.attention import window_mhsa_long_reference
from fastervit_tpu_torch.ops.attention_probes import (
    nobias_attention, nobias_attention_reference, online_attention,
    online_attention_reference, pack_qkv, qkv_views)
from fastervit_tpu_torch.probes import (attn_online_probe, attn_vpu_probe,
                                        sdpa_for)
from torch_parity import few_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TPU_RECORDS = [REPO / "ATTN_ONLINE_PROBE.json", REPO / "ATTN_VPU_PROBE.json"]
B, H, S, HD = 2, 2, 128, 49


@functools.lru_cache(maxsize=None)
def _jax_online_probe():
    """scripts/attn_online_probe.py as a module, leaving sys.path as it was
    (the script puts the repo and scripts/ in front of it)."""
    path = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            "_jax_attn_online_probe",
            REPO / "scripts" / "attn_online_probe.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = path
    return module


def _make(b=B, h=H, s=S, d=HD, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, s, d).astype(np.float32) for _ in range(3))
    return q, k, v, rng.randn(h, s, s).astype(np.float32)


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


# bf16 outputs on both sides from the same roundings (q, k, v, bias and p
# in bf16, logits and sums in f32); the f32 sums run in another order, which
# can move p's or the output's rounding by one bf16 ulp: 2^-8 relative,
# 7.8e-3 on the O(1) outputs here
TOL_BF16 = 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunks", [1, 2, 4])
def test_online_plain_version_matches_jax_online_forward(chunks, dtype):
    probe = _jax_online_probe()
    q, k, v, bias = _make()
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (F._pad_hd(jnp.asarray(t, jdt)) for t in (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        want = probe.online_forward(jq, jk, jv, jnp.asarray(bias, jdt),
                                    HD ** -0.5, chunks)
    want = np.asarray(want, np.float32)[..., :HD]
    got = online_attention_reference(*_torch((q, k, v, bias),
                                             getattr(torch, dtype)),
                                     HD ** -0.5, chunks)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, H, S, HD)
    # f32: both sides f32 throughout; only the order of the sums differs
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=1e-5 if dtype == "float32" else TOL_BF16,
                               rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("oracle", ["flash_interpret", "mhsa_reference"])
def test_nobias_plain_version_matches_jax_at_zero_bias(oracle, dtype):
    q, k, v, _ = _make(seed=1)
    jdt = getattr(jnp, dtype)
    zeros = jnp.zeros((H, S, S), jnp.float32)
    if oracle == "flash_interpret":
        want = F._flash_forward(*(jnp.asarray(t, jdt) for t in (q, k, v)),
                                zeros, HD ** -0.5, True)
    else:
        qkv = np.stack([q, k, v], 2).transpose(0, 3, 2, 1, 4).reshape(
            B, S, 3 * H * HD)
        want = _mhsa_reference(jnp.asarray(qkv, jdt), zeros, H, HD ** -0.5)
        want = np.asarray(want, np.float32).reshape(B, S, H, HD).transpose(
            0, 2, 1, 3)
    got = nobias_attention_reference(*_torch((q, k, v), getattr(torch, dtype)),
                                     HD ** -0.5)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=1e-5 if dtype == "float32" else TOL_BF16,
                               rtol=0)


def test_one_chunk_is_the_long_window_plain_version():
    """At C = 1, P1 is one softmax over the whole row: K3's plain version on
    the same inputs packed as qkv, up to the order of f32 sums."""
    q, k, v, bias = _torch(_make(seed=2), torch.float32)
    got = online_attention_reference(q, k, v, bias, HD ** -0.5, 1)
    want = window_mhsa_long_reference(pack_qkv(q, k, v), bias, H, HD ** -0.5)
    np.testing.assert_allclose(
        got.numpy(), want.reshape(B, S, H, HD).transpose(1, 2).numpy(),
        atol=1e-6, rtol=0)


@pytest.mark.parametrize("s,chunks", [(130, 4), (129, 2), (128, 0),
                                      (128, 3)])
def test_chunks_that_do_not_divide_s_raise(s, chunks):
    """The JAX probe's `cs = s // chunks` drops the last s % chunks keys
    without a word; the port refuses."""
    q, k, v, bias = _torch(_make(1, 1, s, 8), torch.float32)
    for fn in (online_attention, online_attention_reference):
        with pytest.raises(ValueError, match="divisor"):
            fn(q, k, v, bias, 0.1, chunks)
    with pytest.raises(ValueError, match="divisor"):
        cuda_attention.check_supported_probe(q.shape, k.shape, v.shape,
                                             bias.shape, chunks)


@pytest.mark.parametrize("which", ["online", "nobias"])
def test_inputs_that_need_a_gradient_raise(which):
    q, k, v, bias = _torch(_make(1, 1, 16, 8), torch.float32)
    q.requires_grad_()
    with pytest.raises(ValueError, match="no gradient"):
        if which == "online":
            online_attention(q, k, v, bias, 0.1, 2)
        else:
            nobias_attention(q, k, v, 0.1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_dispatch_takes_the_plain_versions(dtype):
    q, k, v, bias = _torch(_make(seed=3), dtype)
    counters = (cuda_attention.online_attention_cuda,
                cuda_attention.nobias_attention_cuda)
    before = [f.launches for f in counters]
    assert torch.equal(online_attention(q, k, v, bias, 0.1, 2),
                       online_attention_reference(q, k, v, bias, 0.1, 2))
    assert torch.equal(nobias_attention(q, k, v, 0.1),
                       nobias_attention_reference(q, k, v, 0.1))
    assert [f.launches for f in counters] == before


def test_qkv_views_read_the_packed_qkv_in_place():
    """qkv_views gives q, k and v back from pack_qkv without a copy, in
    K3's layout, and the plain versions take them as they take separate
    tensors."""
    q, k, v, bias = _torch(_make(seed=4), torch.float32)
    qkv = pack_qkv(q, k, v)
    views = qkv_views(qkv, H)
    assert all(torch.equal(a, b) for a, b in zip(views, (q, k, v)))
    assert [t.data_ptr() for t in views] == [
        qkv.data_ptr() + i * H * HD * qkv.element_size() for i in range(3)]
    assert views[0].stride() == (S * 3 * H * HD, HD, 3 * H * HD, 1)
    assert torch.equal(nobias_attention(*views, 0.1),
                       nobias_attention_reference(q, k, v, 0.1))
    assert torch.equal(online_attention(*views, bias, 0.1, 2),
                       online_attention_reference(q, k, v, bias, 0.1, 2))


@pytest.mark.parametrize("masked", [False, True])
def test_sdpa_for_is_the_attention(masked):
    """The SDPA yardstick of the probes and chip_smoke.py computes the same
    attention as the plain versions (f32, to 1e-5); on the CPU it keeps
    hd, as only the card's fused backends want hd padded."""
    q, k, v, bias = _torch(_make(seed=5), torch.float32)
    run, head_dim = sdpa_for(q, k, v, bias[None] if masked else None, 0.2)
    want = (online_attention_reference(q, k, v, bias, 0.2, 1) if masked
            else nobias_attention_reference(q, k, v, 0.2))
    assert head_dim == HD
    np.testing.assert_allclose(run().numpy(), want.numpy(), atol=1e-5,
                               rtol=0)


def test_tensors_on_two_devices_raise():
    q, k, v, bias = _torch(_make(1, 1, 16, 8), torch.float32)
    with pytest.raises(ValueError, match="one device"):
        nobias_attention(q, k, v.to("meta"), 0.1)


@pytest.mark.parametrize("shape,bias_shape,chunks,exc", [
    ((16, 16, 2304, 49), (16, 2304, 2304), 2, None),   # the probe's call
    ((2, 2, 2305, 128), None, 1, None),                # P2, hd 128
    ((0, 2, 132, 49), (2, 132, 132), 4, None),         # an empty batch
    ((2, 2, 64, 129), None, 1, NotImplementedError),   # hd 129
    ((2, 2, 64, 49), (2, 64, 63), 1, ValueError),
    ((2, 2, 64), None, 1, ValueError),
])
def test_check_supported_probe(shape, bias_shape, chunks, exc):
    args = (shape, shape, shape, bias_shape, chunks)
    if exc is None:
        cuda_attention.check_supported_probe(*args)
    else:
        with pytest.raises(exc):
            cuda_attention.check_supported_probe(*args)


def test_check_supported_probe_wants_q_k_v_alike():
    with pytest.raises(ValueError, match="alike"):
        cuda_attention.check_supported_probe((2, 2, 64, 49), (2, 2, 64, 49),
                                             (2, 2, 63, 49))


def test_probe_cuda_wrappers_refuse_cpu_tensors():
    q, k, v, bias = _torch(_make(1, 2, 64, 8), torch.float32)
    before = (cuda_attention.online_attention_cuda.launches,
              cuda_attention.nobias_attention_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_attention.online_attention_cuda(q, k, v, bias, 0.1, 2)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_attention.nobias_attention_cuda(q, k, v, 0.1)
    assert (cuda_attention.online_attention_cuda.launches,
            cuda_attention.nobias_attention_cuda.launches) == before


TINY = ["--device", "cpu", "--batch", "3", "--seq", "32", "--heads", "2"]
ROWS = {
    attn_online_probe: {"shipped", "online_c2", "online_c4"},
    attn_vpu_probe: {"qk_hd49", "qk_hd128", "av_hd49", "bias_softmax_f32",
                     "exp_only_f32", "flash_bias_f32", "flash_bias_bf16",
                     "flash_nobias", "flash_nobias_bhsd", "composed",
                     "sdpa_bias", "sdpa_nobias"},
}


@pytest.mark.parametrize("probe", list(ROWS), ids=lambda m: m.__name__)
def test_probe_main_on_the_cpu(probe, tmp_path, monkeypatch, capsys):
    """--device cpu runs the plain versions untimed, prints one JSON line
    and writes no file: not in the working directory and not over the JAX
    package's TPU records."""
    records = [p.read_bytes() for p in TPU_RECORDS]
    monkeypatch.chdir(tmp_path)
    result = probe.main(TINY)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == result
    assert ROWS[probe] <= set(result)
    geometry = result["geometry"]
    assert (geometry["b"], geometry["s"], geometry["heads"],
            geometry["head_dim"]) == (3, 32, 2, 49)
    assert result["device"] == {"type": "cpu", "timed": False}
    assert all(result[row]["ms"] is None for row in ROWS[probe])
    if probe is attn_online_probe:
        for row in ("online_c2", "online_c4"):
            # P1 and K3's plain versions on bf16 inputs: one bf16 ulp
            assert 0 <= result[row]["maxdiff_vs_shipped"] <= TOL_BF16
    assert list(tmp_path.iterdir()) == []
    assert [p.read_bytes() for p in TPU_RECORDS] == records


@pytest.mark.parametrize("probe", list(ROWS), ids=lambda m: m.__name__)
def test_probe_writes_only_at_out(probe, tmp_path, capsys):
    out = tmp_path / "probe.json"
    result = probe.main(TINY + ["--out", str(out)])
    assert json.loads(out.read_text()) == result
    assert sorted(tmp_path.iterdir()) == [out]


@pytest.mark.parametrize("probe", list(ROWS), ids=lambda m: m.__name__)
def test_probe_refuses_the_tpu_records_as_out(probe, capsys):
    for path in TPU_RECORDS:
        with pytest.raises(SystemExit) as exc:
            probe.main(TINY + ["--out", str(path)])
        assert exc.value.code != 0


@pytest.mark.parametrize("probe", list(ROWS), ids=lambda m: m.__name__)
def test_probe_without_a_card_exits_nonzero(probe, monkeypatch, capsys):
    """The default device is the card; without one the probe stops and
    prints no result, and never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        probe.main(["--batch", "1", "--seq", "8", "--heads", "1"])
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_online_probe_refuses_chunks_that_do_not_divide_s(capsys):
    with pytest.raises(ValueError, match="divisor"):
        attn_online_probe.main(TINY + ["--seq", "30"])
