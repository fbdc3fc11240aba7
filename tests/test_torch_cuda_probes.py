"""The long-window attention probes' kernels against their plain PyTorch
versions on the card: P1 (csrc/attn_online.cu, chunked online softmax) and
P2 (K3's kernel without its bias, csrc/window_mhsa_long.cu), on separate
(B, H, S, hd) q, k, v and on views of K3's packed qkv, their routes (bf16
on the tensor cores, f32 on scalar FMA) at the tile plan's edges, their
launch counters and the probe modules' timed runs. Every test here needs
a CUDA device and skips without one. On a machine with an H100 (which
need not have jax, so tests/conftest.py is not loaded):

    python -m pytest --noconftest -q tests/test_torch_cuda_probes.py
"""
import json

import numpy as np
import pytest
import torch

from fastervit_tpu_torch.ops import cuda_attention
from fastervit_tpu_torch.ops.attention_probes import (
    nobias_attention, nobias_attention_reference, online_attention,
    online_attention_reference, pack_qkv, qkv_views)
from fastervit_tpu_torch.probes import attn_online_probe, attn_vpu_probe

# (B, S, heads, head_dim): the probe's call at two windows and four heads,
# 21k-768 level 3, a ragged S past one tile and past the probe's S, hd 128,
# hd 32 and 80 (the kernels' other accumulator widths), S = 4.
P1_CASES = [(2, 2304, 4, 49), (4, 576, 8, 49), (2, 132, 2, 49),
            (2, 2308, 2, 49), (2, 2304, 2, 128), (3, 196, 2, 32),
            (2, 264, 2, 80), (3, 4, 2, 49)]
P2_CASES = [(2, 2304, 4, 49), (4, 576, 8, 49), (2, 129, 2, 49),
            (2, 2305, 2, 49), (2, 2304, 2, 128), (3, 197, 2, 32),
            (2, 263, 2, 80), (3, 1, 2, 49)]
# The tensor-core route's edges: S about one and two 64-key tiles and one
# 128-row block, S = 1 and past the probe's S; each hd of a path (32, 49,
# 80, 128) and hd 64. P1 runs there at every chunk count that divides S.
EDGE_SEQS = [1, 63, 64, 65, 127, 128, 129, 2305]
EDGE_HEAD_DIMS = [32, 49, 64, 80, 128]
TOL_FP32 = 2e-5   # f32 throughout, TF32 off: only the order of sums differs
# bf16 outputs from the same roundings; the f32 sums' order can move p's or
# the output's rounding by one bf16 step, at most 2^-7 of the output: a call
# is held to TOL_BF16_REL of its largest plain output, never more than
# TOL_BF16 (one step on outputs up to 2)
TOL_BF16 = 1e-2
TOL_BF16_REL = 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _make(b, s, h, d, device, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32))
               .to(device) for _ in range(3))
    bias = torch.from_numpy(rng.randn(h, s, s).astype(np.float32))
    return q, k, v, bias.to(device)


def _err(got, want):
    return (got.float() - want.float()).abs().max().item() if want.numel() \
        else 0.0


def _bf16_limit(want):
    return min(TOL_BF16, TOL_BF16_REL * want.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", [1, 2, 4])
@pytest.mark.parametrize("b,s,h,d", P1_CASES)
def test_online_kernel_matches_plain(cuda, b, s, h, d, chunks):
    q, k, v, bias = _make(b, s, h, d, cuda)
    scale = d ** -0.5
    got = cuda_attention.online_attention_cuda(q, k, v, bias, scale, chunks)
    want = online_attention_reference(q, k, v, bias, scale, chunks)
    assert _err(got, want) <= TOL_FP32
    q16, k16, v16 = q.bfloat16(), k.bfloat16(), v.bfloat16()
    for bias_in in (bias, bias.bfloat16()):
        got = cuda_attention.online_attention_cuda(q16, k16, v16, bias_in,
                                                   scale, chunks)
        want = online_attention_reference(q16, k16, v16, bias_in, scale,
                                          chunks)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and got.shape == q.shape
        assert _err(got, want) <= _bf16_limit(want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d", P2_CASES)
def test_nobias_kernel_matches_plain(cuda, b, s, h, d):
    q, k, v, _ = _make(b, s, h, d, cuda, seed=1)
    scale = d ** -0.5
    got = cuda_attention.nobias_attention_cuda(q, k, v, scale)
    assert _err(got, nobias_attention_reference(q, k, v, scale)) <= TOL_FP32
    q16, k16, v16 = q.bfloat16(), k.bfloat16(), v.bfloat16()
    got = cuda_attention.nobias_attention_cuda(q16, k16, v16, scale)
    want = nobias_attention_reference(q16, k16, v16, scale)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert _err(got, want) <= _bf16_limit(want)


@pytest.mark.cuda
@pytest.mark.parametrize("d", EDGE_HEAD_DIMS)
@pytest.mark.parametrize("s", EDGE_SEQS)
def test_tensor_core_route_at_the_plans_edges(cuda, s, d):
    """bf16 runs on the tensor cores (last_plan names the wgmma route and
    hd's padding): P2, and P1 at every C that divides S with an f32 and a
    bf16 bias, each within its bf16 bound of the plain version and the
    same bits over two launches."""
    q, k, v, bias = _make(1, s, 2, d, cuda, seed=4)
    q16, k16, v16 = q.bfloat16(), k.bfloat16(), v.bfloat16()
    scale = d ** -0.5
    p1, p2 = (cuda_attention.online_attention_cuda,
              cuda_attention.nobias_attention_cuda)
    got = p2(q16, k16, v16, scale)
    assert p2.last_plan == cuda_attention.long_plan(d, torch.bfloat16)
    assert p2.last_plan.route == "wgmma"
    want = nobias_attention_reference(q16, k16, v16, scale)
    assert _err(got, want) <= _bf16_limit(want)
    assert torch.equal(got, p2(q16, k16, v16, scale))
    for chunks in [c for c in range(1, s + 1) if s % c == 0]:
        for bias_in in (bias, bias.bfloat16()):
            got = p1(q16, k16, v16, bias_in, scale, chunks)
            assert p1.last_plan == cuda_attention.long_plan(
                d, torch.bfloat16, bias_in.dtype)
            want = online_attention_reference(q16, k16, v16, bias_in, scale,
                                              chunks)
            assert _err(got, want) <= _bf16_limit(want), (chunks,
                                                          bias_in.dtype)
            assert torch.equal(got, p1(q16, k16, v16, bias_in, scale,
                                       chunks))


@pytest.mark.cuda
def test_f32_stays_on_scalar_fma(cuda):
    q, k, v, bias = _make(2, 132, 2, 49, cuda)
    cuda_attention.online_attention_cuda(q, k, v, bias, 0.1, 2)
    cuda_attention.nobias_attention_cuda(q, k, v, 0.1)
    for kernel in (cuda_attention.online_attention_cuda,
                   cuda_attention.nobias_attention_cuda):
        assert kernel.last_plan.route == "scalar"
        assert kernel.last_plan.rows_per_block == 64


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,d", [P2_CASES[0], P2_CASES[2],
                                     P2_CASES[4]])
def test_kernels_on_views_of_a_packed_qkv(cuda, b, s, h, d, dtype):
    """Given views of K3's packed qkv, P2 and P1 read them in place, give
    what they give on separate tensors to the bit, and write their output
    in K3's (B, S, H·hd) layout; P2 there is K3 with no bias, and matches
    K3 with a zero bias to the bit (fmaf(x, scale, 0) rounds as x·scale)."""
    q, k, v, bias = (t.to(dtype) for t in _make(b, s, h, d, cuda, seed=2))
    scale = d ** -0.5
    qkv = pack_qkv(q, k, v)
    views = qkv_views(qkv, h)
    for kernel, rest in ((cuda_attention.nobias_attention_cuda, (scale,)),
                         (cuda_attention.online_attention_cuda,
                          (bias, scale, 2 if s % 2 == 0 else 1))):
        got = kernel(*views, *rest)
        assert got.transpose(1, 2).is_contiguous()
        assert torch.equal(got, kernel(q, k, v, *rest))
    k3 = cuda_attention.window_mhsa_long_cuda(
        qkv, torch.zeros(h, s, s, device=cuda, dtype=dtype), h, scale)
    got = cuda_attention.nobias_attention_cuda(*views, scale)
    assert torch.equal(got.transpose(1, 2).reshape(b, s, h * d), k3)


@pytest.mark.cuda
def test_unlike_layouts_raise(cuda):
    q, k, v, _ = _make(2, 64, 2, 49, cuda)
    with pytest.raises(ValueError, match="one layout"):
        nobias_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                         v, 0.1)


@pytest.mark.cuda
def test_empty_batch_launches_nothing(cuda):
    q, k, v, bias = _make(0, 132, 2, 49, cuda)
    before = (cuda_attention.online_attention_cuda.launches,
              cuda_attention.nobias_attention_cuda.launches)
    assert online_attention(q, k, v, bias, 0.1, 4).shape == (0, 2, 132, 49)
    assert nobias_attention(q, k, v, 0.1).shape == (0, 2, 132, 49)
    assert (cuda_attention.online_attention_cuda.launches,
            cuda_attention.nobias_attention_cuda.launches) == before


@pytest.mark.cuda
def test_launches_are_counted_and_bit_identical(cuda):
    """The dispatch sends a CUDA tensor to the kernel, each launch counts
    once, and two launches give the same bits (one owner per output, no
    atomics)."""
    q, k, v, bias = (t.bfloat16() for t in _make(2, 2304, 2, 49, cuda))
    before = (cuda_attention.online_attention_cuda.launches,
              cuda_attention.nobias_attention_cuda.launches)
    first = (online_attention(q, k, v, bias, 0.1, 2),
             nobias_attention(q, k, v, 0.1))
    second = (online_attention(q, k, v, bias, 0.1, 2),
              nobias_attention(q, k, v, 0.1))
    assert (cuda_attention.online_attention_cuda.launches,
            cuda_attention.nobias_attention_cuda.launches) == (
                before[0] + 2, before[1] + 2)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_refused_shapes_raise_and_name_the_limit(cuda):
    q = torch.zeros(1, 1, 8, 129, device=cuda)
    with pytest.raises(NotImplementedError, match="head_dim <= 128"):
        nobias_attention(q, q, q, 0.1)
    q = torch.zeros(1, 1, 9, 8, device=cuda)
    with pytest.raises(ValueError, match="divisor"):
        online_attention(q, q, q, torch.zeros(1, 9, 9, device=cuda), 0.1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("probe", [attn_online_probe, attn_vpu_probe],
                         ids=lambda m: m.__name__)
def test_probe_times_every_row_on_the_card(cuda, probe, tmp_path, capsys):
    out = tmp_path / "probe.json"
    result = probe.main(["--batch", "2", "--seq", "576", "--heads", "4",
                         "--out", str(out)])
    assert json.loads(out.read_text()) == result
    assert result["device"]["type"] == "cuda"
    rows = [r for r in result.values() if isinstance(r, dict) and "ms" in r]
    assert rows and all(r["ms"] > 0 for r in rows)
    for name in ("online_c2", "online_c4"):
        if name in result:
            assert result[name]["maxdiff_vs_shipped"] <= TOL_BF16
