"""The port's long-window attention (K3's plain version) against the JAX
function that reaches the Q-tiled Pallas kernel (run in interpret mode on the
CPU, as tests/test_flash_attention.py runs it) and against its jnp
reference; the K1/K3 route; the CPU dispatch; `bias_attention`; and the
CUDA wrappers' refusals, which need no card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastervit_tpu.ops.attention import \
    bias_attention_reference as jax_bias_attention_reference
from fastervit_tpu.ops.pallas_attention import _mhsa_reference
from fastervit_tpu.ops.pallas_flash_attention import flash_window_mhsa
from fastervit_tpu_torch.ops import cuda_attention
from fastervit_tpu_torch.ops.attention import (attention_route,
                                               bias_attention,
                                               bias_attention_reference,
                                               window_mhsa,
                                               window_mhsa_long_reference,
                                               window_mhsa_reference)
from torch_parity import few_torch_threads  # noqa: F401

# The CASES of tests/test_flash_attention.py: 21k-384 level 2 (576, hd 49),
# 21k-512 level 3 (256), a ragged q-tile split (144) and a small case.
CASES = [(2, 576, 4, 49), (2, 256, 8, 49), (2, 144, 4, 49), (3, 48, 2, 32)]


def _make(b, s, h, d, seed=0):
    rng = np.random.RandomState(seed)
    qkv = rng.randn(b, s, 3 * h * d).astype(np.float32)
    bias = rng.randn(h, s, s).astype(np.float32)
    return qkv, bias


@pytest.mark.parametrize("oracle", ["flash_interpret", "mhsa_reference"])
@pytest.mark.parametrize("b,s,h,d", CASES)
def test_long_plain_version_matches_jax(b, s, h, d, oracle):
    qkv, bias = _make(b, s, h, d)
    scale = d ** -0.5
    if oracle == "flash_interpret":
        want = flash_window_mhsa(jnp.asarray(qkv), jnp.asarray(bias), h,
                                 scale, True)
    else:
        want = _mhsa_reference(jnp.asarray(qkv), jnp.asarray(bias), h, scale)
    got = window_mhsa_long_reference(torch.from_numpy(qkv),
                                     torch.from_numpy(bias), h, scale)
    # f32 both sides; only the order of the sums differs
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_bf16_long_plain_version_matches_jax_flash():
    """bf16 qkv and bias: f32 logits, p cast to bf16 before the f32 PV
    product, the context divided by Σp, on both sides."""
    qkv, bias = _make(2, 144, 4, 49, seed=1)
    want = flash_window_mhsa(jnp.asarray(qkv, jnp.bfloat16),
                             jnp.asarray(bias, jnp.bfloat16), 4, 49 ** -0.5,
                             True)
    got = window_mhsa_long_reference(torch.from_numpy(qkv).bfloat16(),
                                     torch.from_numpy(bias).bfloat16(), 4,
                                     49 ** -0.5)
    assert got.dtype == torch.bfloat16
    # one bf16 ulp on O(1) values where the frameworks round differently
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2)


@pytest.mark.parametrize("s,hd,route", [
    (53, 32, "K1"), (16, 32, "K1"), (49, 32, "K1"),    # fv0
    (53, 49, "K1"), (49, 49, "K1"),                    # fv4 at 224
    (128, 64, "K1"),                                   # K1's limits
    (196, 49, "K3"),                                   # 21k-224 level 2
    (216, 32, "K3"),                                   # any-res carriers
    (576, 49, "K3"), (1024, 49, "K3"), (2304, 49, "K3"),  # 21k-384..768
    (144, 49, "K3"), (256, 49, "K3"),                  # their level 3
    (53, 80, "K3"), (16, 80, "K3"),                    # fv5/fv6, hd 80
    (129, 32, "K3"), (53, 65, "K3"),
])
def test_attention_route(s, hd, route):
    assert attention_route(s, hd) == route


@pytest.mark.parametrize("s,d", [(144, 49), (53, 80)])
def test_cpu_dispatch_takes_the_long_plain_version(s, d):
    qkv, bias = map(torch.from_numpy, _make(2, s, 4, d))
    counters = (cuda_attention.window_mhsa_cuda,
                cuda_attention.window_mhsa_long_cuda,
                cuda_attention.window_mhsa_backward_cuda)
    before = [f.launches for f in counters]
    got = window_mhsa(qkv, bias, 4, d ** -0.5)
    assert [f.launches for f in counters] == before
    assert torch.equal(got, window_mhsa_long_reference(qkv, bias, 4,
                                                       d ** -0.5))


def test_bf16_qkv_streams_the_bias_in_bf16_on_the_k3_route_only():
    """The JAX dispatch's rule (fastervit_tpu/ops/attention.py:83-84)."""
    for s, d, plain, bias_dtype in ((144, 49, window_mhsa_long_reference,
                                     torch.bfloat16),
                                    (53, 32, window_mhsa_reference,
                                     torch.float32)):
        qkv, bias = map(torch.from_numpy, _make(2, s, 4, d, seed=2))
        got = window_mhsa(qkv.bfloat16(), bias, 4, d ** -0.5)
        want = plain(qkv.bfloat16(), bias.to(bias_dtype), 4, d ** -0.5)
        assert torch.equal(got, want)


def test_cpu_backward_of_a_long_window_matches_jax_flash():
    """On the CPU the backward takes any S: the port's gradients against
    jax.grad of flash_window_mhsa (interpret mode)."""
    b, s, h, d = 2, 144, 4, 49
    qkv, bias = _make(b, s, h, d, seed=3)
    cot = np.random.RandomState(4).randn(b, s, h * d).astype(np.float32)
    scale = d ** -0.5
    want = jax.grad(lambda x, y: jnp.sum(
        flash_window_mhsa(x, y, h, scale, True) * cot), argnums=(0, 1))(
            jnp.asarray(qkv), jnp.asarray(bias))
    q = torch.from_numpy(qkv).requires_grad_()
    bb = torch.from_numpy(bias).requires_grad_()
    window_mhsa(q, bb, h, scale).backward(torch.from_numpy(cot))
    np.testing.assert_allclose(q.grad.numpy(), np.asarray(want[0]),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(bb.grad.numpy(), np.asarray(want[1]),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("b,s,h,d", [(2, 53, 4, 32), (2, 144, 4, 49),
                                     (1, 576, 2, 49)])
def test_bias_attention_matches_jax_reference(b, s, h, d):
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(b, h, s, d).astype(np.float32) for _ in range(3))
    bias = rng.randn(h, s, s).astype(np.float32)
    want = np.asarray(jax_bias_attention_reference(
        *(jnp.asarray(t) for t in (q, k, v, bias)), d ** -0.5))
    args = [torch.from_numpy(t) for t in (q, k, v, bias)]
    for fn in (bias_attention, bias_attention_reference):
        got = fn(*args, d ** -0.5)
        assert got.shape == (b, h, s, d)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("qkv_shape,bias_shape,heads,exc", [
    ((16, 2304, 3 * 784), (16, 2304, 2304), 16, None),   # 21k-768 level 2
    ((2, 1, 3 * 256), (2, 1, 1), 2, None),
    ((2, 53, 3 * 256), (2, 53, 53), 2, None),            # hd 128
    ((2, 53, 3 * 258), (2, 53, 53), 2, NotImplementedError),  # hd 129
    ((2, 576, 3 * 196), (4, 576, 575), 4, ValueError),
    ((2, 576, 3 * 196), (2, 576, 576), 4, ValueError),
    ((2, 576, 3 * 196 + 1), (4, 576, 576), 4, ValueError),
])
def test_check_supported_long(qkv_shape, bias_shape, heads, exc):
    if exc is None:
        cuda_attention.check_supported_long(qkv_shape, bias_shape, heads)
    else:
        with pytest.raises(exc):
            cuda_attention.check_supported_long(qkv_shape, bias_shape, heads)


def test_long_cuda_wrapper_refuses_cpu_tensors():
    qkv, bias = map(torch.from_numpy, _make(2, 144, 2, 8))
    before = cuda_attention.window_mhsa_long_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        cuda_attention.window_mhsa_long_cuda(qkv, bias, 2, 0.1)
    assert cuda_attention.window_mhsa_long_cuda.launches == before


@pytest.mark.parametrize("s,hd", [(65, 32), (576, 49), (53, 80)])
def test_backward_refusal_names_k4(s, hd):
    """K2 takes S <= 64 and hd <= 64; beyond that the card's backward waits
    for K4, and says which kernel that is."""
    with pytest.raises(NotImplementedError,
                       match="K4.*pallas_flash_attention.py::_flash_backward"):
        cuda_attention.check_supported_backward((2, s, 3 * 2 * hd),
                                                (2, s, s), 2)
