"""The port's plain window attention against the JAX function that reaches
the packed Pallas kernel (run in interpret mode on the CPU, as
tests/test_pallas_attention.py runs it) and against its jnp reference; the
CPU dispatch; and the CUDA wrapper's shape checks, which need no card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastervit_tpu.ops.pallas_attention import (_mhsa_reference,
                                                fused_window_mhsa)
from fastervit_tpu_torch.ops import cuda_attention
from fastervit_tpu_torch.ops.attention import (window_mhsa,
                                               window_mhsa_reference)
from torch_parity import few_torch_threads  # noqa: F401

# (B, S, heads, head_dim): FasterViT-0's level-2 joint (53 = 49 + 4) and
# carrier (16) attention, level 3 (49), and FasterViT-4's head_dim 49.
CASES = [(8, 53, 8, 32), (16, 16, 8, 32), (4, 49, 16, 32), (3, 53, 4, 49)]


def _make(b, s, h, d, seed=0):
    rng = np.random.RandomState(seed)
    qkv = rng.randn(b, s, 3 * h * d).astype(np.float32)
    bias = rng.randn(h, s, s).astype(np.float32)
    return qkv, bias


@pytest.mark.parametrize("oracle", ["pallas_interpret", "mhsa_reference"])
@pytest.mark.parametrize("b,s,h,d", CASES)
def test_plain_version_matches_jax(b, s, h, d, oracle):
    qkv, bias = _make(b, s, h, d)
    scale = d ** -0.5
    if oracle == "pallas_interpret":
        want = fused_window_mhsa(jnp.asarray(qkv), jnp.asarray(bias), h,
                                 scale, True)
    else:
        want = _mhsa_reference(jnp.asarray(qkv), jnp.asarray(bias), h, scale)
    got = window_mhsa_reference(torch.from_numpy(qkv), torch.from_numpy(bias),
                                h, scale)
    # f32 both sides; only the order of the sums differs
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_bf16_plain_version_matches_jax_reference():
    """bf16 inputs: f32 logits and softmax, p cast to bf16 before PV, on
    both sides."""
    qkv, bias = _make(4, 53, 8, 32, seed=1)
    want = _mhsa_reference(jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(bias),
                           8, 32 ** -0.5)
    got = window_mhsa_reference(torch.from_numpy(qkv).bfloat16(),
                                torch.from_numpy(bias), 8, 32 ** -0.5)
    assert got.dtype == torch.bfloat16
    # the two frameworks round the bf16 PV product at other places: one bf16
    # ulp on O(1) values
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2)


def test_cpu_dispatch_takes_the_plain_version():
    qkv, bias = map(torch.from_numpy, _make(8, 53, 8, 32))
    before = cuda_attention.window_mhsa_cuda.launches
    got = window_mhsa(qkv, bias, 8, 32 ** -0.5)
    assert cuda_attention.window_mhsa_cuda.launches == before
    assert torch.equal(got, window_mhsa_reference(qkv, bias, 8, 32 ** -0.5))


@pytest.mark.parametrize("backward", [False, True])
def test_cuda_wrapper_refuses_cpu_tensors(backward):
    qkv, bias = map(torch.from_numpy, _make(2, 16, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        if backward:
            cuda_attention.window_mhsa_backward_cuda(
                qkv, bias, torch.zeros(2, 16, 16), 2, 0.1)
        else:
            cuda_attention.window_mhsa_cuda(qkv, bias, 2, 0.1)


@pytest.mark.parametrize("s", [576, 1024, 2304])
def test_long_windows_name_the_unported_kernel(s):
    """The 21k-384/512/768 level-2 windows exceed the kernel's S."""
    with pytest.raises(NotImplementedError, match="K3"):
        cuda_attention.check_supported((2, s, 3 * 196), (4, s, s), 4)


@pytest.mark.parametrize("qkv_shape,bias_shape,heads,exc", [
    ((2, 53, 3 * 256), (8, 53, 53), 8, None),
    ((2, 128, 3 * 128), (2, 128, 128), 2, None),
    ((2, 53, 3 * 256 + 1), (8, 53, 53), 8, ValueError),
    ((2, 53, 3 * 256), (8, 49, 49), 8, ValueError),
    ((2, 53, 3 * 250), (8, 53, 53), 8, ValueError),
    ((2, 53, 3 * 520), (8, 53, 53), 8, NotImplementedError),
])
def test_check_supported(qkv_shape, bias_shape, heads, exc):
    if exc is None:
        cuda_attention.check_supported(qkv_shape, bias_shape, heads)
    else:
        with pytest.raises(exc):
            cuda_attention.check_supported(qkv_shape, bias_shape, heads)
