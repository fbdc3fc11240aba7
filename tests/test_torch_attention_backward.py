"""The port's window-attention backward on the CPU against the JAX package's
gradient of `fused_window_mhsa`, whose custom VJP reaches the packed Pallas
backward kernel `_mhsa_bwd_kernel` (run in interpret mode, packing
included, as tests/test_pallas_attention.py runs it); and the backward
kernel's shape limits, which need no card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastervit_tpu.ops.pallas_attention import fused_window_mhsa
from fastervit_tpu_torch.ops import cuda_attention
from fastervit_tpu_torch.ops.attention import (window_mhsa,
                                               window_mhsa_backward_reference)
from torch_parity import few_torch_threads  # noqa: F401

# (B, S, heads, head_dim): FasterViT-0's level-2 joint (53 = 49 + 4) and
# carrier (16) attention, level 3 (49), and FasterViT-4's head_dim 49
CASES = [(8, 53, 8, 32), (4, 16, 8, 32), (8, 49, 16, 32), (4, 53, 4, 49)]
# f32 on both sides; only the order of the sums differs (dbias sums over the
# windows)
TOL = 1e-4


def _make(b, s, h, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, 3 * h * d).astype(np.float32),
            rng.randn(h, s, s).astype(np.float32),
            rng.randn(b, s, h * d).astype(np.float32))


def _jax_grads(qkv, bias, g, h, scale):
    _, vjp = jax.vjp(lambda q, b: fused_window_mhsa(q, b, h, scale, True),
                     jnp.asarray(qkv), jnp.asarray(bias))
    return [np.asarray(t) for t in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("via", ["backward_reference", "autograd"])
@pytest.mark.parametrize("b,s,h,d", CASES)
def test_backward_matches_jax_pallas_interpret(b, s, h, d, via):
    qkv, bias, g = _make(b, s, h, d)
    scale = d ** -0.5
    want_dqkv, want_dbias = _jax_grads(qkv, bias, g, h, scale)
    tq, tb, tg = map(torch.from_numpy, (qkv, bias, g))
    if via == "backward_reference":
        dqkv, dbias = window_mhsa_backward_reference(tq, tb, tg, h, scale)
    else:
        tq.requires_grad_()
        tb.requires_grad_()
        dqkv, dbias = torch.autograd.grad(window_mhsa(tq, tb, h, scale),
                                          (tq, tb), tg)
    np.testing.assert_allclose(dqkv.numpy(), want_dqkv, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(dbias.numpy(), want_dbias, atol=TOL, rtol=TOL)


def test_backward_keeps_input_dtypes():
    """dqkv in qkv's dtype, dbias in bias's, for K1's dtype pairs."""
    qkv, bias, g = map(torch.from_numpy, _make(2, 16, 2, 8, seed=1))
    for qd in (torch.float32, torch.bfloat16):
        for bd in (torch.float32, torch.bfloat16):
            dqkv, dbias = window_mhsa_backward_reference(
                qkv.to(qd), bias.to(bd), g.to(qd), 2, 8 ** -0.5)
            assert (dqkv.dtype, dbias.dtype) == (qd, bd)
            assert dqkv.shape == qkv.shape and dbias.shape == bias.shape


def test_autocast_keeps_f32_logits_on_cpu():
    """Under torch.autocast(bfloat16) the plain versions still compute the
    logits and the backward in f32: bf16 inputs give the same result with
    autocast on and off."""
    qkv, bias, g = map(torch.from_numpy, _make(2, 53, 2, 16, seed=2))
    qkv, bias = qkv.bfloat16().requires_grad_(), bias.bfloat16()
    bias.requires_grad_()
    grads = []
    for enabled in (False, True):
        with torch.autocast("cpu", dtype=torch.bfloat16, enabled=enabled):
            out = window_mhsa(qkv, bias, 2, 0.25)
        grads.append(torch.autograd.grad(out, (qkv, bias), g.bfloat16())
                     + (out,))
    for a, b in zip(*grads):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


@pytest.mark.parametrize("qkv_shape,bias_shape,heads,exc", [
    ((2, 53, 3 * 256), (8, 53, 53), 8, None),
    ((2, 64, 3 * 128), (2, 64, 64), 2, None),
    ((2, 65, 3 * 64), (2, 65, 65), 2, NotImplementedError),
    ((2, 128, 3 * 128), (2, 128, 128), 2, NotImplementedError),
    ((2, 53, 3 * 160), (2, 53, 53), 2, NotImplementedError),
    ((2, 53, 3 * 256), (8, 49, 49), 8, ValueError),
])
def test_check_supported_backward(qkv_shape, bias_shape, heads, exc):
    """K2 takes S <= 64 and head_dim <= 64, less than K1's S <= 128."""
    if exc is None:
        cuda_attention.check_supported_backward(qkv_shape, bias_shape, heads)
    else:
        with pytest.raises(exc):
            cuda_attention.check_supported_backward(qkv_shape, bias_shape,
                                                    heads)


@pytest.mark.parametrize("b,h", [(512, 8), (128, 8), (128, 16), (3, 4),
                                 (1, 1), (1000, 1)])
def test_backward_grid_covers_every_window_once(b, h):
    per_block, groups = cuda_attention.backward_grid(b, h)
    assert per_block * groups >= b > per_block * (groups - 1)
    assert groups <= 65535
