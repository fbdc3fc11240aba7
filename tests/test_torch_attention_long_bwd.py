"""The port's long-window attention backward (K4's plain version, which is
K2's too) on the CPU against the JAX package's gradient of
`flash_window_mhsa`, whose custom VJP reaches the two Pallas backward
kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel` (run in interpret mode, as
tests/test_flash_attention.py runs them); the K2/K4 backward route; and
K4's shape limits and launch grid, which need no card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastervit_tpu.ops.pallas_flash_attention import flash_window_mhsa
from fastervit_tpu_torch.ops import cuda_attention
from fastervit_tpu_torch.ops.attention import (backward_route, window_mhsa,
                                               window_mhsa_backward_reference)
from torch_parity import few_torch_threads  # noqa: F401

# (B, S, heads, head_dim): 21k-384 level 3 (144, hd 49), the any-res
# carrier attention (216), fv5's joint attention (53, hd 80) and a K1-forward
# window that K2 cannot take (64 < S <= 128)
CASES = [(2, 144, 4, 49), (2, 216, 2, 32), (2, 53, 2, 80), (3, 100, 2, 32)]
# f32 on both sides; only the order of the sums differs (dbias sums over the
# windows; the TPU kernel sums dk and dv across its q-tiles)
TOL = 1e-4


def _make(b, s, h, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, 3 * h * d).astype(np.float32),
            rng.randn(h, s, s).astype(np.float32),
            rng.randn(b, s, h * d).astype(np.float32))


@pytest.mark.parametrize("via", ["backward_reference", "autograd"])
@pytest.mark.parametrize("b,s,h,d", CASES)
def test_long_backward_matches_jax_flash_interpret(b, s, h, d, via):
    qkv, bias, g = _make(b, s, h, d)
    scale = d ** -0.5
    _, vjp = jax.vjp(lambda q, y: flash_window_mhsa(q, y, h, scale, True),
                     jnp.asarray(qkv), jnp.asarray(bias))
    want_dqkv, want_dbias = (np.asarray(t) for t in vjp(jnp.asarray(g)))
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


@pytest.mark.parametrize("s,hd,route", [
    (53, 32, "K2"), (16, 32, "K2"), (49, 32, "K2"),    # fv0
    (53, 49, "K2"), (49, 49, "K2"),                    # fv4 at 224
    (64, 64, "K2"),                                    # K2's limits
    (65, 32, "K4"), (100, 32, "K4"), (128, 64, "K4"),  # K1 forward, K4 back
    (196, 49, "K4"),                                   # 21k-224 level 2
    (216, 32, "K4"),                                   # any-res carriers
    (576, 49, "K4"), (1024, 49, "K4"), (2304, 49, "K4"),  # 21k-384..768
    (144, 49, "K4"), (256, 49, "K4"),                  # their level 3
    (53, 80, "K4"), (16, 80, "K4"),                    # fv5/fv6, hd 80
    (53, 65, "K4"), (53, 128, "K4"),
])
def test_backward_route(s, hd, route):
    assert backward_route(s, hd) == route


@pytest.mark.parametrize("s,d", [(144, 49), (53, 80), (100, 32)])
def test_cpu_backward_of_a_k4_window_takes_the_plain_version(s, d):
    qkv, bias, g = map(torch.from_numpy, _make(2, s, 2, d, seed=1))
    counters = (cuda_attention.window_mhsa_backward_cuda,
                cuda_attention.window_mhsa_long_backward_cuda)
    before = [f.launches for f in counters]
    q = qkv.clone().requires_grad_()
    bb = bias.clone().requires_grad_()
    got = torch.autograd.grad(window_mhsa(q, bb, 2, d ** -0.5), (q, bb), g)
    assert [f.launches for f in counters] == before
    want = window_mhsa_backward_reference(qkv, bias, g, 2, d ** -0.5)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("qkv_shape,bias_shape,heads,exc", [
    ((32, 576, 3 * 784), (16, 576, 576), 16, None),      # 21k-384 level 2
    ((16, 2304, 3 * 784), (16, 2304, 2304), 16, None),   # 21k-768 level 2
    ((2, 1, 3 * 256), (2, 1, 1), 2, None),
    ((2, 53, 3 * 256), (2, 53, 53), 2, None),            # hd 128
    ((2, 53, 3 * 258), (2, 53, 53), 2, NotImplementedError),  # hd 129
    ((2, 576, 3 * 196), (4, 576, 575), 4, ValueError),
    ((2, 576, 3 * 196), (2, 576, 576), 4, ValueError),
    ((2, 576, 3 * 196 + 1), (4, 576, 576), 4, ValueError),
    ((2, 576, 3 * 65536), (65536, 576, 576), 65536, ValueError),
])
def test_check_supported_long_backward(qkv_shape, bias_shape, heads, exc):
    if exc is None:
        cuda_attention.check_supported_long_backward(qkv_shape, bias_shape,
                                                     heads)
    else:
        with pytest.raises(exc):
            cuda_attention.check_supported_long_backward(qkv_shape,
                                                         bias_shape, heads)


@pytest.mark.parametrize("rows", [64, 128])  # the scalar and wgmma plans
@pytest.mark.parametrize("b,s,h", [(32, 576, 16), (32, 144, 32),
                                   (16, 2304, 16), (64, 216, 8), (3, 100, 2),
                                   (1, 1, 1), (1000, 53, 16), (64, 4096, 32)])
def test_long_backward_grid_covers_every_window_once(b, s, h, rows):
    per_block, groups = cuda_attention.long_backward_grid(b, s, h, rows)
    assert per_block * groups >= b > per_block * (groups - 1)
    # the f32 (groups, H, S, S) partial sums stay within their budget
    # unless one slab alone exceeds it
    assert (groups == 1
            or 4 * groups * h * s * s
            <= cuda_attention._LONG_BWD_PARTIAL_BYTES)


def test_long_backward_wrapper_refuses_cpu_tensors():
    qkv, bias, g = map(torch.from_numpy, _make(2, 144, 2, 8))
    before = cuda_attention.window_mhsa_long_backward_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        cuda_attention.window_mhsa_long_backward_cuda(qkv, bias, g, 2, 0.1)
    assert cuda_attention.window_mhsa_long_backward_cuda.launches == before
