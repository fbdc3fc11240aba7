"""The window-attention CUDA kernel K1 against its plain PyTorch version, on
the card: bf16 on the tensor cores (wgmma), f32 on scalar FMA, each call's
plan (`cuda_attention.short_plan`) and its shared memory against the
library's. Every test here needs a CUDA device and skips without one. On a
machine with an H100 (which need not have jax, so tests/conftest.py is not
loaded):

    python -m pytest --noconftest -q tests/test_torch_cuda_kernel.py
"""
import numpy as np
import pytest
import torch

from fastervit_tpu_torch.ops import cuda_attention
from fastervit_tpu_torch.ops.attention import (window_mhsa,
                                               window_mhsa_reference)

# (B, S, heads, head_dim): FasterViT-0 at batch 256 (level-2 joint window +
# carrier attention, level-2 carrier attention, level 3), an odd shape with
# FasterViT-4's head_dim, and the kernel's largest S and head_dim.
CASES = [
    (1024, 53, 8, 32),
    (256, 16, 8, 32),
    (256, 49, 16, 32),
    (3, 53, 4, 49),
    (5, 128, 2, 64),
]
# The tensor-core route at every window length that changes its tiles (one
# key, the carrier call's 16, fv0's 49 and 53, a tile less one, one, one
# more, two less one, two) and every head dim of the family (fv0 32, fv1
# 40, fv2 48, the fv4 family 49, fv3 64), with 1,100 windows of 2 heads:
# three windows a block, so each warpgroup's two stages both serve.
TC_SEQS = [1, 16, 49, 53, 63, 64, 65, 127, 128]
TC_HEAD_DIMS = [32, 40, 48, 49, 64]
TC_BATCH, TC_HEADS = 1100, 2
# bf16 on both sides of the comparison; the kernel rounds the output to
# bf16 and p to bf16 before p·v (unnormalised, the plain version the
# normalised p): ~3 significant digits on O(1) values
TOL_BF16 = 2e-2


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
    qkv = torch.from_numpy(rng.randn(b, s, 3 * h * d).astype(np.float32))
    bias = torch.from_numpy(rng.randn(h, s, s).astype(np.float32))
    return qkv.to(device), bias.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d", CASES)
def test_kernel_fp32_matches_plain(cuda, b, s, h, d):
    qkv, bias = _make(b, s, h, d, cuda)
    got = cuda_attention.window_mhsa_cuda(qkv, bias, h, d ** -0.5)
    want = window_mhsa_reference(qkv, bias, h, d ** -0.5)
    torch.cuda.synchronize()
    # f32 throughout, TF32 off: only the order of the sums differs
    assert (got - want).abs().max().item() <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d", CASES)
@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
def test_kernel_bf16_matches_plain_f32(cuda, b, s, h, d, bias_dtype):
    qkv, bias = _make(b, s, h, d, cuda, seed=1)
    qkv, bias = qkv.bfloat16(), bias.to(bias_dtype)
    got = cuda_attention.window_mhsa_cuda(qkv, bias, h, d ** -0.5)
    assert got.dtype == torch.bfloat16
    want = window_mhsa_reference(qkv.float(), bias.float(), h, d ** -0.5)
    # bf16 output and bf16 probabilities: ~3 significant digits on O(1) values
    assert (got.float() - want).abs().max().item() <= TOL_BF16
    assert cuda_attention.window_mhsa_cuda.last_plan.route == "wgmma"


@pytest.mark.cuda
@pytest.mark.parametrize("s", TC_SEQS)
@pytest.mark.parametrize("d", TC_HEAD_DIMS)
@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16],
                         ids=str)
def test_tensor_core_route_matches_plain(cuda, s, d, bias_dtype):
    """bf16 takes wgmma by short_plan, with the library's shared memory;
    two launches give the same bits; the output matches the plain version
    in f32 on the same bf16 inputs, relative to max(1, max |plain|)."""
    h = TC_HEADS
    qkv, bias = _make(TC_BATCH, s, h, d, cuda, seed=s * 100 + d)
    qkv, bias = qkv.bfloat16(), bias.to(bias_dtype)
    kernel = cuda_attention.window_mhsa_cuda
    got = kernel(qkv, bias, h, d ** -0.5)
    plan = kernel.last_plan
    assert plan == cuda_attention.short_plan(s, d, torch.bfloat16,
                                             bias_dtype)
    assert plan.route == "wgmma" and plan.depth == (32 if d <= 32 else 64)
    assert plan.key_tiles == (1 if s <= 64 else 2)
    assert plan.smem_bytes == \
        cuda_attention._library().short_attention_smem_bytes(s, d, 1)
    again = kernel(qkv, bias, h, d ** -0.5)
    want = window_mhsa_reference(qkv.float(), bias.float(), h, d ** -0.5)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    err = ((got.float() - want).abs().max()
           / want.abs().max().clamp(min=1.0)).item()
    assert err <= TOL_BF16, err


@pytest.mark.cuda
@pytest.mark.parametrize("s,d", [(53, 32), (128, 64), (16, 49)])
def test_fp32_takes_the_scalar_route(cuda, s, d):
    qkv, bias = _make(4, s, 2, d, cuda)
    cuda_attention.window_mhsa_cuda(qkv, bias.bfloat16(), 2, d ** -0.5)
    plan = cuda_attention.window_mhsa_cuda.last_plan
    assert plan == cuda_attention.short_plan(s, d, torch.float32,
                                             torch.bfloat16)
    assert plan.route == "scalar"
    assert plan.smem_bytes == \
        cuda_attention._library().short_attention_smem_bytes(s, d, 0)


@pytest.mark.cuda
def test_dispatch_launches_kernel(cuda):
    qkv, bias = _make(8, 53, 8, 32, cuda)
    before = cuda_attention.window_mhsa_cuda.launches
    out = window_mhsa(qkv, bias, 8, 32 ** -0.5)
    assert cuda_attention.window_mhsa_cuda.launches == before + 1
    assert out.shape == (8, 53, 256) and out.device.type == "cuda"


@pytest.mark.cuda
def test_long_window_raises_instead_of_falling_back(cuda):
    """K1's wrapper refuses a window beyond its S and names K3, which
    `window_mhsa` routes such windows to (tests/test_torch_cuda_long.py)."""
    qkv, bias = _make(2, 576, 4, 49, cuda)
    with pytest.raises(NotImplementedError, match="K3"):
        cuda_attention.window_mhsa_cuda(qkv, bias, 4, 49 ** -0.5)


@pytest.mark.cuda
def test_bad_inputs_raise(cuda):
    qkv, bias = _make(2, 53, 4, 32, cuda)
    with pytest.raises(TypeError):
        window_mhsa(qkv.half(), bias, 4, 0.1)
    with pytest.raises(ValueError):
        window_mhsa(qkv.transpose(0, 1).contiguous().transpose(0, 1), bias,
                    4, 0.1)
    with pytest.raises(ValueError):
        window_mhsa(qkv, bias.cpu(), 4, 0.1)
