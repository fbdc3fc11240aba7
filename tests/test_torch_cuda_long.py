"""The long-window attention kernel (K3) against its plain PyTorch version,
the K1/K3 routing and deploy mode, on the card. Every test here needs a
CUDA device and skips without one. On a machine with an H100 (which need not
have jax, so tests/conftest.py is not loaded):

    python -m pytest --noconftest -q tests/test_torch_cuda_long.py
"""
import numpy as np
import pytest
import torch

import fastervit_tpu_torch as fvt
from fastervit_tpu_torch.ops import cuda_attention
from fastervit_tpu_torch.ops.attention import (window_mhsa,
                                               window_mhsa_long_reference)

# (B, S, heads, head_dim): 21k-768 level 2 and 21k-384 level 3 at a small
# batch, 21k-384 level 2, fv0_any_res's carrier attention, fv5's joint
# attention (hd 80), ragged S with hd 49 and 128, and S = 1.
CASES = [
    (2, 2304, 4, 49),
    (4, 144, 8, 49),
    (2, 576, 8, 49),
    (8, 216, 8, 32),
    (8, 53, 4, 80),
    (3, 129, 2, 49),
    (2, 197, 2, 128),
    (1, 2305, 2, 128),
    (3, 1, 2, 49),
]
# the narrow 21k-768 geometry of tests/test_torch_family.py
NARROW = dict(depths=[1, 1, 2, 1], num_heads=[1, 2, 4, 8], dim=49,
              in_dim=16, num_classes=100)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = prev


def _make(b, s, h, d, device, seed=0):
    rng = np.random.RandomState(seed)
    qkv = torch.from_numpy(rng.randn(b, s, 3 * h * d).astype(np.float32))
    bias = torch.from_numpy(rng.randn(h, s, s).astype(np.float32))
    return qkv.to(device), bias.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d", CASES)
def test_kernel_fp32_matches_plain(cuda, b, s, h, d):
    qkv, bias = _make(b, s, h, d, cuda)
    got = cuda_attention.window_mhsa_long_cuda(qkv, bias, h, d ** -0.5)
    want = window_mhsa_long_reference(qkv, bias, h, d ** -0.5)
    torch.cuda.synchronize()
    # f32 throughout, TF32 off: the order of the sums and the running max's
    # rescaling differ
    assert (got - want).abs().max().item() <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d", CASES)
@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
def test_kernel_bf16_matches_plain_f32(cuda, b, s, h, d, bias_dtype):
    qkv, bias = _make(b, s, h, d, cuda, seed=1)
    qkv, bias = qkv.bfloat16(), bias.to(bias_dtype)
    got = cuda_attention.window_mhsa_long_cuda(qkv, bias, h, d ** -0.5)
    assert got.dtype == torch.bfloat16
    want = window_mhsa_long_reference(qkv.float(), bias.float(), h,
                                      d ** -0.5)
    # bf16 output and bf16 probabilities: ~3 significant digits on O(1)
    # values, the bound K1 is held to
    assert (got.float() - want).abs().max().item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("s,d,route", [(53, 32, "K1"), (576, 49, "K3"),
                                       (53, 80, "K3")])
def test_dispatch_launches_the_routed_kernel(cuda, s, d, route):
    qkv, bias = _make(2, s, 4, d, cuda)
    k1 = cuda_attention.window_mhsa_cuda.launches
    k3 = cuda_attention.window_mhsa_long_cuda.launches
    out = window_mhsa(qkv, bias, 4, d ** -0.5)
    assert cuda_attention.window_mhsa_cuda.launches - k1 == (route == "K1")
    assert cuda_attention.window_mhsa_long_cuda.launches - k3 == \
        (route == "K3")
    assert out.shape == (2, s, 4 * d) and out.device.type == "cuda"


@pytest.mark.cuda
def test_empty_batch_launches_nothing(cuda):
    qkv, bias = _make(0, 576, 2, 49, cuda)
    before = cuda_attention.window_mhsa_long_cuda.launches
    out = cuda_attention.window_mhsa_long_cuda(qkv, bias, 2, 0.1)
    assert out.shape == (0, 576, 98)
    assert cuda_attention.window_mhsa_long_cuda.launches == before


@pytest.mark.cuda
def test_bad_inputs_raise(cuda):
    qkv, bias = _make(2, 576, 4, 49, cuda)
    kernel = cuda_attention.window_mhsa_long_cuda
    with pytest.raises(TypeError):
        kernel(qkv.half(), bias, 4, 0.1)
    with pytest.raises(ValueError):
        kernel(qkv.transpose(0, 1).contiguous().transpose(0, 1), bias, 4, 0.1)
    with pytest.raises(ValueError):
        kernel(qkv, bias.cpu(), 4, 0.1)
    with pytest.raises(ValueError):
        kernel(qkv, bias[:, :-1], 4, 0.1)
    wide, wide_bias = _make(2, 576, 1, 129, cuda)
    with pytest.raises(NotImplementedError):
        kernel(wide, wide_bias, 1, 0.1)


@pytest.mark.cuda
def test_backward_of_a_long_window_names_k4(cuda):
    """K2 takes S <= 64: the backward of a K3-routed forward is K4's,
    counted under K4's wrapper, never K2's."""
    qkv, bias = _make(2, 576, 2, 49, cuda)
    qkv.requires_grad_()
    out = window_mhsa(qkv, bias, 2, 49 ** -0.5)
    k2 = cuda_attention.window_mhsa_backward_cuda.launches
    k4 = cuda_attention.window_mhsa_long_backward_cuda.launches
    out.sum().backward()
    assert cuda_attention.window_mhsa_long_backward_cuda.launches == k4 + 1
    assert cuda_attention.window_mhsa_backward_cuda.launches == k2
    assert bool(torch.isfinite(qkv.grad).all())


@pytest.mark.cuda
def test_narrow_21k_768_card_matches_cpu_and_bakes(cuda):
    """The narrow 21k-768 model, fp32: the card (K3 path) against the CPU
    (plain path) on the same weights, then deploy mode bit-identical to the
    live forward on the card."""
    model_cpu = fvt.create_model("faster_vit_4_21k_768", device="cpu",
                                 **NARROW).eval()
    model = fvt.create_model("faster_vit_4_21k_768", device=cuda,
                             **NARROW).eval()
    model.load_state_dict(model_cpu.state_dict())
    x = torch.from_numpy(np.random.RandomState(2).randn(
        2, 3, 768, 768).astype(np.float32))
    with torch.no_grad():
        want = model_cpu(x)
        k1 = cuda_attention.window_mhsa_cuda.launches
        k3 = cuda_attention.window_mhsa_long_cuda.launches
        live = model(x.to(cuda))
        torch.cuda.synchronize()
        # level 2: 2 blocks of one 48x48 window; level 3: 1 block
        assert cuda_attention.window_mhsa_long_cuda.launches - k3 == 3
        assert cuda_attention.window_mhsa_cuda.launches == k1
        baked = fvt.bake_posemb(model)(x.to(cuda))
    assert (live.cpu() - want).abs().max().item() <= 1e-4
    assert torch.equal(baked, live)
