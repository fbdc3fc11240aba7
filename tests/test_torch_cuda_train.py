"""The window-attention backward kernel (K2) against its plain PyTorch
version, and the port's training path, on the card. Every test here needs a
CUDA device and skips without one. On a machine with an H100 (which need not
have jax, so tests/conftest.py is not loaded):

    python -m pytest --noconftest -q tests/test_torch_cuda_train.py
"""
import numpy as np
import pytest
import torch

import fastervit_tpu_torch as fvt
from fastervit_tpu_torch.ops import cuda_attention
from fastervit_tpu_torch.ops.attention import (window_mhsa,
                                               window_mhsa_backward_reference)
from fastervit_tpu_torch.train.mixup import MixupConfig
from fastervit_tpu_torch.train.steps import (TrainConfig, create_train_state,
                                             make_train_step)

# (B, S, heads, head_dim): FasterViT-0's training shapes at batch 128
# (level-2 joint window + carrier attention, level-2 carrier attention,
# level 3), an odd shape with FasterViT-4's head_dim, and K2's largest S
# and head_dim.
CASES = [
    (512, 53, 8, 32),
    (128, 16, 8, 32),
    (128, 49, 16, 32),
    (3, 53, 4, 49),
    (5, 64, 2, 64),
]
# f32 throughout, TF32 off: only the order of the sums differs
TOL_FP32 = 1e-4
# bf16 inputs on both sides; the kernel rounds dqkv and dbias to bf16 once
# (2^-8 relative), the plain version here stays f32
TOL_BF16 = 1e-2


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
    qkv = rng.randn(b, s, 3 * h * d).astype(np.float32)
    bias = rng.randn(h, s, s).astype(np.float32)
    g = rng.randn(b, s, h * d).astype(np.float32)
    return (torch.from_numpy(t).to(device) for t in (qkv, bias, g))


def _rel_err(got, want):
    """max |got − want| over max(1, max |want|)."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1.0)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d", CASES)
def test_backward_kernel_fp32_matches_plain(cuda, b, s, h, d):
    qkv, bias, g = _make(b, s, h, d, cuda)
    dqkv, dbias = cuda_attention.window_mhsa_backward_cuda(qkv, bias, g, h,
                                                           d ** -0.5)
    want_dqkv, want_dbias = window_mhsa_backward_reference(qkv, bias, g, h,
                                                           d ** -0.5)
    torch.cuda.synchronize()
    assert _rel_err(dqkv, want_dqkv) <= TOL_FP32
    assert _rel_err(dbias, want_dbias) <= TOL_FP32


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d", CASES)
@pytest.mark.parametrize("qkv_dtype,bias_dtype", [
    (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
def test_backward_kernel_bf16_matches_plain_f32(cuda, b, s, h, d, qkv_dtype,
                                                bias_dtype):
    """K1's mixed dtype pairs, against the plain backward in f32 on the
    same (rounded) inputs."""
    qkv, bias, g = _make(b, s, h, d, cuda, seed=1)
    qkv, g, bias = qkv.to(qkv_dtype), g.to(qkv_dtype), bias.to(bias_dtype)
    dqkv, dbias = cuda_attention.window_mhsa_backward_cuda(qkv, bias, g, h,
                                                           d ** -0.5)
    assert dqkv.dtype == qkv_dtype and dbias.dtype == bias_dtype
    want_dqkv, want_dbias = window_mhsa_backward_reference(
        qkv.float(), bias.float(), g.float(), h, d ** -0.5)
    assert _rel_err(dqkv, want_dqkv) <= TOL_BF16
    assert _rel_err(dbias, want_dbias) <= TOL_BF16


@pytest.mark.cuda
def test_backward_kernel_is_deterministic(cuda):
    qkv, bias, g = _make(512, 53, 8, 32, cuda, seed=2)
    a = cuda_attention.window_mhsa_backward_cuda(qkv, bias, g, 8, 0.2)
    b = cuda_attention.window_mhsa_backward_cuda(qkv, bias, g, 8, 0.2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.parametrize("s,h,d", [(65, 2, 32), (128, 2, 64), (53, 2, 72)])
def test_backward_beyond_its_limit_raises(cuda, s, h, d):
    """K1 takes S <= 128, K2 only S <= 64: the backward raises, with no
    fallback. Beyond hd = 64 the forward runs on K3 and the backward
    raises."""
    qkv, bias, _ = _make(2, s, h, d, cuda)
    qkv.requires_grad_()
    with pytest.raises(NotImplementedError):
        window_mhsa(qkv, bias, h, d ** -0.5).sum().backward()


@pytest.mark.cuda
def test_autograd_on_card_matches_cpu_and_counts_launches(cuda):
    qkv, bias, g = _make(16, 53, 8, 32, "cpu", seed=3)
    grads = {}
    for device in ("cpu", cuda):
        q = qkv.to(device).detach().requires_grad_()
        bb = bias.to(device).detach().requires_grad_()
        k1 = cuda_attention.window_mhsa_cuda.launches
        k2 = cuda_attention.window_mhsa_backward_cuda.launches
        out = window_mhsa(q, bb, 8, 32 ** -0.5)
        out.backward(g.to(device))
        on_card = device != "cpu"
        assert cuda_attention.window_mhsa_cuda.launches == k1 + on_card
        assert cuda_attention.window_mhsa_backward_cuda.launches == \
            k2 + on_card
        grads[on_card] = (q.grad.cpu(), bb.grad.cpu())
    assert _rel_err(grads[True][0], grads[False][0]) <= TOL_FP32
    assert _rel_err(grads[True][1], grads[False][1]) <= TOL_FP32


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_step_on_card_trains_attention(cuda, dtype):
    """A tiny FasterViT step on the card: attention's gradients reach every
    qkv projection and CPB MLP, through K1 and K2."""
    model = fvt.create_model("faster_vit_0_224", device=cuda,
                             depths=[1, 1, 2, 1], num_heads=[1, 2, 4, 8],
                             dim=32, in_dim=16, num_classes=10)
    cfg = TrainConfig(mixup=MixupConfig(num_classes=10))
    state = create_train_state(model, cfg)
    step = make_train_step(cfg, lambda t: 1e-3, dtype)
    rng = np.random.RandomState(4)
    batch = {"image": rng.randn(4, 224, 224, 3).astype(np.float32),
             "label": np.arange(4, dtype=np.int32)}
    k1 = cuda_attention.window_mhsa_cuda.launches
    k2 = cuda_attention.window_mhsa_backward_cuda.launches
    metrics = step(state, batch)
    torch.cuda.synchronize()
    # level 2: 2 blocks x (carrier + joint attention); level 3: 1 block
    assert cuda_attention.window_mhsa_cuda.launches - k1 == 5
    assert cuda_attention.window_mhsa_backward_cuda.launches - k2 == 5
    assert np.isfinite(metrics["loss"].item())
    for name, p in model.named_parameters():
        if ".qkv." in name or ".pos_emb_funct.cpb_mlp." in name:
            assert p.grad is not None and bool(p.grad.abs().sum() > 0), name
            assert bool(torch.isfinite(p.grad).all()), name
