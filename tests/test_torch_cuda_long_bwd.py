"""The long-window attention backward (K4) against its plain PyTorch
version, the K2/K4 backward route and a large-window train step, on the
card. Every test here needs a CUDA device and skips without one. On a
machine with an H100 (which need not have jax, so tests/conftest.py is not
loaded):

    python -m pytest --noconftest -q tests/test_torch_cuda_long_bwd.py
"""
import numpy as np
import pytest
import torch

import fastervit_tpu_torch as fvt
from fastervit_tpu_torch.ops import cuda_attention
from fastervit_tpu_torch.ops.attention import (window_mhsa,
                                               window_mhsa_backward_reference)
from fastervit_tpu_torch.train.steps import (TrainConfig, create_train_state,
                                             make_train_step)

# bf16 on the tensor cores: every padded head dim (32, 49 -> 64, 64, 80,
# 128) at S of one key, a tile less one, one, one more, a block of 128 q
# rows less one, one, one more, and the 21k-768 level-2 window plus one
BF16_SEQS = [1, 63, 64, 65, 127, 128, 129, 2305]
BF16_HEAD_DIMS = [32, 49, 64, 80, 128]
# (B, S, heads, head_dim): faster_vit_4_21k_384 at batch 32 (level 2, level
# 3), faster_vit_4_21k_768 (level 2 at batch 2, where the plain version's
# four (B, H, S, S) f32 tensors fit; level 3 at batch 16), 21k-224's level
# 2, fv5's joint attention (hd 80), the any-res carriers, a K1-forward
# window past K2 (64 < S <= 128), ragged S at hd 49 and 128, and S = 1.
CASES = [
    (32, 576, 16, 49), (32, 144, 32, 49),
    (2, 2304, 16, 49), (16, 576, 32, 49),
    (8, 196, 16, 49), (8, 53, 16, 80), (8, 216, 8, 32), (8, 100, 4, 32),
    (2, 129, 2, 49), (2, 197, 2, 49), (2, 2305, 2, 49),
    (2, 129, 2, 128), (2, 197, 2, 128), (2, 2305, 2, 128),
    (3, 1, 2, 49),
]
# f32 throughout, TF32 off: the order of the sums, the online row
# statistics and exp(logit − L) in place of exp(logit − m)/l differ; K4 sums
# dk and dv across q-tiles in f32, where the TPU kernel sums in qkv's type.
# Relative to the tensor's largest entry.
TOL_FP32 = 1e-5
# bf16 inputs on both sides; the kernel rounds dqkv and dbias to bf16 once
# (2^-8 relative), the plain version here stays f32; on the tensor cores
# it also rounds P and dl to bf16 before the second products (2^-9)
TOL_BF16 = 1e-2
NARROW = dict(depths=[1, 1, 2, 1], num_heads=[1, 2, 4, 8], dim=32,
              in_dim=16, num_classes=10, drop_path_rate=0.0)


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
    """max |got − want| over the largest |want| (an all-zero want, as dbias
    at S = 1, counts as 1e-6)."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1e-6)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d", CASES)
def test_long_backward_fp32_matches_plain(cuda, b, s, h, d):
    qkv, bias, g = _make(b, s, h, d, cuda)
    got = cuda_attention.window_mhsa_long_backward_cuda(qkv, bias, g, h,
                                                        d ** -0.5)
    want = window_mhsa_backward_reference(qkv, bias, g, h, d ** -0.5)
    torch.cuda.synchronize()
    assert cuda_attention.window_mhsa_long_backward_cuda.last_plan.route == \
        "scalar"
    assert _rel_err(got[0], want[0]) <= TOL_FP32
    assert _rel_err(got[1], want[1]) <= TOL_FP32


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d", CASES)
@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
def test_long_backward_bf16_matches_plain_f32(cuda, b, s, h, d, bias_dtype):
    qkv, bias, g = _make(b, s, h, d, cuda, seed=1)
    qkv, g, bias = qkv.bfloat16(), g.bfloat16(), bias.to(bias_dtype)
    dqkv, dbias = cuda_attention.window_mhsa_long_backward_cuda(
        qkv, bias, g, h, d ** -0.5)
    assert dqkv.dtype == torch.bfloat16 and dbias.dtype == bias_dtype
    assert cuda_attention.window_mhsa_long_backward_cuda.last_plan.route == \
        "wgmma"
    want = window_mhsa_backward_reference(qkv.float(), bias.float(),
                                          g.float(), h, d ** -0.5)
    assert _rel_err(dqkv, want[0]) <= TOL_BF16
    assert _rel_err(dbias, want[1]) <= TOL_BF16


@pytest.mark.cuda
@pytest.mark.parametrize("s", BF16_SEQS)
@pytest.mark.parametrize("d", BF16_HEAD_DIMS)
@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
def test_long_backward_tensor_cores_at_every_depth_and_ragged_s(
        cuda, s, d, bias_dtype):
    """The tensor-core route at each padded head dim (hd 49 pads to 64,
    zeros in shared memory) and at S that end a key tile, a q-row block
    or both raggedly, against the plain f32 version, its plan the
    library's."""
    b, h = 2, 2
    qkv, bias, g = _make(b, s, h, d, cuda, seed=5)
    qkv, g, bias = qkv.bfloat16(), g.bfloat16(), bias.to(bias_dtype)
    kernel = cuda_attention.window_mhsa_long_backward_cuda
    dqkv, dbias = kernel(qkv, bias, g, h, d ** -0.5)
    assert kernel.last_plan == cuda_attention.long_bwd_plan(
        d, torch.bfloat16, bias_dtype)
    assert kernel.last_plan.route == "wgmma"
    want = window_mhsa_backward_reference(qkv.float(), bias.float(),
                                          g.float(), h, d ** -0.5)
    assert torch.isfinite(dqkv).all() and torch.isfinite(dbias).all()
    assert _rel_err(dqkv, want[0]) <= TOL_BF16
    assert _rel_err(dbias, want[1]) <= TOL_BF16


@pytest.mark.cuda
@pytest.mark.parametrize("tensor_cores", [0, 1])
@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
def test_plan_shared_memory_is_the_librarys(cuda, tensor_cores, bias_dtype):
    """long_bwd_plan names, for each pass and every hd, the shared memory
    the built library computes, so the entry point's check of the plan
    passes."""
    lib = cuda_attention._library()
    dtype = torch.bfloat16 if tensor_cores else torch.float32
    for hd in range(1, cuda_attention.LONG_MAX_HEAD_DIM + 1):
        plan = cuda_attention.long_bwd_plan(hd, dtype, bias_dtype)
        assert plan.smem_bytes == tuple(
            lib.long_attention_bwd_smem_bytes(hd, tensor_cores,
                                              bias_dtype.itemsize, p)
            for p in range(3)), hd


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d", [(32, 576, 16, 49), (64, 216, 8, 32),
                                     (16, 53, 16, 80), (4, 2305, 2, 49),
                                     (6, 129, 4, 80)])
def test_long_backward_is_deterministic(cuda, b, s, h, d):
    """dbias is summed in a fixed order, with no atomics: the same bits
    from launch to launch, and dqkv too."""
    qkv, bias, g = _make(b, s, h, d, cuda, seed=2)
    qkv, bias, g = qkv.bfloat16(), bias.bfloat16(), g.bfloat16()
    a = cuda_attention.window_mhsa_long_backward_cuda(qkv, bias, g, h, 0.2)
    c = cuda_attention.window_mhsa_long_backward_cuda(qkv, bias, g, h, 0.2)
    assert torch.equal(a[1], c[1]) and torch.equal(a[0], c[0])


@pytest.mark.cuda
def test_empty_batch_launches_nothing(cuda):
    qkv, bias, g = _make(0, 576, 2, 49, cuda)
    before = cuda_attention.window_mhsa_long_backward_cuda.launches
    dqkv, dbias = cuda_attention.window_mhsa_long_backward_cuda(
        qkv, bias, g, 2, 0.1)
    assert dqkv.shape == (0, 576, 294) and torch.equal(
        dbias, torch.zeros_like(bias))
    assert cuda_attention.window_mhsa_long_backward_cuda.launches == before


@pytest.mark.cuda
def test_bad_inputs_raise(cuda):
    qkv, bias, g = _make(2, 576, 4, 49, cuda)
    kernel = cuda_attention.window_mhsa_long_backward_cuda
    with pytest.raises(TypeError):
        kernel(qkv, bias, g.bfloat16(), 4, 0.1)
    with pytest.raises(ValueError):
        kernel(qkv, bias, g[:, :-1].contiguous(), 4, 0.1)
    with pytest.raises(ValueError):
        kernel(qkv, bias.cpu(), g, 4, 0.1)
    wide, wide_bias, wide_g = _make(2, 576, 1, 129, cuda)
    with pytest.raises(NotImplementedError):
        kernel(wide, wide_bias, wide_g, 1, 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("s,d,route", [(53, 32, "K2"), (64, 64, "K2"),
                                       (65, 32, "K4"), (576, 49, "K4"),
                                       (53, 80, "K4")])
def test_autograd_launches_the_routed_backward(cuda, s, d, route):
    qkv, bias, g = _make(2, s, 4, d, cuda, seed=3)
    q = qkv.requires_grad_()
    bb = bias.requires_grad_()
    k2 = cuda_attention.window_mhsa_backward_cuda.launches
    k4 = cuda_attention.window_mhsa_long_backward_cuda.launches
    window_mhsa(q, bb, 4, d ** -0.5).backward(g)
    assert cuda_attention.window_mhsa_backward_cuda.launches - k2 == \
        (route == "K2")
    assert cuda_attention.window_mhsa_long_backward_cuda.launches - k4 == \
        (route == "K4")
    want = window_mhsa_backward_reference(qkv.detach(), bias.detach(), g, 4,
                                          d ** -0.5)
    assert _rel_err(q.grad, want[0]) <= TOL_FP32
    assert _rel_err(bb.grad, want[1]) <= TOL_FP32


def _stem_relu_inputs(model):
    seen = []
    for m in model.patch_embed.conv_down:
        if isinstance(m, torch.nn.ReLU):
            m.register_forward_hook(
                lambda mod, args, out: seen.append(args[0].detach().cpu()))
    return seen


@pytest.mark.cuda
def test_narrow_21k_384_train_step_card_matches_cpu(cuda):
    """One fp32 step of the narrow 21k-384 model (no mixup, no drop path):
    the card (K3 forward, K4 backward) against the CPU (plain versions) on
    the same weights: the loss, and each gradient to 1e-3 of its tensor's
    largest entry (floor: 1e-5 of the largest of all). Where an input of
    the stem's ReLUs sits on the other side of 0 on the card (within
    rounding of the kink), the stem's gradients move by whole per-element
    terms: they are then held to 2e-2 of their largest entry, as in
    chip_smoke.py."""
    model_cpu = fvt.create_model("faster_vit_4_21k_384", device="cpu",
                                 **NARROW)
    model = fvt.create_model("faster_vit_4_21k_384", device=cuda, **NARROW)
    model.load_state_dict(model_cpu.state_dict())
    relus = [_stem_relu_inputs(m) for m in (model_cpu, model)]
    cfg = TrainConfig(mixup=None)
    rng = np.random.RandomState(4)
    batch = {"image": rng.randn(2, 384, 384, 3).astype(np.float32),
             "label": np.arange(2, dtype=np.int32)}
    losses = {}
    for m in (model_cpu, model):
        k3 = cuda_attention.window_mhsa_long_cuda.launches
        k4 = cuda_attention.window_mhsa_long_backward_cuda.launches
        losses[m] = make_train_step(cfg, lambda t: 1e-3)(
            create_train_state(m, cfg), batch)["loss"].item()
        torch.cuda.synchronize()
    # level 2: 2 blocks of one 24x24 window; level 3: 1 block
    assert cuda_attention.window_mhsa_long_cuda.launches - k3 == 3
    assert cuda_attention.window_mhsa_long_backward_cuda.launches - k4 == 3
    assert abs(losses[model] - losses[model_cpu]) <= 1e-4
    flips = sum(int(((a > 0) != (b > 0)).sum()) for a, b in zip(*relus))
    want = dict(model_cpu.named_parameters())
    floor = 1e-5 * max(p.grad.abs().max().item() for p in want.values())
    for name, p in model.named_parameters():
        w = want[name].grad
        bound = max(1e-3 * w.abs().max().item(), floor)
        if flips and name.startswith("patch_embed."):
            bound = 2e-2 * w.abs().max().item()
        assert (p.grad.cpu() - w).abs().max().item() <= bound, name
