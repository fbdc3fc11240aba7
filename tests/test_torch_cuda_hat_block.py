"""K6, the fused HAT sub-block kernel, against its plain PyTorch version on
the card. Every test here needs a CUDA device and skips without one. On a
machine with an H100 (which need not have jax, so tests/conftest.py is not
loaded):

    python -m pytest --noconftest -q tests/test_torch_cuda_hat_block.py
"""
import numpy as np
import pytest
import torch

import fastervit_tpu_torch as fvt
from fastervit_tpu_torch.models import layers
from fastervit_tpu_torch.ops import cuda_attention, cuda_hat_block
from fastervit_tpu_torch.ops import hat_block as hb

# (B, S, heads, C): the JAX package's test shapes, a head dim of 49, one
# token a window, a ragged batch of carrier windows, and an fv1 carrier site
CASES = [(8, 53, 4, 128), (4, 16, 8, 128), (8, 49, 2, 64), (3, 49, 4, 196),
         (5, 1, 2, 32), (3, 16, 8, 256), (2, 16, 10, 320)]
# f32 throughout with TF32 off: only the order of the sums differs; bf16:
# the kernel rounds each product once after its f32 bias, the plain version
# (as the JAX reference) rounds the product to bf16 before the bias too,
# one bf16 step (2^-8 relative) at each of the five rounded tensors
TOL_FP32 = 2e-5
TOL_BF16 = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def make(b, s, h, c, device, seed=0, learned_gamma=True):
    """Seeded inputs as tests/test_fused_block.py::_make draws them, the
    matrices as nn.Linear holds them (out, in)."""
    rng = np.random.RandomState(seed)
    hidden = 4 * c

    def f(*shape, scale=1.0, shift=0.0, uniform=False):
        a = rng.rand(*shape) if uniform else rng.randn(*shape)
        return torch.from_numpy((a * scale + shift).astype(np.float32))

    x = f(b, s, c, scale=0.5)
    params = {
        "ln1_scale": f(c, uniform=True, shift=0.5),
        "ln1_bias": f(c, scale=0.1),
        "qkv_w": f(3 * c, c, scale=0.05), "qkv_b": f(3 * c, scale=0.05),
        "proj_w": f(c, c, scale=0.05), "proj_b": f(c, scale=0.05),
        "gamma3": f(c, uniform=True),
        "ln2_scale": f(c, uniform=True, shift=0.5),
        "ln2_bias": f(c, scale=0.1),
        "fc1_w": f(hidden, c, scale=0.05), "fc1_b": f(hidden, scale=0.05),
        "fc2_w": f(c, hidden, scale=0.05), "fc2_b": f(c, scale=0.05),
        "gamma4": f(c, uniform=True)}
    if not learned_gamma:
        params["gamma3"] = params["gamma4"] = torch.ones(c)
    bias = f(h, s, s)
    return (x.to(device), {k: v.to(device) for k, v in params.items()},
            bias.to(device))


def cast(params, dtype):
    return {k: v.to(dtype) if k in hb.MATRICES else v
            for k, v in params.items()}


def bound(want, tol):
    return tol * max(1.0, want.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,c", CASES)
def test_kernel_fp32_matches_plain(cuda, b, s, h, c):
    x, params, bias = make(b, s, h, c, cuda)
    scale = (c // h) ** -0.5
    got = cuda_hat_block.hat_block_cuda(x, params, bias, h, scale)
    want = hb.hat_block_reference(x, params, bias, h, scale,
                                  attn_impl="plain")
    assert got.dtype == torch.float32 and got.shape == (b, s, c)
    assert (got - want).abs().max().item() <= bound(want, TOL_FP32)
    again = cuda_hat_block.hat_block_cuda(x, params, bias, h, scale)
    assert torch.equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,c", CASES)
@pytest.mark.parametrize("learned_gamma", [True, False])
def test_kernel_bf16_matches_plain(cuda, b, s, h, c, learned_gamma):
    x, params, bias = make(b, s, h, c, cuda, learned_gamma=learned_gamma)
    x16, p16 = x.bfloat16(), cast(params, torch.bfloat16)
    b16 = bias.bfloat16()
    scale = (c // h) ** -0.5
    got = cuda_hat_block.hat_block_cuda(x16, p16, b16, h, scale)
    assert cuda_hat_block.hat_block_cuda.last_plan == cuda_hat_block.plan(
        b, s, c, 4 * c, h, True)
    want = hb.hat_block_reference(x16, p16, b16, h, scale, attn_impl="plain")
    assert got.dtype == torch.bfloat16
    assert (got.float() - want.float()).abs().max().item() <= bound(
        want, TOL_BF16)
    again = cuda_hat_block.hat_block_cuda(x16, p16, b16, h, scale)
    assert torch.equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("s,h,c", [(s, h, c) for _, s, h, c in CASES]
                         + [(16, 8, 256), (53, 8, 256), (49, 16, 512)])
def test_plan_smem_matches_the_kernel(cuda, s, h, c):
    """The shared memory ops/cuda_hat_block.py plans with, held against the
    kernel's own figure, at every block size, both routes and every ring
    depth."""
    lib = cuda_attention._library()
    for wpb in range(1, 64 // s + 1):
        assert lib.hat_block_smem_bytes(s, c, h, wpb, 0, 0) == \
            cuda_hat_block._smem(s, c, h, wpb)
        for stages in range(cuda_hat_block.MIN_STAGES,
                            cuda_hat_block.MAX_STAGES + 1):
            assert lib.hat_block_smem_bytes(s, c, h, wpb, 1, stages) == \
                cuda_hat_block._smem(s, c, h, wpb, "wgmma", stages)


# (B, S, heads, C): FasterViT-0's three sites at a small batch, FasterViT-1
# to -3's admitted widths on the tensor cores (hd 40, 48, 64; FasterViT-3's
# carriers moved there from scalar FMA), and ragged batches of carrier
# windows that leave the last block one window short
TC_CASES = [(5, 16, 8, 256), (3, 53, 8, 256), (2, 49, 16, 512),
            (6, 16, 8, 320), (2, 53, 8, 320), (4, 16, 8, 384),
            (2, 53, 8, 384), (4, 16, 8, 512), (259, 16, 8, 256),
            (133, 16, 8, 320)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,c", TC_CASES)
def test_tensor_core_route_at_family_widths(cuda, b, s, h, c):
    """bf16 on the wgmma route at the family's admitted widths, within the
    bf16 tolerance of the plain version, two launches bit-identical."""
    x, params, bias = make(b, s, h, c, cuda, seed=11)
    x16, p16, b16 = x.bfloat16(), cast(params, torch.bfloat16), \
        bias.bfloat16()
    scale = (c // h) ** -0.5
    got = cuda_hat_block.hat_block_cuda(x16, p16, b16, h, scale)
    plan = cuda_hat_block.hat_block_cuda.last_plan
    assert plan.route == "wgmma" and plan.stages >= cuda_hat_block.MIN_STAGES
    if b % plan.windows_per_block:
        assert b > plan.windows_per_block  # a short last block
    want = hb.hat_block_reference(x16, p16, b16, h, scale, attn_impl="plain")
    assert (got.float() - want.float()).abs().max().item() <= bound(
        want, TOL_BF16)
    assert torch.equal(cuda_hat_block.hat_block_cuda(x16, p16, b16, h, scale),
                       got)


# Plans the C entry point must refuse, each beside a shape it is handed
# with: the tensor cores for f32, a ring of 2 and of 9 slots, a third
# warpgroup, a wrong shared-memory figure, more than 64 tokens a block, and
# a scalar plan with a ring
def _wrong_plans():
    tc = cuda_hat_block.plan(4, 16, 256, 1024, 8, True)
    sc = cuda_hat_block.plan(4, 16, 256, 1024, 8, False)
    return [(torch.float32, tc._replace(smem_bytes=tc.smem_bytes)),
            (torch.bfloat16, tc._replace(stages=2)),
            (torch.bfloat16, tc._replace(stages=9)),
            (torch.bfloat16, tc._replace(warpgroups=3)),
            (torch.bfloat16, tc._replace(smem_bytes=tc.smem_bytes + 16)),
            (torch.bfloat16, tc._replace(windows_per_block=5)),
            (torch.float32, sc._replace(stages=3))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(7))
def test_wrong_plans_are_refused(cuda, monkeypatch, case):
    dtype, wrong = _wrong_plans()[case]
    x, params, bias = make(4, 16, 8, 256, cuda)
    x, params = x.to(dtype), cast(params, dtype)
    monkeypatch.setattr(cuda_hat_block, "plan", lambda *_: wrong)
    before = cuda_hat_block.hat_block_cuda.launches
    with pytest.raises(RuntimeError, match="hat_block"):
        cuda_hat_block.hat_block_cuda(x, params, bias, 8, 0.1)
    assert cuda_hat_block.hat_block_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL_FP32),
                                       (torch.bfloat16, TOL_BF16)])
def test_dp_variant_matches_plain(cuda, dtype, tol):
    b, s, h, c = 8, 53, 4, 128
    x, params, bias = make(b, s, h, c, cuda, seed=3)
    x, params = x.to(dtype), cast(params, dtype)
    rng = np.random.RandomState(7)
    dp1, dp2 = (torch.from_numpy(((rng.rand(b) < 0.6) / 0.6).astype(
        np.float32)).to(cuda) for _ in range(2))
    assert (dp1 == 0).any() and (dp2 == 0).any()
    scale = (c // h) ** -0.5
    got = cuda_hat_block.hat_block_cuda(x, params, bias, h, scale, dp1, dp2)
    want = hb.hat_block_reference(x, params, bias, h, scale, dp1, dp2,
                                  attn_impl="plain")
    assert (got.float() - want.float()).abs().max().item() <= bound(want,
                                                                    tol)
    assert torch.equal(
        cuda_hat_block.hat_block_cuda(x, params, bias, h, scale, dp1, dp2),
        got)


@pytest.mark.cuda
def test_empty_batch_launches_nothing(cuda):
    x, params, bias = make(2, 16, 2, 64, cuda)
    before = cuda_hat_block.hat_block_cuda.launches
    out = hb.fused_hat_block(x[:0], params, bias, 2, 0.1)
    assert out.shape == (0, 16, 64)
    assert cuda_hat_block.hat_block_cuda.launches == before


@pytest.mark.cuda
def test_refused_shapes_raise_and_name_the_limit(cuda):
    x, params, bias = make(2, 65, 1, 64, cuda)
    with pytest.raises(NotImplementedError, match="S <= 64"):
        hb.fused_hat_block(x, params, bias, 1, 0.1)
    x, params, bias = make(1, 49, 32, 1024, cuda)
    with pytest.raises(NotImplementedError, match="shared-memory"):
        hb.fused_hat_block(x, params, bias, 32, 0.1)
    assert not hb.fused_block_supported(x.shape, 1024, 4096, 32)
    x, params, bias = make(2, 16, 2, 64, cuda)
    with pytest.raises(TypeError):
        cuda_hat_block.hat_block_cuda(x.bfloat16(), params, bias, 2, 0.1)
    mixed = dict(params, gamma3=params["gamma3"].bfloat16())
    with pytest.raises(TypeError, match="vectors"):
        cuda_hat_block.hat_block_cuda(x, mixed, bias, 2, 0.1)


@pytest.mark.cuda
def test_cuda_tensor_never_takes_the_plain_version(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(hb, "hat_block_reference", refuse)
    x, params, bias = make(2, 16, 2, 64, cuda)
    before = cuda_hat_block.hat_block_cuda.launches
    with torch.no_grad():
        hb.fused_hat_block(x, params, bias, 2, 0.1)
    assert cuda_hat_block.hat_block_cuda.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("with_dp", [False, True])
def test_gradients_match_autograd_through_plain(cuda, with_dp):
    """The recompute backward (attention on K1 + K2) against autograd
    through the plain version, fp32: x, every param, the bias, dp1, dp2."""
    b, s, h, c = 6, 16, 2, 64
    x, params, bias = make(b, s, h, c, cuda, seed=5)
    rng = np.random.RandomState(9)
    dps = [torch.from_numpy(((rng.rand(b) < 0.7) / 0.7).astype(np.float32))
           .to(cuda) for _ in range(2)] if with_dp else [None, None]
    g = torch.from_numpy(rng.randn(b, s, c).astype(np.float32)).to(cuda)
    scale = (c // h) ** -0.5

    def grads(fn):
        leaves = [x, bias] + [params[k] for k in hb.PARAM_ORDER] + [
            d for d in dps if d is not None]
        leaves = [t.detach().clone().requires_grad_() for t in leaves]
        xx, bb, *rest = leaves
        pp = dict(zip(hb.PARAM_ORDER, rest[:14]))
        d1, d2 = rest[14:] if with_dp else (None, None)
        out = fn(xx, pp, bb, d1, d2)
        return torch.autograd.grad((out * g).sum(), leaves)

    k2 = cuda_attention.window_mhsa_backward_cuda.launches
    got = grads(lambda xx, pp, bb, d1, d2: (
        hb.fused_hat_block_dp(xx, pp, bb, d1, d2, h, scale) if with_dp
        else hb.fused_hat_block(xx, pp, bb, h, scale)))
    assert cuda_attention.window_mhsa_backward_cuda.launches == k2 + 1
    want = grads(lambda xx, pp, bb, d1, d2: hb.hat_block_reference(
        xx, pp, bb, h, scale, d1, d2, attn_impl="plain"))
    for a, e in zip(got, want):
        assert (a - e).abs().max().item() <= 1e-4 * max(
            1.0, e.abs().max().item())


@pytest.mark.cuda
def test_model_routes_every_sub_block_through_k6(cuda):
    """A narrow fv0 in eval mode with the switch on: one K6 launch per HAT
    sub-block (2 carrier and 2 joint at level 2, 1 at level 3), no K1;
    logits as with the switch off."""
    kw = dict(depths=[1, 1, 2, 1], num_heads=[1, 2, 4, 8], dim=32, in_dim=16,
              num_classes=10, do_propagation=True)
    model = fvt.create_model("faster_vit_0_224", device="cuda",
                             generator=torch.Generator().manual_seed(0),
                             **kw).eval()
    x = torch.randn(2, 3, 224, 224, device="cuda")
    with torch.no_grad():
        off = model(x)
        prev = fvt.set_fused_hat(True)
        try:
            k6 = cuda_hat_block.hat_block_cuda.launches
            k1 = cuda_attention.window_mhsa_cuda.launches
            on = model(x)
            assert cuda_hat_block.hat_block_cuda.launches - k6 == 5
            assert cuda_attention.window_mhsa_cuda.launches == k1
        finally:
            layers.set_fused_hat(prev)
    assert (on - off).abs().max().item() <= 5e-5
