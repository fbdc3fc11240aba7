"""K7, the multi-scale deformable attention backward kernel, against its
plain PyTorch version on the card. Every test here needs a CUDA device and
skips without one. On a machine with an H100 (which need not have jax, so
tests/conftest.py is not loaded):

    python -m pytest --noconftest -q tests/test_torch_cuda_msda_bwd.py

Tolerances, each with its reason:
- dweights and dloc sum over D in another order than the plain version
  (the lanes' shares added by shuffles): f32 within 2e-5 of each tensor's
  largest entry; bf16 dweights within one bf16 rounding (2⁻⁸ of the entry)
  of the plain version's f32 sum, plus that f32 bound;
- dvalue adds its terms with atomics, in an order that changes from run to
  run: within the order bound c·2⁻²⁴·Σ|terms| of `ops.msda.
  dvalue_order_bound`, c counting the tile flushes of the launch's plan
  (`cuda_msda.msda_bwd_flushes`) (plus one bf16 rounding for bf16).
Two launches give dloc and dweights bit for bit, dvalue within that
bound."""
import numpy as np
import pytest
import torch

from fastervit_tpu_torch.ops import cuda_msda, msda
from fastervit_tpu_torch.ops.msda import (dvalue_order_bound, ms_deform_attn,
                                          msda_backward_reference)

SERVED = ((100, 167), (50, 84), (25, 42), (13, 21))
# MOTR's four levels at 800x1536 (faster_vit_0_any_res): its encoder call,
# Q = S = 102,000 rows a head on route l2, and its training decoder's 130
MOTR = ((200, 384), (100, 192), (50, 96), (25, 48))
# (N, Q, M, D, P, levels): DINO-4scale's decoder call at batch 2, MOTR's
# encoder and decoder calls, then odd shapes that reach every group size
# of the plans (D 1, 4, 8, 16, 24, 32, 33, 48, 64), a 1x1 level and empty
# batches and query sets
CASES = [
    (2, 900, 8, 32, 4, SERVED),
    (1, 102_000, 8, 32, 4, MOTR),
    (1, 130, 8, 32, 4, MOTR),
    (1, 37, 3, 4, 2, ((5, 7), (1, 1), (3, 2))),
    (2, 50, 2, 8, 3, ((9, 4), (1, 1))),
    (1, 64, 4, 64, 4, ((12, 17), (6, 9), (3, 5), (2, 3))),
    (3, 41, 5, 33, 1, ((7, 7),)),
    (1, 19, 2, 16, 20, ((6, 5), (3, 3))),
    (2, 29, 3, 24, 3, ((8, 6), (4, 3), (1, 2))),
    (1, 23, 2, 1, 3, ((5, 4), (2, 2))),
    (2, 30, 3, 48, 2, ((7, 9), (4, 5))),
    (0, 10, 8, 32, 4, SERVED),
    (2, 0, 8, 32, 4, SERVED),
]
TOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def make_inputs(n, q, m, d, p, shapes, device, seed=0):
    """value and g N(0, 1); locations in [-0.1, 1.1] with a quarter of
    them on the borders or far outside; weights softmax-normalised."""
    rng = np.random.RandomState(seed)
    s, nl = sum(h * w for h, w in shapes), len(shapes)
    value = rng.randn(n, s, m, d).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, (n, q, m, nl, p, 2)).astype(np.float32)
    special = np.array([0.0, 1.0, -10.0, 10.0, -1e9, 1e9], np.float32)
    pick = rng.rand(*loc.shape) < 0.25
    loc[pick] = special[rng.randint(0, len(special), pick.sum())]
    logits = rng.randn(n, q, m, nl * p).astype(np.float32)
    w = np.exp(logits - logits.max(-1, keepdims=True))
    w = (w / w.sum(-1, keepdims=True)).reshape(n, q, m, nl, p)
    g = rng.randn(n, q, m * d).astype(np.float32)
    return [torch.from_numpy(t).to(device) for t in (value, loc, w, g)]


def rel_to_largest(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1e-30)).item()


def flushes(q):
    """The tile flushes an element of dvalue took in K7's latest launch."""
    return cuda_msda.msda_bwd_flushes(
        cuda_msda.ms_deform_attn_backward_cuda.last_plan, q)


def check_against_plain(value, shapes, loc, w, g):
    """K7 on these inputs against the plain version, to the bounds in the
    module docstring; returns K7's outputs."""
    kernel = cuda_msda.ms_deform_attn_backward_cuda
    before = kernel.launches
    got = kernel(value, shapes, loc, w, g)
    torch.cuda.synchronize()
    n, q = loc.shape[:2]
    assert kernel.launches == before + int(n * q > 0)
    want = msda_backward_reference(value, shapes, loc, w, g)
    for t, ref in zip(got, want):
        assert t.shape == ref.shape and t.dtype == ref.dtype
    if not n * q:
        assert all(not t.abs().sum() for t in got)
        return got
    dv, dl, dw = got
    bound, c = dvalue_order_bound(value, shapes, loc, w, g, flushes(q))
    want32 = msda_backward_reference(value.float(), shapes, loc, w.float(),
                                     g.float())
    if value.dtype == torch.bfloat16:
        # the f32 sum (within bound of the plain one) rounded to bf16 once
        bound = bound + 2 ** -8 * (want32[0].abs() + bound)
    assert ((dv.float() - want32[0]).abs() <= bound).all()
    assert rel_to_largest(dl, want32[1]) <= TOL
    if value.dtype == torch.float32:
        assert rel_to_largest(dw, want32[2]) <= TOL
    else:
        top = want32[2].abs().max()
        assert ((dw.float() - want32[2]).abs()
                <= 2 ** -8 * want32[2].abs() + TOL * top).all()
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n,q,m,d,p,shapes", CASES)
def test_kernel_matches_plain(cuda, dtype, n, q, m, d, p, shapes):
    value, loc, w, g = make_inputs(n, q, m, d, p, shapes, cuda)
    value, w, g = value.to(dtype), w.to(dtype), g.to(dtype)
    got = check_against_plain(value, shapes, loc, w, g)
    if n * q:
        plan = cuda_msda.ms_deform_attn_backward_cuda.last_plan
        assert plan == cuda_msda.msda_bwd_plan(
            d, dtype, cuda_msda.pointer_alignment(value.data_ptr()),
            cuda_msda.pointer_alignment(g.data_ptr()), shapes, q, n * m,
            cuda_msda._sm_count(value.device))
        again = cuda_msda.ms_deform_attn_backward_cuda(value, shapes, loc, w,
                                                       g)
        assert torch.equal(again[1], got[1]) and torch.equal(again[2], got[2])
        bound, _ = dvalue_order_bound(value, shapes, loc, w, g, flushes(q))
        if dtype == torch.bfloat16:
            # two f32 sums rounded to bf16: one bf16 step apart at most
            bound = bound + 2 ** -7 * got[0].float().abs()
        assert ((again[0].float() - got[0].float()).abs() <= bound).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_value_one_element_into_its_storage(cuda, dtype):
    """A value (and g) one element into its storage: scalar loads and
    atomics (V 1), within the same bounds."""
    value, loc, w, g = make_inputs(2, 30, 3, 48, 2, ((7, 9), (4, 5)), cuda)
    shifted = []
    for t in (value.to(dtype), g.to(dtype)):
        buf = torch.empty(t.numel() + 1, dtype=dtype, device=cuda)
        shifted.append(buf[1:].view(t.shape))
        shifted[-1].copy_(t)
    check_against_plain(shifted[0], ((7, 9), (4, 5)), loc, w.to(dtype),
                        shifted[1])
    assert cuda_msda.ms_deform_attn_backward_cuda.last_plan.vec == 1


@pytest.mark.cuda
def test_autograd_runs_k5_and_k7_never_the_plain_backward(cuda,
                                                          monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the plain backward ran on the card")

    monkeypatch.setattr(msda, "msda_backward_reference", refuse)
    shapes = ((6, 8), (3, 4))
    value, loc, w, g = make_inputs(2, 30, 4, 8, 2, shapes, cuda)
    leaves = [t.clone().requires_grad_() for t in (value, loc, w)]
    fwd = cuda_msda.ms_deform_attn_cuda.launches
    bwd = cuda_msda.ms_deform_attn_backward_cuda.launches
    out = ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2])
    out.backward(g)
    assert cuda_msda.ms_deform_attn_cuda.launches == fwd + 1
    assert cuda_msda.ms_deform_attn_backward_cuda.launches == bwd + 1
    want = cuda_msda.ms_deform_attn_backward_cuda(value, shapes, loc, w, g)
    assert torch.equal(leaves[1].grad, want[1])
    assert torch.equal(leaves[2].grad, want[2])


@pytest.mark.cuda
def test_bad_inputs_raise(cuda):
    shapes = ((6, 8),)
    value, loc, w, g = make_inputs(1, 5, 2, 8, 2, shapes, cuda)
    kernel = cuda_msda.ms_deform_attn_backward_cuda
    with pytest.raises(TypeError):
        kernel(value, shapes, loc, w, g.bfloat16())
    with pytest.raises(ValueError):
        kernel(value, shapes, loc, w, g[:, :, :8].contiguous())
    with pytest.raises(ValueError):
        kernel(value, shapes, loc, w, g.cpu())
    wide = torch.zeros(1, 48, 1, 65, device=cuda)
    with pytest.raises(NotImplementedError, match="channels"):
        kernel(wide, shapes, loc[:, :, :1], w[:, :, :1],
               torch.zeros(1, 5, 65, device=cuda))
