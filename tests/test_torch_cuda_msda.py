"""K5, the multi-scale deformable attention kernel, against its plain
PyTorch version on the card. Every test here needs a CUDA device and skips
without one. On a machine with an H100 (which need not have jax, so
tests/conftest.py is not loaded):

    python -m pytest --noconftest -q tests/test_torch_cuda_msda.py
"""
import numpy as np
import pytest
import torch

from fastervit_tpu_torch.ops import cuda_msda
from fastervit_tpu_torch.ops.cuda_msda import msda_plan, pointer_alignment
from fastervit_tpu_torch.ops.msda import (MSDeformAttnModule,
                                          ms_deform_attn, msda_reference)

# DINO-4scale on an 800x1333 canvas: the four levels' (H, W)
SERVED = ((100, 167), (50, 84), (25, 42), (13, 21))
# (N, Q, M, D, P, levels): the served encoder (Q = S) and decoder calls at
# batch 2, then odd shapes: narrow and wide heads, a 1x1 level, one level,
# many points, and empty batches and query sets; between them they reach
# every group size of K5's plans (`cuda_msda.msda_plan`: D 1, 4, 8, 16, 24,
# 32, 33, 48, 64), a row's samples fewer than, and not a multiple of, its
# group's lanes, and rows that do not fill a block
CASES = [
    (2, 22223, 8, 32, 4, SERVED),
    (2, 900, 8, 32, 4, SERVED),
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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def make_inputs(n, q, m, d, p, shapes, device, seed=0):
    """value N(0, 1); locations mostly in [-0.1, 1.1], a quarter of them
    on the borders (0, 1, and half a pixel inside each edge) and far
    outside (±10, ±1e9); weights softmax-normalised over L·P."""
    rng = np.random.RandomState(seed)
    s, nl = sum(h * w for h, w in shapes), len(shapes)
    value = rng.randn(n, s, m, d).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, (n, q, m, nl, p, 2)).astype(np.float32)
    special = np.array([0.0, 1.0, -10.0, 10.0, -1e9, 1e9], np.float32)
    pick = rng.rand(*loc.shape) < 0.25
    loc[pick] = special[rng.randint(0, len(special), pick.sum())]
    wh = np.array([[w, h] for h, w in shapes], np.float32)
    half = rng.rand(*loc.shape) < 0.1    # half a pixel inside an edge
    edge = np.broadcast_to(0.5 / wh[None, None, None, :, None, :], loc.shape)
    loc[half] = np.where(rng.rand(half.sum()) < 0.5, edge[half],
                         1 - edge[half])
    logits = rng.randn(n, q, m, nl * p).astype(np.float32)
    w = np.exp(logits - logits.max(-1, keepdims=True))
    w = (w / w.sum(-1, keepdims=True)).reshape(n, q, m, nl, p)
    return [torch.from_numpy(t).to(device) for t in (value, loc, w)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,q,m,d,p,shapes", CASES)
def test_kernel_fp32_matches_plain(cuda, n, q, m, d, p, shapes):
    value, loc, w = make_inputs(n, q, m, d, p, shapes, cuda)
    before = cuda_msda.ms_deform_attn_cuda.launches
    got = cuda_msda.ms_deform_attn_cuda(value, shapes, loc, w)
    want = msda_reference(value, shapes, loc, w)
    torch.cuda.synchronize()
    assert got.shape == (n, q, m * d) and got.dtype == torch.float32
    assert cuda_msda.ms_deform_attn_cuda.launches == before + int(n * q > 0)
    if n * q:
        assert cuda_msda.ms_deform_attn_cuda.last_plan == msda_plan(
            d, torch.float32, pointer_alignment(value.data_ptr()))
        # f32 throughout; only the order of the sums differs
        assert (got - want).abs().max().item() <= 1e-5
        again = cuda_msda.ms_deform_attn_cuda(value, shapes, loc, w)
        assert torch.equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("n,q,m,d,p,shapes", CASES)
def test_kernel_bf16_matches_plain(cuda, n, q, m, d, p, shapes):
    value, loc, w = (t.bfloat16() for t in make_inputs(n, q, m, d, p,
                                                        shapes, cuda, 1))
    got = cuda_msda.ms_deform_attn_cuda(value, shapes, loc, w)
    assert got.dtype == torch.bfloat16 and got.shape == (n, q, m * d)
    if n * q:
        want = msda_reference(value.float(), shapes, loc.float(), w.float())
        # the same f32 math on the same bf16 inputs, rounded to bf16 once
        bound = 2 ** -8 * max(1.0, want.abs().max().item())
        assert (got.float() - want).abs().max().item() <= bound
        assert torch.equal(msda_reference(value, shapes, loc, w).float(),
                           want.bfloat16().float())


@pytest.mark.cuda
@pytest.mark.parametrize("n,q,m,d,p,shapes", CASES)
def test_kernel_bf16_value_f32_locations_matches_plain(cuda, n, q, m, d, p,
                                                       shapes):
    """The bf16 detector's mix, as the JAX package's: bf16 value and
    weights, f32 sampling locations."""
    value, loc, w = make_inputs(n, q, m, d, p, shapes, cuda, 2)
    value, w = value.bfloat16(), w.bfloat16()
    got = cuda_msda.ms_deform_attn_cuda(value, shapes, loc, w)
    assert got.dtype == torch.bfloat16 and got.shape == (n, q, m * d)
    if n * q:
        plan = cuda_msda.ms_deform_attn_cuda.last_plan
        assert plan == msda_plan(d, torch.bfloat16,
                                 pointer_alignment(value.data_ptr()))
        if d % 2 == 0:  # the served form loads vectors
            assert plan.vec > 1
        want = msda_reference(value.float(), shapes, loc, w.float())
        # the same f32 math on the same inputs, rounded to bf16 once
        bound = 2 ** -8 * max(1.0, want.abs().max().item())
        assert (got.float() - want).abs().max().item() <= bound
        assert torch.equal(msda_reference(value, shapes, loc, w).float(),
                           want.bfloat16().float())
        again = cuda_msda.ms_deform_attn_cuda(value, shapes, loc, w)
        assert torch.equal(again, got)


def _at_element_offset(t):
    """A contiguous copy of t whose address is one element past an
    allocation's (so aligned to the element alone)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("n,q,m,d,p,shapes", [c for c in CASES
                                              if c[0] * c[1] and c[1] < 2000])
def test_value_at_an_odd_element_offset(cuda, dtype, n, q, m, d, p, shapes):
    """A value that is a view one element into its storage runs on scalar
    loads (V 1), and gives the aligned launch's bits, since each lane sums
    its channels in the same order whatever the plan."""
    value, loc, w = make_inputs(n, q, m, d, p, shapes, cuda, 3)
    value, w = value.to(dtype), w.to(dtype)
    shifted = _at_element_offset(value)
    assert pointer_alignment(shifted.data_ptr()) == dtype.itemsize
    got = cuda_msda.ms_deform_attn_cuda(shifted, shapes, loc, w)
    plan = cuda_msda.ms_deform_attn_cuda.last_plan
    assert plan == msda_plan(d, dtype, dtype.itemsize) and plan.vec == 1
    aligned = cuda_msda.ms_deform_attn_cuda(value, shapes, loc, w)
    assert torch.equal(got, aligned)
    want = msda_reference(value.float(), shapes, loc, w.float())
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-5
    else:
        bound = 2 ** -8 * max(1.0, want.abs().max().item())
        assert (got.float() - want).abs().max().item() <= bound


# plans the C entry point refuses, each beside the value it is given: a
# D 32 bf16 value aligned to 16 bytes, or one element into its storage
WRONG_PLANS = [
    ((4, 8, 8, 8, 8), True),    # 16-byte loads from a 2-byte-aligned value
    ((4, 4, 4, 8, 8), False),   # 4 lanes of 4 channels: 16 of D's 32
    ((2, 8, 16, 16, 8), False),  # two lanes a row: no instance runs it
    ((4, 8, 8, 8, 9), False),   # nine warps a block, past kMaxWarps
    ((4, 8, 8, 4, 8), False),   # 4 lanes, 4 rows: not a whole warp
]


@pytest.mark.cuda
@pytest.mark.parametrize("plan,shifted", WRONG_PLANS)
def test_kernel_refuses_a_plan_it_cannot_run(cuda, plan, shifted,
                                             monkeypatch):
    """The C entry point checks the plan it is handed and refuses one that
    no instance runs on these pointers: the call raises, and counts no
    launch."""
    n, q, m, d, p, shapes = CASES[1]
    value, loc, w = make_inputs(n, q, m, d, p, shapes, cuda, 4)
    value, w = value.bfloat16(), w.bfloat16()
    if shifted:
        value = _at_element_offset(value)
    kernel = cuda_msda.ms_deform_attn_cuda
    kernel(value, shapes, loc, w)
    before = kernel.launches
    monkeypatch.setattr(cuda_msda, "msda_plan",
                        lambda *_: cuda_msda.MsdaPlan(*plan))
    with pytest.raises(RuntimeError, match="msda_forward"):
        kernel(value, shapes, loc, w)
    assert kernel.launches == before


@pytest.mark.cuda
def test_dispatch_and_module_launch_kernel(cuda):
    shapes = ((6, 8), (3, 4))
    value, loc, w = make_inputs(2, 30, 4, 8, 2, shapes, cuda)
    before = cuda_msda.ms_deform_attn_cuda.launches
    out = ms_deform_attn(value, shapes, loc, w)
    assert cuda_msda.ms_deform_attn_cuda.launches == before + 1
    assert out.shape == (2, 30, 32) and out.device.type == "cuda"
    attn = MSDeformAttnModule(32, 2, 4, 2).to(cuda)
    ref = torch.rand(2, 30, 2, 4, device=cuda)
    with torch.no_grad():
        y = attn(torch.randn(2, 30, 32, device=cuda), ref,
                 torch.randn(2, 60, 32, device=cuda), shapes)
    assert cuda_msda.ms_deform_attn_cuda.launches == before + 2
    assert y.shape == (2, 30, 32) and bool(torch.isfinite(y).all())


@pytest.mark.cuda
def test_inputs_that_need_a_gradient_raise(cuda):
    """K5 called alone on inputs that need a gradient raises (its output
    would drop it); through ms_deform_attn they reach K5 and then K7."""
    shapes = ((6, 8),)
    value, loc, w = make_inputs(1, 5, 2, 8, 2, shapes, cuda)
    with pytest.raises(ValueError, match="gradient"):
        cuda_msda.ms_deform_attn_cuda(value.requires_grad_(), shapes, loc, w)
    bwd = cuda_msda.ms_deform_attn_backward_cuda.launches
    ms_deform_attn(value, shapes, loc, w).sum().backward()
    assert cuda_msda.ms_deform_attn_backward_cuda.launches == bwd + 1
    assert value.grad is not None and value.grad.shape == value.shape
    with torch.no_grad():
        assert ms_deform_attn(value, shapes, loc, w).shape == (1, 5, 16)


@pytest.mark.cuda
def test_bad_inputs_raise(cuda):
    shapes = ((6, 8),)
    value, loc, w = make_inputs(1, 5, 2, 8, 2, shapes, cuda)
    # the mixes K5 refuses: bf16 locations beside f32 values, weights in
    # another dtype than the value's, half precision; it names what it takes
    with pytest.raises(TypeError, match="float32 locations"):
        ms_deform_attn(value, shapes, loc.bfloat16(), w)
    with pytest.raises(TypeError, match="float32 locations"):
        ms_deform_attn(value.bfloat16(), shapes, loc, w)
    with pytest.raises(TypeError):
        ms_deform_attn(value.half(), shapes, loc.half(), w.half())
    assert ms_deform_attn(value.bfloat16(), shapes, loc,
                          w.bfloat16()).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="cover"):
        ms_deform_attn(value, ((6, 7),), loc, w)
    with pytest.raises(ValueError):
        ms_deform_attn(value, shapes, loc.cpu(), w)
    with pytest.raises(ValueError):
        ms_deform_attn(value, shapes, loc.transpose(1, 2).contiguous()
                       .transpose(1, 2), w)
    wide = torch.zeros(1, 48, 1, 65, device=cuda)
    with pytest.raises(NotImplementedError, match="channels"):
        ms_deform_attn(wide, shapes, loc[:, :, :1], w[:, :, :1])
