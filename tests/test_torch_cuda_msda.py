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
from fastervit_tpu_torch.ops.msda import (MSDeformAttnModule,
                                          ms_deform_attn, msda_reference)

# DINO-4scale on an 800x1333 canvas: the four levels' (H, W)
SERVED = ((100, 167), (50, 84), (25, 42), (13, 21))
# (N, Q, M, D, P, levels): the served encoder (Q = S) and decoder calls at
# batch 2, then odd shapes: narrow and wide heads, a 1x1 level, one level,
# many points, and empty batches and query sets
CASES = [
    (2, 22223, 8, 32, 4, SERVED),
    (2, 900, 8, 32, 4, SERVED),
    (1, 37, 3, 4, 2, ((5, 7), (1, 1), (3, 2))),
    (2, 50, 2, 8, 3, ((9, 4), (1, 1))),
    (1, 64, 4, 64, 4, ((12, 17), (6, 9), (3, 5), (2, 3))),
    (3, 41, 5, 33, 1, ((7, 7),)),
    (1, 19, 2, 16, 20, ((6, 5), (3, 3))),
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
    shapes = ((6, 8),)
    value, loc, w = make_inputs(1, 5, 2, 8, 2, shapes, cuda)
    with pytest.raises(NotImplementedError, match="backward"):
        ms_deform_attn(value.requires_grad_(), shapes, loc, w)
    with torch.no_grad():
        assert ms_deform_attn(value, shapes, loc, w).shape == (1, 5, 16)


@pytest.mark.cuda
def test_bad_inputs_raise(cuda):
    shapes = ((6, 8),)
    value, loc, w = make_inputs(1, 5, 2, 8, 2, shapes, cuda)
    with pytest.raises(TypeError):
        ms_deform_attn(value, shapes, loc.bfloat16(), w)
    with pytest.raises(TypeError):
        ms_deform_attn(value.half(), shapes, loc.half(), w.half())
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
