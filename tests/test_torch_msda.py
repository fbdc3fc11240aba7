"""The port's multi-scale deformable attention against fastervit_tpu's on the
CPU: `msda_reference` (K5's plain version) against JAX's `_msda_body` and
against the Pallas kernel run in interpret mode (`msda_forward_pallas`, as
tests/test_msda_pallas.py runs it), in f32 and bf16, on 1-4 levels with a
1x1 level, with locations on, just inside and far outside the borders, and
with no queries; `MSDeformAttnModule` against JAX's on the same weights,
with 2- and 4-coordinate reference points; and the dispatch of CPU
tensors to the plain version."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastervit_tpu.ops import msda as jmsda
from fastervit_tpu.ops.msda_pallas import msda_forward_pallas
from fastervit_tpu_torch.ops import cuda_msda
from fastervit_tpu_torch.ops.msda import (MSDeformAttnModule,
                                          ms_deform_attn, msda_reference)
from torch_parity import few_torch_threads  # noqa: F401

# (N, Q, M, D, P, levels)
CASES = [
    (2, 13, 2, 8, 2, ((5, 7),)),
    (1, 17, 3, 4, 3, ((6, 5), (1, 1))),
    (2, 11, 2, 8, 2, ((7, 9), (4, 5), (1, 1))),
    (1, 9, 4, 4, 4, ((8, 6), (4, 3), (2, 2), (1, 1))),
    (2, 0, 2, 8, 2, ((5, 7), (3, 4))),
]


def _inputs(n, q, m, d, p, shapes, seed):
    """value N(0, 1); locations in [-0.15, 1.15] with a third of them
    replaced by border values (0, 1, half a pixel inside an edge) and far
    outside ones (±3, ±1e6); weights softmax-normalised over L·P."""
    rng = np.random.RandomState(seed)
    s, nl = sum(h * w for h, w in shapes), len(shapes)
    value = rng.randn(n, s, m, d).astype(np.float32)
    loc = rng.uniform(-0.15, 1.15, (n, q, m, nl, p, 2)).astype(np.float32)
    wh = np.array([[w, h] for h, w in shapes], np.float32)
    edge = np.broadcast_to(0.5 / wh[None, None, None, :, None, :], loc.shape)
    special = rng.randint(0, 8, loc.shape)
    loc = np.where(special == 0, 0.0, loc)
    loc = np.where(special == 1, 1.0, loc)
    loc = np.where(special == 2, edge, loc)
    loc = np.where(special == 3, 1.0 - edge, loc)
    far = rng.choice(np.array([-3.0, 3.0, -1e6, 1e6], np.float32),
                     loc.shape)
    loc = np.where(special == 4, far, loc).astype(np.float32)
    logits = rng.randn(n, q, m, nl * p).astype(np.float32)
    w = np.exp(logits - logits.max(-1, keepdims=True))
    w = (w / w.sum(-1, keepdims=True)).reshape(n, q, m, nl, p)
    return value, loc, w.astype(np.float32)


@pytest.mark.parametrize("case", CASES,
                         ids=[f"{len(c[5])}levels_q{c[1]}" for c in CASES])
def test_reference_matches_jax_fp32(case):
    value, loc, w = _inputs(*case, seed=1)
    shapes = case[5]
    got = msda_reference(torch.from_numpy(value), shapes,
                         torch.from_numpy(loc), torch.from_numpy(w))
    assert got.shape == (case[0], case[1], case[2] * case[3])
    jv, jl, jw = map(jnp.asarray, (value, loc, w))
    want = np.asarray(jmsda._msda_body(shapes, jv, jl, jw))
    # the same ops in the same order: equal up to an ulp or two
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    if case[1]:
        pallas = np.asarray(msda_forward_pallas(shapes, jv, jl, jw,
                                                interpret=True))
        # the Pallas kernel combines the corners in another order
        np.testing.assert_allclose(got.numpy(), pallas, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", CASES[1:4],
                         ids=[f"{len(c[5])}levels" for c in CASES[1:4]])
def test_reference_matches_jax_bf16(case):
    value, loc, w = (t.astype(jnp.bfloat16) for t in _inputs(*case, seed=2))
    shapes = case[5]
    tv, tl, tw = (torch.from_numpy(np.asarray(t, np.float32)).bfloat16()
                  for t in (value, loc, w))
    got = msda_reference(tv, shapes, tl, tw)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jmsda._msda_body(shapes, value, loc, w), np.float32)
    pallas = np.asarray(msda_forward_pallas(shapes, value, loc, w,
                                            interpret=True), np.float32)
    # f32 geometry and sums on the same bf16 inputs, rounded to bf16 once:
    # at most one bf16 step (2^-8 of |x|) apart where the f32 sums straddle
    # a rounding boundary
    for other in (want, pallas):
        bound = 2 ** -8 * np.maximum(np.abs(other), 1.0)
        assert (np.abs(got.float().numpy() - other) <= bound).all()


@pytest.mark.parametrize("case", CASES[1:4],
                         ids=[f"{len(c[5])}levels" for c in CASES[1:4]])
def test_reference_f32_locations_beside_bf16_values_matches_jax(case):
    """The bf16 detector's mix: bf16 value and weights, f32 locations. The
    geometry is computed in f32 from the f32 locations, as JAX's
    `_level_geometry` does (promote(loc.dtype, f32))."""
    value, loc, w = _inputs(*case, seed=3)
    value, w = value.astype(jnp.bfloat16), w.astype(jnp.bfloat16)
    shapes = case[5]
    tv, tw = (torch.from_numpy(np.asarray(t, np.float32)).bfloat16()
              for t in (value, w))
    got = msda_reference(tv, shapes, torch.from_numpy(loc), tw)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jmsda._msda_body(shapes, value, jnp.asarray(loc), w),
                      np.float32)
    # the same f32 math, rounded to bf16 once: one bf16 step apart at most
    bound = 2 ** -8 * np.maximum(np.abs(want), 1.0)
    assert (np.abs(got.float().numpy() - want) <= bound).all()
    # the f32 locations matter: rounding them to bf16 moves samples
    rounded = msda_reference(tv, shapes, torch.from_numpy(loc).bfloat16(), tw)
    assert not torch.equal(rounded, got)


def test_bf16_module_hands_f32_locations_to_msda(monkeypatch):
    """A bf16 MSDeformAttnModule with f32 reference points (the bf16
    detector's) passes f32 sampling locations and bf16 value and weights
    to `ms_deform_attn`, as the JAX module does (msda.py:496-508)."""
    from fastervit_tpu_torch.ops import msda as tmsda
    seen = []

    def spy(value, shapes, loc, weights):
        seen.append((value.dtype, loc.dtype, weights.dtype))
        return tmsda.msda_reference(value, shapes, loc, weights)

    monkeypatch.setattr(tmsda, "ms_deform_attn", spy)
    shapes = ((6, 7), (3, 4))
    tm = MSDeformAttnModule(32, 2, 4, 2).bfloat16()
    query = torch.randn(2, 5, 32, dtype=torch.bfloat16)
    feats = torch.randn(2, 54, 32, dtype=torch.bfloat16)
    for coords in (2, 4):
        ref = torch.rand(2, 5, 2, coords)
        with torch.no_grad():
            assert tm(query, ref, feats, shapes).dtype == torch.bfloat16
    assert seen == [(torch.bfloat16, torch.float32, torch.bfloat16)] * 2


def _module_params(rng, d_model, m, nl, p):
    """Random JAX MSDeformAttnModule params (kernel (in, out), bias)."""
    def dense(i, o):
        return {"kernel": (rng.randn(i, o) / np.sqrt(i)).astype(np.float32),
                "bias": (0.1 * rng.randn(o)).astype(np.float32)}
    return {"value_proj": dense(d_model, d_model),
            "sampling_offsets": dense(d_model, m * nl * p * 2),
            "attention_weights": dense(d_model, m * nl * p),
            "output_proj": dense(d_model, d_model)}


@pytest.mark.parametrize("coords", [2, 4])
def test_module_matches_jax(coords):
    d_model, m, p = 32, 4, 3
    shapes = ((6, 7), (3, 4), (1, 1))
    nl, s = len(shapes), sum(h * w for h, w in shapes)
    rng = np.random.RandomState(coords)
    params = _module_params(rng, d_model, m, nl, p)
    query = rng.randn(2, 15, d_model).astype(np.float32)
    feats = rng.randn(2, s, d_model).astype(np.float32)
    ref = rng.uniform(0.05, 0.95, (2, 15, nl, coords)).astype(np.float32)
    jm = jmsda.MSDeformAttnModule(d_model, nl, m, p)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(query),
                               jnp.asarray(ref), jnp.asarray(feats), shapes))
    tm = MSDeformAttnModule(d_model, nl, m, p)
    tm.load_state_dict({f"{name}.{leaf}": torch.from_numpy(
        np.ascontiguousarray(v[k].T if k == "kernel" else v[k]))
        for name, v in params.items()
        for k, leaf in (("kernel", "weight"), ("bias", "bias"))})
    with torch.no_grad():
        got = tm(torch.from_numpy(query), torch.from_numpy(ref),
                 torch.from_numpy(feats), shapes)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_module_init_matches_jax():
    """The offset head's directional bias and the zero kernels."""
    shapes = ((4, 4), (2, 2))
    jm = jmsda.MSDeformAttnModule(16, 2, 4, 3)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 5, 16)),
                        jnp.zeros((1, 5, 2, 2)), jnp.zeros((1, 20, 16)),
                        shapes)["params"]
    tm = MSDeformAttnModule(16, 2, 4, 3)
    np.testing.assert_allclose(
        tm.sampling_offsets.bias.detach().numpy(),
        np.asarray(variables["sampling_offsets"]["bias"]), atol=1e-6)
    assert not tm.sampling_offsets.weight.any()
    assert not tm.attention_weights.weight.any()
    assert not tm.attention_weights.bias.any()


def test_cpu_tensors_take_the_plain_path():
    value, loc, w = (torch.from_numpy(t) for t in _inputs(*CASES[2], seed=3))
    before = cuda_msda.ms_deform_attn_cuda.launches
    got = ms_deform_attn(value, CASES[2][5], loc, w)
    assert cuda_msda.ms_deform_attn_cuda.launches == before
    assert torch.equal(got, msda_reference(value, CASES[2][5], loc, w))
    with pytest.raises(ValueError, match="cover"):
        msda_reference(value, ((7, 9), (4, 5)), loc[:, :, :, :2],
                       w[:, :, :, :2])


def test_kernel_wrapper_checks_before_the_card():
    """K5's shape checks, which run before anything needs the card."""
    shapes = ((5, 7), (3, 4))
    cuda_msda.check_supported((2, 47, 8, 32), shapes, (2, 9, 8, 2, 4, 2),
                              (2, 9, 8, 2, 4))
    with pytest.raises(NotImplementedError, match="channels"):
        cuda_msda.check_supported((2, 47, 8, 65), shapes, (2, 9, 8, 2, 4, 2),
                                  (2, 9, 8, 2, 4))
    with pytest.raises(ValueError, match="cover"):
        cuda_msda.check_supported((2, 48, 8, 32), shapes, (2, 9, 8, 2, 4, 2),
                                  (2, 9, 8, 2, 4))
    with pytest.raises(ValueError, match="must be"):
        cuda_msda.check_supported((2, 47, 8, 32), shapes, (2, 9, 8, 3, 4, 2),
                                  (2, 9, 8, 3, 4))
    with pytest.raises(ValueError):
        cuda_msda.ms_deform_attn_cuda(torch.zeros(2, 47, 8, 32), shapes,
                                      torch.zeros(2, 9, 8, 2, 4, 2),
                                      torch.zeros(2, 9, 8, 2, 4))
