"""The port's MSDA backward against fastervit_tpu's on the CPU:
`msda_backward_reference` (K7's plain version) against JAX's custom VJP
(`jax.vjp` of `ms_deform_attn` on the XLA path, whose backward is
`_msda_core_bwd`) and against autodiff through the forward
(`ms_deform_attn_autodiff`), in f32 on 1-4 levels with border and far
outside locations; in bf16 (and bf16 beside f32 locations) against JAX's
bf16 VJP; `MSDeformAttnFunction` under torch.autograd.gradcheck in f64,
and through `ms_deform_attn`; empty batches and query sets;
`dvalue_order_bound`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastervit_tpu.ops import msda as jmsda
from fastervit_tpu_torch.ops.msda import (MSDeformAttnFunction,
                                          dvalue_order_bound, ms_deform_attn,
                                          msda_backward_reference)
from torch_parity import few_torch_threads  # noqa: F401
from test_torch_msda import CASES, _inputs

# f32, relative to each tensor's largest entry: the same sums as JAX's in
# another order (index_add_ against the one-hot matmuls, einsum orders)
TOL = 1e-5


def _grad(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    top = np.abs(want).max()
    return float(np.abs(got.float().numpy() - want).max() / top) if top \
        else float(np.abs(got.float().numpy()).max())


def _jax_vjp(fn, value, loc, w, g):
    """fn's VJP at (value, loc, w) applied to g, jitted (one compile)."""
    def run(v, l_, w_, g_):
        return jax.vjp(fn, v, l_, w_)[1](g_)
    return jax.jit(run)(*map(jnp.asarray, (value, loc, w, g)))


@pytest.mark.parametrize("case", CASES[:4],
                         ids=[f"{len(c[5])}levels" for c in CASES[:4]])
def test_backward_matches_jax_fp32(case):
    n, q, m, d, p, shapes = case
    value, loc, w = _inputs(*case, seed=5)
    g = _grad((n, q, m * d), 6)
    got = msda_backward_reference(torch.from_numpy(value), shapes,
                                  torch.from_numpy(loc), torch.from_numpy(w),
                                  torch.from_numpy(g))
    # the custom VJP of the XLA path (query_chunk 0: one call)
    vjp = _jax_vjp(lambda v, l_, w_: jmsda.ms_deform_attn(
        v, shapes, l_, w_, query_chunk=0), value, loc, w, g)
    auto = _jax_vjp(lambda v, l_, w_: jmsda.ms_deform_attn_autodiff(
        v, shapes, l_, w_), value, loc, w, g)
    for name, t, want, other in zip(("dvalue", "dloc", "dweights"), got, vjp,
                                    auto):
        assert t.dtype == torch.float32 and t.shape == want.shape, name
        assert _rel(t, want) <= TOL, (name, _rel(t, want))
        assert _rel(t, other) <= TOL, (name, _rel(t, other))


def test_out_of_range_samples_have_zero_gradients():
    """Samples whose top-left corner lies outside [-1, W-1] x [-1, H-1]
    get zero dloc and dweights and add nothing to dvalue; one half a pixel
    past the edge keeps its in-range corners' share."""
    shapes = ((4, 5),)
    rng = np.random.RandomState(7)
    value = torch.from_numpy(rng.randn(1, 20, 1, 3).astype(np.float32))
    far = [(-3.0, 0.5), (0.5, 1e6), (-1e6, -1e6), (1.4, 0.5)]
    edge = [(-0.05, 0.5), (0.5, 1.05)]       # x0 = -1 or y0 = H - 1
    loc = torch.tensor(far + edge, dtype=torch.float32).reshape(
        1, 6, 1, 1, 1, 2)
    w = torch.ones(1, 6, 1, 1, 1)
    g = torch.from_numpy(rng.randn(1, 6, 3).astype(np.float32))
    dv, dl, dw = msda_backward_reference(value, shapes, loc, w, g)
    assert not dl[0, :4].abs().sum() and not dw[0, :4].abs().sum()
    assert dw[0, 4:].abs().sum() > 0 and dl[0, 4:].abs().sum() > 0
    _, _, dw_edge = msda_backward_reference(value, shapes, loc[:, 4:],
                                            w[:, 4:], g[:, 4:])
    dv_edge, _, _ = msda_backward_reference(value, shapes, loc[:, 4:],
                                            w[:, 4:], g[:, 4:])
    assert torch.equal(dv, dv_edge) and torch.equal(dw[:, 4:], dw_edge)
    vjp = _jax_vjp(lambda v, l_, w_: jmsda.ms_deform_attn(
        v, shapes, l_, w_, query_chunk=0), value.numpy(), loc.numpy(),
        w.numpy(), g.numpy())
    for t, want in zip((dv, dl, dw), vjp):
        assert _rel(t, want) <= TOL


@pytest.mark.parametrize("f32_loc", [False, True],
                         ids=["bf16", "bf16_f32_locations"])
def test_backward_matches_jax_bf16(f32_loc):
    """bf16 value, weights and g (the locations bf16 or, as the bf16
    detector hands them, f32) against JAX's bf16 VJP: f32 geometry and sums
    on the same bf16 inputs, each gradient rounded to its dtype once, so
    at most one bf16 step (2⁻⁸ relative) apart, plus the f32 order of the
    sums (TOL of the largest entry)."""
    case = CASES[3]
    n, q, m, d, p, shapes = case
    value, loc, w = _inputs(*case, seed=8)
    g = _grad((n, q, m * d), 9)
    bf = jnp.bfloat16
    jv, jw, jg = (jnp.asarray(t).astype(bf) for t in (value, w, g))
    jl = jnp.asarray(loc) if f32_loc else jnp.asarray(loc).astype(bf)
    want = _jax_vjp(lambda v, l_, w_: jmsda.ms_deform_attn(
        v, shapes, l_, w_, query_chunk=0), jv, jl, jw, jg)
    tv, tw, tg = (torch.from_numpy(np.asarray(t, np.float32)).bfloat16()
                  for t in (jv, jw, jg))
    tl = torch.from_numpy(np.array(jl, np.float32))
    if not f32_loc:
        tl = tl.bfloat16()
    got = msda_backward_reference(tv, shapes, tl, tw, tg)
    for name, t, ref in zip(("dvalue", "dloc", "dweights"), got, want):
        assert str(t.dtype).split(".")[-1] == str(ref.dtype), name
        ref = np.asarray(ref, np.float32)
        err = np.abs(t.float().numpy() - ref)
        bound = 2 ** -8 * np.abs(ref) + TOL * np.abs(ref).max()
        assert (err <= bound).all(), (name, err.max())


def test_function_gradcheck_f64():
    shapes = ((3, 4), (2, 2))
    rng = np.random.RandomState(10)
    n, q, m, d, p = 1, 3, 2, 2, 2
    value = torch.from_numpy(rng.randn(n, 16, m, d)).requires_grad_()
    # locations away from the cell borders, where the bilinear form is
    # smooth for the finite differences
    loc = torch.from_numpy(rng.uniform(0.05, 0.95, (n, q, m, 2, p, 2))
                           ).requires_grad_()
    w = torch.from_numpy(rng.rand(n, q, m, 2, p)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda v, l_, w_: MSDeformAttnFunction.apply(v, shapes, l_, w_),
        (value, loc, w), eps=1e-6, atol=1e-7, rtol=1e-5)


def test_ms_deform_attn_backward_is_the_plain_backward():
    case = CASES[2]
    n, q, m, d, p, shapes = case
    value, loc, w = _inputs(*case, seed=11)
    g = torch.from_numpy(_grad((n, q, m * d), 12))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (value, loc, w)]
    ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2]).backward(g)
    want = msda_backward_reference(leaves[0].detach(), shapes,
                                   leaves[1].detach(), leaves[2].detach(), g)
    for t, ref in zip(leaves, want):
        assert torch.equal(t.grad, ref)


@pytest.mark.parametrize("n,q", [(0, 10), (2, 0)], ids=["n0", "q0"])
def test_empty_inputs(n, q):
    shapes = ((5, 7), (3, 4))
    value, loc, w = _inputs(n, q, 2, 8, 2, shapes, seed=13)
    g = torch.zeros(n, q, 16)
    got = msda_backward_reference(torch.from_numpy(value), shapes,
                                  torch.from_numpy(loc), torch.from_numpy(w),
                                  g)
    assert [tuple(t.shape) for t in got] == [value.shape, loc.shape, w.shape]
    assert not any(t.abs().sum() for t in got)
    bound, c = dvalue_order_bound(torch.from_numpy(value), shapes,
                                  torch.from_numpy(loc), torch.from_numpy(w),
                                  g)
    assert c == 0 and bound.shape == value.shape


def test_dvalue_order_bound_counts_contributions():
    """One element reached by three samples' corners: c = 3, and the bound
    is c·2⁻²⁴ times the plain dvalue on |g| and |w|."""
    shapes = ((2, 2),)
    value = torch.zeros(1, 4, 1, 1)
    # three samples at the centre of the top-left pixel: all weight on it
    loc = torch.full((1, 3, 1, 1, 1, 2), 0.25)
    w = torch.tensor([1.0, -2.0, 0.5]).reshape(1, 3, 1, 1, 1)
    g = torch.tensor([1.0, 1.0, -1.0]).reshape(1, 3, 1)
    bound, c = dvalue_order_bound(value, shapes, loc, w, g)
    assert c == 3
    assert torch.allclose(bound.flatten(),
                          torch.tensor([3.5 * 3 * 2 ** -24, 0, 0, 0]))


@pytest.mark.parametrize("run", [7, 24, 80], ids=lambda r: f"run{r}")
def test_dvalue_order_bound_counts_run_partials(run):
    """K7's route "smem": each block sums its run's terms for a head in a
    tile, and the runs' partial sums meet in the f32 buffer. Summing each
    run of `run` (n, m, q) rows alone (the plain version's index_add_ over
    its rows) and then the partials from the last run to the first stays
    within the bound whose c counts the runs that meet a head."""
    n, q, m, d, p = 2, 40, 2, 8, 3
    shapes = ((6, 5), (3, 3), (2, 2))
    value, loc, w = (torch.from_numpy(t) for t in _inputs(
        n, q, m, d, p, shapes, seed=14))
    g = torch.from_numpy(_grad((n, q, m * d), 15))
    want = msda_backward_reference(value, shapes, loc, w, g)[0]
    rows = n * m * q
    partials, met = [], [0] * (n * m)
    for lo in range(0, rows, run):
        keep = torch.zeros(n, m, q, dtype=torch.bool)
        keep.view(-1)[lo:lo + run] = True
        for head in {r // q for r in range(lo, min(lo + run, rows))}:
            met[head] += 1
        mask = keep.permute(0, 2, 1)[..., None].expand(n, q, m, d)
        g_run = torch.where(mask.reshape(n, q, m * d), g, torch.zeros(()))
        partials.append(msda_backward_reference(value, shapes, loc, w,
                                                g_run)[0])
    got = torch.zeros_like(want)
    for part in reversed(partials):
        got = got + part
    flushes = max(met)
    bound, c = dvalue_order_bound(value, shapes, loc, w, g, flushes)
    _, c0 = dvalue_order_bound(value, shapes, loc, w, g)
    assert c == c0 + flushes
    assert ((got - want).abs() <= bound).all()
