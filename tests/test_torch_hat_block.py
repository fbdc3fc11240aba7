"""The port's fused HAT sub-block against fastervit_tpu's on the CPU:
`hat_block_reference` and `fused_hat_block` (whose CPU path is the plain
version) against JAX's `hat_block_reference` and `fused_hat_block` run in
interpret mode (as tests/test_fused_block.py runs it), in f32 and bf16;
the DropPath entry point `fused_hat_block_dp` and the gradients of both
against JAX's; the weights bridge `hat_params_from_jax`; the A&S GELU; the
model's routing behind `set_fused_hat` against JAX's narrow model; and which
HAT sub-blocks of the 22 variants `fused_block_supported` admits, beside
JAX's predicate."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import fastervit_tpu as jfvt
from fastervit_tpu.models import layers as jlayers
from fastervit_tpu.ops import pallas_hat_block as jhb
import fastervit_tpu_torch as fvt
from fastervit_tpu_torch.models import layers
from fastervit_tpu_torch.ops import cuda_hat_block
from fastervit_tpu_torch.ops import hat_block as hb
from fastervit_tpu_torch.utils.convert import hat_params_from_jax
from torch_parity import (few_torch_threads, nchw,  # noqa: F401
                          port_state_dict, random_variables)

SHAPES = [(8, 53, 4, 128), (4, 16, 8, 128), (8, 49, 2, 64)]
TOL = 2e-5        # f32 on both sides, sums in another order
TOL_GRAD = 1e-4   # tests/test_fused_block.py's bound on the gradients


def _make(b, s, h, c, seed=0):
    """tests/test_fused_block.py::_make's inputs, as numpy."""
    rng = np.random.RandomState(seed)
    hidden = 4 * c
    f32 = np.float32
    x = (rng.randn(b, s, c) * 0.5).astype(f32)
    params = {
        "ln1_scale": (rng.rand(c) + 0.5).astype(f32),
        "ln1_bias": (rng.randn(c) * 0.1).astype(f32),
        "qkv_w": (rng.randn(c, 3 * c) * 0.05).astype(f32),
        "qkv_b": (rng.randn(3 * c) * 0.05).astype(f32),
        "proj_w": (rng.randn(c, c) * 0.05).astype(f32),
        "proj_b": (rng.randn(c) * 0.05).astype(f32),
        "gamma3": rng.rand(c).astype(f32),
        "ln2_scale": (rng.rand(c) + 0.5).astype(f32),
        "ln2_bias": (rng.randn(c) * 0.1).astype(f32),
        "fc1_w": (rng.randn(c, hidden) * 0.05).astype(f32),
        "fc1_b": (rng.randn(hidden) * 0.05).astype(f32),
        "fc2_w": (rng.randn(hidden, c) * 0.05).astype(f32),
        "fc2_b": (rng.randn(c) * 0.05).astype(f32),
        "gamma4": rng.rand(c).astype(f32),
    }
    bias = rng.randn(h, s, s).astype(f32)
    return x, params, bias


def _jax(params, dtype=jnp.float32):
    """JAX's dict as its model hands it over: matrices in the compute
    dtype, vectors f32."""
    return {k: jnp.asarray(v, dtype if k in hb.MATRICES else jnp.float32)
            for k, v in params.items()}


def _close(got: torch.Tensor, want, tol: float, what: str = "") -> None:
    want = np.asarray(want, np.float32)
    err = np.abs(got.detach().float().numpy() - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (what, err)


@pytest.mark.parametrize("b,s,h,c", SHAPES)
@pytest.mark.parametrize("fn", ["reference", "fused"])
def test_fp32_matches_jax(b, s, h, c, fn):
    x, params, bias = _make(b, s, h, c)
    scale = (c // h) ** -0.5
    tp = hat_params_from_jax(params)
    tx, tb = torch.from_numpy(x), torch.from_numpy(bias)
    if fn == "reference":
        want = jhb.hat_block_reference(jnp.asarray(x), _jax(params),
                                       jnp.asarray(bias), h, scale)
        got = hb.hat_block_reference(tx, tp, tb, h, scale, attn_impl="plain")
        _close(hb.hat_block_reference(tx, tp, tb, h, scale), want, TOL)
    else:
        want = jhb.fused_hat_block(jnp.asarray(x), _jax(params),
                                   jnp.asarray(bias), h, scale, True)
        got = hb.fused_hat_block(tx, tp, tb, h, scale)
    assert got.dtype == torch.float32 and got.shape == (b, s, c)
    _close(got, want, TOL)


@pytest.mark.parametrize("b,s,h,c", SHAPES)
def test_bf16_matches_jax(b, s, h, c):
    """bf16 x and matrices, f32 vectors and bias, as the bf16 model hands
    them over. The plain versions round at the same places (each product
    to bf16 before its f32 bias, then the sum), so they differ only where
    a sum in another order rounds to the other bf16 neighbour: a step of
    2^-8 relative in a rounded intermediate, here up to 2^-7 of the
    output's scale. JAX's kernel does not round the product before its
    bias (pallas_hat_block.py:73-77, :91-94, :108-112): that is one more
    bf16 step at qkv, ctx, proj, h1 and fc2, 2^-6 of the output's scale."""
    x, params, bias = _make(b, s, h, c, seed=1)
    scale = (c // h) ** -0.5
    jx, jp = jnp.asarray(x, jnp.bfloat16), _jax(params, jnp.bfloat16)
    tp = {k: v.bfloat16() if k in hb.MATRICES else v
          for k, v in hat_params_from_jax(params).items()}
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16()
    got = hb.fused_hat_block(tx, tp, torch.from_numpy(bias), h, scale)
    assert got.dtype == torch.bfloat16
    ref = jhb.hat_block_reference(jx, jp, jnp.asarray(bias), h, scale)
    assert ref.dtype == jnp.bfloat16
    _close(got, ref.astype(jnp.float32), 2 ** -7, "vs JAX's reference")
    kernel = jhb.fused_hat_block(jx, jp, jnp.asarray(bias), h, scale, True)
    _close(got, kernel.astype(jnp.float32), 2 ** -6, "vs JAX's kernel")


def _torch_grads(fn, x, params, bias, dps, g):
    leaves = ([torch.from_numpy(x), torch.from_numpy(bias)]
              + [hat_params_from_jax(params)[k] for k in hb.PARAM_ORDER]
              + [torch.from_numpy(d) for d in dps])
    leaves = [t.clone().requires_grad_() for t in leaves]
    tx, tb, *rest = leaves
    out = fn(tx, dict(zip(hb.PARAM_ORDER, rest[:14])), tb, *rest[14:])
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), leaves)
    dx, dbias, *rest = grads
    return out, dx, dict(zip(hb.PARAM_ORDER, rest[:14])), dbias, rest[14:]


def _check_grads(got, want_x, want_p, want_bias):
    _, dx, dparams, dbias, _ = got
    _close(dx, want_x, TOL_GRAD, "x")
    _close(dbias, want_bias, TOL_GRAD, "bias")
    for k in hb.PARAM_ORDER:
        w = np.asarray(want_p[k])
        _close(dparams[k], w.T if k in hb.MATRICES else w, TOL_GRAD, k)


def test_gradients_match_jax():
    x, params, bias = _make(4, 16, 2, 64)
    h, scale = 2, 32 ** -0.5
    g = np.random.RandomState(5).randn(4, 16, 64).astype(np.float32)
    want = jax.grad(lambda x, p, b: jnp.sum(
        jhb.fused_hat_block(x, p, b, h, scale, True) * g),
        argnums=(0, 1, 2))(jnp.asarray(x), _jax(params), jnp.asarray(bias))
    got = _torch_grads(lambda x, p, b: hb.fused_hat_block(x, p, b, h, scale),
                       x, params, bias, [], g)
    _check_grads(got, *want)


def test_dp_forward_and_gradients_match_jax():
    """Per-row residual scales with zeros in them: the forward and the
    gradients of x, every param, the bias and dp1, dp2 against JAX's
    `fused_hat_block_dp` in interpret mode."""
    b, s, h, c = 8, 16, 2, 64
    x, params, bias = _make(b, s, h, c)
    scale = (c // h) ** -0.5
    rng = np.random.RandomState(7)
    keep = 0.8
    dp1, dp2 = (((rng.rand(b) < keep) / keep).astype(np.float32)
                for _ in range(2))
    assert (dp1 == 0).any() or (dp2 == 0).any()
    g = rng.randn(b, s, c).astype(np.float32)
    args = (jnp.asarray(x), _jax(params), jnp.asarray(bias),
            jnp.asarray(dp1), jnp.asarray(dp2))
    fwd = jhb.fused_hat_block_dp(*args, h, scale, True)
    want = jax.grad(lambda x, p, bb, d1, d2: jnp.sum(
        jhb.fused_hat_block_dp(x, p, bb, d1, d2, h, scale, True) * g),
        argnums=(0, 1, 2, 3, 4))(*args)
    got = _torch_grads(lambda x, p, bb, d1, d2: hb.fused_hat_block_dp(
        x, p, bb, d1, d2, h, scale), x, params, bias, [dp1, dp2], g)
    _close(got[0], fwd, TOL, "forward")
    _check_grads(got, *want[:3])
    for dgot, dwant, name in zip(got[4], want[3:], ("dp1", "dp2")):
        _close(dgot, dwant, TOL_GRAD, name)


def test_hat_params_from_jax_round_trips():
    _, params, _ = _make(2, 16, 2, 64)
    tp = hat_params_from_jax(params)
    assert set(tp) == set(hb.PARAM_ORDER)
    for k, v in params.items():
        back = tp[k].numpy().T if k in hb.MATRICES else tp[k].numpy()
        assert back.dtype == np.float32 and np.array_equal(back, v), k
        if k in hb.MATRICES:
            assert tp[k].is_contiguous()
    bf = hat_params_from_jax(_jax(params, jnp.bfloat16))
    assert bf["qkv_w"].dtype == torch.bfloat16
    assert bf["qkv_b"].dtype == torch.float32
    assert torch.equal(bf["fc1_w"].T.float(), torch.from_numpy(np.array(
        jnp.asarray(params["fc1_w"], jnp.bfloat16).astype(jnp.float32))))


def test_as_gelu_matches_exact_gelu():
    """0.5·x·erf differs from the exact GELU by 0.5·|x| times A&S's erf
    error (< 1.5e-7): within 2e-7 of max(1, |x|) (2.1e-7 at x = -3.08 in
    f64). In f32 the port's and JAX's agree to an ulp or two."""
    x = torch.linspace(-8, 8, 200001, dtype=torch.float64)
    err = ((hb._gelu(x) - F.gelu(x)).abs() / x.abs().clamp(min=1)).max()
    assert err.item() <= 2e-7, err.item()
    np.testing.assert_allclose(
        hb._gelu(x.float()).numpy(),
        np.asarray(jhb._gelu(jnp.asarray(x.float().numpy()))), rtol=0,
        atol=5e-7)


NARROW = dict(depths=[1, 1, 2, 1], num_heads=[1, 2, 4, 8], dim=32, in_dim=16,
              num_classes=10, layer_scale=1e-5, do_propagation=True)


def test_set_fused_hat_defaults_off_and_returns_previous():
    assert layers._FUSED_HAT is False
    assert fvt.set_fused_hat(True) is False
    try:
        assert layers._FUSED_HAT is True
        assert fvt.set_fused_hat(True) is True
    finally:
        assert fvt.set_fused_hat(False) is True
    assert layers._FUSED_HAT is False


@pytest.mark.parametrize("resolution", [112, 224])
def test_model_fused_matches_jax(resolution, monkeypatch):
    """JAX's narrow model of tests/test_fused_block.py (attn_impl pallas,
    the fused block on, interpret mode) against the port's with the switch
    on, on the same weights; and the port's switch on against off. At 112
    the level-2 windows have no carriers (3 sub-blocks); at 224 they do
    (5: 2 carrier, 2 joint, 1 at level 3)."""
    kw = dict(NARROW, resolution=resolution)
    jm = jfvt.create_model("faster_vit_0_224", attn_impl="pallas", **kw)
    shapes = jax.eval_shape(lambda: jm.module.init(jax.random.PRNGKey(0),
                                                   jm.dummy_input()))
    variables = random_variables(shapes, seed=21)
    x = np.random.RandomState(22).randn(2, resolution, resolution,
                                        3).astype(np.float32)
    prev = jlayers.set_fused_hat(True)
    try:
        want = np.asarray(jm.module.apply(variables, x))
    finally:
        jlayers.set_fused_hat(prev)
    tm = fvt.create_model("faster_vit_0_224", device="cpu", **kw)
    tm.load_state_dict(port_state_dict(variables), strict=True)
    tm.eval()
    routed = []
    fused = layers.fused_hat_block
    monkeypatch.setattr(layers, "fused_hat_block",
                        lambda *a: routed.append(a[0].shape) or fused(*a))
    with torch.no_grad():
        off = tm(nchw(x))
        assert not routed
        prev = fvt.set_fused_hat(True)
        try:
            on = tm(nchw(x))
        finally:
            fvt.set_fused_hat(prev)
    assert len(routed) == (3 if resolution == 112 else 5)
    np.testing.assert_allclose(on.numpy(), want, atol=5e-5, rtol=1e-4)
    np.testing.assert_allclose(on.numpy(), off.numpy(), atol=5e-5, rtol=1e-4)


# Sub-blocks of one forward at batch 256 and the default resolution, as
# (all, admitted by JAX's fused_block_supported in bf16, admitted by the
# port's). The port's predicate is K6's own limits (S <= 64, hd <= 64, the
# shared-memory plan); JAX's is TPU VMEM (weights <= 8 MB, activations).
# They differ where:
#  - any_res carriers (S 216 or 180): JAX admits (fv0-2); K6 takes S <= 64;
#  - level 3 of fv1 and fv2 (C 640, 768): over JAX's 8 MB of weights; K6
#    streams the weights from L2 and takes them;
#  - fv4_224 and fv4_any_res (C 784, hd 49): the same, for the carrier and
#    joint sub-blocks; K6 fits their windows' f32 residual in shared memory.
# Both refuse level 3 of fv3-6 (C >= 1024), fv5-6 (C 1280) and every
# 21k variant (S >= 144 at levels 2 and 3 from 384 up; C 784 with S 196 at
# 224).
ADMITTED = {
    "faster_vit_0_224": (17, 17, 17),
    "faster_vit_0_any_res": (17, 17, 11),
    "faster_vit_1_224": (21, 16, 21),
    "faster_vit_1_any_res": (21, 16, 13),
    "faster_vit_2_224": (21, 16, 21),
    "faster_vit_2_any_res": (21, 16, 13),
    "faster_vit_3_224": (29, 24, 24),
    "faster_vit_3_any_res": (29, 12, 12),
    "faster_vit_4_21k_224": (17, 0, 0),
    "faster_vit_4_21k_224_any_res": (17, 0, 0),
    "faster_vit_4_21k_384": (17, 0, 0),
    "faster_vit_4_21k_384_any_res": (17, 0, 0),
    "faster_vit_4_21k_512": (17, 0, 0),
    "faster_vit_4_21k_512_any_res": (17, 0, 0),
    "faster_vit_4_21k_768": (17, 0, 0),
    "faster_vit_4_21k_768_any_res": (17, 0, 0),
    "faster_vit_4_224": (29, 0, 24),
    "faster_vit_4_any_res": (29, 0, 12),
    "faster_vit_5_224": (29, 0, 0),
    "faster_vit_5_any_res": (29, 0, 0),
    "faster_vit_6_224": (40, 0, 0),
    "faster_vit_6_any_res": (40, 0, 0),
}


@pytest.mark.parametrize("name", sorted(ADMITTED))
def test_admission_beside_jax(name, monkeypatch):
    """Every HAT sub-block of a bf16 forward of `name` (traced, not run),
    through both predicates."""
    assert sorted(ADMITTED) == sorted(jfvt.list_models())
    seen = []
    jax_pred = jhb.fused_block_supported

    def record(x_shape, params, num_heads=0):
        ok = jax_pred(x_shape, params, num_heads)
        seen.append((tuple(x_shape), params["fc1_w"].shape[1], num_heads,
                     ok))
        return False

    monkeypatch.setattr(jhb, "fused_block_supported", record)
    jm = jfvt.create_model(name, attn_impl="pallas", dtype=jnp.bfloat16)
    shapes = jax.eval_shape(lambda: jm.module.init(jax.random.PRNGKey(0),
                                                   jm.dummy_input()))
    x = jax.ShapeDtypeStruct((256,) + tuple(jm.dummy_input().shape[1:]),
                             jnp.float32)
    prev = jlayers.set_fused_hat(True)
    try:
        seen.clear()
        jax.eval_shape(jm.module.apply, shapes, x)
    finally:
        jlayers.set_fused_hat(prev)
    port = [hb.fused_block_supported(s, s[2], hidden, heads)
            for s, hidden, heads, _ in seen]
    counts = (len(seen), sum(ok for *_, ok in seen), sum(port))
    assert counts == ADMITTED[name], (name, counts, seen)


# K6's launch plan: (B, S, H, C, bf16) -> (route, whole windows a block).
# FasterViT-0's batch-256 sites in bf16 all run on the tensor cores (wgmma),
# the carriers two windows a block so that 128 blocks fill the card; f32 and
# widths that are not multiples of 32 take scalar FMA; a small batch gives
# one window a block on the tensor cores.
PLANS = [((256, 16, 8, 256, True), ("wgmma", 2)),
         ((1024, 53, 8, 256, True), ("wgmma", 1)),
         ((256, 49, 16, 512, True), ("wgmma", 1)),
         ((256, 49, 16, 512, False), ("scalar", 1)),
         ((2, 16, 8, 256, True), ("wgmma", 1)),
         ((3, 49, 4, 196, True), ("scalar", 1))]


@pytest.mark.parametrize("shape,want", PLANS)
def test_k6_plan(shape, want):
    b, s, h, c, bf16 = shape
    plan = cuda_hat_block.plan(b, s, c, 4 * c, h, bf16)
    assert (plan.route, plan.windows_per_block) == want
    assert plan.smem_bytes == cuda_hat_block._smem(
        s, c, h, plan.windows_per_block, plan.route, plan.stages)
    assert plan.smem_bytes <= cuda_hat_block.SMEM_LIMIT
    assert plan.tensor_cores == (want[0] == "wgmma")
    assert (plan.stages >= cuda_hat_block.MIN_STAGES if plan.tensor_cores
            else plan.stages == 0)
    assert hb.fused_block_supported((b, s, c), c, 4 * c, h)
