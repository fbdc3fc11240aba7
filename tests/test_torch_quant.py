"""The port's int8 serving path (fastervit_tpu_torch/ops/quant.py,
create_model(quantized=True)) against fastervit_tpu/ops/quant.py on the
CPU: the weight bits, the int32 accumulations of the dense and conv
products (padded where cuBLASLt's shape rules ask), the percentile scales
and the port's quantile past torch.quantile's 2^24 limit, the set of
quantised layers, the bridge of JAX's quantised variables, and a tiny
model's logits against `quantized_call`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastervit_tpu import create_model as jax_create_model
from fastervit_tpu.ops import quant as jq
from fastervit_tpu_torch import create_model, set_act_clip_percentile
from fastervit_tpu_torch.ops import quant
from fastervit_tpu_torch.utils.convert import (quantized_state_dict_from_jax,
                                               state_dict_from_jax)
from torch_parity import (few_torch_threads, nchw,  # noqa: F401
                          random_variables)

# widths that are no multiple of 8 (36, 72, 144, 288; the stem's second
# conv has k = 20·9 = 180), so that every product pads k or n; at 64x64
# and batch 1, level 3's windows hold 4 tokens and its products pad rows
ODD = dict(depths=[1, 1, 1, 1], dim=36, in_dim=20, num_heads=[2, 2, 4, 4],
           resolution=64, num_classes=10)


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / max(1.0, float(np.abs(np.asarray(want)).max())))


def _jax_acc_dense(x, kq, p):
    """JAX int8_dense's int32 accumulation (quant.py:141-148)."""
    xs = jq._act_scale(jnp.abs(x), -1, p)
    xq = jnp.clip(jnp.round(x / xs), -127, 127).astype(jnp.int8)
    return np.asarray(jax.lax.dot_general(
        xq, kq, (((xq.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))


def _jax_acc_conv(x, kq, stride, p):
    """JAX int8_conv's int32 accumulation (quant.py:161-168)."""
    xs = jq._act_scale(jnp.abs(x), None, p)
    xq = jnp.clip(jnp.round(x / xs), -127, 127).astype(jnp.int8)
    return np.asarray(jax.lax.conv_general_dilated(
        xq, kq, (stride, stride), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))


@pytest.mark.parametrize("shape", [(96, 80), (3, 3, 20, 36)],
                         ids=["linear", "hwio_conv"])
def test_quantize_kernel_matches_jax_bits(shape):
    """Bit-equal int8 values and equal scales (f32 division and
    round-half-to-even on both sides)."""
    w = (np.random.RandomState(0).randn(*shape) * 0.05).astype(np.float32)
    kq, ks = jq.quantize_kernel(jnp.asarray(w))
    port_w = w.T if w.ndim == 2 else w.transpose(3, 2, 0, 1)
    tq, ts = quant.quantize_kernel(torch.from_numpy(port_w.copy()))
    want = np.asarray(kq).T if w.ndim == 2 else \
        np.asarray(kq).transpose(3, 2, 0, 1)
    assert tq.dtype == torch.int8 and np.array_equal(tq.numpy(), want)
    assert np.array_equal(ts.numpy(), np.asarray(ks))


@pytest.mark.parametrize("p", [None, 99.9], ids=["max", "p99.9"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("rows,k,n", [(4 * 37, 96, 80), (5, 100, 36)])
def test_int8_dense_matches_jax(rows, k, n, bias, p):
    """The int32 accumulations equal JAX's, the outputs within 1e-6 of the
    largest (both eager: the same f32 operations; (5, 100, 36) pads rows to
    17, k to 104 and n to 40)."""
    rs = np.random.RandomState(1)
    x = rs.randn(rows, k).astype(np.float32)
    w = (rs.randn(k, n) * 0.05).astype(np.float32)
    b = (rs.randn(n) * 0.01).astype(np.float32) if bias else None
    kq, ks = jq.quantize_kernel(jnp.asarray(w))
    tq, ts = quant.quantize_kernel(torch.from_numpy(w.T.copy()))
    acc, _, xq = quant.int8_dense_acc(torch.from_numpy(x), tq, p)
    assert np.array_equal(acc.numpy(), _jax_acc_dense(jnp.asarray(x), kq, p))
    assert torch.equal(acc, quant.int_mm_reference(xq, tq.t()))
    want = jq.int8_dense(jnp.asarray(x), kq, ks,
                         None if b is None else jnp.asarray(b), p)
    got = quant.int8_dense(torch.from_numpy(x), tq, ts,
                           None if b is None else torch.from_numpy(b), p)
    assert _rel(got.numpy(), want) <= 1e-6


@pytest.mark.parametrize("p", [None, 99.9], ids=["max", "p99.9"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("stride", [1, 2])
def test_int8_conv_matches_jax(stride, bias, p):
    """3x3 padding 1 (the model's convs): the int32 accumulations equal
    JAX's conv_general_dilated, the outputs within 1e-6 of the largest;
    k = 20·9 = 180 pads to 184, n = 36 to 40."""
    rs = np.random.RandomState(2)
    x = rs.randn(2, 14, 13, 20).astype(np.float32)
    w = (rs.randn(3, 3, 20, 36) * 0.05).astype(np.float32)
    b = (rs.randn(36) * 0.01).astype(np.float32) if bias else None
    kq, ks = jq.quantize_kernel(jnp.asarray(w))
    tq, ts = quant.quantize_kernel(
        torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
    xt = nchw(x)
    acc, _, cols = quant.int8_conv_acc(xt, tq, stride, 1, p)
    want_acc = _jax_acc_conv(jnp.asarray(x), kq, stride, p)
    assert np.array_equal(acc.permute(0, 2, 3, 1).numpy(), want_acc)
    ref = quant.int_mm_reference(cols, tq.reshape(36, -1).t())
    assert torch.equal(acc.permute(0, 2, 3, 1).reshape(-1, 36), ref)
    want = jq.int8_conv(jnp.asarray(x), kq, ks,
                        None if b is None else jnp.asarray(b),
                        (stride, stride), [(1, 1), (1, 1)], 1, p)
    got = quant.int8_conv(xt, tq, ts, None if b is None
                          else torch.from_numpy(b), stride, 1, p)
    assert _rel(got.permute(0, 2, 3, 1).numpy(), want) <= 1e-6


@pytest.mark.parametrize("dim", [None, -1], ids=["tensor", "token"])
def test_percentile_scale_matches_jnp_quantile(dim):
    """`quantile` follows jnp.quantile's linear method in its f32
    arithmetic: equal to within 1e-6 of the value (per token over 96
    channels, and per tensor over 7,104 elements)."""
    absx = np.abs(np.random.RandomState(3).randn(74, 96)).astype(np.float32)
    for q in (0.999, 0.5, 0.0, 1.0):
        want = np.asarray(jnp.quantile(jnp.asarray(absx), q, axis=dim,
                                       keepdims=dim is not None))
        got = quant.quantile(torch.from_numpy(absx), q, dim,
                             keepdim=dim is not None).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    want = np.asarray(jq._act_scale(jnp.asarray(absx), dim, 99.9))
    got = quant.act_scale(torch.from_numpy(absx), dim, 99.9).numpy()
    np.testing.assert_allclose(got.reshape(want.shape), want, rtol=1e-6)


def test_quantile_past_torch_limit_matches_numpy():
    """2^24 + 1 elements, one past what torch.quantile takes (a per-tensor
    conv scale at fv0 b256 reads 2.1e8): the 99.9th percentile against
    numpy's (float64). The position is computed in f32, as jnp.quantile
    computes it, and f32(2^24 + 1) is 2^24: the position moves by under one
    order statistic, a gap of ~2e-5 at this density, so the tolerance is
    1e-4 of the value."""
    x = torch.randn(2 ** 24 + 1, generator=torch.Generator().manual_seed(4))
    absx = x.abs()
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(absx, 0.999)
    got = float(quant.quantile(absx, 0.999))
    want = float(np.quantile(absx.numpy(), 0.999))
    assert abs(got - want) <= 1e-4 * want


@pytest.mark.parametrize("rows,k,n", [(1, 27, 13), (16, 64, 64), (17, 1764,
                                                                  196)])
def test_int_mm_pads_to_cublas_shapes(rows, k, n):
    """Rows up to 17, k and n up to multiples of 8 (fv4's 3x3 conv: k 1764,
    n 196); the product equals the plain int32 one."""
    g = torch.Generator().manual_seed(5)
    a = torch.randint(-127, 128, (rows, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    assert quant.int_mm_padding(rows, k, n) == (
        max(rows, 17), -(-k // 8) * 8, -(-n // 8) * 8)
    got = quant.int_mm(a, w.t())
    assert got.dtype == torch.int32 and got.shape == (rows, n)
    assert torch.equal(got, quant.int_mm_reference(a, w.t()))


def _jax_quantized(name, seed=0, **kw):
    """(JAX model, random variables, quantize_variables of them)."""
    jm = jax_create_model(name, quantized=True, **kw)
    shapes = jax.eval_shape(lambda: jm.module.init(jax.random.PRNGKey(0),
                                                   jm.dummy_input()))
    variables = random_variables(shapes, seed)
    return jm, variables, jax.device_get(jq.quantize_variables(variables))


@pytest.fixture(scope="module")
def odd_jax():
    return _jax_quantized("faster_vit_0_224", seed=6, **ODD)


def _leaf_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_fv0_quantises_the_layers_jax_does():
    """FasterViT-0: the port quantises exactly the kernels JAX's
    quantize_variables does (its `_eligible` on each kernel of the
    variables' shapes): the stem's first conv, the position-bias MLPs, the
    tokenizer's depthwise conv and the head stay float, 82 layers are
    int8."""
    from fastervit_tpu_torch.utils.convert import torch_key_for_path
    jm = jax_create_model("faster_vit_0_224", quantized=True)
    shapes = jax.eval_shape(lambda: jm.module.init(jax.random.PRNGKey(0),
                                                   jm.dummy_input()))
    want = {torch_key_for_path(path[:-1] + ("kernel_q",))
            for path, leaf in _leaf_paths(shapes["params"])
            if path[-1] == "kernel" and jq._eligible(path[:-1], leaf)}
    tm = create_model("faster_vit_0_224", device="meta", quantized=True)
    port = {k for k in tm.state_dict() if k.endswith(".weight_q")}
    assert port == want and len(port) == 82
    assert "patch_embed.conv_down.3.weight_q" in port
    assert "patch_embed.conv_down.0.weight" in tm.state_dict()
    assert "head.weight" in tm.state_dict()


def test_quantized_state_dict_loads_strictly_and_equals_port_quantisation(
        odd_jax):
    """At widths that are no multiple of 8: the bridged variables of JAX's
    quantize_variables cover the int8 model's state_dict key for key and
    load strictly, and their int8 weights and scales are the bits the
    port's own quantize_model makes from the bridged f32 weights."""
    _, variables, qv = odd_jax
    sd = quantized_state_dict_from_jax(qv)
    tm = create_model("faster_vit_0_224", device="cpu", quantized=True, **ODD)
    assert set(tm.state_dict()) == set(sd)
    tm.load_state_dict(sd, strict=True)
    own = create_model("faster_vit_0_224", device="cpu", **ODD)
    own.load_state_dict(state_dict_from_jax(variables), strict=True)
    quant.quantize_model(own)
    a, b = tm.state_dict(), own.state_dict()
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    with pytest.raises(ValueError, match="kernel_q"):
        quantized_state_dict_from_jax(variables)


@pytest.fixture(scope="module")
def odd_model(odd_jax):
    jm, _, qv = odd_jax
    tm = create_model("faster_vit_0_224", device="cpu", quantized=True, **ODD)
    tm.load_state_dict(quantized_state_dict_from_jax(qv), strict=True)
    x = np.random.RandomState(7).randn(1, 64, 64, 3).astype(np.float32)
    return jm, qv, tm.eval(), x


@pytest.mark.parametrize("p", [None, 99.9], ids=["max", "p99.9"])
def test_quantized_model_matches_jax_quantized_call(odd_model, p):
    """fp32, batch 1 (level 3's products pad rows): each int8 layer's output
    on its own input from the port's forward equals JAX's int8_dense /
    int8_conv on that input to 1e-6 of its largest entry; the logits agree
    with JAX's jitted quantized_call to 2e-2 of the largest. The second
    bound is not the first's because a quantiser's input differs between
    the two frameworks by an ulp or so (the float layers between the int8
    ones sum in another order), and where x / scale lies within that of a
    half-integer, round() takes the other integer: one quantisation step,
    ~1/127 of the token's range, which the layers after it carry to the
    logits."""
    jm, qv, tm, x = odd_model
    set_act_clip_percentile(tm, p)
    seen = []

    def hook(mod, inp, out):
        seen.append((mod, inp[0].detach().clone(), out.detach().clone()))

    handles = [m.register_forward_hook(hook)
               for _, m in quant.int8_layers(tm)]
    try:
        with torch.no_grad():
            got = tm(nchw(x)).numpy()
    finally:
        for h in handles:
            h.remove()
    assert len(seen) == len(quant.int8_layers(tm)) > 10
    for mod, inp, out in seen:
        bias = None if mod.bias is None else jnp.asarray(mod.bias.numpy())
        if isinstance(mod, quant.Int8Linear):
            want = jq.int8_dense(jnp.asarray(inp.numpy()),
                                 jnp.asarray(mod.weight_q.numpy().T),
                                 jnp.asarray(mod.weight_scale.numpy()), bias,
                                 p)
            assert _rel(out.numpy(), want) <= 1e-6
        else:
            s = mod.stride[0]
            want = jq.int8_conv(
                jnp.asarray(inp.permute(0, 2, 3, 1).numpy()),
                jnp.asarray(mod.weight_q.permute(2, 3, 1, 0).numpy()),
                jnp.asarray(mod.weight_scale.numpy()), bias, (s, s),
                [(1, 1), (1, 1)], 1, p)
            assert _rel(out.permute(0, 2, 3, 1).numpy(), want) <= 1e-6
    want = np.asarray(jax.jit(lambda v, xx: jq.quantized_call(
        jm.module.apply, v, xx, act_clip_percentile=p))(qv, x))
    assert got.shape == want.shape == (1, 10)
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_quantized_bf16_model_keeps_scales_f32_and_routes_composed(
        monkeypatch):
    """A cast to bf16 leaves weight_q int8 and weight_scale and the biases
    f32; the HAT blocks of a quantised model never take the fused block,
    even with set_fused_hat(True)."""
    import fastervit_tpu_torch as fvt
    from fastervit_tpu_torch.models import layers

    tm = create_model("faster_vit_0_224", device="cpu", quantized=True,
                      dtype=torch.bfloat16, **ODD).eval()
    layers_ = quant.int8_layers(tm)
    assert all(m.weight_q.dtype == torch.int8
               and m.weight_scale.dtype == torch.float32
               and (m.bias is None or m.bias.dtype == torch.float32)
               for _, m in layers_)
    assert tm.patch_embed.conv_down[0].weight.dtype == torch.bfloat16

    def refuse(*args, **kwargs):
        raise AssertionError("a quantised block took the fused path")

    monkeypatch.setattr(layers, "fused_hat_block", refuse)
    prev = fvt.set_fused_hat(True)
    try:
        with torch.no_grad():
            out = tm(torch.zeros(1, 3, 64, 64, dtype=torch.bfloat16))
    finally:
        fvt.set_fused_hat(prev)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 10)
    assert bool(torch.isfinite(out.float()).all())


def test_pyramid_with_quantized_raises():
    with pytest.raises(ValueError, match="classifier"):
        create_model("faster_vit_0_224", device="meta", pyramid=True,
                     quantized=True)


def test_quantize_model_logs_layers_left_in_float(capsys):
    tm = create_model("faster_vit_0_224", device="meta", **ODD)
    quant.quantize_model(tm, verbose=True)
    out = capsys.readouterr().out
    assert "int8: 10 layers left in full precision" in out
    assert "patch_embed.conv_down.0" in out and "head" in out
    assert all(blk.quantized for lvl in tm.levels[2:] for blk in lvl.blocks)
