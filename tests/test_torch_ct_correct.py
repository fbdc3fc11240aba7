"""The last module options of the port's layers against the JAX package on
the CPU, weights carried by the bridge (utils/convert.py): the CPB bias of
PosEmbMLPSwinv2D with ct_correct (the carrier tokens' rows and columns
taken from window tokens), a rectangular window, a pretrained window
other than the window and no_log, under both bias expansions in both
packages; WindowAttention(ct_correct=True), its forward and its
parameter gradients under a fixed random cotangent (JAX through its jnp
attention); the rank-1 PosEmbMLPSwinv1D, its output and its weights
carried to the port and back; and deploy mode's baked tensors, bit-equal
to the live ones."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastervit_tpu.models import layers as jl
from fastervit_tpu.utils import convert as jconvert
from fastervit_tpu_torch import bake_posemb
from fastervit_tpu_torch.models import layers as tl
from fastervit_tpu_torch.utils.convert import state_dict_from_jax
from torch_parity import (few_torch_threads,  # noqa: F401
                          port_state_dict, random_variables)

TOL_BIAS = 1e-6
TOL_FWD = 1e-5
TOL_GRAD = 2e-4
MODES = ("gather", "separable")

# name: (window, pretrained window, seq_length, heads, ct_correct, no_log)
BIAS_CASES = {
    "ct_correct_7_53": ((7, 7), None, 53, 4, True, False),
    "ct_correct_24_580": ((24, 24), None, 580, 2, True, False),
    "rectangular_3x5": ((3, 5), None, 15, 2, False, False),
    "rectangular_3x5_ct_correct": ((3, 5), None, 19, 2, True, False),
    "pretrained_12_on_7": ((7, 7), (12, 12), 49, 2, False, False),
    "no_log_7_53": ((7, 7), None, 53, 2, False, True),
}
# name: (dim, heads, window, seq_length, batch)
ATTN_CASES = {"7_53": (32, 2, 7, 53, 3), "24_580": (16, 2, 24, 580, 2)}


def _jax_bias_module(window, pretrained, seq, heads, ct, no_log):
    return jl.PosEmbMLPSwinv2D(window_size=window,
                               pretrained_window_size=pretrained or window,
                               num_heads=heads, seq_length=seq,
                               ct_correct=ct, no_log=no_log)


def _in_mode(layers, mode, fn):
    prev = layers.set_bias_expand(mode)
    try:
        return fn()
    finally:
        layers.set_bias_expand(prev)


@pytest.fixture(scope="module")
def jax_biases():
    """{case: (variables, {mode: JAX's bias})}."""
    out = {}
    for i, (name, case) in enumerate(BIAS_CASES.items()):
        fm = _jax_bias_module(*case)
        shapes = jax.eval_shape(lambda: fm.init(jax.random.PRNGKey(0)))
        variables = random_variables(shapes, seed=100 + i)
        # a fresh jit for each mode: JAX reads the mode at trace time
        out[name] = (variables, {
            mode: np.asarray(_in_mode(jl, mode,
                                      lambda: jax.jit(fm.apply)(variables)))
            for mode in MODES})
    return out


def _port_bias_module(window, pretrained, seq, heads, ct, no_log):
    return tl.PosEmbMLPSwinv2D(window, heads, seq,
                               pretrained_window_size=pretrained,
                               no_log=no_log, ct_correct=ct)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(BIAS_CASES))
def test_cpb_bias_matches_jax(jax_biases, case, mode):
    window, _, seq, heads, ct, _ = BIAS_CASES[case]
    variables, want = jax_biases[case]
    tm = _port_bias_module(*BIAS_CASES[case])
    tm.load_state_dict(port_state_dict(variables, "pos_emb_funct"),
                       strict=True)
    assert set(tm.state_dict()) == {"cpb_mlp.0.weight", "cpb_mlp.0.bias",
                                    "cpb_mlp.2.weight"}
    with torch.no_grad():
        got = _in_mode(tl, mode, tm).numpy()
    assert got.shape == (heads, seq, seq)
    # f32 on both sides: the MLP's sums in another order, so within
    # TOL_BIAS of the largest entry (a bias up to 16)
    err = np.abs(got - want[mode]).max()
    assert err <= TOL_BIAS * np.abs(want[mode]).max(), err
    n = seq - window[0] * window[1]
    if ct:
        # the carriers' rows and columns are window tokens' biases, the
        # window block zero (JAX layers.py:317-326)
        assert (got[:, :n] > 0).all() and (got[:, :, :n] > 0).all()
        assert not got[:, n:, n:].any()
    elif n:
        assert not got[:, :n].any() and not got[:, :, :n].any()


def _attn_pair(case):
    dim, heads, window, seq, batch = ATTN_CASES[case]
    fm = jl.WindowAttention(dim, num_heads=heads, resolution=window,
                            seq_length=seq, ct_correct=True,
                            attn_impl="jnp")
    rng = np.random.RandomState(7)
    x = rng.randn(batch, seq, dim).astype(np.float32)
    cot = rng.randn(batch, seq, dim).astype(np.float32)
    shapes = jax.eval_shape(lambda: fm.init(jax.random.PRNGKey(0), x))
    variables = random_variables(shapes, seed=11)
    return fm, variables, x, cot


@pytest.fixture(scope="module")
def jax_attention():
    """{case: (variables, x, cotangent, JAX's output, JAX's parameter
    gradients of <output, cotangent>)}."""
    out = {}
    for case in ATTN_CASES:
        fm, variables, x, cot = _attn_pair(case)
        y = jax.jit(fm.apply)(variables, x)
        grads = jax.jit(jax.grad(lambda p: jnp.sum(
            fm.apply({"params": p}, x) * cot)))(variables["params"])
        out[case] = (variables, x, cot, np.asarray(y),
                     jax.tree_util.tree_map(np.asarray, grads))
    return out


def _port_attention(case, variables):
    dim, heads, window, seq, _ = ATTN_CASES[case]
    tm = tl.WindowAttention(dim, heads, window, seq, ct_correct=True)
    tm.load_state_dict(port_state_dict(variables, "attn"), strict=True)
    return tm.eval()


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_window_attention_ct_correct_forward_matches_jax(jax_attention,
                                                         case):
    variables, x, _, want, _ = jax_attention[case]
    tm = _port_attention(case, variables)
    assert tm.pos_emb_funct.ct_correct
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL_FWD, atol=TOL_FWD)


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_window_attention_ct_correct_gradients_match_jax(jax_attention,
                                                         case):
    variables, x, cot, _, grads = jax_attention[case]
    tm = _port_attention(case, variables)
    (tm(torch.from_numpy(x)) * torch.from_numpy(cot)).sum().backward()
    want = port_state_dict({"params": grads}, "attn")
    got = {name: p.grad for name, p in tm.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        largest = float(want[name].abs().max())
        err = float((g - want[name]).abs().max())
        assert largest > 0 and err <= TOL_GRAD * largest, (name, err,
                                                           largest)


@pytest.mark.parametrize("norm_by_seq", [False, True])
def test_rank1_pos_embed_matches_jax(norm_by_seq):
    """norm_by_seq does not apply at rank 1, in either package."""
    x = np.random.RandomState(3).randn(2, 9, 24).astype(np.float32)
    fm = jl.PosEmbMLPSwinv1D(24, seq_length=9, rank=1,
                             norm_by_seq=norm_by_seq)
    shapes = jax.eval_shape(lambda: fm.init(jax.random.PRNGKey(0), x))
    variables = random_variables(shapes, seed=5)
    tm = tl.PosEmbMLPSwinv1D(24, 9, norm_by_seq=norm_by_seq, rank=1)
    tm.load_state_dict(port_state_dict(variables, "pos_embed"), strict=True)
    assert tm.cpb_mlp[0].weight.shape == (512, 1)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(fm.apply(variables, x)),
                               rtol=TOL_FWD, atol=TOL_FWD)


def test_rank1_weights_cross_to_the_port_and_back():
    """JAX's (1, 512) fc1 kernel is the port's (512, 1) cpb_mlp.0.weight,
    and the port's state_dict fills JAX's variables back, every leaf
    bit-equal."""
    fm = jl.PosEmbMLPSwinv1D(24, seq_length=9, rank=1)
    x = np.zeros((1, 9, 24), np.float32)
    shapes = jax.eval_shape(lambda: fm.init(jax.random.PRNGKey(0), x))
    variables = {"params": {"pos_embed": random_variables(
        shapes, seed=6)["params"]}}
    sd = state_dict_from_jax(variables)
    assert sd["pos_embed.cpb_mlp.0.weight"].shape == (512, 1)
    tm = tl.PosEmbMLPSwinv1D(24, 9, rank=1)
    tm.load_state_dict({k[len("pos_embed."):]: v for k, v in sd.items()},
                       strict=True)
    back = jconvert.convert_state_dict(
        {f"pos_embed.{k}": v for k, v in tm.state_dict().items()},
        variables)
    for want, got in zip(jax.tree_util.tree_leaves(variables),
                         jax.tree_util.tree_leaves(back)):
        assert want.shape == got.shape and np.array_equal(want, got)
    assert back["params"]["pos_embed"]["fc1"]["kernel"].shape == (1, 512)


def test_rank_other_than_1_or_2_is_refused():
    with pytest.raises(ValueError, match="rank 3"):
        tl.PosEmbMLPSwinv1D(8, 9, rank=3)


def test_baked_equals_live_bit_for_bit(jax_attention):
    """bake_posemb stores the ct_correct bias and the rank-1 embedding;
    forwards then read them, bit-equal to the live forwards."""
    variables, x, _, _, _ = jax_attention["7_53"]
    model = torch.nn.Sequential(tl.PosEmbMLPSwinv1D(32, 53, rank=1),
                                _port_attention("7_53", variables)).eval()
    xt = torch.from_numpy(x)
    with torch.no_grad():
        live = model(xt)
        bake_posemb(model)
        assert model[0].relative_bias.shape == (53, 32)
        assert torch.equal(model[1].pos_emb_funct.relative_bias,
                           model[1].pos_emb_funct.compute())
        assert torch.equal(model(xt), live)
