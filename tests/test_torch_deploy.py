"""Deploy mode and the separable bias expansion in the port, against the
JAX package on the CPU: `bake_posemb` (fastervit_tpu's
`Model.bake_posemb`), the weights bridge for baked variables, and
`set_bias_expand` (fastervit_tpu/models/layers.py), at the narrow
faster_vit_4_21k_768 geometry (windows of 48 and 24, head dim 49)."""
import jax
import numpy as np
import pytest
import torch

from fastervit_tpu import create_model as jax_create_model
from fastervit_tpu.models import layers as jl
from fastervit_tpu_torch import bake_posemb, create_model
from fastervit_tpu_torch.models import layers as tl
from fastervit_tpu_torch.utils.convert import (baked_from_jax, load_baked,
                                               state_dict_from_jax)
from torch_parity import (few_torch_threads, nchw,  # noqa: F401
                          port_state_dict, random_variables)

NAME = "faster_vit_4_21k_768"
NARROW = dict(depths=[1, 1, 2, 1], num_heads=[1, 2, 4, 8], dim=49,
              in_dim=16, num_classes=100)


@pytest.fixture(scope="module")
def jax_baked():
    """JAX random variables for the narrow 21k-768 and their baked form."""
    jm = jax_create_model(NAME, **NARROW)
    shapes = jax.eval_shape(lambda: jm.module.init(jax.random.PRNGKey(0),
                                                   jm.dummy_input()))
    variables = random_variables(shapes, seed=21)
    return variables, jax.device_get(jm.bake_posemb(variables))


def _port(variables):
    tm = create_model(NAME, device="cpu", **NARROW)
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    return tm.eval()


def _input(seed=22):
    x = np.random.RandomState(seed).randn(1, 768, 768, 3).astype(np.float32)
    return nchw(x)


def _posemb_modules(model):
    return {name: m for name, m in model.named_modules()
            if isinstance(m, (tl.PosEmbMLPSwinv1D, tl.PosEmbMLPSwinv2D))}


@pytest.mark.parametrize("window", [24, 32, 48])
def test_separable_and_gather_expansions_are_value_identical(window):
    module = tl.PosEmbMLPSwinv2D(window, 2, window * window + 4)
    # the gather index is kept only where 'auto' gathers (S < 1024)
    assert (module.relative_position_index is None) == (window >= 32)
    prev = tl.set_bias_expand("gather")
    try:
        gathered = module()
        tl.set_bias_expand("separable")
        separable = module()
    finally:
        tl.set_bias_expand(prev)
    assert gathered.shape == (2, window * window + 4, window * window + 4)
    assert torch.equal(gathered, separable)
    assert torch.equal(module(), separable)


def test_set_bias_expand_refuses_an_unknown_mode():
    with pytest.raises(ValueError):
        tl.set_bias_expand("dense")
    assert tl.set_bias_expand("auto") == "auto"


@pytest.mark.parametrize("window", [24, 32, 48])
def test_large_window_bias_matches_jax(window):
    """'auto' on both sides: the gather at 24, the separable product at 32
    and 48 (S >= 1024)."""
    fm = jl.PosEmbMLPSwinv2D(window_size=(window, window),
                             pretrained_window_size=(window, window),
                             num_heads=2, seq_length=window * window)
    shapes = jax.eval_shape(lambda: fm.init(jax.random.PRNGKey(0)))
    variables = random_variables(shapes, seed=23)
    tm = tl.PosEmbMLPSwinv2D(window, 2, window * window)
    tm.load_state_dict(port_state_dict(variables, "pos_emb_funct"),
                       strict=True)
    with torch.no_grad():
        got = tm()
    np.testing.assert_allclose(got.numpy(), np.asarray(fm.apply(variables)),
                               atol=1e-5, rtol=1e-5)


def test_baked_forward_bit_identical_to_live(jax_baked):
    tm = _port(jax_baked[0])
    x = _input()
    with torch.no_grad():
        live = tm(x)
        assert bake_posemb(tm) is tm
        baked = tm(x)
    assert all(m.relative_bias is not None
               for m in _posemb_modules(tm).values())
    assert torch.equal(baked, live)


@pytest.mark.parametrize("source", ["bridge", "recomputed"])
def test_baked_tensors_match_jax_bake(jax_baked, source):
    """The port's baked tensors against JAX's `bake_posemb` collection:
    carried across by the bridge (exactly), or recomputed by the port's
    `bake_posemb` from the same parameters (f32, within 1e-5)."""
    variables, baked_vars = jax_baked
    want = baked_from_jax(baked_vars)
    tm = _port(variables)
    if source == "bridge":
        load_baked(tm, want)
    else:
        bake_posemb(tm)
    modules = _posemb_modules(tm)
    assert set(want) == {f"{name}.relative_bias" for name in modules}
    for key, tensor in want.items():
        got = modules[key[:-len(".relative_bias")]].relative_bias
        assert got.shape == tensor.shape
        if source == "bridge":
            assert torch.equal(got, tensor)
        else:
            np.testing.assert_allclose(got.numpy(), tensor.numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=key)


def test_bridge_carries_jax_baked_variables(jax_baked):
    """The bridge on `Model.bake_posemb`'s output: the params load strictly
    (the 'baked' collection is left out of the state_dict), and the baked
    tensors carried across give the logits of the port's own bake."""
    baked_vars = jax_baked[1]
    assert "baked" in baked_vars
    sd = state_dict_from_jax(baked_vars)
    assert not any(k.endswith("relative_bias") for k in sd)
    carried = load_baked(_port(baked_vars), baked_from_jax(baked_vars))
    own = bake_posemb(_port(baked_vars))
    x = _input(seed=24)
    with torch.no_grad():
        np.testing.assert_allclose(carried(x).numpy(), own(x).numpy(),
                                   atol=1e-5, rtol=1e-5)


def test_load_baked_refuses_a_partial_set(jax_baked):
    baked = baked_from_jax(jax_baked[1])
    baked.pop(next(iter(baked)))
    with pytest.raises(KeyError):
        load_baked(_port(jax_baked[0]), baked)


def test_rebake_after_a_parameter_change_recomputes(jax_baked):
    tm = bake_posemb(_port(jax_baked[0]))
    attn = tm.levels[2].blocks[0].attn.pos_emb_funct
    pos = tm.levels[2].blocks[0].pos_embed
    stale = attn.relative_bias.clone(), pos.relative_bias.clone()
    with torch.no_grad():
        for p in list(attn.parameters()) + list(pos.parameters()):
            p.add_(0.05)
    bake_posemb(tm)
    for module, old in zip((attn, pos), stale):
        assert not torch.equal(module.relative_bias, old)
        with torch.no_grad():
            assert torch.equal(module.relative_bias, module.compute())
