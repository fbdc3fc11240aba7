"""The port's FasterViT against fastervit_tpu's on the CPU: strict weight
loading through state_dict_from_jax, full-width FasterViT-0 logits, the
narrow layer-scale + propagation config (square and rectangular input), and
bf16 against fp32."""
import jax
import numpy as np
import pytest
import torch

from fastervit_tpu import create_model as jax_create_model
from fastervit_tpu_torch import create_model
from fastervit_tpu_torch.utils.convert import state_dict_from_jax
from torch_parity import (few_torch_threads, nchw,  # noqa: F401
                          port_state_dict, random_variables)


# The golden-logits config of tests/test_golden_logits.py: it takes the
# layer-scale and carrier-propagation branches, which FasterViT-0 never does.
NARROW = dict(depths=[1, 1, 2, 2], num_heads=[1, 2, 4, 8], dim=32, in_dim=16,
              num_classes=100, layer_scale=1e-5, do_propagation=True)


def _input(b, h, w, seed=99):
    return np.random.RandomState(seed).randn(b, h, w, 3).astype(np.float32)


def _jax_random_variables(jm, seed):
    shapes = jax.eval_shape(lambda: jm.module.init(jax.random.PRNGKey(0),
                                                   jm.dummy_input()))
    return random_variables(shapes, seed)


def _port(name, variables, dtype=torch.float32, **kw):
    tm = create_model(name, **kw)
    tm.load_state_dict(port_state_dict(variables), strict=True)
    return tm.to(dtype).eval()


def _logits(tm, x, dtype=torch.float32):
    with torch.no_grad():
        return tm(nchw(x).to(dtype)).float().numpy()


def test_jax_init_variables_load_strictly_and_match():
    """The bridge on what `model.init` really returns (BN statistics at
    their init values)."""
    jm = jax_create_model("faster_vit_0_224", **NARROW)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(3)))
    sd = state_dict_from_jax(variables)
    assert "levels.2.global_tokenizer.pos_embed.weight" in sd
    assert "levels.2.global_tokenizer.to_global_feature.pos.weight" in sd
    assert int(sd["patch_embed.conv_down.1.num_batches_tracked"]) == 0
    tm = create_model("faster_vit_0_224", **NARROW)
    tm.load_state_dict(sd, strict=True)
    x = _input(2, 224, 224)
    want = np.asarray(jax.jit(jm.module.apply)(variables, x))
    np.testing.assert_allclose(_logits(tm.eval(), x), want, atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("hw", [(224, 224), (160, 224)],
                         ids=["square", "rectangular_pad_crop"])
def test_narrow_config_matches_jax(hw):
    """160x224 pads level 2 from 10x14 to 14x14 and level 3 from 5x7 to
    7x7, then crops back."""
    jm = jax_create_model("faster_vit_0_224", **NARROW)
    variables = _jax_random_variables(jm, seed=5)
    tm = _port("faster_vit_0_224", variables, resolution=hw, **NARROW)
    x = _input(2, *hw)
    want = np.asarray(jax.jit(jm.module.apply)(variables, x))
    # f32 through 6 blocks; logits are O(1)-O(10)
    np.testing.assert_allclose(_logits(tm, x), want, atol=1e-4, rtol=1e-4)


def test_narrow_config_bf16_close_to_jax_fp32():
    jm = jax_create_model("faster_vit_0_224", **NARROW)
    variables = _jax_random_variables(jm, seed=6)
    x = _input(4, 224, 224, seed=7)
    want = np.asarray(jax.jit(jm.module.apply)(variables, x))
    got = _logits(_port("faster_vit_0_224", variables, torch.bfloat16,
                        **NARROW), x, torch.bfloat16)
    assert np.isfinite(got).all()
    # bf16 keeps ~3 significant digits; the bound of tests/test_variants.py
    assert np.abs(got - want).max() < 0.15
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.5


def test_rejects_input_of_another_geometry():
    tm = create_model("faster_vit_0_224", **NARROW).eval()
    with pytest.raises(ValueError, match="window grid"):
        tm(torch.zeros(1, 3, 448, 448))


def test_full_width_fv0_matches_jax():
    """faster_vit_0_224 at full width, batch 2, fp32, random variables with
    moved BN statistics."""
    jm = jax_create_model("faster_vit_0_224")
    variables = _jax_random_variables(jm, seed=8)
    tm = _port("faster_vit_0_224", variables)
    x = _input(2, 224, 224, seed=9)
    want = np.asarray(jax.jit(jm.module.apply)(variables, x))
    got = _logits(tm, x)
    assert got.shape == (2, 1000)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
