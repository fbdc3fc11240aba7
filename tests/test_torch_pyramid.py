"""The port's FasterViTPyramid (dynamic mode) against fastervit_tpu's on the
CPU, on the same random weights: rectangular canvases whose level 2 pads to
a 2x3 window grid and a rectangular 4x6 carrier grid, a square one, both
stage norms; the weights bridge with the pyramid's norms; deploy mode
leaves the dynamic position embeddings live."""
import jax
import numpy as np
import pytest
import torch

from fastervit_tpu import get_config as jax_get_config
from fastervit_tpu.models.fastervit import FasterViTPyramid as JaxPyramid
from fastervit_tpu_torch import bake_posemb, create_model, get_config
from fastervit_tpu_torch.models.fastervit import FasterViTPyramid, level_shapes
from fastervit_tpu_torch.models.layers import PosEmbMLPSwinv1D
from torch_parity import (few_torch_threads, nchw,  # noqa: F401
                          port_state_dict, random_variables)

# the narrow golden-test config: layer scale and carrier propagation
NARROW = dict(depths=[1, 1, 2, 2], num_heads=[1, 2, 4, 8], dim=32, in_dim=16,
              layer_scale=1e-5, do_propagation=True)


def _pair(hw, stage_norm, seed):
    """(JAX module, its random variables, the port's pyramid on them)."""
    jcfg = jax_get_config("faster_vit_0_224", resolution=list(hw), **NARROW)
    jm = JaxPyramid(jcfg, stage_norm=stage_norm)
    x0 = np.zeros((1, *hw, 3), np.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x0))
    variables = random_variables(shapes, seed)
    tm = FasterViTPyramid(get_config("faster_vit_0_224", resolution=hw,
                                     **NARROW), stage_norm=stage_norm)
    tm.load_state_dict(port_state_dict(variables), strict=True)
    return jm, variables, tm.eval()


@pytest.mark.parametrize("hw,stage_norm", [((200, 320), "batchnorm"),
                                           ((160, 288), "layernorm"),
                                           ((224, 224), "batchnorm")],
                         ids=["200x320_bn", "160x288_ln", "224x224_bn"])
def test_pyramid_matches_jax(hw, stage_norm):
    """200x320 and 160x288 pad level 2 (13x20, 10x18) to 14x21: a 2x3
    window grid, a rectangular 4x6 carrier grid, whose carrier attention
    takes int(sqrt(24)) = 4 with 8 zero-padded rows; 224x224 gives the
    square 2x2 grid."""
    jm, variables, tm = _pair(hw, stage_norm, seed=hw[0])
    x = np.random.RandomState(1).randn(2, *hw, 3).astype(np.float32)
    want = jax.jit(jm.apply)(variables, x)
    with torch.no_grad():
        got = tm(nchw(x))
    assert sorted(got) == ["res2", "res3", "res4", "res5"]
    for i, (h, w) in enumerate(level_shapes(*hw)):
        key = f"res{i + 2}"
        g = got[key].permute(0, 2, 3, 1).numpy()
        assert g.shape == (2, h, w, 32 * 2 ** i), key
        # f32 through up to 6 blocks; the maps are normalised, O(1)
        np.testing.assert_allclose(g, np.asarray(want[key]), atol=1e-4,
                                   rtol=1e-4, err_msg=key)


def test_level_shapes_match_jax_outputs():
    """tests/test_pyramid.py's 200x320 strides: ceil(25/2) = 13 at level
    2."""
    assert level_shapes(200, 320) == ((50, 80), (25, 40), (13, 20), (7, 10))
    assert level_shapes(800, 1333) == ((200, 334), (100, 167), (50, 84),
                                       (25, 42))


def test_create_model_pyramid_and_bridge_keys():
    tm = create_model("faster_vit_0_224", device="cpu", pyramid=True,
                      resolution=(200, 320), **NARROW)
    assert isinstance(tm, FasterViTPyramid)
    keys = set(tm.state_dict())
    assert {"norm0.weight", "norm3.running_var"} <= keys
    assert "levels.2.blocks.0.hat_pos_embed.cpb_mlp.0.weight" in keys
    jcfg = jax_get_config("faster_vit_0_224", resolution=[200, 320], **NARROW)
    shapes = jax.eval_shape(lambda: JaxPyramid(jcfg).init(
        jax.random.PRNGKey(0), np.zeros((1, 200, 320, 3), np.float32)))
    assert set(port_state_dict(random_variables(shapes, 0))) == keys


def test_bake_posemb_leaves_dynamic_sites_live():
    _, _, tm = _pair((200, 320), "batchnorm", seed=3)
    x = torch.from_numpy(np.random.RandomState(4).randn(1, 3, 200, 320)
                         .astype(np.float32))
    with torch.no_grad():
        live = tm(x)
        bake_posemb(tm)
        baked = tm(x)
    dynamic = [m for m in tm.modules() if isinstance(m, PosEmbMLPSwinv1D)]
    assert dynamic and all(m.norm_by_seq and m.relative_bias is None
                           for m in dynamic)
    attn_biases = [m for m in tm.modules() if hasattr(m, "window_tokens")]
    assert attn_biases and all(m.relative_bias is not None
                               for m in attn_biases)
    for key in live:
        assert torch.equal(live[key], baked[key]), key
