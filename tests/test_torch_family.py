"""The large-window, any-res and head-dim-80 members of the family: the
port's logits against fastervit_tpu's on the CPU, fp32, batch 1, at a narrow
width (depths 1,1,2,1; heads 1,2,4,8; head dim 49, or 80 for FasterViT-5)
with the real window geometry, live and in deploy mode (`bake_posemb`).
Together they take K3's route at every S it sees on the card: 2304 and 576
(21k-768), 576 and 144 (21k-384), 196 (21k-224), 216 (any-res carriers)
and hd 80 (FasterViT-5)."""
import jax
import numpy as np
import pytest
import torch

from fastervit_tpu import create_model as jax_create_model
from fastervit_tpu_torch import bake_posemb, create_model
from fastervit_tpu_torch.ops.attention import attention_route
from torch_parity import (few_torch_threads, nchw,  # noqa: F401
                          port_state_dict, random_variables)

NARROW = dict(depths=[1, 1, 2, 1], num_heads=[1, 2, 4, 8], dim=49,
              in_dim=16, num_classes=100)
MODELS = {"faster_vit_4_21k_768": {}, "faster_vit_4_21k_384": {},
          "faster_vit_4_21k_224": {}, "faster_vit_0_any_res": {},
          "faster_vit_5_224": dict(dim=80)}
_JAX_CACHE = {}


def _jax_logits(name):
    """JAX random variables and logits for `name`, computed once."""
    if name not in _JAX_CACHE:
        kw = {**NARROW, **MODELS[name]}
        jm = jax_create_model(name, **kw)
        shapes = jax.eval_shape(lambda: jm.module.init(jax.random.PRNGKey(0),
                                                       jm.dummy_input()))
        variables = random_variables(shapes, seed=31)
        h, w = jm.cfg.resolution
        x = np.random.RandomState(32).randn(1, h, w, 3).astype(np.float32)
        want = np.asarray(jax.jit(jm.module.apply)(variables, x))
        _JAX_CACHE[name] = (kw, variables, x, want)
    return _JAX_CACHE[name]


@pytest.mark.parametrize("mode", ["live", "baked"])
@pytest.mark.parametrize("name", list(MODELS))
def test_port_matches_jax(name, mode):
    kw, variables, x, want = _jax_logits(name)
    tm = create_model(name, device="cpu", **kw)
    tm.load_state_dict(port_state_dict(variables), strict=True)
    tm.eval()
    if mode == "baked":
        bake_posemb(tm)
    with torch.no_grad():
        got = tm(nchw(x)).numpy()
    assert got.shape == (1, 100)
    # f32 through 5 blocks; 1e-6 was measured
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_the_family_takes_k3_where_k1_cannot():
    """The attention shapes of each model in the port's full-width configs,
    by route: what the card runs through K1 and K3."""
    def shapes(name):
        m = create_model(name, device="meta")
        return [(mod.pos_emb_funct.seq_length, mod.qkv.in_features
                 // mod.num_heads) for mod in m.modules()
                if hasattr(mod, "pos_emb_funct")]

    def routes(name):
        counts = {"K1": 0, "K3": 0}
        for s, hd in shapes(name):
            counts[attention_route(s, hd)] += 1
        return counts["K1"], counts["K3"]

    assert routes("faster_vit_0_224") == (17, 0)
    assert routes("faster_vit_0_any_res") == (11, 6)
    assert routes("faster_vit_4_21k_224") == (5, 12)
    assert routes("faster_vit_4_21k_384") == (0, 17)
    assert routes("faster_vit_4_21k_768") == (0, 17)
    assert routes("faster_vit_5_224") == (0, 29)
