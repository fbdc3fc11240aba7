"""Each of the port's layers against its flax counterpart on the CPU: the
same numpy random variables (through state_dict_from_jax) and the same
numpy inputs on both sides, fp32, within 1e-5."""
import jax
import numpy as np
import pytest
import torch

from fastervit_tpu.models import layers as jl
from fastervit_tpu_torch.models import layers as tl
from torch_parity import (few_torch_threads, nchw, nhwc,  # noqa: F401
                          port_state_dict, random_variables)

TOL = dict(atol=1e-5, rtol=1e-5)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(flax_module, torch_module, name, *args):
    """Random variables for `flax_module` (initialised on `args`), loaded
    strictly into `torch_module`, which is returned in eval mode."""
    shapes = jax.eval_shape(lambda: flax_module.init(jax.random.PRNGKey(0),
                                                     *args))
    variables = random_variables(shapes, seed=1)
    torch_module.load_state_dict(port_state_dict(variables, name), strict=True)
    return variables, torch_module.eval()


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_pos_emb_mlp_swin_v1d():
    x = _rand(3, 49, 64)
    fm = jl.PosEmbMLPSwinv1D(64, seq_length=49, rank=2)
    v, tm = _pair(fm, tl.PosEmbMLPSwinv1D(64, 49), "pos_embed", x)
    _close(tm(torch.from_numpy(x)), fm.apply(v, x))


@pytest.mark.parametrize("window,seq,heads", [(4, 16, 8), (7, 53, 8),
                                              (7, 49, 16)])
def test_pos_emb_mlp_swin_v2d(window, seq, heads):
    """S=16 (carrier grid), S=53 (window + 4 zero-padded carrier rows and
    columns) and S=49."""
    fm = jl.PosEmbMLPSwinv2D(window_size=(window, window),
                             pretrained_window_size=(window, window),
                             num_heads=heads, seq_length=seq)
    v, tm = _pair(fm, tl.PosEmbMLPSwinv2D(window, heads, seq), "pos_emb_funct")
    got = tm().detach()
    assert got.shape == (heads, seq, seq)
    assert float(got[:, :seq - window ** 2].abs().sum()) == 0.0
    assert float(got[:, :, :seq - window ** 2].abs().sum()) == 0.0
    _close(got, fm.apply(v))


@pytest.mark.parametrize("window,seq", [(7, 53), (4, 16)])
def test_window_attention(window, seq):
    x = _rand(4, seq, 64)
    fm = jl.WindowAttention(64, num_heads=2, resolution=window, seq_length=seq)
    v, tm = _pair(fm, tl.WindowAttention(64, 2, window, seq), "attn", x)
    _close(tm(torch.from_numpy(x)), fm.apply(v, x))


def test_patch_embed():
    x = _rand(2, 32, 32, 3)
    fm = jl.PatchEmbed(in_dim=16, dim=32)
    v, tm = _pair(fm, tl.PatchEmbed(3, 16, 32), "patch_embed", x)
    _close(nhwc(tm(nchw(x))), fm.apply(v, x))


@pytest.mark.parametrize("layer_scale", [None, 1e-5])
def test_conv_block(layer_scale):
    x = _rand(2, 14, 14, 32)
    fm = jl.ConvBlock(32, layer_scale=layer_scale)
    v, tm = _pair(fm, tl.ConvBlock(32, layer_scale=layer_scale), "blocks_0", x)
    _close(nhwc(tm(nchw(x))), fm.apply(v, x))


def test_downsample():
    x = _rand(2, 14, 14, 32)
    fm = jl.Downsample(32)
    v, tm = _pair(fm, tl.Downsample(32), "downsample", x)
    _close(nhwc(tm(nchw(x))), fm.apply(v, x))


@pytest.mark.parametrize("res", [(14, 14), (14, 21)])
def test_token_initializer(res):
    """FasterViT-0 level 2 (14x14: a kernel-5 stride-3 pool, not 2x2) and a
    rectangular any-res grid."""
    x = _rand(2, *res, 32)
    fm = jl.TokenInitializer(32, input_resolution=res, window_size=7,
                             ct_size=2)
    v, tm = _pair(fm, tl.TokenInitializer(32, res, 7, 2), "global_tokenizer",
                  x)
    _close(tm(nchw(x)), fm.apply(v, x))


@pytest.mark.parametrize("kw", [
    dict(sr_ratio=(2, 2)),                                     # fv0 level 2
    dict(sr_ratio=(2, 2), layer_scale=1e-5, last=True, do_propagation=True),
    dict(sr_ratio=(1, 1)),                                     # fv0 level 3
], ids=["carriers", "carriers_layer_scale_propagation", "window_only"])
def test_hat_block(kw):
    b, dim = 2, 64
    n_win = kw["sr_ratio"][0] * kw["sr_ratio"][1]
    x = _rand(b * n_win, 49, dim)
    ct = _rand(b, n_win * 4, dim, seed=1) if n_win > 1 else None
    fm = jl.HAT(dim, num_heads=2, window_size=7, ct_size=2, **kw)
    v, tm = _pair(fm, tl.HAT(dim, 2, window_size=7, ct_size=2, **kw),
                  "blocks_0", x, ct)
    want_x, want_ct = fm.apply(v, x, ct)
    got_x, got_ct = tm(torch.from_numpy(x),
                       None if ct is None else torch.from_numpy(ct))
    _close(got_x, want_x)
    if ct is None:
        assert got_ct is None and want_ct is None
    else:
        _close(got_ct, want_ct)
