"""The port's dropout (drop_rate, attn_drop_rate: models/layers.py's
Dropout, Mlp, WindowAttention; ops/attention.py's route PLAIN_DROPOUT) on
the CPU:

- attention dropout on a keep mask drawn here: the plain attention and
  `dropout_window_mhsa` against the JAX package's bias_attention_reference
  and window_mhsa (jnp route) with that mask put in place of
  jax.random.bernoulli's draw, where(keep, p / (1 - rate), 0), within
  1e-6 (f32; the sums in another order);
- in eval mode a model with dropout equals the model without it, bit for
  bit, and runs the kernels' route; in training every attention takes
  PLAIN_DROPOUT, and the fused HAT block stays off;
- Dropout draws from the generator it is given: one seed, one mask; rate
  0 (Mlp's default) is the identity; a train step with dropout is the
  same for one seed twice and differentiable.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastervit_tpu.ops import attention as jax_attention
from fastervit_tpu_torch import create_model
from fastervit_tpu_torch.models import layers
from fastervit_tpu_torch.ops import attention
from fastervit_tpu_torch.train.mixup import MixupConfig
from fastervit_tpu_torch.train.steps import (TrainConfig, create_train_state,
                                             make_train_step)
from torch_parity import few_torch_threads  # noqa: F401

TOL = 1e-6
RATE = 0.25
TINY = dict(depths=[1, 1, 1, 1], num_heads=[1, 2, 4, 8], dim=16, in_dim=8,
            resolution=112, num_classes=10)
B, H, S, D = 3, 2, 53, 8


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    qkv = rng.randn(B, S, 3 * H * D).astype(np.float32)
    bias = rng.randn(H, S, S).astype(np.float32)
    keep = rng.uniform(size=(B, H, S, S)) >= RATE
    return qkv, bias, keep


@pytest.fixture(scope="module")
def jax_window_mhsa():
    """JAX's window_mhsa on its jnp route with attention dropout, the
    bernoulli draw replaced by the given keep mask, jitted."""
    def run(qkv, bias, keep):
        orig = jax.random.bernoulli
        jax.random.bernoulli = lambda rng, p, shape: keep
        try:
            return jax_attention.window_mhsa(
                qkv, bias, H, D ** -0.5, attn_drop=RATE, deterministic=False,
                dropout_rng=jax.random.PRNGKey(0), impl="jnp")
        finally:
            jax.random.bernoulli = orig
    return jax.jit(run)


def test_dropout_attention_matches_jax_on_one_mask(jax_window_mhsa):
    qkv, bias, keep = _inputs()
    want = np.asarray(jax_window_mhsa(qkv, bias, keep))
    got = attention.dropout_window_mhsa(
        torch.from_numpy(qkv), torch.from_numpy(bias), H, D ** -0.5, RATE,
        keep=torch.from_numpy(keep))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_plain_attention_with_a_mask_matches_jax_reference():
    qkv, bias, keep = _inputs(1)
    q, k, v = (qkv.reshape(B, S, 3, H, D).transpose(2, 0, 3, 1, 4))
    orig = jax.random.bernoulli
    jax.random.bernoulli = lambda rng, p, shape: jnp.asarray(keep)
    try:
        want = np.asarray(jax_attention.bias_attention_reference(
            q, k, v, bias, D ** -0.5, attn_drop=RATE, deterministic=False,
            dropout_rng=jax.random.PRNGKey(0)))
    finally:
        jax.random.bernoulli = orig
    got = attention.bias_attention_reference(
        *(torch.from_numpy(np.ascontiguousarray(t)) for t in (q, k, v, bias)),
        D ** -0.5, torch.from_numpy(keep), RATE)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_routes_plain_under_attention_dropout_only_in_training():
    assert attention.attention_route(53, 32, RATE) == attention.PLAIN_DROPOUT
    assert attention.attention_route(53, 32) == "K1"
    model = create_model("faster_vit_0_224", device="cpu",
                         drop_rate=0.1, attn_drop_rate=0.1, **TINY)
    x = torch.randn(2, 3, 112, 112, generator=torch.Generator().manual_seed(0))
    layers.set_drop_path_generator(model, torch.Generator().manual_seed(1))
    before = attention.dropout_window_mhsa.calls
    model.train()(x)
    # fv0's narrow config at 112: level 2 runs no carriers; levels 2 and 3
    # one window attention each
    assert attention.dropout_window_mhsa.calls - before == 2
    before = attention.dropout_window_mhsa.calls
    with torch.no_grad():
        model.eval()(x)
    assert attention.dropout_window_mhsa.calls == before


def test_eval_with_dropout_equals_no_dropout(monkeypatch):
    plain = create_model("faster_vit_0_224", device="cpu", **TINY).eval()
    dropped = create_model("faster_vit_0_224", device="cpu", drop_rate=0.3,
                           attn_drop_rate=0.3, **TINY).eval()
    dropped.load_state_dict(plain.state_dict())
    x = torch.randn(2, 3, 112, 112, generator=torch.Generator().manual_seed(2))

    def refuse(*args, **kwargs):
        raise AssertionError("the fused block ran with dropout")

    monkeypatch.setattr(layers, "fused_hat_block", refuse)
    prev = layers.set_fused_hat(True)
    try:
        with torch.no_grad():
            got = dropped(x)
    finally:
        layers.set_fused_hat(prev)
    with torch.no_grad():
        assert torch.equal(got, plain(x))


def test_dropout_draws_from_its_generator():
    drop = layers.Dropout(RATE).train()
    x = torch.ones(4, 1000)
    outs = []
    for _ in range(2):
        drop.generator = torch.Generator().manual_seed(5)
        outs.append(drop(x))
    assert torch.equal(outs[0], outs[1])
    kept = outs[0] != 0
    assert torch.all(outs[0][kept] == 1 / (1 - RATE))
    assert abs(kept.float().mean().item() - (1 - RATE)) < 0.03
    assert torch.equal(drop.eval()(x), x)


def test_mlp_dropout_at_rate_zero_is_the_identity():
    mlp = layers.Mlp(8, 16).train()
    x = torch.randn(3, 8)
    assert torch.equal(mlp(x), mlp.fc2(mlp.act(mlp.fc1(x))))


def test_train_step_with_dropout_is_seeded_and_differentiable():
    cfg = TrainConfig(mixup=MixupConfig(num_classes=10), use_ema=False)
    batch = {"image": np.random.RandomState(3).randn(2, 112, 112, 3)
             .astype(np.float32), "label": np.array([1, 2])}
    losses = []
    for _ in range(2):
        model = create_model("faster_vit_0_224", device="cpu",
                             generator=torch.Generator().manual_seed(4),
                             drop_rate=0.1, attn_drop_rate=0.1, **TINY)
        state = create_train_state(model, cfg)
        got = make_train_step(cfg, lambda s: 1e-3, seed=6)(state, batch)
        losses.append(got["loss"].item())
        qkv = model.levels[2].blocks[0].attn.qkv.weight
        assert qkv.grad is not None and torch.isfinite(qkv.grad).all()
        assert qkv.grad.abs().sum() > 0
    assert losses[0] == losses[1] and np.isfinite(losses[0])
