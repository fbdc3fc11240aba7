"""The port's training pieces against the JAX package's, on the CPU, one
function at a time: the six losses, mixup/cutmix fed JAX's own draws, every
schedule, adamw/lamb with clipping against the optax chain, train-mode
BatchNorm against flax, EMA (the shared tokenizer conv included) and
DropPath's generator."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastervit_tpu as jfvt
import fastervit_tpu.train.losses as JL
import fastervit_tpu.train.schedule as JS
from fastervit_tpu.train.ema import ema_update as jax_ema_update
from fastervit_tpu.train.mixup import MixupConfig as JaxMixupConfig
from fastervit_tpu.train.mixup import mixup_cutmix as jax_mixup_cutmix
from fastervit_tpu.train.steps import TrainConfig as JaxTrainConfig
from fastervit_tpu.train.steps import create_optimizer as jax_create_optimizer
import fastervit_tpu_torch as fvt
import fastervit_tpu_torch.train.losses as TL
import fastervit_tpu_torch.train.schedule as TS
from fastervit_tpu_torch.models.layers import (BatchNorm2d, DropPath,
                                               set_drop_path_generator)
from fastervit_tpu_torch.train.ema import create_ema_model, ema_update
from fastervit_tpu_torch.train.mixup import (MixupConfig, mixup_cutmix,
                                             mixup_cutmix_with)
from fastervit_tpu_torch.train.steps import (TrainConfig, create_optimizer,
                                             optimizer_step)
from torch_parity import (few_torch_threads, nchw,  # noqa: F401
                          port_state_dict, random_variables)

RNG = np.random.RandomState(0)
LOGITS = (RNG.randn(6, 10) * 2).astype(np.float32)
LABELS = np.array([1, 0, 9, 3, 3, 7], np.int32)
SOFT = RNG.dirichlet(np.ones(10), 6).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("name", [
    "label_smoothing", "soft_target", "bce_labels", "bce_soft_threshold",
    "cross_entropy", "jsd", "mesa_kd"])
def test_loss_matches_jax(name):
    other = LOGITS[::-1].copy() * 0.5
    cases = {
        "label_smoothing": (JL.label_smoothing_cross_entropy,
                            TL.label_smoothing_cross_entropy,
                            (LOGITS, LABELS), {"smoothing": 0.1}),
        "soft_target": (JL.soft_target_cross_entropy,
                        TL.soft_target_cross_entropy, (LOGITS, SOFT), {}),
        "bce_labels": (JL.binary_cross_entropy, TL.binary_cross_entropy,
                       (LOGITS, LABELS), {"smoothing": 0.1}),
        "bce_soft_threshold": (JL.binary_cross_entropy,
                               TL.binary_cross_entropy, (LOGITS, SOFT),
                               {"target_threshold": 0.2}),
        "cross_entropy": (JL.cross_entropy, TL.cross_entropy,
                          (LOGITS, LABELS), {}),
        "jsd": (JL.jsd_cross_entropy, TL.jsd_cross_entropy,
                ([LOGITS, other, LOGITS * 0.3], LABELS), {"alpha": 12.0}),
        "mesa_kd": (JL.mesa_kd_loss, TL.mesa_kd_loss, (LOGITS, other), {}),
    }
    jfn, tfn, args, kw = cases[name]
    jargs = [[jnp.asarray(x) for x in a] if isinstance(a, list)
             else jnp.asarray(a) for a in args]
    targs = [[_t(x) for x in a] if isinstance(a, list) else _t(a)
             for a in args]
    want = float(jfn(*jargs, **kw))
    got = tfn(*targs, **kw)
    assert got.dtype == torch.float32 and got.ndim == 0
    # f32 on both sides; only the order of the sums differs
    np.testing.assert_allclose(got.item(), want, rtol=1e-5, atol=1e-6)


def _jax_draws(key, h, w, cfg):
    """The draws mixup.py:52-63 takes from `key`."""
    r_apply, r_switch, r_mix, r_cut, r_box = jax.random.split(key, 5)
    ry, rx = jax.random.randint(r_box, (2,), 0, jnp.asarray([h, w]))
    return {
        "apply": float(jax.random.uniform(r_apply)),
        "switch": float(jax.random.uniform(r_switch)),
        "lam_mix": (float(jax.random.beta(r_mix, cfg.mixup_alpha,
                                          cfg.mixup_alpha))
                    if cfg.mixup_alpha > 0 else 1.0),
        "lam_cut": (float(jax.random.beta(r_cut, cfg.cutmix_alpha,
                                          cfg.cutmix_alpha))
                    if cfg.cutmix_alpha > 0 else 1.0),
        "box": (int(ry), int(rx)),
    }


@pytest.mark.parametrize("kw", [
    {}, {"prob": 0.5}, {"mixup_alpha": 0.0}, {"cutmix_alpha": 0.0},
    {"cutmix_alpha": 0.2, "switch_prob": 0.8}],
    ids=["recipe", "prob_half", "cutmix_only", "mixup_only", "small_box"])
def test_mixup_with_jax_draws_matches_jax(kw):
    jcfg = JaxMixupConfig(num_classes=10, **kw)
    tcfg = MixupConfig(num_classes=10, **kw)
    rng = np.random.RandomState(1)
    x = rng.randn(6, 20, 24, 3).astype(np.float32)
    y = np.array([1, 2, 3, 4, 5, 6], np.int32)
    kinds = set()
    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        want_x, want_t = jax_mixup_cutmix(key, jnp.asarray(x), jnp.asarray(y),
                                          jcfg)
        draws = _jax_draws(key, 20, 24, tcfg)
        got_x, got_t = mixup_cutmix_with(draws, nchw(x), _t(y), tcfg)
        np.testing.assert_allclose(got_x.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want_x), rtol=1e-6, atol=1e-6)
        # λ is rounded to f32 in one framework and kept in float64 in the
        # other before 1 − λ
        np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t),
                                   rtol=1e-6, atol=1e-7)
        changed = not np.array_equal(np.asarray(want_x), x)
        whole = changed and not np.any(np.asarray(want_x) == x)
        kinds.add("none" if not changed else "mix" if whole else "cut")
    if not kw:
        assert kinds >= {"mix", "cut"}, kinds


def test_mixup_draws_are_seeded_and_targets_sum_to_one():
    cfg = MixupConfig(num_classes=10)
    x = torch.randn(4, 3, 16, 16, generator=torch.Generator().manual_seed(0))
    y = torch.arange(4)
    a = mixup_cutmix(np.random.default_rng((7, 3)), x, y, cfg)
    b = mixup_cutmix(np.random.default_rng((7, 3)), x, y, cfg)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    np.testing.assert_allclose(a[1].sum(-1).numpy(), 1.0, atol=1e-6)
    assert a[1].min().item() >= 0.0


STEPS = [0, 1, 50, 99, 100, 101, 333, 500, 999, 1000, 1001, 1500, 2500]


@pytest.mark.parametrize("name,kw", [
    ("cosine", dict(base_lr=5e-3, t_initial=1000, lr_min=5e-6, warmup_t=100,
                    warmup_lr_init=1e-6)),
    ("cosine", dict(base_lr=1e-2, t_initial=400, lr_min=1e-5, cycle_mul=2.0,
                    cycle_decay=0.5, cycle_limit=3, k_decay=1.5)),
    ("cosine", dict(base_lr=1e-2, t_initial=1000, warmup_t=50,
                    warmup_prefix=True, cycle_limit=2)),
    ("tanh", dict(base_lr=5e-3, t_initial=1000, lr_min=1e-6, warmup_t=100,
                  warmup_lr_init=1e-6)),
    ("tanh", dict(base_lr=5e-3, t_initial=300, cycle_mul=1.5, cycle_limit=4)),
    ("step", dict(base_lr=0.1, decay_t=300, decay_rate=0.5, warmup_t=100,
                  warmup_lr_init=1e-3)),
    ("multistep", dict(base_lr=0.1, decay_t=[1000, 300], decay_rate=0.1,
                       warmup_t=10)),
    ("poly", dict(base_lr=5e-3, t_initial=1000, power=2.0, lr_min=1e-6,
                  warmup_t=100, warmup_lr_init=1e-6)),
    ("poly", dict(base_lr=5e-3, t_initial=500, cycle_mul=2.0,
                  cycle_limit=2, k_decay=0.5)),
])
def test_schedule_matches_jax(name, kw):
    want_fn = getattr(JS, f"{name}_schedule")(**kw)
    got_fn = getattr(TS, f"{name}_schedule")(**kw)
    for t in STEPS:
        # the JAX schedules run in f32, the port's in float64
        np.testing.assert_allclose(got_fn(t), float(want_fn(t)), rtol=2e-5,
                                   atol=1e-9, err_msg=f"{name} t={t}")


@pytest.mark.parametrize("sched", ["cosine", "tanh", "step", "multistep",
                                   "poly"])
def test_create_scheduler_matches_jax(sched):
    fields = dict(sched=sched, epochs=30, warmup_epochs=3, cooldown_epochs=2,
                  data_len=12800, batch_size=128, decay_epochs=10,
                  decay_milestones=(10, 20), decay_rate=0.5)
    want_fn, want_total = JS.create_scheduler(JS.ScheduleConfig(**fields))
    got_fn, got_total = TS.create_scheduler(TS.ScheduleConfig(**fields))
    assert got_total == want_total
    for t in range(0, want_total + 50, 97):
        np.testing.assert_allclose(got_fn(t), float(want_fn(t)), rtol=2e-5,
                                   atol=1e-9, err_msg=f"t={t}")


def test_plateau_scheduler_matches_jax():
    kw = dict(base_lr=0.1, decay_rate=0.5, patience_t=1, warmup_t=2,
              warmup_lr_init=0.01, cooldown_t=1, lr_min=0.02)
    want, got = JS.PlateauScheduler(**kw), TS.PlateauScheduler(**kw)
    for epoch, metric in enumerate([0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2]):
        assert got.step(epoch, metric) == want.step(epoch, metric)


# a parameter set with a matrix, a vector, a conv-like tensor and a zero
# tensor (LAMB's trust ratio is 1 where a norm is 0)
_SHAPES = {"w": (6, 5), "b": (5,), "k": (3, 3, 2, 4), "z": (4,)}


@pytest.mark.parametrize("clip", [5.0, 0.0])
@pytest.mark.parametrize("grad_scale", [0.3, 4.0], ids=["small", "large"])
@pytest.mark.parametrize("opt", ["adamw", "lamb"])
def test_optimizer_steps_match_optax(opt, grad_scale, clip):
    """1 and 3 steps of clip -> adamw / lamb against the optax chain of
    fastervit_tpu.train.steps.create_optimizer, with a warmup schedule."""
    rng = np.random.RandomState(2)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in _SHAPES.items()}
    params["z"][:] = 0.0
    grads = [{k: (grad_scale * rng.randn(*s)).astype(np.float32)
              for k, s in _SHAPES.items()} for _ in range(3)]
    for g in grads:
        g["z"][:] = 0.0
    sched = JS.cosine_schedule(1e-2, 100, warmup_t=2, warmup_lr_init=1e-3)
    tsched = TS.cosine_schedule(1e-2, 100, warmup_t=2, warmup_lr_init=1e-3)

    tx = jax_create_optimizer(sched, JaxTrainConfig(opt=opt, clip_grad=clip))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    tp = {k: torch.nn.Parameter(_t(v.copy())) for k, v in params.items()}
    topt = create_optimizer(tp.values(), TrainConfig(opt=opt,
                                                     clip_grad=clip))
    for step, g in enumerate(grads):
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        for k, p in tp.items():
            p.grad = _t(g[k].copy())
        norm = optimizer_step(topt, tsched(step), clip)
        want_norm = np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                                for v in g.values()))
        np.testing.assert_allclose(norm.item(), want_norm, rtol=1e-6)
        if step in (0, 2):
            for k in _SHAPES:
                np.testing.assert_allclose(tp[k].detach().numpy(),
                                           np.asarray(jp[k]), rtol=1e-5,
                                           atol=1e-6, err_msg=f"{k} {step}")


def test_train_mode_batchnorm_matches_flax():
    rng = np.random.RandomState(3)
    x = (rng.randn(4, 6, 5, 3) * 2 + 0.5).astype(np.float32)  # NHWC
    variables = {"params": {"scale": 1 + 0.1 * rng.randn(3),
                            "bias": 0.1 * rng.randn(3)},
                 "batch_stats": {"mean": 0.1 * rng.randn(3),
                                 "var": rng.uniform(0.5, 1.5, 3)}}
    variables = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), variables)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-4)
    state = variables
    port = BatchNorm2d(3, eps=1e-4)
    port.load_state_dict(port_state_dict(variables, "norm"), strict=False)
    port.train()
    for _ in range(2):
        want, mut = bn.apply(state, jnp.asarray(x), mutable=["batch_stats"])
        state = {"params": variables["params"], **mut}
        got = port(nchw(x))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                                   np.asarray(want), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(port.running_mean.numpy(),
                                   np.asarray(state["batch_stats"]["mean"]),
                                   rtol=1e-6, atol=1e-7)
        # the biased batch variance, as flax takes it
        np.testing.assert_allclose(port.running_var.numpy(),
                                   np.asarray(state["batch_stats"]["var"]),
                                   rtol=1e-5, atol=1e-7)
    assert set(port.state_dict()) == set(torch.nn.BatchNorm2d(3).state_dict())
    ref = torch.nn.BatchNorm2d(3, eps=1e-4)
    ref.load_state_dict(port.state_dict())
    port.eval()
    ref.eval()
    assert torch.equal(port(nchw(x)), ref(nchw(x)))


_TINY = dict(depths=[1, 1, 1, 1], num_heads=[1, 2, 4, 8], dim=16, in_dim=8,
             num_classes=10)


def test_ema_matches_jax_and_updates_shared_conv_once():
    """224² gives level 2 a carrier grid, so the model has the tokenizer
    conv that the state_dict holds under two keys."""
    jm = jfvt.create_model("faster_vit_0_224", **_TINY)
    shapes = jax.eval_shape(lambda: jm.module.init(jax.random.PRNGKey(0),
                                                   jm.dummy_input()))
    old, new = random_variables(shapes, 4), random_variables(shapes, 5)
    want = {c: jax_ema_update(old[c], new[c], 0.9) for c in old}
    want = port_state_dict(jax.device_get(want))

    model = fvt.create_model("faster_vit_0_224", device="cpu", **_TINY)
    model.load_state_dict(port_state_dict(new), strict=True)
    ema = create_ema_model(model)
    ema.load_state_dict(port_state_dict(old), strict=True)
    tables = {k: v.clone() for k, v in ema.named_buffers()
              if k not in ema.state_dict()}
    ema_update(ema, model, 0.9)
    got = ema.state_dict()
    assert "levels.2.global_tokenizer.pos_embed.weight" in got
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
    assert int(got["patch_embed.conv_down.1.num_batches_tracked"]) == 0
    assert all(torch.equal(v, dict(ema.named_buffers())[k])
               for k, v in tables.items())
    assert not any(p.requires_grad for p in ema.parameters())


def test_drop_path_needs_and_follows_its_generator():
    dp = DropPath(0.5).train()
    x = torch.ones(64, 3, 4)
    with pytest.raises(RuntimeError, match="generator"):
        dp(x)
    set_drop_path_generator(dp, torch.Generator().manual_seed(1))
    a = dp(x)
    set_drop_path_generator(dp, torch.Generator().manual_seed(1))
    assert torch.equal(a, dp(x))
    # one draw per entry of dim 0, scaled by 1/keep
    assert set(a.unique().tolist()) == {0.0, 2.0}
    assert all(len(row.unique()) == 1 for row in a)
    assert torch.equal(dp.eval()(x), x)
