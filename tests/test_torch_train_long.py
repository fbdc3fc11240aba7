"""A train step of the large-window family on the CPU: a narrow
faster_vit_4_21k_384 (windows 24 and 12 at 384², so every attention is
K4-routed on the card) against the JAX package's `make_train_step`, with
and without gradient checkpointing, at tests/test_torch_train_step.py's
tolerances; and the port's checkpointed step against its plain step with
the variant's drop path of 0.42, bit for bit."""
import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastervit_tpu as jfvt
import fastervit_tpu.train.schedule as JS
from fastervit_tpu.train.steps import TrainConfig as JaxTrainConfig
from fastervit_tpu.train.steps import TrainState as JaxTrainState
from fastervit_tpu.train.steps import create_optimizer as jax_create_optimizer
from fastervit_tpu.train.steps import make_train_step as jax_make_train_step
import fastervit_tpu_torch as fvt
import fastervit_tpu_torch.models.layers as layers
import fastervit_tpu_torch.train.schedule as TS
from fastervit_tpu_torch.ops.attention import backward_route
from fastervit_tpu_torch.train.mixup import MixupConfig
from fastervit_tpu_torch.train.steps import (TrainConfig, create_train_state,
                                             make_train_step)
from test_torch_train_step import (NOISE_ONLY, _adam_state, _close_per_tensor,
                                   _largest, _tree)
from torch_parity import (few_torch_threads,  # noqa: F401
                          port_state_dict, random_variables)

NARROW = dict(depths=[1, 1, 2, 1], num_heads=[1, 2, 4, 8], dim=32,
              in_dim=16, num_classes=10)
CFG = dict(mixup=None, mesa=0.2, mesa_start_step=0, use_ema=True)
SCHED = dict(base_lr=1e-3, t_initial=100, warmup_t=1, warmup_lr_init=1e-4)
STEPS = 2
BATCH = 2


def _batches(seed):
    rng = np.random.RandomState(seed)
    return [{"image": rng.randn(BATCH, 384, 384, 3).astype(np.float32),
             "label": rng.randint(0, 10, BATCH).astype(np.int32)}
            for _ in range(STEPS)]


def test_every_attention_of_the_narrow_model_takes_k4():
    model = fvt.create_model("faster_vit_4_21k_384", device="meta", **NARROW)
    shapes = [(m.pos_emb_funct.seq_length,
               m.qkv.out_features // 3 // m.num_heads)
              for m in model.modules() if hasattr(m, "pos_emb_funct")]
    assert sorted(s for s, _ in shapes) == [144, 576, 576]
    assert {backward_route(s, hd) for s, hd in shapes} == {"K4"}


@pytest.fixture(scope="module", params=[False, True],
                ids=["plain", "grad_checkpoint"])
def runs(request):
    """Both frameworks' states and metrics after each of STEPS steps, with
    gradient checkpointing off or on in both."""
    gc = request.param
    jm = jfvt.create_model("faster_vit_4_21k_384", drop_path_rate=0.0,
                           **NARROW)
    shapes = jax.eval_shape(lambda: jm.module.init(jax.random.PRNGKey(0),
                                                   jm.dummy_input()))
    variables = random_variables(shapes, 31)
    batches = _batches(32)

    jcfg = JaxTrainConfig(grad_checkpoint=gc, **CFG)
    sched = JS.cosine_schedule(**SCHED)
    tx = jax_create_optimizer(sched, jcfg)
    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=stats, opt_state=tx.init(params),
                          ema_params=params, ema_batch_stats=stats)
    step = jax.jit(jax_make_train_step(jm.module, tx, jcfg, sched))
    jax_runs = []
    for batch in batches:
        state, metrics = step(state, {k: jnp.asarray(v)
                                      for k, v in batch.items()},
                              jax.random.PRNGKey(0))
        jax_runs.append((jax.device_get(state), jax.device_get(metrics)))

    model = fvt.create_model("faster_vit_4_21k_384", device="cpu",
                             drop_path_rate=0.0, **NARROW)
    model.load_state_dict(port_state_dict(variables), strict=True)
    tcfg = TrainConfig(grad_checkpoint=gc, **CFG)
    tstate = create_train_state(model, tcfg)
    tstep = make_train_step(tcfg, TS.cosine_schedule(**SCHED))
    port_runs = []
    for batch in batches:
        metrics = tstep(tstate, batch)
        opt = tstate.optimizer
        port_runs.append({
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grad": {n: p.grad.clone() for n, p in model.named_parameters()},
            "mu": {n: opt.state[p]["exp_avg"].clone()
                   for n, p in model.named_parameters()},
            "nu": {n: opt.state[p]["exp_avg_sq"].clone()
                   for n, p in model.named_parameters()},
            "model": {k: v.clone() for k, v in model.state_dict().items()},
        })
    return jax_runs, port_runs


@pytest.mark.parametrize("i", range(STEPS))
def test_metrics_match(runs, i):
    (_, jm), port = runs[0][i], runs[1][i]["metrics"]
    np.testing.assert_allclose(port["loss"], float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(port["grad_norm"], float(jm["grad_norm"]),
                               rtol=1e-4)
    np.testing.assert_allclose(port["lr"], float(jm["lr"]), rtol=1e-6)


@pytest.mark.parametrize("i", range(STEPS))
def test_gradients_match(runs, i):
    (js, _), port = runs[0][i], runs[1][i]
    adam = _adam_state(js.opt_state)
    _close_per_tensor(port["mu"], _tree(adam.mu), 2e-4, "mu")
    _close_per_tensor(port["nu"], _tree(adam.nu), 4e-4, "nu")
    if i == 0:
        _close_per_tensor(port["grad"],
                          {k: v / 0.1 for k, v in _tree(adam.mu).items()},
                          2e-4, "grad")


def _above_noise(runs, name, i):
    """Entries of parameter `name` whose gradients stood above the sums'
    noise (1e-3 of the tensor's largest and 1e-4 of the largest of all) at
    every step up to i: Adam's sign-like early steps move a noise-level
    entry by ±lr either way, and that move stays in the parameter."""
    keep = True
    for run in runs[1][:i + 1]:
        g = run["grad"][name].abs().numpy()
        largest = _largest(run["grad"].values())
        keep = keep & (g > max(1e-3 * g.max(), 1e-4 * largest))
    return keep


@pytest.mark.parametrize("i", range(STEPS))
def test_bn_stats_and_parameters_match(runs, i):
    """BN statistics after step i, and the parameters whose gradients stand
    above the sums' noise, with test_torch_train_step.py's bounds."""
    (js, _), port = runs[0][i], runs[1][i]
    moved = sum(r["metrics"]["lr"] for r in runs[1][:i + 1])
    atol = 1e-6 + (1e-1 * sum(r["metrics"]["lr"] for r in runs[1][:i])
                   if i else 0.0)
    for k, v in _tree(js.batch_stats, "batch_stats").items():
        if k.endswith("num_batches_tracked") or NOISE_ONLY.search(k):
            continue
        np.testing.assert_allclose(port["model"][k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=atol, err_msg=k)
    want = _tree(js.params)
    for name in port["grad"]:
        if NOISE_ONLY.search(name):
            continue
        keep = _above_noise(runs, name, i)
        np.testing.assert_allclose(
            port["model"][name].numpy()[keep], want[name].numpy()[keep],
            rtol=0, atol=(5e-2 if i else 1e-2) * moved, err_msg=name)


def _two_steps(model, grad_checkpoint):
    cfg = TrainConfig(mixup=MixupConfig(num_classes=10),
                      grad_checkpoint=grad_checkpoint)
    state = create_train_state(model, cfg)
    step = make_train_step(cfg, lambda t: 1e-3, seed=33)
    losses = [step(state, b)["loss"] for b in _batches(34)]
    return (losses, {n: p.grad.clone() for n, p in model.named_parameters()},
            {k: v.clone() for k, v in model.state_dict().items()})


@pytest.fixture(scope="module")
def plain_and_checkpointed():
    """Two mixup steps of the narrow model with drop path 0.42, plain and
    checkpointed, from the same weights."""
    model = fvt.create_model("faster_vit_4_21k_384", device="cpu", **NARROW)
    assert model.cfg.drop_path_rate == 0.42
    return model, _two_steps(copy.deepcopy(model), False), \
        _two_steps(copy.deepcopy(model), True)


@pytest.mark.parametrize("what", ["loss", "gradients", "state"])
def test_checkpointed_step_equals_plain_step(plain_and_checkpointed, what):
    """Gradients, parameters and BN running statistics after two steps:
    the recompute replays the forward's DropPath masks and leaves the BN
    statistics alone, so nothing differs, on the CPU, to the bit."""
    _, plain, ckpt = plain_and_checkpointed
    index = {"loss": 0, "gradients": 1, "state": 2}[what]
    got, want = ckpt[index], plain[index]
    if what == "loss":
        assert [x.item() for x in got] == [x.item() for x in want]
        return
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_without_the_replay_the_checkpointed_step_differs(
        plain_and_checkpointed, monkeypatch):
    """The check above can fail: a recompute that draws fresh DropPath
    masks and updates the BN statistics again changes gradients and
    statistics."""
    model, plain, _ = plain_and_checkpointed
    monkeypatch.setattr(layers, "_replay_context", lambda block: (
        contextlib.nullcontext(), contextlib.nullcontext()))
    _, grads, state = _two_steps(copy.deepcopy(model), True)
    assert any(not torch.equal(grads[k], plain[1][k]) for k in grads)
    assert not torch.equal(
        state["levels.0.blocks.0.norm1.num_batches_tracked"],
        plain[2]["levels.0.blocks.0.norm1.num_batches_tracked"])
