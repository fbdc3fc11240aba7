"""A whole train step of the port against the JAX package's
`make_train_step`, on the CPU: the tiny config of tests/test_train.py
(depths 1,1,1,1; heads 1,2,4,8; dim 32; in_dim 16; 112²; 10 classes) with
the same random variables, no drop path, no mixup, MESA from step 0 and
EMA on, over two steps of adamw with clipping and a warmup schedule."""
import re

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
import fastervit_tpu_torch.train.schedule as TS
from fastervit_tpu_torch.train.steps import (TrainConfig, create_train_state,
                                             make_train_step)
from torch_parity import (few_torch_threads,  # noqa: F401
                          port_state_dict, random_variables)

TINY = dict(depths=[1, 1, 1, 1], num_heads=[1, 2, 4, 8], dim=32, in_dim=16,
            resolution=112, num_classes=10, drop_path_rate=0.0)
CFG = dict(mixup=None, mesa=0.2, mesa_start_step=0, use_ema=True)
SCHED = dict(base_lr=1e-3, t_initial=100, warmup_t=1, warmup_lr_init=1e-4)
STEPS = 2
# A conv bias in front of a train-mode BatchNorm has a zero gradient in
# exact arithmetic, so both frameworks hold only noise there, and Adam's
# sign-like first step moves the bias by ±lr at random; the running mean of
# the BatchNorm behind it inherits that. Those are left out of the
# comparisons of values after a step.
NOISE_ONLY = re.compile(r"levels\.[01]\.blocks\.\d+\.(conv[12]\.bias|"
                        r"norm[12]\.running_mean)$")


@pytest.fixture(scope="module")
def runs():
    """Both frameworks' states and metrics after each of STEPS steps."""
    jm = jfvt.create_model("faster_vit_0_224", **TINY)
    shapes = jax.eval_shape(lambda: jm.module.init(jax.random.PRNGKey(0),
                                                   jm.dummy_input()))
    variables = random_variables(shapes, 11)
    rng = np.random.RandomState(12)
    batches = [{"image": rng.randn(8, 112, 112, 3).astype(np.float32),
                "label": rng.randint(0, 10, 8).astype(np.int32)}
               for _ in range(STEPS)]

    jcfg = JaxTrainConfig(**CFG)
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

    model = fvt.create_model("faster_vit_0_224", device="cpu", **TINY)
    model.load_state_dict(port_state_dict(variables), strict=True)
    tstate = create_train_state(model, TrainConfig(**CFG))
    tstep = make_train_step(TrainConfig(**CFG), TS.cosine_schedule(**SCHED))
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
            "ema": {k: v.clone()
                    for k, v in tstate.ema_model.state_dict().items()},
        })
    return jax_runs, port_runs


def _adam_state(opt_state):
    """optax's ScaleByAdamState inside the clip -> adamw chain."""
    adam = opt_state[1][0]
    assert hasattr(adam, "mu") and hasattr(adam, "nu")
    return adam


def _tree(tree, collection="params"):
    return port_state_dict({collection: tree})


def _largest(tensors):
    return max(t.abs().max().item() for t in tensors)


def _close_per_tensor(got, want, rel, what):
    """max |got − want| <= rel · max |want| for each tensor, with a floor
    of 1e-5 of the largest entry of all: a gradient that is zero in exact
    arithmetic (a conv bias in front of a train-mode BatchNorm) is pure
    noise in both frameworks."""
    floor = 1e-5 * _largest(want[name] for name in got)
    for name, t in got.items():
        w = want[name].numpy()
        bound = max(rel * np.abs(w).max(), floor)
        err = np.abs(t.numpy() - w).max()
        assert err <= bound, f"{what} {name}: {err} > {bound}"


@pytest.mark.parametrize("i", range(STEPS))
def test_metrics_match(runs, i):
    (_, jm), port = runs[0][i], runs[1][i]["metrics"]
    # f32 through a 4-level model, both sides; sums in another order
    np.testing.assert_allclose(port["loss"], float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(port["grad_norm"], float(jm["grad_norm"]),
                               rtol=1e-4)
    np.testing.assert_allclose(port["lr"], float(jm["lr"]), rtol=1e-6)


@pytest.mark.parametrize("i", range(STEPS))
def test_gradients_match(runs, i):
    """Adam's moments hold the clipped gradients: mu = (1 − b1)·g after the
    first step, and both moments follow the gradients after that."""
    (js, _), port = runs[0][i], runs[1][i]
    adam = _adam_state(js.opt_state)
    # gradient noise from the order of the sums, against each tensor's
    # largest entry
    _close_per_tensor(port["mu"], _tree(adam.mu), 2e-4, "mu")
    _close_per_tensor(port["nu"], _tree(adam.nu), 4e-4, "nu")
    if i == 0:
        _close_per_tensor(port["grad"],
                          {k: v / 0.1 for k, v in _tree(adam.mu).items()},
                          2e-4, "grad")


def _moved(runs, i):
    """The learning rates summed over steps 0..i: how far Adam can move an
    entry."""
    return sum(r["metrics"]["lr"] for r in runs[1][:i + 1])


@pytest.mark.parametrize("i", range(STEPS))
def test_bn_stats_and_ema_match(runs, i):
    """BN statistics and EMA after step i. From the second step on, the
    forward also sees the ±lr moves of noise-level entries (see
    test_parameters_match_where_gradients_are_above_noise), so the bound
    grows with the learning rates: a tenth of those of the earlier steps.
    (At learning rates 1000 times smaller the second step's statistics agree
    within 1e-6.)"""
    (js, _), port = runs[0][i], runs[1][i]
    atol = 1e-6 + (1e-1 * _moved(runs, i - 1) if i else 0.0)
    want_bs = _tree(js.batch_stats, "batch_stats")
    want_ema = {**_tree(js.ema_params),
                **_tree(js.ema_batch_stats, "batch_stats")}
    for k, v in want_bs.items():
        if k.endswith("num_batches_tracked") or NOISE_ONLY.search(k):
            continue
        np.testing.assert_allclose(port["model"][k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=atol, err_msg=k)
    for k, v in want_ema.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(port["ema"][k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=atol, err_msg=k)


@pytest.mark.parametrize("i", range(STEPS))
def test_parameters_match_where_gradients_are_above_noise(runs, i):
    """Adam's first steps are sign-like, so an entry whose gradient is at
    the level of the sums' noise may move either way; entries whose
    gradients stand well above it (1e-3 of the tensor's largest and 1e-4
    of the largest of all) must agree: after the first step to 1% of the
    learning rate (an entry's whole Adam movement); after later steps to 5%
    of the learning rates summed, since the noise-level entries' ±lr moves
    of the earlier steps perturb the later forwards."""
    (js, _), port = runs[0][i], runs[1][i]
    want = _tree(js.params)
    largest = _largest(port["grad"].values())
    moved = (5e-2 if i else 1e-2) * _moved(runs, i)
    for name, g in port["grad"].items():
        if NOISE_ONLY.search(name):
            continue
        g = g.abs().numpy()
        keep = g > max(1e-3 * g.max(), 1e-4 * largest)
        got = port["model"][name].numpy()
        np.testing.assert_allclose(got[keep], want[name].numpy()[keep],
                                   rtol=0, atol=moved, err_msg=name)
