"""Fine-tuning: the program's train step (`make_train_step`) on one train
state (`create_train_state`: the model with float32 weights, AdamW, the
EMA copy), in a closed loop that keeps `in_flight` steps on the card, each
step's loss copied to the host behind it.

Set-up: the model built from the seed's weights, the state, a pool of
distinct batches (images and labels drawn on the card), then the first
`compared_steps` steps through the window's own call on distinct batches.
Their losses, the first step's clipped gradients (read back from AdamW's
first moment, m = (1 - β1)·g after one step) and the weights' change over
them are kept. The window: steps issued for `seconds` on the same state.
With --trace, `trace_batches` more steps follow under the profiler.

Correctness, after the window, with the program freed: the float32
reference (TF32 off) runs the same steps from the same weights on the
same batches and draws (h100bench/reference/train.py). Compared: each
step's loss (the largest relative gap), and by the worst leaf the norm of
the first gradient and of the weights' change, each gap taken against the
reference's norm of that leaf or of the median leaf, whichever is larger.
What the reference's first gradient holds at nought to rounding is left
out: of the gradient, leaves under a thousandth of the median leaf's norm;
of the change, entries under a thousandth of the median leaf's
root-mean-square entry (a key's bias under softmax is a third of its
qkv bias).
"""
from __future__ import annotations

import gc
import statistics
import time
from typing import Dict

import torch

from h100bench import faults, harness, program, weights
from h100bench.counts import fastervit as counts
from h100bench.loop import Loop
from h100bench.reference import fastervit as reference
from h100bench.reference import train as ref_train

ZERO_GRAD = 1e-3   # of the median leaf's reference gradient norm
# the control (the reference in the program's place, its products in
# float8, one precision below bf16) and the faults a train step can have,
# for h100bench/control.py
CONTROLS = {"fp8": {"cast": faults.fp8},
            "half_batch": {"fault": faults.half_batch},
            "altered_answer": {"fault": faults.altered_answer},
            "unchanged_state": {"fault": faults.unchanged_state}}


def recipe(traffic: Dict) -> ref_train.Recipe:
    return ref_train.Recipe(lr=traffic["lr"],
                            weight_decay=traffic["weight_decay"],
                            clip_grad=traffic["clip_grad"])


def make_batches(cell: harness.Cell):
    """(images NCHW, labels) of `pool` distinct batches, float32, from the
    seed on the device."""
    cfg, t, dev = cell.config, cell.traffic, cell.device
    res = cfg["resolution"]
    images = weights.input_pool(cell.seed, t["pool"],
                                (t["batch"], cfg["in_chans"], res, res), dev,
                                torch.float32)
    gen = torch.Generator(device=dev).manual_seed(cell.seed ^ 0x1AB)
    labels = torch.randint(0, cfg["num_classes"], (t["pool"], t["batch"]),
                           generator=gen, device=dev)
    return images, labels


def program_step(cell: harness.Cell, fault=None):
    """The program's state and step; `fault` breaks the step underneath
    (the faults of h100bench/control.py)."""
    from fastervit_tpu_torch.train import steps
    from fastervit_tpu_torch.train.mixup import MixupConfig
    cfg, t = cell.config, cell.traffic
    model = program.build(cfg, cell.seed, cell.device, torch.float32, False)
    tcfg = steps.TrainConfig(
        clip_grad=t["clip_grad"], weight_decay=t["weight_decay"],
        opt="adamw", ema_decay=t["ema_decay"], use_ema=True,
        mixup=MixupConfig(num_classes=cfg["num_classes"]))
    state = steps.create_train_state(model, tcfg)
    lr = t["lr"]
    step = steps.make_train_step(tcfg, lambda _: lr,
                                 getattr(torch, t["dtype"]), seed=cell.seed)
    return state, (step if fault is None else fault(step))


def run(cell: harness.Cell, fault=None, cast=None) -> harness.Record:
    """One run. `fault` and `cast` are for h100bench/control.py: a fault
    planted in the program's step, or the reference in the program's place
    at a lower precision (`cast` on every product's operands)."""
    cfg, t, dev = cell.config, cell.traffic, cell.device
    cuda = dev.type == "cuda"
    images, labels = make_batches(cell)
    nhwc = images.permute(0, 1, 3, 4, 2).contiguous()   # a loader's layout
    n_cmp, b = t["compared_steps"], t["batch"]
    if cast is None:
        state, step = program_step(cell, fault)

        def work(i):
            p = i % t["pool"]
            metrics = step(state, {"image": nhwc[p], "label": labels[p]})
            return metrics["loss"].reshape(1), b

        loop = Loop(work, t["in_flight"], dev)
        names = dict(state.model.named_parameters())
        losses = _steps(loop, 1)
        t_check = time.perf_counter()
        # after one step AdamW's first moment is (1 - β1)·g
        moments = state.optimizer.state
        grads = {k: float(moments[p]["exp_avg"].norm()) / (1.0 - 0.9)
                 for k, p in names.items() if p in moments}
        t_check -= time.perf_counter()
        losses += _steps(loop, n_cmp - 1)
        t_check += time.perf_counter()
        delta = _change(cell, names)
        t_check -= time.perf_counter()
    else:
        loop, t_check = None, 0.0
        losses, grads, delta = _reference_readings(cell, images, labels,
                                                   cast)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    # the readings kept for the check are not set-up
    setup_s = time.perf_counter() - cell.t_start + t_check
    window, trace = [], None
    if loop is not None and cell.seconds > 0:
        window = loop.run(seconds=cell.seconds)
        trace = loop.traced(t["trace_batches"]) if cell.trace else None
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if loop is not None:
        del loop, work, step, state, names, moments
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    want = _reference_readings(cell, images, labels, None)
    checks = compare(cell, (losses, grads, delta), want)
    calls = counts.attention_calls(cfg, b)
    return harness.Record(
        kind="train", setup_s=setup_s, seconds=cell.seconds, batches=window,
        flops_per_image=3 * counts.forward_flops(cfg, live_bias=True),
        attention_forward=calls, attention_backward=calls, checks=checks,
        attempted=len(window), failed=0, memory_peak_bytes=peak,
        trace=trace)


def _steps(loop: Loop, n: int):
    """n steps through the window's loop; their losses."""
    out = []
    loop.on_done = lambda i, host: out.append(host.item())
    loop.run(n=n)
    loop.on_done = None
    return out


def _change(cell, names):
    """The weights' change from the seed's, by leaf, on the host."""
    start = weights.reference_weights(
        reference.parameter_layout(cell.config), cell.seed, cell.device,
        torch.float32)
    with torch.no_grad():
        return {k: (p - start[k]).cpu() for k, p in names.items()}


def _reference_readings(cell, images, labels, cast):
    """(losses, first gradients, changes) of the reference's steps, float32
    with TF32 off (or cast lower)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    layout = reference.parameter_layout(cell.config)
    params = weights.reference_weights(layout, cell.seed, cell.device,
                                       torch.float32)
    start = {k: v.clone() for k, v in params.items()}
    n = cell.traffic["compared_steps"]
    losses, first = ref_train.train_steps(
        params, [(images[s], labels[s]) for s in range(n)], cell.config,
        recipe(cell.traffic), cell.seed, cast)
    with torch.no_grad():
        delta = {k: params[k] - start[k] for k in first}
    return losses, first, delta


def _norm(t) -> float:
    return float(t.norm()) if isinstance(t, torch.Tensor) else float(t)


def grad_gap(got: Dict, first: Dict[str, torch.Tensor]) -> float:
    """The worst leaf's |‖got‖ - ‖want‖| / max(‖want‖, median ‖want‖) of
    the first gradient, over the leaves whose reference gradient is at
    least a thousandth of the median leaf's."""
    want = {k: _norm(g) for k, g in first.items()}
    med = statistics.median(want.values())
    worst = 0.0
    for k, w in want.items():
        if w < ZERO_GRAD * med:
            continue
        gap = abs(_norm(got.get(k, float("nan"))) - w) / max(w, med)
        worst = max(worst, gap if gap == gap else float("inf"))
    return worst


def delta_gap(got: Dict, want: Dict[str, torch.Tensor],
              first: Dict[str, torch.Tensor]) -> float:
    """The same gap of the weights' change, each leaf's norm taken over the
    entries whose first reference gradient is at least a thousandth of the
    median leaf's root-mean-square entry: the rest (a key's bias under
    softmax, a conv bias in front of a train-mode BatchNorm) is nought to
    rounding, and AdamW moves it by round-off alone."""
    rms = statistics.median(_norm(g) / g.numel() ** 0.5
                            for g in first.values())
    kept_want, kept_got = {}, {}
    for k, w in want.items():
        keep = first[k].abs() >= ZERO_GRAD * rms
        if not bool(keep.any()):
            continue
        kept_want[k] = _norm(w[keep])
        g = got.get(k)
        kept_got[k] = (float("nan") if g is None
                       else _norm(g.to(keep.device)[keep]))
    med = statistics.median(kept_want.values())
    worst = 0.0
    for k, w in kept_want.items():
        gap = abs(kept_got[k] - w) / max(w, med)
        worst = max(worst, gap if gap == gap else float("inf"))
    return worst


def compare(cell, got, want):
    (lp, gp, dp), (lr, first, dr) = got, want
    if len(lp) != len(lr):
        loss = float("inf")
    else:
        loss = max(abs(a - b) / abs(b) for a, b in zip(lp, lr))
        loss = loss if loss == loss else float("inf")
    readings = {"loss_gap": loss, "grad_gap": grad_gap(gp, first),
                "delta_gap": delta_gap(dp, dr, first)}
    return {k: {"value": v, "limit": cell.limits[k]}
            for k, v in readings.items() if k in cell.limits}
