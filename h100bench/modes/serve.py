"""Batched classification serving: a closed loop that keeps `in_flight`
batches on the card (one queued behind the one running, at 2), each
batch's logits copied to pinned host memory as it ends.

Set-up: the model built and baked, the input pool made on the card, and
`warmup_batches` batches through the same loop. The window: batches issued
for `seconds`; each batch's issue, enqueue end and arrival on the host are
timed by the host clock; batches still in flight at the close are drained.
With --trace, `trace_batches` more batches follow under the profiler.

Correctness: for each pool entry, one of the window's batches on it is
kept, drawn from the seed (reservoir sampling over the batches that
finished), and its logits are held against the float32 reference over the
same weights and images, after the program is freed. The number compared
is the widest relative gap of a row, ‖served − reference‖ / ‖reference‖.
"""
from __future__ import annotations

import collections
import gc
import random
import time

import torch

from h100bench import harness, program, weights
from h100bench.loop import Loop
from h100bench.counts import fastervit as counts
from h100bench.reference import fastervit as reference


# the control (h100bench/control.py): the program's own int8 serving path
CONTROLS = {"int8": {"quantized": True}}


def run(cell: harness.Cell, quantized: bool = False) -> harness.Record:
    """One run of the cell. `quantized` serves the program's int8 path in
    place of the configured one: the control of `h100bench/control.py`."""
    cfg, traffic, dev = cell.config, cell.traffic, cell.device
    dtype = getattr(torch, traffic["dtype"])
    batch, res = traffic["batch"], cfg["resolution"]
    cuda = dev.type == "cuda"
    model = program.build(cfg, cell.seed, dev, dtype, traffic["baked"],
                          quantized)
    pool = weights.input_pool(cell.seed, traffic["pool"],
                              (batch, cfg["in_chans"], res, res), dev, dtype)
    kept, seen = {}, collections.Counter()
    keep = random.Random(cell.seed)

    def work(i):
        with torch.no_grad():
            return model(pool[i % len(pool)]), batch

    def sample(i, host):
        # one batch a pool entry, uniform over those that finished
        p = i % len(pool)
        seen[p] += 1
        if keep.randrange(seen[p]) == 0:
            kept[p] = host.clone()

    loop = Loop(work, traffic["in_flight"], dev)
    loop.run(n=traffic["warmup_batches"])
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - cell.t_start

    loop.on_done = sample
    window = loop.run(seconds=cell.seconds)
    loop.on_done = None
    trace = loop.traced(traffic["trace_batches"]) if cell.trace else None
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    del loop, work, model, pool
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    checks = compare(cell, kept, dtype)
    calls = counts.attention_calls(cfg, batch)
    return harness.Record(
        kind="serve", setup_s=setup_s, seconds=cell.seconds, batches=window,
        flops_per_image=counts.forward_flops(cfg,
                                             live_bias=not traffic["baked"]),
        attention_forward=calls, attention_backward=[], checks=checks,
        attempted=len(window), failed=0, memory_peak_bytes=peak,
        trace=trace)


def compare(cell: harness.Cell, kept, dtype: torch.dtype):
    """The kept batches' logits against the float32 reference (TF32 off),
    in blocks of `reference_rows` images."""
    cfg, traffic, dev = cell.config, cell.traffic, cell.device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = weights.reference_weights(reference.parameter_layout(cfg),
                                       cell.seed, dev, dtype)
    res, batch = cfg["resolution"], traffic["batch"]
    pool = weights.input_pool(cell.seed, traffic["pool"],
                              (batch, cfg["in_chans"], res, res), dev, dtype)
    rows = traffic["reference_rows"]
    worst = 0.0
    for p, served in sorted(kept.items()):
        x = pool[p].float()
        with torch.no_grad():
            want = torch.cat([reference.forward(params, x[i:i + rows], cfg)
                              for i in range(0, batch, rows)])
        worst = max(worst, row_gap(served.to(dev).float(), want))
    if not kept:
        worst = float("inf")
    return {"logit_gap": {"value": worst,
                          "limit": cell.limits["logit_gap"]}}


def row_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over rows of ‖got − want‖ / ‖want‖ (inf where not finite)."""
    gap = ((got - want).norm(dim=1) / want.norm(dim=1)).max().item()
    return gap if gap == gap else float("inf")
