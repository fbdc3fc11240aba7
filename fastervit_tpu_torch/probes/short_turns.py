"""K1 and K2, the short-window attention forward and backward, timed on the
card at the calls of a faster_vit_0_224 bf16 b256 forward (K1) and b128
train step (K2), in the port found under --root: for comparing two trees
of the port (a parent unpacked by `git archive`, and the change) on one
card, each in its own process, in turns:

    for t in parent change change parent; do d=.; [ $t = parent ] && \\
        d=_trees/parent; python fastervit_tpu_torch/probes/short_turns.py \\
        --root $d --out out/short_turns_$t.json; done

It is run by path, so that it imports `fastervit_tpu_torch` from --root
(whose kernels it builds there) and not from its own tree. Inputs are
bf16 qkv, g and a bf16 bias from a seeded torch.Generator on the card;
each shape is timed with CUDA events over 50 calls after 5, and its sum
over the forward's or the step's calls is printed. With --profile each
K2 call's device time is split by kernel (the main kernel and the dbias
sum; torch.profiler). With --sweep it also times each call of the tree
under --root at grids of 132 to 4,224 blocks (a tree whose cuda_attention
sets the grids' target by `_FWD_TARGET_BLOCKS` and `_BWD_TARGET_BLOCKS`).
It prints one JSON object, with the card's name and power limit, and
writes it to --out if given. It needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# (B, S, heads, head_dim, calls): fv0's level-2 joint window + carrier
# attention, level-2 carrier attention and level 3, at batch 256 (K1, a
# forward) and at batch 128 (K2, a train step)
K1_SHAPES = ((1024, 53, 8, 32, 6), (256, 16, 8, 32, 6), (256, 49, 16, 32, 5))
K2_SHAPES = ((512, 53, 8, 32, 6), (128, 16, 8, 32, 6), (128, 49, 16, 32, 5))
ITERS = 50
WARMUP = 5
SWEEP = (132, 264, 528, 1056, 2112, 4224)  # blocks a call, --sweep


def _time_ms(torch, run) -> float:
    for _ in range(WARMUP):
        run()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
    start.record()
    for _ in range(ITERS):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def _kernels_us(torch, run) -> dict:
    """Device µs of one call of run, by kernel name (cut to 60 chars)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return {e.key[:60]: e.device_time_total for e in prof.key_averages()
            if e.device_time_total > 0}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".",
                    help="the checkout whose fastervit_tpu_torch is timed")
    ap.add_argument("--profile", action="store_true",
                    help="also split each K2 call's device time by kernel")
    ap.add_argument("--sweep", action="store_true",
                    help="also time each call at grids of 132 to 4,224 "
                         "blocks")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        sys.exit("short_turns needs a CUDA device")
    from fastervit_tpu_torch.ops import cuda_attention
    if not Path(cuda_attention.__file__).resolve().is_relative_to(root):
        sys.exit(f"imported {cuda_attention.__file__}, not from {root}")
    cuda_attention.build()

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": str(root), "iters": ITERS}
    for name, shapes, backward in (("k1", K1_SHAPES, False),
                                   ("k2", K2_SHAPES, True)):
        kernel = (cuda_attention.window_mhsa_backward_cuda if backward
                  else cuda_attention.window_mhsa_cuda)
        rows, total = {}, 0.0
        for b, s, h, d, calls in shapes:
            def rand(*shape):
                return torch.randn(*shape, device="cuda", generator=gen,
                                   dtype=torch.bfloat16)
            qkv, bias = rand(b, s, 3 * h * d), rand(h, s, s)
            g = rand(b, s, h * d)
            if backward:
                run = lambda: kernel(qkv, bias, g, h, d ** -0.5)  # noqa: E731
                flops = 10.0 * b * h * s * s * d
            else:
                run = lambda: kernel(qkv, bias, h, d ** -0.5)  # noqa: E731
                flops = 4.0 * b * h * s * s * d
            ms = _time_ms(torch, run)
            row = {"ms": ms, "calls": calls,
                   "tflop_s": flops / ms / 1e9,
                   "plan": getattr(kernel, "last_plan", None)}
            if row["plan"] is not None:
                row["plan"] = row["plan"]._asdict()
            if backward and args.profile:
                row["kernels_us"] = _kernels_us(torch, run)
            if args.sweep:
                knob = "_BWD_TARGET_BLOCKS" if backward else \
                    "_FWD_TARGET_BLOCKS"
                was = getattr(cuda_attention, knob)
                row["sweep_ms"] = {}
                for target in SWEEP:
                    setattr(cuda_attention, knob, target)
                    cuda_attention._run_grid.cache_clear()
                    row["sweep_ms"][target] = _time_ms(torch, run)
                setattr(cuda_attention, knob, was)
                cuda_attention._run_grid.cache_clear()
            rows[f"({b},{s},{h},{d})"] = row
            total += calls * ms
            del qkv, bias, g
        out[name] = {"rows": rows, "ms_summed": total,
                     "per": ("one fv0 bf16 b128 train step (17 calls)"
                             if backward else
                             "one fv0 bf16 b256 forward (17 calls)")}
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps(out))
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
    return out


if __name__ == "__main__":
    main()
