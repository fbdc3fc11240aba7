"""K4, the long-window attention backward, timed on the card at the calls
of a faster_vit_4_21k_384 bf16 b32 fine-tune step, in the port found
under --root: for comparing two trees of the port (a parent unpacked by
`git archive`, and the change) on one card, each in its own process, in
turns:

    for t in parent change change parent; do d=.; [ $t = parent ] && \\
        d=_trees/parent; python fastervit_tpu_torch/probes/long_bwd_turns.py \\
        --root $d --out out/k4_turns_$t.json; done

It is run by path, so that it imports `fastervit_tpu_torch` from --root
(whose kernels it builds there) and not from its own tree. Inputs are
bf16 qkv, g and a bf16 bias from a seeded torch.Generator on the card;
each shape is timed with CUDA events over 20 calls after 3, and
with --profile its launches' device times are split by kernel
(torch.profiler). It prints one JSON object, with the card's name and
power limit, and writes it to --out if given. It needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# (B, S, heads, head_dim): the 21k-384 b32 step's level-2 and level-3 calls
SHAPES = ((32, 576, 16, 49), (32, 144, 32, 49))
ITERS = 20


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".",
                    help="the checkout whose fastervit_tpu_torch is timed")
    ap.add_argument("--profile", action="store_true",
                    help="also split one call's device time by kernel")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        sys.exit("long_bwd_turns needs a CUDA device")
    from fastervit_tpu_torch.ops import cuda_attention
    kernel = cuda_attention.window_mhsa_long_backward_cuda
    if not Path(cuda_attention.__file__).resolve().is_relative_to(root):
        sys.exit(f"imported {cuda_attention.__file__}, not from {root}")
    cuda_attention.build()

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for b, s, h, d in SHAPES:
        qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen,
                          dtype=torch.bfloat16)
        bias = torch.randn(h, s, s, device="cuda", generator=gen,
                           dtype=torch.bfloat16)
        g = torch.randn(b, s, h * d, device="cuda", generator=gen,
                        dtype=torch.bfloat16)
        run = lambda: kernel(qkv, bias, g, h, d ** -0.5)  # noqa: E731
        for _ in range(3):
            run()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        for _ in range(ITERS):
            run()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / ITERS
        row = {"ms": ms, "tflop_s": 10.0 * b * h * s * s * d / ms / 1e9,
               "plan": getattr(kernel, "last_plan", None)}
        if row["plan"] is not None:
            row["plan"] = row["plan"]._asdict()
        if args.profile:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            row["kernels_us"] = {
                e.key[:60]: e.device_time_total
                for e in prof.key_averages() if e.device_time_total > 0}
        rows[f"({b},{s},{h},{d})"] = row
        del qkv, bias, g
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    out = {"root": str(root), "card": smi, "iters": ITERS, "rows": rows}
    print(json.dumps(out))
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
    return out


if __name__ == "__main__":
    main()
