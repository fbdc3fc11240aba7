"""K6, the fused HAT sub-block, timed on the card at the calls of a
faster_vit_0_224 bf16 b256 forward with set_fused_hat(True), in the port
found under --root: for comparing two trees of the port (a parent unpacked
by `git archive`, and the change) on one card, each in its own process, in
turns:

    for t in parent change change parent; do d=.; [ $t = parent ] && \\
        d=_trees/parent; python fastervit_tpu_torch/probes/hat_turns.py \\
        --root $d --out out/hat_turns_$t.json; done

It is run by path, so that it imports `fastervit_tpu_torch` from --root
(whose kernels it builds there) and not from its own tree. The calls are
the level-2 carrier sub-blocks (B 256 windows of S 16, six a forward), the
level-2 joint ones (B 1024 of S 53, six) and level 3 (B 256 of S 49, C 512,
five), with bf16 inputs, weights and bias from a seeded torch.Generator on
the card (hidden 4C). Each call is timed with CUDA events over 30 calls
after 5, beside the port's composed sub-block (LayerNorm, cuBLAS, K1,
GELU and elementwise passes: no single PyTorch call computes a HAT
sub-block) on the same inputs and the least time the card could take
(the weights, x and out over the memory rate, or the products over the
bf16 tensor-core peak, whichever is larger); the 17-call sums are
printed. With --profile each call's device time is split by kernel
(torch.profiler). With --forward the whole fv0 bf16 b256 forward is timed
fused and composed, in turns (on, off, off, on), 20 forwards each. It
prints one JSON object, with the card's name and power limit, and writes
it to --out if given. It needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# (B, S, heads, C, calls a forward) of faster_vit_0_224 at batch 256
SITES = ((256, 16, 8, 256, 6), (1024, 53, 8, 256, 6), (256, 49, 16, 512, 5))
ITERS = 30
WARMUP = 5
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
BF16_FLOP_PER_S = 989e12    # H100 SXM dense bf16 tensor cores


def _time_ms(torch, run, iters: int = ITERS) -> float:
    for _ in range(WARMUP):
        run()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
    start.record()
    for _ in range(iters):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _kernels_us(torch, run) -> dict:
    """Device µs of one call of run, by kernel name (cut to 60 chars)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return {e.key[:60]: e.device_time_total for e in prof.key_averages()
            if e.device_time_total > 0}


def _inputs(torch, b, s, h, c, gen):
    """x (B, S, C), the fused block's params (matrices (out, in), scaled by
    1/sqrt(fan in)) and a bias (H, S, S), all bf16 on the card."""
    hidden = 4 * c

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen) * scale
                ).bfloat16()

    def u(n, shift=0.0):
        return (torch.rand(n, device="cuda", generator=gen) + shift
                ).bfloat16()

    params = {"ln1_scale": u(c, 0.5), "ln1_bias": r(c, scale=0.1),
              "qkv_w": r(3 * c, c, scale=c ** -0.5),
              "qkv_b": r(3 * c, scale=0.05),
              "proj_w": r(c, c, scale=c ** -0.5), "proj_b": r(c, scale=0.05),
              "gamma3": u(c), "ln2_scale": u(c, 0.5),
              "ln2_bias": r(c, scale=0.1),
              "fc1_w": r(hidden, c, scale=c ** -0.5),
              "fc1_b": r(hidden, scale=0.05),
              "fc2_w": r(c, hidden, scale=hidden ** -0.5),
              "fc2_b": r(c, scale=0.05), "gamma4": u(c)}
    return r(b, s, c), params, r(h, s, s)


def _composed(torch, attention, x, p, bias, h, scale):
    """The port's composed HAT sub-block (models.layers.HAT with the switch
    off)."""
    F = torch.nn.functional
    c = x.shape[-1]
    y = F.layer_norm(x, (c,), p["ln1_scale"], p["ln1_bias"], 1e-5)
    y = attention.window_mhsa(F.linear(y, p["qkv_w"], p["qkv_b"]), bias, h,
                              scale)
    x = x + p["gamma3"] * F.linear(y, p["proj_w"], p["proj_b"])
    y = F.layer_norm(x, (c,), p["ln2_scale"], p["ln2_bias"], 1e-5)
    y = F.linear(F.gelu(F.linear(y, p["fc1_w"], p["fc1_b"])), p["fc2_w"],
                 p["fc2_b"])
    return x + p["gamma4"] * y


def _forward(torch, fvt) -> dict:
    """faster_vit_0_224 bf16 b256 eval forwards with the fused block on and
    off, in turns (on, off, off, on), 20 each after 5."""
    model = fvt.create_model("faster_vit_0_224",
                             generator=torch.Generator().manual_seed(43))
    model = model.eval().to(torch.bfloat16)
    x = torch.randn(256, 3, 224, 224, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(44)
                    ).bfloat16()
    times = {True: [], False: []}
    prev = fvt.set_fused_hat(True)
    try:
        with torch.no_grad():
            for on in (True, False, False, True):
                fvt.set_fused_hat(on)
                times[on].append(_time_ms(torch, lambda: model(x), 20))
    finally:
        fvt.set_fused_hat(prev)
    return {"fused_ms": times[True], "composed_ms": times[False],
            "fused_mean_ms": sum(times[True]) / 2,
            "composed_mean_ms": sum(times[False]) / 2}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".",
                    help="the checkout whose fastervit_tpu_torch is timed")
    ap.add_argument("--profile", action="store_true",
                    help="also split each call's device time by kernel")
    ap.add_argument("--forward", action="store_true",
                    help="also time the fv0 bf16 b256 forward, fused and "
                         "composed, in turns")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        sys.exit("hat_turns needs a CUDA device")
    import fastervit_tpu_torch as fvt
    from fastervit_tpu_torch.ops import attention, cuda_attention
    from fastervit_tpu_torch.ops import cuda_hat_block
    if not Path(cuda_hat_block.__file__).resolve().is_relative_to(root):
        sys.exit(f"imported {cuda_hat_block.__file__}, not from {root}")
    cuda_attention.build()
    kernel = cuda_hat_block.hat_block_cuda

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": str(root), "iters": ITERS, "sites": {}}
    sums = {"ms": 0.0, "composed_ms": 0.0, "bound_ms": 0.0}
    with torch.no_grad():
        for b, s, h, c, calls in SITES:
            x, p, bias = _inputs(torch, b, s, h, c, gen)
            scale = (c // h) ** -0.5
            run = lambda: kernel(x, p, bias, h, scale)  # noqa: E731
            ms = _time_ms(torch, run)
            composed = _time_ms(torch, lambda: _composed(
                torch, attention, x, p, bias, h, scale))
            flops = 2.0 * b * s * c * 12 * c + 4.0 * b * h * s * s * (c // h)
            nbytes = 2 * (2 * b * s * c + sum(v.numel() for v in p.values())
                          + bias.numel())
            bound = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                              flops / BF16_FLOP_PER_S)
            plan = kernel.last_plan
            row = {"calls": calls, "ms": ms, "composed_ms": composed,
                   "bound_ms": bound, "tflop_s": flops / ms / 1e9,
                   "plan": plan._asdict() if plan is not None else None}
            if args.profile:
                row["kernels_us"] = _kernels_us(torch, run)
            out["sites"][f"({b},{s},{h},{c})"] = row
            for key in sums:
                sums[key] += calls * row[key]
            del x, p, bias
    out["sum17"] = sums
    out["per"] = "one faster_vit_0_224 bf16 b256 forward (17 K6 calls)"
    if args.forward:
        out["forward"] = _forward(torch, fvt)
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
