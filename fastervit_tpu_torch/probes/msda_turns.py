"""K5, the MSDA forward, timed on the card at the calls of a DINO-4scale
bf16 b2 800x1333 forward, in the port found under --root: for comparing
two trees of the port (a parent unpacked by `git archive`, and the change)
on one card, each in its own process, in turns:

    for t in parent change change parent; do d=.; [ $t = parent ] && \\
        d=_trees/parent; python fastervit_tpu_torch/probes/msda_turns.py \\
        --root $d --out out/msda_turns_$t.json; done

It is run by path, so that it imports `fastervit_tpu_torch` from --root
(whose kernels it builds there) and not from its own tree. The calls are
the encoder's (Q = S = 22,223, six a forward) and the decoder's (Q = 900,
six), at N 2, M 8, D 32, L 4, P 4, each in two location modes:
- uniform: every coordinate uniform in [0, 1] (as chip_smoke.py's phase
  18 times K5);
- coherent: a query's reference point, to which each (head, level, point)
  adds the offset of `ops/msda.py::_sampling_offset_bias` (the module's
  init, (p + 1) pixels along the head's direction) plus N(0, 1) pixels;
  the reference point is the query's own token's centre in the encoder
  (Q = S) and uniform in [0, 1]² in the decoder.
value N(0, 1) and softmax-normalised weights, from a seeded
torch.Generator on the card, in bf16 (the served form, beside f32
locations) and in f32. Each call is timed with CUDA events over 50 calls
after 5, and the sum over the forward's 12 calls printed for each mode and
dtype, with samples a second and the corner bytes a second they imply
(4 corners × D channels a sample). Each output's SHA-256 is written, so
that the outputs of two trees compare bit for bit across processes
(chip_smoke.py's phase 18 reports the registers and spills of K5's
instances). With --profile, one bf16 call's device time is split by
kernel (torch.profiler), to tell the kernel's time from the host's. It
prints one JSON object, with the card's name and power limit,
and writes it to --out if given. It needs a CUDA device.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

# DINO-4scale at 800x1333: the transformer's four levels
LEVELS = ((100, 167), (50, 84), (25, 42), (13, 21))
N, M, D, P = 2, 8, 32, 4
# (call, Q, calls a forward)
CALLS = (("encoder", sum(h * w for h, w in LEVELS), 6), ("decoder", 900, 6))
MODES = ("uniform", "coherent")
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
ITERS = 50
WARMUP = 5


def _time_ms(run) -> float:
    for _ in range(WARMUP):
        run()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
    start.record()
    for _ in range(ITERS):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def token_centres(shapes, device) -> torch.Tensor:
    """(S, 2) normalised (x, y) of every token's centre, level by level,
    row-major within a level, as value's tokens lie."""
    out = []
    for h, w in shapes:
        y, x = torch.meshgrid(torch.arange(h, device=device),
                              torch.arange(w, device=device), indexing="ij")
        out.append(torch.stack([(x.flatten() + 0.5) / w,
                                (y.flatten() + 0.5) / h], -1))
    return torch.cat(out)


def locations(mode: str, n: int, q: int, m: int, p: int, shapes,
              gen: torch.Generator) -> torch.Tensor:
    """Sampling locations (N, Q, M, L, P, 2) f32 on the card in `mode`
    (see the module's docstring)."""
    nl = len(shapes)
    if mode == "uniform":
        return torch.rand(n, q, m, nl, p, 2, device="cuda", generator=gen)
    from fastervit_tpu_torch.ops.msda import _sampling_offset_bias
    if q == sum(h * w for h, w in shapes):
        ref = token_centres(shapes, "cuda").expand(n, q, 2)
    else:
        ref = torch.rand(n, q, 2, device="cuda", generator=gen)
    bias = torch.from_numpy(_sampling_offset_bias(m, nl, p)).cuda()
    pixels = bias.view(m, nl, p, 2) + torch.randn(
        n, q, m, nl, p, 2, device="cuda", generator=gen)
    wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                      device="cuda")
    return (ref[:, :, None, None, None, :]
            + pixels / wh[:, None, :]).contiguous()


def inputs(q: int, mode: str, gen: torch.Generator):
    """f32 value (N, S, M, D), locations and weights (N, Q, M, L, P)."""
    s, nl = sum(h * w for h, w in LEVELS), len(LEVELS)
    value = torch.randn(N, s, M, D, device="cuda", generator=gen)
    w = torch.randn(N, q, M, nl * P, device="cuda", generator=gen)
    w = w.softmax(-1).reshape(N, q, M, nl, P).contiguous()
    return value, locations(mode, N, q, M, P, LEVELS, gen), w


def kernels_us(run) -> dict:
    """Device µs of one call of run, by kernel name (cut to 60 chars)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return {e.key[:60]: e.device_time_total for e in prof.key_averages()
            if e.device_time_total > 0}


def sha256(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".",
                    help="the checkout whose fastervit_tpu_torch is timed")
    ap.add_argument("--profile", action="store_true",
                    help="also split one bf16 call's device time by kernel")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    if not torch.cuda.is_available():
        sys.exit("msda_turns needs a CUDA device")
    from fastervit_tpu_torch.ops import cuda_attention, cuda_msda
    if not Path(cuda_msda.__file__).resolve().is_relative_to(root):
        sys.exit(f"imported {cuda_msda.__file__}, not from {root}")
    cuda_attention.build()
    kernel = cuda_msda.ms_deform_attn_cuda

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"root": str(root), "iters": ITERS, "shape": {
        "N": N, "M": M, "D": D, "P": P, "levels": LEVELS}, "calls": {}}
    sums = {mode: {name: 0.0 for name in DTYPES} for mode in MODES}
    with torch.no_grad():
        for call, q, count in CALLS:
            out["calls"][call] = {"Q": q, "calls": count}
            for mode in MODES:
                value, loc, w = inputs(q, mode, gen)
                samples = N * q * M * len(LEVELS) * P
                row = {"samples": samples, "sha256": {}}
                for name, dtype in DTYPES.items():
                    v, wt = value.to(dtype), w.to(dtype)
                    got = kernel(v, LEVELS, loc, wt)
                    row["sha256"][name] = sha256(got)
                    ms = _time_ms(lambda: kernel(v, LEVELS, loc, wt))
                    plan = getattr(kernel, "last_plan", None)
                    row[name] = {
                        "ms": ms, "g_samples_s": samples / ms / 1e6,
                        "corner_gb_s": (samples * 4 * D * dtype.itemsize
                                        / ms / 1e6),
                        "plan": plan._asdict() if plan else None}
                    sums[mode][name] += count * ms
                    if args.profile and name == "bf16":
                        row[name]["kernels_us"] = kernels_us(
                            lambda: kernel(v, LEVELS, loc, wt))
                    del v, wt, got
                out["calls"][call][mode] = row
                del value, loc, w
    out["sum12_ms"] = sums
    out["per"] = ("one DINO-4scale b2 800x1333 forward: 6 encoder calls "
                  "(Q = 22,223) and 6 decoder calls (Q = 900)")
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
