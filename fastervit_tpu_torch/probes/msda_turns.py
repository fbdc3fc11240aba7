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

With --backward it times K7, the MSDA backward, instead, at the same calls
of a DINO-4scale bf16 b2 800x1333 train step (6 encoder and 6 decoder
calls), given grad_out N(0, 1): the wrapper as the model calls it (the f32
dvalue buffer's zeroing and cast included), in both location modes and
both dtypes, each launch's plan and ptxas' registers and spills of the
served instances. It writes the SHA-256 of dloc and dweights, which keep
their bits across trees, and holds dvalue, in each process, to the plain
version's order bound (`ops/msda.py::dvalue_order_bound`, c counting the
tree's tile flushes where it has them, plus one bf16 rounding); it fails
if dvalue leaves it. --sweep (the change's tree) times K7 at both calls
and modes in bf16 under each candidate plan of `cuda_msda._bwd_plan`,
the choices behind `msda_bwd_plan`:

    python fastervit_tpu_torch/probes/msda_turns.py --backward --sweep \\
        --out out/msda_bwd_sweep.json
"""
from __future__ import annotations

import argparse
import hashlib
import json
import re
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


# K7's candidate plans for --sweep: (label, _bwd_plan's choices: blocks an
# SM the tile must fit, rounds of the grid's chunks a head's rows must fill
# for a tile (inf: never), heads of rows a round of runs covers; ALL: one
# run a block, the first design's grid)
ALL, NEVER = 1e9, float("inf")
SWEEP = (("smem level 3, 2x8 warps, a head a round (the plan)",
          dict(tile_blocks=2, tile_rounds=1, heads_in_flight=1)),
         ("smem level 3, 2x8, also at the decoder",
          dict(tile_blocks=2, tile_rounds=0, heads_in_flight=1)),
         ("smem level 3, 2x8, 4 heads a round",
          dict(tile_blocks=2, tile_rounds=1, heads_in_flight=4)),
         ("smem level 3, 2x8, one run a block",
          dict(tile_blocks=2, tile_rounds=1, heads_in_flight=ALL)),
         ("smem levels 2-3, 1x16 warps, a head a round",
          dict(tile_blocks=1, tile_rounds=1, heads_in_flight=1)),
         ("l2, 2x8 warps, a head a round",
          dict(tile_blocks=2, tile_rounds=NEVER, heads_in_flight=1)),
         ("l2, 2x8 warps, one run a block",
          dict(tile_blocks=2, tile_rounds=NEVER, heads_in_flight=ALL)))


def k7_ptxas(lib: Path) -> dict:
    """Registers and spill stores of K7's served instances (bf16 V 8 G 4,
    f32 V 4 G 8), from the build's ptxas log."""
    out, cur = {}, None
    for line in lib.with_suffix(".log").read_text().splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            cur = None
            for name, mangled in (("bf16", "13__nv_bfloat16Li8ELi4ELi1E"),
                                  ("f32", "fLi4ELi8ELi1E")):
                if "msda_bwd_kernelI" + mangled in entry.group(1):
                    cur = out.setdefault(name, {})
            continue
        if cur is not None:
            for key, pat in (("registers", r"Used (\d+) registers"),
                             ("spill_stores", r"(\d+) bytes spill stores")):
                hit = re.search(pat, line)
                if hit:
                    cur[key] = int(hit.group(1))
    return out


def backward(args, cuda_attention, cuda_msda, lib: Path) -> dict:
    """K7 timed, its dloc and dweights hashed and its dvalue held to the
    order bound at each call, mode and dtype (see the docstring)."""
    from fastervit_tpu_torch.ops import msda
    kernel = cuda_msda.ms_deform_attn_backward_cuda
    flushes = getattr(cuda_msda, "msda_bwd_flushes", None)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"kernel": "K7", "ptxas": k7_ptxas(lib), "calls": {}}
    sums = {mode: {name: 0.0 for name in DTYPES} for mode in MODES}
    sweep = {label: {} for label, _ in SWEEP} if args.sweep else None
    for call, q, count in CALLS:
        out["calls"][call] = {"Q": q, "calls": count}
        for mode in MODES:
            value, loc, w = inputs(q, mode, gen)
            g = torch.randn(N, q, M * D, device="cuda", generator=gen)
            row = {"sha256": {}}
            for name, dtype in DTYPES.items():
                v, wt, gt = value.to(dtype), w.to(dtype), g.to(dtype)
                got = kernel(v, LEVELS, loc, wt, gt)
                plan = kernel.last_plan
                row["sha256"][name] = {"dloc": sha256(got[1]),
                                       "dweights": sha256(got[2])}
                # dvalue against the plain version's f32 sum
                want = msda.msda_backward_reference(
                    v.float(), LEVELS, loc, wt.float(), gt.float())[0]
                extra = {"flushes": flushes(plan, q)} if flushes else {}
                bound, c = msda.dvalue_order_bound(v, LEVELS, loc, wt, gt,
                                                   **extra)
                if dtype == torch.bfloat16:
                    bound = bound + 2 ** -8 * (want.abs() + bound)
                over = ((got[0].float() - want).abs()
                        / bound.clamp(min=torch.finfo(torch.float32).tiny)
                        ).max().item()
                if over > 1:
                    sys.exit(f"K7's dvalue at {call} {mode} {name} is "
                             f"{over:.3f} of its order bound")
                ms = _time_ms(lambda: kernel(v, LEVELS, loc, wt, gt))
                row[name] = {"ms": ms, "dvalue_over_bound": over, "c": c,
                             "plan": plan._asdict()}
                sums[mode][name] += count * ms
                if args.profile and name == "bf16":
                    row[name]["kernels_us"] = kernels_us(
                        lambda: kernel(v, LEVELS, loc, wt, gt))
                if sweep is not None and name == "bf16":
                    make = cuda_msda.msda_bwd_plan
                    try:
                        for label, how in SWEEP:
                            cuda_msda.msda_bwd_plan = (
                                lambda d_, dt, va, ga, shapes, q_, heads,
                                sms, how=how: cuda_msda._bwd_plan(
                                    d_, dt, min(va, ga), shapes, q_, heads,
                                    sms, **how))
                            same = kernel(v, LEVELS, loc, wt, gt)
                            if not (torch.equal(same[1], got[1])
                                    and torch.equal(same[2], got[2])):
                                sys.exit(f"K7 under plan {label} changed "
                                         "dloc or dweights")
                            sweep[label].setdefault(call, {})[mode] = {
                                "ms": _time_ms(lambda: kernel(
                                    v, LEVELS, loc, wt, gt)),
                                "plan": kernel.last_plan._asdict()}
                    finally:
                        cuda_msda.msda_bwd_plan = make
                del v, wt, gt, got, want, bound
            out["calls"][call][mode] = row
            del value, loc, w, g
    out["sum12_ms"] = sums
    if sweep is not None:
        out["sweep"] = sweep
    out["per"] = ("one DINO-4scale b2 800x1333 train step: 6 encoder calls "
                  "(Q = 22,223) and 6 decoder calls (Q = 900)")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".",
                    help="the checkout whose fastervit_tpu_torch is timed")
    ap.add_argument("--profile", action="store_true",
                    help="also split one bf16 call's device time by kernel")
    ap.add_argument("--backward", action="store_true",
                    help="time K7, the MSDA backward, instead of K5")
    ap.add_argument("--sweep", action="store_true",
                    help="with --backward: also time K7's candidate plans")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    if not torch.cuda.is_available():
        sys.exit("msda_turns needs a CUDA device")
    from fastervit_tpu_torch.ops import cuda_attention, cuda_msda
    if not Path(cuda_msda.__file__).resolve().is_relative_to(root):
        sys.exit(f"imported {cuda_msda.__file__}, not from {root}")
    lib = cuda_attention.build()
    if args.backward:
        out = {"root": str(root), "iters": ITERS, "shape": {
            "N": N, "M": M, "D": D, "P": P, "levels": LEVELS},
            **backward(args, cuda_attention, cuda_msda, lib)}
        return _report(out, args)
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
    return _report(out, args)


def _report(out: dict, args) -> dict:
    """out with the card's name and power limit, printed as one JSON line
    and written to --out if given."""
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
