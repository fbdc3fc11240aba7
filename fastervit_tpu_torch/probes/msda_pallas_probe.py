"""Can a kernel that is handed each sample's patch corner and fractions
gather MOTR's level maps faster than K5 computes its own geometry?

The port's counterpart of scripts/msda_pallas_probe.py. At MOTR's streaming
geometry (1536×800: the padded level maps 202×386, 102×194, 52×98 and
27×50; 8 heads, D 32, P 4, QP = 408,000 samples a head and level, f32)
it times, at each level, in turns:

  flat            P3a `fused_gather`: w·bilinear(map, sample), one
                  (M, QP, D) output row a sample;
  p4              P3b `fused_gather_p4`: the same summed over each query's
                  P samples in registers, (M, QP/P, D);
  perhead         P3c `fused_gather_per_head`: P3a with one launch a head;
  grid_sample     the library yardstick: F.grid_sample (bilinear, zeros,
                  align_corners=True) of the padded map at the same
                  samples, times w (`probes.gather_grid_sample`);
  grid_sample_p4  the same summed over P;

each with its ms, ns a sample and bound (bytes at 3.35 TB/s), beside the
map's MB a head. Then the encoder call of the JAX script's `main`
(:348-380): the unpadded levels 200×384 … 25×48, S = Q = 102,000, N 1,
M 8, D 32, L 4, P 4, f32, locations uniform in [0, 1), softmax weights,
through K5 (`ops.msda.ms_deform_attn`), its plain version
(`msda_reference`) and upstream's grid_sample form: their ms, K5's
largest difference from the plain version and the speed-up. The JAX
script's "pallas" and "xla" backends are, in the port, K5 and the plain
version.

First, on a small case (27×50, QP 400), each kernel against the plain
version (P3b against it summed over P); with --device cpu that check runs
through the plain versions, and the probe stops there, as the JAX
script's --interpret does. --e2e-only skips the levels. The JAX script's
--iters is the package's ITERS; its VMEM-driven skips of some variants at
some levels, and the pad of QP to 409,600 (its chunk's), are not carried.

    python -m fastervit_tpu_torch.probes.msda_pallas_probe [--out PATH]
    python -m fastervit_tpu_torch.probes.msda_pallas_probe --device cpu
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from fastervit_tpu_torch.ops import msda, msda_probes
from fastervit_tpu_torch.probes import (HBM_BYTES_PER_S, device_record,
                                        gather_bytes, gather_grid,
                                        gather_grid_sample, in_turns,
                                        msda_grid_sample, parse_probe_args,
                                        probe_parser, report, resolve_device)

# MOTR streaming geometry (1536×800): per-head padded level maps
LEVELS = ((202, 386), (102, 194), (52, 98), (27, 50))
M, D, P = 8, 32, 4
QP = 408_000  # queries (102,000) × points (4) per (head, level)
CHECK_CASE = (27, 50, 400)  # padded map and QP of the correctness check
ENCODER_LEVELS = ((200, 384), (100, 192), (50, 96), (25, 48))
# largest |kernel − plain| on the check case: the same roundings (f32);
# the P sum against the plain P3a's output summed by torch.sum, in another
# order; grid_sample recomputes x, y from the grid in its own arithmetic
TOL_CHECK = {"flat": 1e-5, "p4": 1e-4, "perhead": 1e-5,
             "grid_sample": 1e-4}


def correctness(device: torch.device, gen: torch.Generator) -> dict:
    """P3a, P3b, P3c and the grid_sample yardstick against the plain P3a
    (summed over P for P3b) on the check case; raise past TOL_CHECK."""
    hp, wp, qp = CHECK_CASE
    case = msda_probes.sample_case(hp, wp, qp, M, D, gen, device)
    vm, iy, ix, fy, fx, w = case
    want = msda_probes.gather_reference(*case)
    got = {"flat": msda_probes.fused_gather(*case),
           "p4": msda_probes.fused_gather_p4(*case, P),
           "perhead": msda_probes.fused_gather_per_head(*case),
           "grid_sample": gather_grid_sample(
               vm.permute(0, 3, 1, 2).contiguous(),
               gather_grid(iy, ix, fy, fx, hp, wp), w, 1).transpose(1, 2)}
    wants = {"p4": want.view(M, qp // P, P, D).sum(2)}
    errs = {name: (g - wants.get(name, want)).abs().max().item()
            for name, g in got.items()}
    for name, err in errs.items():
        if not err <= TOL_CHECK[name]:
            raise RuntimeError(f"{name} off the plain version by {err} "
                               f"(tolerance {TOL_CHECK[name]})")
    return errs


def level_row(hp: int, wp: int, gen: torch.Generator,
              device: torch.device) -> dict:
    """The level's rows, timed in turns."""
    case = msda_probes.sample_case(hp, wp, QP, M, D, gen, device)
    vm, iy, ix, fy, fx, w = case
    vm_nchw = vm.permute(0, 3, 1, 2).contiguous()
    grid = gather_grid(iy, ix, fy, fx, hp, wp)
    rows = {  # name: (function, P of its output)
        "flat": (lambda: msda_probes.fused_gather(*case), 1),
        "p4": (lambda: msda_probes.fused_gather_p4(*case, P), P),
        "perhead": (lambda: msda_probes.fused_gather_per_head(*case), 1),
        "grid_sample": (lambda: gather_grid_sample(vm_nchw, grid, w, 1), 1),
        "grid_sample_p4": (lambda: gather_grid_sample(vm_nchw, grid, w, P),
                           P),
    }
    times = in_turns({name: fn for name, (fn, _) in rows.items()})
    row = {"level": f"{hp - 2}x{wp - 2}", "padded": [hp, wp],
           "map_mb_per_head": hp * wp * D * 4 / 1e6}
    for name, (_, p) in rows.items():
        nbytes = gather_bytes(vm.numel() * 4, M, QP, D, p, 5)
        row[name] = {"ms": times[name],
                     "ns_per_sample": times[name] * 1e6 / (M * QP),
                     "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S}
    return row


def encoder_row(gen: torch.Generator, device: torch.device) -> dict:
    """K5, its plain version and upstream's grid_sample form at the JAX
    script's encoder call, in turns."""
    shapes = ENCODER_LEVELS
    s = sum(h * w for h, w in shapes)
    nl = len(shapes)
    kw = {"generator": gen, "device": device}
    value = torch.randn(1, s, M, D, **kw)
    loc = torch.rand(1, s, M, nl, P, 2, **kw)
    weights = torch.randn(1, s, M, nl * P, **kw).softmax(-1).reshape(
        1, s, M, nl, P)
    fns = {"k5": lambda: msda.ms_deform_attn(value, shapes, loc, weights),
           "plain": lambda: msda.msda_reference(value, shapes, loc, weights),
           "grid_sample": lambda: msda_grid_sample(value, shapes, loc,
                                                   weights)}
    times = in_turns(fns)
    diff = (fns["k5"]() - fns["plain"]()).abs().max().item()
    samples = s * M * nl * P
    return {"S": s, "levels": [list(hw) for hw in shapes], "N": 1, "M": M,
            "D": D, "L": nl, "P": P, "samples": samples,
            **{f"ms_{name}": t for name, t in times.items()},
            "ns_per_sample_k5": times["k5"] * 1e6 / samples,
            "parity_max_abs_diff": diff,
            "speedup": times["plain"] / times["k5"]}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = probe_parser(__doc__)
    ap.add_argument("--e2e-only", action="store_true",
                    help="skip the levels; run the check and the encoder "
                         "call only")
    args = parse_probe_args(ap, argv)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    result = {"probe": "msda_pallas_probe",
              "geometry": {"levels": [list(hw) for hw in LEVELS], "M": M,
                           "D": D, "P": P, "QP": QP, "dtype": "float32"},
              "device": device_record(device)}
    with torch.no_grad():
        result["correctness_max_err"] = correctness(device, gen)
        if device.type == "cuda":
            result["levels"] = [] if args.e2e_only else [
                level_row(hp, wp, gen, device) for hp, wp in LEVELS]
            result["encoder_call"] = encoder_row(gen, device)
    return report(result, args.out)


if __name__ == "__main__":
    main()
