"""Does the MSDA gather pay for its per-sample scalar work: an integer
div/mod, the four corner weights, or the weights' broadcast over lanes?

The port's counterpart of scripts/msda_packed_probe2.py. At MOTR's
streaming geometry (the padded levels 202×386 … 27×50, 8 heads, D 32, P 4,
QP = 408,000 samples a head and level, f32) it times, at each of the first
--levels levels (the largest first; 2 by default, as the JAX script), in
turns:

  pair_staticr     P4b `pair_staticr`: P3b's sum over P on the unpacked
                   map (the JAX kernel's static row index, which spares
                   the TPU's scalar unit a div/mod, has no counterpart
                   here);
  packed_coeff     P4c `packed_coeff`: the corner-packed gather with the
                   four corner weights precomputed (`coeff_scalars`), a
                   fifth 4-byte stream a sample;
  packed_wide      P4d `packed_wide`: the corner-packed gather times a
                   coefficient row a sample (`coeff_wide`, 4D f32), the
                   four corner groups kept, (M, QP/P, 4D);
  packed_wide_sum  P4d and the group sum after it in torch, as the JAX
                   script's XLA reduction (:242);
  pair_p4          P3b `fused_gather_p4`, beside P4b;
  packed           P4a `packed_gather`, which forms its corner weights in
                   the kernel, beside P4c and P4d;
  grid_sample_p4   the library yardstick: F.grid_sample of the padded map
                   at the same samples, times w, summed over P;

each with its ms, ns a sample and bound (bytes at 3.35 TB/s). First, on a
small case (27×50, QP 400), P4b, P4c and P4d (its groups summed) against
the plain P3a summed over P; with --device cpu that check runs through the
plain versions and the probe stops there, as the JAX script's --interpret
does. The JAX script's --iters is the package's ITERS; the pad of QP to
its chunk is not carried.

    python -m fastervit_tpu_torch.probes.msda_packed_probe2 [--out PATH]
    python -m fastervit_tpu_torch.probes.msda_packed_probe2 --levels 4
    python -m fastervit_tpu_torch.probes.msda_packed_probe2 --device cpu
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from fastervit_tpu_torch.ops import msda_probes
from fastervit_tpu_torch.probes import (HBM_BYTES_PER_S, device_record,
                                        gather_bytes, gather_grid,
                                        gather_grid_sample, in_turns,
                                        parse_probe_args, probe_parser,
                                        report, resolve_device)
from fastervit_tpu_torch.probes.msda_packed_probe import packed_case
from fastervit_tpu_torch.probes.msda_pallas_probe import (CHECK_CASE, D,
                                                          LEVELS, M, P, QP)

# largest |variant − plain P3a summed over P| on the check case, the JAX
# script's bound: f32 both sides, in other orders of roundings (the corner
# weights multiplied out first, the P sum by torch.sum, P4d's groups added
# after the P sum)
TOL_CHECK = 1e-4


def group_sum(wide: torch.Tensor) -> torch.Tensor:
    """P4d's (M, QP/P, 4D) output with its four corner groups added:
    (M, QP/P, D), as the JAX script's `reshape(M, qp/P, 4, D).sum(2)`."""
    m, q, d4 = wide.shape
    return wide.view(m, q, 4, d4 // 4).sum(2)


def variants(case, wp: int) -> dict:
    """P4b, P4c and P4d (its groups summed) of a P3 case (vm, iy, ix, fy,
    fx, w), as the JAX script's `main` forms them (:234-242): P4b on vm,
    P4c and P4d on its corner-packed map with fl = iy·(Wp−1) + ix and the
    weights of `coeff_scalars` and `coeff_wide`. Each (M, QP/P, D) f32."""
    pm, _, fl = packed_case(case, wp)
    fy, fx, w = case[3:]
    d = case[0].shape[-1]
    return {"pair_staticr": msda_probes.pair_staticr(*case, P),
            "packed_coeff": msda_probes.packed_coeff(
                pm, fl, *msda_probes.coeff_scalars(fy, fx, w), P),
            "packed_wide": group_sum(msda_probes.packed_wide(
                pm, fl, msda_probes.coeff_wide(fy, fx, w, d), P))}


def correctness(device: torch.device, gen: torch.Generator) -> dict:
    """P4b, P4c and P4d (its groups summed) against the plain P3a summed
    over P on the check case; raise past TOL_CHECK."""
    hp, wp, qp = CHECK_CASE
    case = msda_probes.sample_case(hp, wp, qp, M, D, gen, device)
    want = msda_probes.gather_reference(*case).view(M, qp // P, P, D).sum(2)
    errs = {name: (g - want).abs().max().item()
            for name, g in variants(case, wp).items()}
    for name, err in errs.items():
        if not err <= TOL_CHECK:
            raise RuntimeError(f"{name} off the plain version by {err} "
                               f"(tolerance {TOL_CHECK})")
    return errs


def level_row(hp: int, wp: int, gen: torch.Generator,
              device: torch.device) -> dict:
    """The level's rows, timed in turns."""
    case = msda_probes.sample_case(hp, wp, QP, M, D, gen, device)
    vm, iy, ix, fy, fx, w = case
    pm, _, fl = packed_case(case, wp)
    cs = msda_probes.coeff_scalars(fy, fx, w)
    cw = msda_probes.coeff_wide(fy, fx, w, D)
    vm_nchw = vm.permute(0, 3, 1, 2).contiguous()
    grid = gather_grid(iy, ix, fy, fx, hp, wp)
    vm_bytes, pm_bytes = vm.numel() * 4, pm.numel() * 4
    rows = {  # name: (function, map bytes, output width, 4-byte values a
        #          sample)
        "pair_staticr": (lambda: msda_probes.pair_staticr(*case, P),
                         vm_bytes, D, 5),
        "packed_coeff": (lambda: msda_probes.packed_coeff(pm, fl, *cs, P),
                         pm_bytes, D, 5),
        "packed_wide": (lambda: msda_probes.packed_wide(pm, fl, cw, P),
                        pm_bytes, 4 * D, 1 + 4 * D),
        "packed_wide_sum": (lambda: group_sum(msda_probes.packed_wide(
            pm, fl, cw, P)), pm_bytes, D, 1 + 4 * D),
        "pair_p4": (lambda: msda_probes.fused_gather_p4(*case, P),
                    vm_bytes, D, 5),
        "packed": (lambda: msda_probes.packed_gather(pm, fl, fy, fx, w, P),
                   pm_bytes, D, 4),
        "grid_sample_p4": (lambda: gather_grid_sample(vm_nchw, grid, w, P),
                           vm_bytes, D, 5),
    }
    times = in_turns({name: fn for name, (fn, *_) in rows.items()})
    row = {"level": f"{hp - 2}x{wp - 2}", "padded": [hp, wp],
           "map_mb_per_head": hp * wp * D * 4 / 1e6,
           "packed_mb_per_head": (hp - 1) * (wp - 1) * 4 * D * 4 / 1e6,
           "cf_mb": cw.numel() * 4 / 1e6}
    for name, (_, map_bytes, width, scalars) in rows.items():
        nbytes = gather_bytes(map_bytes, M, QP, width, P, scalars)
        row[name] = {"ms": times[name],
                     "ns_per_sample": times[name] * 1e6 / (M * QP),
                     "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S}
    return row


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = probe_parser(__doc__)
    ap.add_argument("--levels", type=int, default=2,
                    choices=range(1, len(LEVELS) + 1),
                    help="how many levels to time, the largest first")
    args = parse_probe_args(ap, argv)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    result = {"probe": "msda_packed_probe2",
              "geometry": {"levels": [list(hw) for hw in
                                      LEVELS[:args.levels]],
                           "M": M, "D": D, "P": P, "QP": QP,
                           "dtype": "float32"},
              "device": device_record(device)}
    with torch.no_grad():
        result["correctness_max_err"] = correctness(device, gen)
        if device.type == "cuda":
            result["levels"] = [level_row(hp, wp, gen, device)
                                for hp, wp in LEVELS[:args.levels]]
    return report(result, args.out)


if __name__ == "__main__":
    main()
