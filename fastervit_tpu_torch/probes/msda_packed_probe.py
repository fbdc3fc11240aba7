"""Does one contiguous 4·D-wide row a sample gather faster than two 2·D-wide
runs in two map rows?

The port's counterpart of scripts/msda_packed_probe.py. `pack_corners`
stores each pixel's four bilinear corners side by side,
pm[y·(Wp−1) + x] = [v[y, x] | v[y, x+1] | v[y+1, x] | v[y+1, x+1]], so a
sample's corners are one 512-byte row (f32 at D 32) where P3 reads two
256-byte runs. At MOTR's streaming geometry (the padded levels 202×386 …
27×50, 8 heads, D 32, P 4, QP = 408,000 samples a head and level) it times,
at each level, in turns:

  packed          P4a `packed_gather` on the f32 packed map;
  packed_bf16     P4a on the packed map in bf16 (half its bytes; f32
                  arithmetic and output);
  pair_p4         P3b `fused_gather_p4` on the unpacked map, the JAX
                  script's `pair_p4_u8` row;
  grid_sample_p4  the library yardstick: F.grid_sample of the padded map
                  at the same samples, times w, summed over P;

each with its ms, ns a sample and bound (bytes at 3.35 TB/s), beside the
packed map's MB a head. First, on a small case (27×50, QP 400), P4a on the
f32 and the bf16 packed map against the plain P3a summed over P (for bf16,
on the map rounded to bf16); with --device cpu that check runs through the
plain versions and the probe stops there, as the JAX script's --interpret
does. The JAX script's --iters is the package's ITERS; its unroll
variants and the pad of QP to its chunk are not carried.

    python -m fastervit_tpu_torch.probes.msda_packed_probe [--out PATH]
    python -m fastervit_tpu_torch.probes.msda_packed_probe --device cpu
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
from fastervit_tpu_torch.probes.msda_pallas_probe import (CHECK_CASE, D,
                                                          LEVELS, M, P, QP)

# largest |P4a − plain P3a summed over P| on the check case: f32 both
# sides, in another order of roundings (the corner weights multiplied out
# first, the P sum by torch.sum)
TOL_CHECK = 1e-4


def packed_case(case, wp: int):
    """(pm in f32, pm in bf16, fl) of a P3 case: its map corner-packed, and
    fl = iy·(Wp−1) + ix."""
    vm, iy, ix = case[:3]
    pm = msda_probes.pack_corners(vm)
    return pm, pm.bfloat16(), iy * (wp - 1) + ix


def correctness(device: torch.device, gen: torch.Generator) -> dict:
    """P4a on the f32 and the bf16 packed map against the plain P3a summed
    over P (on the bf16-rounded map for bf16); raise past TOL_CHECK."""
    hp, wp, qp = CHECK_CASE
    case = msda_probes.sample_case(hp, wp, qp, M, D, gen, device)
    pm, pm16, fl = packed_case(case, wp)
    rest = case[3:]
    errs = {}
    for name, packed, vm in (("packed", pm, case[0]),
                             ("packed_bf16", pm16,
                              case[0].bfloat16().float())):
        got = msda_probes.packed_gather(packed, fl, *rest, P)
        want = msda_probes.gather_reference(vm, *case[1:]).view(
            M, qp // P, P, D).sum(2)
        errs[name] = (got - want).abs().max().item()
        if not errs[name] <= TOL_CHECK:
            raise RuntimeError(f"{name} off the plain version by "
                               f"{errs[name]} (tolerance {TOL_CHECK})")
    return errs


def level_row(hp: int, wp: int, gen: torch.Generator,
              device: torch.device) -> dict:
    """The level's rows, timed in turns."""
    case = msda_probes.sample_case(hp, wp, QP, M, D, gen, device)
    vm, iy, ix, fy, fx, w = case
    pm, pm16, fl = packed_case(case, wp)
    vm_nchw = vm.permute(0, 3, 1, 2).contiguous()
    grid = gather_grid(iy, ix, fy, fx, hp, wp)
    rows = {  # name: (function, bytes of its map, scalars a sample)
        "packed": (lambda: msda_probes.packed_gather(pm, fl, fy, fx, w, P),
                   pm.numel() * 4, 4),
        "packed_bf16": (lambda: msda_probes.packed_gather(pm16, fl, fy, fx,
                                                          w, P),
                        pm.numel() * 2, 4),
        "pair_p4": (lambda: msda_probes.fused_gather_p4(*case, P),
                    vm.numel() * 4, 5),
        "grid_sample_p4": (lambda: gather_grid_sample(vm_nchw, grid, w, P),
                           vm.numel() * 4, 5),
    }
    times = in_turns({name: fn for name, (fn, _, _) in rows.items()})
    row = {"level": f"{hp - 2}x{wp - 2}", "padded": [hp, wp],
           "packed_mb_per_head": (hp - 1) * (wp - 1) * 4 * D * 4 / 1e6}
    for name, (_, map_bytes, scalars) in rows.items():
        nbytes = gather_bytes(map_bytes, M, QP, D, P, scalars)
        row[name] = {"ms": times[name],
                     "ns_per_sample": times[name] * 1e6 / (M * QP),
                     "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S}
    return row


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_probe_args(probe_parser(__doc__), argv)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    result = {"probe": "msda_packed_probe",
              "geometry": {"levels": [list(hw) for hw in LEVELS], "M": M,
                           "D": D, "P": P, "QP": QP},
              "device": device_record(device)}
    with torch.no_grad():
        result["correctness_max_err"] = correctness(device, gen)
        if device.type == "cuda":
            result["levels"] = [level_row(hp, wp, gen, device)
                                for hp, wp in LEVELS]
    return report(result, args.out)


if __name__ == "__main__":
    main()
