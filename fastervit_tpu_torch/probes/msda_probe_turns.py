"""The MSDA gather probes' kernels P3a-P4d timed on the card at MOTR's four
padded levels, in the port found under --root: for comparing two trees of
the port (a parent unpacked by `git archive`, and the change) on one card,
each in its own process, in turns:

    for t in parent change change parent; do d=.; [ $t = parent ] && \\
        d=_trees/parent; python fastervit_tpu_torch/probes/msda_probe_turns.py \\
        --root $d --out out/msda_probe_turns_$t.json; done

It is run by path, so that it imports `fastervit_tpu_torch` from --root
(whose kernels it builds there) and not from its own tree; its timer and
hashes are that tree's `probes/msda_turns.py`'s. At each level (202×386,
102×194, 52×98, 27×50 padded; M 8, D 32, QP 408,000 samples a head, the
probes' geometry) one case is drawn by `ops.msda_probes.sample_case` from a
seeded torch.Generator on the card (every sample in range), and each
kernel runs on it:
- P3a `fused_gather_cuda`, P3b `fused_gather_p4_cuda` at P 1, 2 and 4, P3c
  `fused_gather_per_head_cuda` (one launch a head), all on the f32 map;
- P4a `packed_gather_cuda` on the f32 and the bf16 corner-packed map, P 4;
- P4b `pair_staticr_cuda` on the bf16 map, P 4;
- P4c `packed_coeff_cuda` on the f32 and the bf16 packed map with
  `coeff_scalars`' weights, and P4d `packed_wide_cuda` on the f32 one with
  `coeff_wide`'s rows, P 4.
Each call is timed with CUDA events over 50 calls after 5, with the
samples a second and the corner rows a second it implies (4 corners × D
channels a sample, in the map's type); each output's SHA-256 is written,
so that two trees' outputs compare bit for bit across processes; a
kernel's `last_plan`, where its wrapper keeps one, is written beside it.
With --profile each call's device time is split by kernel
(torch.profiler). With --both-routes (a tree whose wrappers run
`cuda_msda.probe_plan`) each call that took route "smem" is timed again on
route "l2", the plan probe_plan gives a map one byte past a block's shared
memory, beside its SHA-256. It prints one JSON object, with the card's
name and power limit, and writes it to --out if given. It needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

LEVELS = ((202, 386), (102, 194), (52, 98), (27, 50))
M, D, QP = 8, 32, 408_000


def cases(cuda_msda, msda_probes, level_case):
    """{name: (kernel, arguments, the map's element bytes)} of one level."""
    vm, iy, ix, fy, fx, w = level_case
    wp = vm.shape[2]
    pm = msda_probes.pack_corners(vm)
    fl = iy * (wp - 1) + ix
    pm16 = pm.bfloat16()
    out = {"P3a": (cuda_msda.fused_gather_cuda, level_case, 4)}
    for p in (1, 2, 4):
        out[f"P3b P{p}"] = (cuda_msda.fused_gather_p4_cuda,
                            [*level_case, p], 4)
    out["P3c"] = (cuda_msda.fused_gather_per_head_cuda, level_case, 4)
    out["P4a"] = (cuda_msda.packed_gather_cuda, [pm, fl, fy, fx, w, 4], 4)
    out["P4a bf16"] = (cuda_msda.packed_gather_cuda,
                       [pm16, fl, fy, fx, w, 4], 2)
    out["P4b bf16"] = (cuda_msda.pair_staticr_cuda,
                       [vm.bfloat16(), iy, ix, fy, fx, w, 4], 2)
    cs = msda_probes.coeff_scalars(fy, fx, w)
    out["P4c"] = (cuda_msda.packed_coeff_cuda, [pm, fl, *cs, 4], 4)
    out["P4c bf16"] = (cuda_msda.packed_coeff_cuda, [pm16, fl, *cs, 4], 2)
    out["P4d"] = (cuda_msda.packed_wide_cuda,
                  [pm, fl, msda_probes.coeff_wide(fy, fx, w, D), 4], 4)
    return out


def on_l2(cuda_msda, kernel, call_args, time_ms, sha256) -> dict:
    """The call timed with probe_plan's route l2 in place of smem: the plan
    of a map one byte past a block's shared memory."""
    make = cuda_msda.probe_plan

    def l2_plan(mode, d, dtype, _map_bytes, alignment, sms):
        return make(mode, d, dtype, cuda_msda.PROBE_SMEM_BYTES + 1,
                    alignment, sms)

    cuda_msda.probe_plan = l2_plan
    try:
        got = kernel(*call_args)
        plan = kernel.last_plan
        return {"ms": time_ms(lambda: kernel(*call_args)),
                "sha256": sha256(got), "plan": plan._asdict()}
    finally:
        cuda_msda.probe_plan = make


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".",
                    help="the checkout whose fastervit_tpu_torch is timed")
    ap.add_argument("--profile", action="store_true",
                    help="also split each call's device time by kernel")
    ap.add_argument("--both-routes", action="store_true",
                    help="also time each smem-route call on route l2")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    if not torch.cuda.is_available():
        sys.exit("msda_probe_turns needs a CUDA device")
    from fastervit_tpu_torch.ops import cuda_attention, cuda_msda
    from fastervit_tpu_torch.ops import msda_probes
    from fastervit_tpu_torch.probes.msda_turns import (ITERS, _time_ms,
                                                       kernels_us, sha256)
    if not Path(cuda_msda.__file__).resolve().is_relative_to(root):
        sys.exit(f"imported {cuda_msda.__file__}, not from {root}")
    cuda_attention.build()

    gen = torch.Generator(device="cuda").manual_seed(0)
    samples = M * QP
    out = {"root": str(root), "iters": ITERS,
           "shape": {"M": M, "D": D, "QP": QP}, "levels": {}}
    with torch.no_grad():
        for hp, wp in LEVELS:
            level_case = list(msda_probes.sample_case(hp, wp, QP, M, D, gen,
                                                      "cuda"))
            rows = {}
            for name, (kernel, call_args, elem) in cases(
                    cuda_msda, msda_probes, level_case).items():
                got = kernel(*call_args)
                ms = _time_ms(lambda: kernel(*call_args))
                plan = getattr(kernel, "last_plan", None)
                rows[name] = {
                    "ms": ms, "sha256": sha256(got),
                    "g_samples_s": samples / ms / 1e6,
                    "corner_gb_s": samples * 4 * D * elem / ms / 1e6,
                    "plan": plan._asdict() if plan else None}
                if args.profile:
                    rows[name]["kernels_us"] = kernels_us(
                        lambda: kernel(*call_args))
                if args.both_routes and plan and plan.route == "smem":
                    rows[name]["l2_route"] = on_l2(cuda_msda, kernel,
                                                   call_args, _time_ms,
                                                   sha256)
                del got
            out["levels"][f"{hp - 2}x{wp - 2}"] = {"padded": [hp, wp],
                                                   "rows": rows}
            del level_case
            torch.cuda.empty_cache()
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps(out))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
    return out


if __name__ == "__main__":
    main()
