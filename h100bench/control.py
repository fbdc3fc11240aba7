"""Readings that a cell's limits are set from: the program's compared
numbers over many seeds (the lower reading is their largest) and those of
the controls and faults (the upper reading is the smallest of those that
separate), each run at the cell's own load for a short window (none for a
training cell), all in one process.

The mode's CONTROLS name them. A serving cell's control is the program's
own int8 serving path (`quantize_model`: int8 weights and activations, the
precision below the configured bf16), on the same weights and images. A
training cell's is the reference in the program's place with its products
in float8 (`faults.fp8`), and its faults are planted in the program's
step (`faults`).

    python3 h100bench/control.py --workload <name> --seeds 1,2,... \
        --control-seeds 7,8,9 --controls int8 --seconds 3 \
        --out readings.json

Not part of a benchmark run; it needs a card.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

import torch  # noqa: E402

from h100bench import harness  # noqa: E402


def readings(workload: str, seeds, seconds: float, control: str = ""):
    """{seed: {check: value}} of the program, or of the named control."""
    out = {}
    for seed in seeds:
        cell = harness.load_cell(ROOT, workload, seed, seconds, False, "cuda",
                                 time.perf_counter())
        mode = harness.mode_module(ROOT, cell.traffic["mode"])
        record = mode.run(cell, **(mode.CONTROLS[control] if control
                                   else {}))
        out[seed] = {k: c["value"] for k, c in record.checks.items()}
        print(f"{control or 'program'} seed {seed}: {out[seed]}",
              flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--controls", default="",
                    help="comma-separated names of the mode's CONTROLS")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    program = readings(args.workload, seeds, args.seconds)
    controls = {c: readings(args.workload, control_seeds, args.seconds, c)
                for c in args.controls.split(",") if c}
    summary = {}
    for name in {k for r in program.values() for k in r}:
        lower = max(r[name] for r in program.values())
        summary[name] = {"lower": lower}
        for c, runs in controls.items():
            least = min(r[name] for r in runs.values())
            summary[name][c] = {"least": least, "ratio": least / lower}
    result = {"workload": args.workload, "card": torch.cuda.get_device_name(),
              "program": program, "controls": controls, "summary": summary}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
