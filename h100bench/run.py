"""Run one cell of the benchmark once and print its result as the last line
of standard output.

    python3 h100bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell, its configuration, traffic mix,
limits and metrics are found by the names in BENCHMARK.json (see
h100bench/harness.py). With --trace 0 the line carries the cell's
end-to-end metrics, with --trace 1 its per-layer metrics, the device's
busy and traced seconds and a breakdown. The compared numbers, each with
its limit, are the last lines of standard error and the last key of the
result. The run needs the cards the cell asks for: without them, or if a
JAX module is loaded once the window has closed, it prints no result and
exits non-zero.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the program's and the compilers' caches at fixed paths in the checkout
CACHE = ROOT / ".h100bench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
sys.path[0] = str(ROOT)

import torch  # noqa: E402

from h100bench import harness  # noqa: E402


def card() -> str:
    """The card's name, power limit, clocks, temperature, power draw and
    throttle reasons now, as nvidia-smi reads them."""
    out = []
    for query in ("name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu,"
                  "power.draw", "clocks_throttle_reasons.active"):
        try:
            out.append(subprocess.run(
                ["nvidia-smi", f"--query-gpu={query}",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60).stdout.strip())
        except (OSError, subprocess.SubprocessError) as e:
            out.append(f"nvidia-smi unavailable ({e})")
    return ", ".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(ROOT, args.workload, args.seed, args.seconds,
                             bool(args.trace), "cuda", T_START)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"h100bench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    result = harness.run_cell(cell)
    found = harness.forbidden_modules()
    if found:
        print(f"h100bench: JAX modules loaded: {found}", file=sys.stderr)
        return 4
    print(f"card: {card()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
