"""On the card: each cell runs through run.py and comes out correct, and
each cell's control (the program's int8 serving path on the same weights
and images, at the cell's size) reads above its limit. Skips without a
card; run on the H100 with `python -m pytest h100bench -q -m cuda`."""
import json
import subprocess
import sys
import time

import pytest
import torch

from h100bench import harness
from h100bench.conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    need_card()
    proc = subprocess.run(
        [sys.executable, "h100bench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 11), "--seconds", "3", "--trace", "0"], cwd=REPO,
        capture_output=True, text=True, timeout=1500)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]
                                  if w["traffic"].startswith("serve")])
def test_control_fails_the_limit(cell):
    need_card()
    c = harness.load_cell(REPO, cell, 2 ** 31 + 13, 3.0, False, "cuda",
                          time.perf_counter())
    record = harness.mode_module(REPO, "serve").run(c, quantized=True)
    assert not harness.verdict(record), record.checks
