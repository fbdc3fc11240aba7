"""The harness on the CPU: BENCHMARK.json against the contract and the
files it names; a cell, a configuration, a traffic mix and a per-layer
metric found from new files alone; the result line's keys; run.py's
refusal without a card; the import fence; the trace's reduction."""
import ast
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

from h100bench import harness, tracing
from h100bench.conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_benchmark_has_the_contracts_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "h100bench/run.py"]
    assert BENCH["paths"] == ["h100bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert re.match(r"^https://\S+$", c["source"])
        assert (REPO / c["file"]).is_file()
        assert json.loads((REPO / c["file"]).read_text())["source"] \
            == c["source"]
        assert c["file"].startswith("h100bench/")
        assert (REPO / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    names = [x["name"] for s in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[s]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"])
               for s in ("end_to_end", "per_layer") for m in BENCH[s])
    assert len({(w["config"], w["traffic"])
                for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]
    texts = (BENCH["command"]
             + [x["why"] for s in ("configs", "workloads") for x in BENCH[s]]
             + [c["source"] for c in BENCH["configs"]]
             + [m["layer"] for m in BENCH["per_layer"]])
    assert all(1 <= len(t) <= 200 and not re.search(r"[\t\r\n]", t)
               for t in texts)
    assert all(len(c["reduced"]) <= 16 for c in BENCH["configs"])
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_named_file_exists():
    for w in BENCH["workloads"]:
        cell = harness.load_cell(REPO, w["name"], 1, 1.0, False, "cpu", 0.0)
        assert harness.mode_module(REPO, cell.traffic["mode"]).run
        assert set(cell.limits) and all(v > 0 for v in cell.limits.values())
        (cfg,) = [c for c in BENCH["configs"] if c["name"] == w["config"]]
        assert cell.config["name"] == cfg["name"]
        assert cell.config["reduced"] == cfg["reduced"]


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_metric_files_agree_with_the_benchmark(section):
    for m in BENCH[section]:
        reader = harness.metric_module(REPO, m["name"])
        assert reader.UNIT == m["unit"], m["name"]
        if section == "per_layer":
            assert reader.LAYER == m["layer"], m["name"]
            assert reader.MOVES == m["moves"], m["name"]


def test_each_moves_names_an_end_to_end_metric_its_cells_report():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        reported = {m["name"] for m in
                    harness.cell_metrics(BENCH, w["name"], "end_to_end")}
        layer = harness.cell_metrics(BENCH, w["name"], "per_layer")
        assert "setup_s" in reported and len(reported) >= 2, w["name"]
        assert layer, w["name"]
        for m in layer:
            assert m["moves"] in e2e and m["moves"] in reported, \
                (w["name"], m["name"])


def run_tiny(root: Path, trace: bool, seed: int = 2 ** 31 + 77):
    cell = harness.load_cell(root, "tiny_fv0.tiny_serve", seed, 0.3, trace,
                             "cpu", time.perf_counter())
    return harness.run_cell(cell)


@pytest.mark.parametrize("trace", [False, True])
def test_new_cell_config_and_metric_from_files_alone(checkout, trace,
                                                     cpu_threads):
    result = run_tiny(checkout, trace)
    assert list(result) == RESULT_KEYS + ["checks"]
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    if trace:
        assert result["metrics"]["batches_done.serve"]["unit"] == "batches"
        assert "serve_img_per_s" not in result["metrics"]
    else:
        assert set(result["metrics"]) == {"serve_img_per_s",
                                          "serve_batch_p95_ms", "setup_s"}
    (check,) = result["checks"].values()
    assert set(check) == {"value", "limit"} and check["value"] < 1e-4


def test_run_py_refuses_a_machine_without_the_card():
    proc = subprocess.run(
        [sys.executable, "h100bench/run.py", "--workload",
         BENCH["workloads"][0]["name"], "--seed", str(2 ** 31 + 5),
         "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "CUDA device" in proc.stderr


def test_run_py_fails_with_only_the_benchmarks_files(tmp_path):
    import shutil
    shutil.copytree(REPO / "h100bench", tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, "h100bench/run.py", "--workload",
         BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0 and "{" not in proc.stdout


FENCE = """
import sys, time, importlib
from pathlib import Path
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(2)
from h100bench import harness
from h100bench.conftest import make_checkout
root = Path({root!r})
for path in sorted((root / "h100bench").rglob("*.py")):
    rel = path.relative_to(root).with_suffix("")
    if path.parent.name in ("metrics", "modes"):
        harness.load_module(path, "fence_" + path.stem.replace(".", "_"))
    elif not path.name.startswith(("test_", "conftest")):
        importlib.import_module(".".join(rel.parts))
cell = harness.load_cell(root, "tiny_fv0.tiny_serve", 3, 0.2, True, "cpu",
                         time.perf_counter())
assert harness.run_cell(cell)["correct"]
print(harness.forbidden_modules())
"""


def test_no_jax_module_is_loaded(checkout):
    code = FENCE.format(repo=str(REPO), root=str(checkout))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "fastervit_tpu_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax.numpy"]


def test_harness_sources_import_no_jax():
    for path in (REPO / "h100bench").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            assert not any(m.split(".")[0] in harness.FORBIDDEN
                           for m in mods), (path, mods)


def test_trace_reduction():
    busy = tracing.union([(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)])
    assert busy == [(0.0, 2.0), (3.0, 4.0)]
    assert tracing.clip(busy, 1.0, 3.5) == [(1.0, 2.0), (3.0, 3.5)]
    gaps = tracing.idle_gaps(busy, -1.0, 5.0)
    assert gaps == [(-1.0, 0.0), (2.0, 3.0), (4.0, 5.0)]
    spans = [("enqueue", 1.5, 2.8), ("wait", 4.2, 4.9)]
    assert tracing.label_gaps(gaps, spans) == [
        ("outside the loop's spans", 1.0), ("enqueue", 1.0), ("wait", 1.0)]
    trace = tracing.Trace(window_s=6.0, busy_s=3.0,
                          ops=[("k1", 0.0, 1.0), ("k2", 1.0, 1.5),
                               ("k1", 3.0, 4.0)],
                          gaps=[("a", 1.0), ("b", 2.0)], batches=1)
    assert trace.breakdown() == {"device_ops": [["k1", 2.0], ["k2", 0.5]],
                                 "idle_gaps": [["b", 2.0], ["a", 1.0]]}


@pytest.mark.parametrize("trace", [False, True])
def test_a_train_cell_runs_from_files_alone(checkout, trace, cpu_threads):
    cell = harness.load_cell(checkout, "tiny_fv0.tiny_train", 2 ** 31 + 31,
                             0.3, trace, "cpu", time.perf_counter())
    result = harness.run_cell(cell)
    assert list(result) == RESULT_KEYS + ["checks"]
    assert result["correct"] is True, result["checks"]
    assert set(result["checks"]) == {"loss_gap", "grad_gap", "delta_gap"}
    if trace:
        assert set(result["metrics"]) == {"enqueue_ms.train", "mfu.train"}
    else:
        assert set(result["metrics"]) == {"train_img_per_s", "setup_s"}
