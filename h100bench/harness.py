"""One run of one cell: find its files by name, drive its mode, read its
metrics, decide `correct`, and assemble the result line.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by the names in BENCHMARK.json:

    h100bench/configs/<config>.json     the model, as it is run
    h100bench/traffic/<traffic>.json    the load: mode, batch, dtype, depth
    h100bench/workloads/<cell>.json     the cell's limits for `correct`
    h100bench/modes/<mode>.py           one loop a kind of work
    h100bench/metrics/<metric>.py       one reader a metric

A mode's `run(cell)` returns a `Record`; a metric's `read(record)` returns
a number or None (nothing to read in this run).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

import torch

BENCH_DIR = "h100bench"
# top-level module names that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "fastervit_tpu")
SPAN_ENQUEUE = "h100bench.enqueue"
SPAN_WAIT = "h100bench.wait"


@dataclasses.dataclass
class Cell:
    root: Path
    name: str
    bench: Dict
    workload: Dict
    config: Dict
    traffic: Dict
    limits: Dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float          # host clock at process start


@dataclasses.dataclass
class Batch:
    """One batch or step of the window, in seconds from the window's
    start: issued (host at the call), enqueued (the call returned), done
    (its result on the host), and the images it carried."""
    issue: float
    enqueued: float
    done: float
    images: int


@dataclasses.dataclass
class Record:
    """What a mode hands the metric readers and the verdict."""
    kind: str                         # "serve" | "train"
    setup_s: float
    seconds: float                    # the window's length
    batches: List[Batch]
    flops_per_image: float
    attention_forward: List[tuple]    # (windows, S, heads, hd, calls)
    attention_backward: List[tuple]   # a batch or step
    checks: Dict[str, Dict[str, float]]   # name -> {value, limit}
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: Optional[object] = None    # tracing.Trace of the traced stretch

    def completed_rate(self) -> Optional[float]:
        """Images a second whose results reached the host within the
        window, over the time from its start to the last of them (whole
        batches: a count over the window's full length would move by a
        batch's images at a time, 1.3% of a fine-tune cell's 20 s)."""
        done = [b for b in self.batches if b.done <= self.seconds]
        if not done:
            return None
        return sum(b.images for b in done) / max(b.done for b in done)


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """Import the file at `path` (its name may hold dots) as `name`."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def mode_module(root: Path, mode: str) -> ModuleType:
    return load_module(root / BENCH_DIR / "modes" / f"{mode}.py",
                       f"h100bench_mode_{mode}")


def metric_module(root: Path, metric: str) -> ModuleType:
    return load_module(root / BENCH_DIR / "metrics" / f"{metric}.py",
                       "h100bench_metric_" + metric.replace(".", "_"))


def load_cell(root: Path, workload: str, seed: int, seconds: float,
              trace: bool, device, t_start: float) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = found[0]
    (cfg_entry,) = [c for c in bench["configs"] if c["name"] == w["config"]]
    return Cell(
        root=root, name=workload, bench=bench, workload=w,
        config=load_json(root / cfg_entry["file"]),
        traffic=load_json(root / BENCH_DIR / "traffic"
                          / f"{w['traffic']}.json"),
        limits=load_json(root / BENCH_DIR / "workloads"
                         / f"{workload}.json")["limits"],
        seed=seed, seconds=seconds, trace=trace,
        device=torch.device(device), t_start=t_start)


def cell_metrics(bench: Dict, workload: str, section: str) -> List[Dict]:
    """The metrics of `section` ("end_to_end" or "per_layer") that this
    cell reports: those that list it under `workloads`, and those without
    the key whose `moves` (per-layer) the cell reports, or all of them
    (end-to-end without the key)."""
    def reports(m: Dict) -> bool:
        return "workloads" not in m or workload in m["workloads"]

    e2e = {m["name"] for m in bench["end_to_end"] if reports(m)}
    out = []
    for m in bench[section]:
        if "workloads" in m:
            ok = workload in m["workloads"]
        else:
            ok = section == "end_to_end" or m["moves"] in e2e
        if ok:
            out.append(m)
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({n for n in list(sys.modules)
                   if n.split(".", 1)[0] in FORBIDDEN})


def verdict(record: Record) -> bool:
    """Correct: every compared number within its limit (a number that is
    not a number fails), and no batch lost."""
    return record.failed == 0 and bool(record.checks) and all(
        c["value"] <= c["limit"] for c in record.checks.values())


def device_info(record: Record, device: torch.device, chips: int) -> Dict:
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": chips,
            "memory_peak_bytes": int(record.memory_peak_bytes)}
    if record.trace is not None:
        info["busy_s"] = record.trace.busy_s
        info["window_s"] = record.trace.window_s
    return info


def run_cell(cell: Cell) -> Dict:
    """Drive the cell's mode once and return the result line's object
    (without the fence, which the caller checks last)."""
    mode = mode_module(cell.root, cell.traffic["mode"])
    record: Record = mode.run(cell)
    section = "per_layer" if cell.trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(cell.bench, cell.name, section):
        value = metric_module(cell.root, m["name"]).read(record)
        if value is None:
            if section == "end_to_end":
                raise RuntimeError(f"end-to-end metric {m['name']} read "
                                   "nothing")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": verdict(record), "attempted": record.attempted,
              "failed": record.failed, "metrics": metrics,
              "device": device_info(record, cell.device,
                                    cell.workload["chips"])}
    if cell.trace and record.trace is not None:
        result["breakdown"] = record.trace.breakdown()
    result["checks"] = record.checks
    return result
