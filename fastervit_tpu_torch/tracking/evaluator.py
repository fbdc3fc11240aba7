"""TrackEval-style orchestration: one entry point sweeping multiple
benchmarks x trackers, optionally parallel over sequences.

The reference's vendored TrackEval drives every benchmark through a single
`Evaluator` (trackeval/eval.py: USE_PARALLEL / NUM_PARALLEL_CORES /
OUTPUT_FOLDER config, per-sequence multiprocessing pool, per-tracker
detailed CSVs, and an (output_res, output_msg) return with per-tracker
success/error strings) plus thin CLIs (scripts/run_mot_challenge.py,
run_rob_mots.py). This module is the counterpart over this repo's adapter
inventory (tracking/benchmarks.py, tao.py, mots.py, vis.py, davis.py,
robmots.py).

Parallelism model: one multiprocessing pool is shared by the whole sweep.
Datasets that inherit `MOTChallengeDataset.evaluate` unchanged (MOT17/20,
DanceTrack, CroHD, MOTSChallenge) fan out per *sequence* — the reference's
eval_sequence unit. Datasets with cross-sequence pooling or per-class
structure (KITTI, BDD, TAO, YT-VIS, DAVIS, RobMOTS, KITTI-MOTS) fan out per
(dataset, tracker) task, the finest unit whose results compose without
re-deriving each adapter's combine rules. Serial mode (use_parallel=False)
calls each adapter's own evaluate directly.

CLI:
    python -m fastervit_tpu_torch.tracking.evaluator \
        --dataset kind=mot,benchmark=MINI,split=train,gt_folder=G,trackers_folder=T \
        --dataset kind=davis,gt_folder=G2,trackers_folder=T2 \
        --parallel --cores 4 --output out/

The port's copy of fastervit_tpu/tracking/evaluator.py: the same names,
signatures and code, importing nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import time
import traceback
from typing import Dict, List, Optional, Sequence, Tuple

from fastervit_tpu_torch.tracking.benchmarks import (
    BDD100KDataset, DanceTrackDataset, HeadTrackingDataset,
    KITTI2DBoxDataset, MOTChallengeDataset, _all_metrics,
    combine_sequence_data, write_detailed_csv)

DATASET_KINDS = {
    "mot": MOTChallengeDataset,
    "dancetrack": DanceTrackDataset,
    "head": HeadTrackingDataset,
    "kitti": KITTI2DBoxDataset,
    "bdd": BDD100KDataset,
}


def _lazy_kinds():
    # heavier adapters imported on demand (mask codecs, json parsing)
    from fastervit_tpu_torch.tracking.davis import DAVISDataset
    from fastervit_tpu_torch.tracking.mots import (KITTIMOTSDataset,
                                                   MOTSChallengeDataset)
    from fastervit_tpu_torch.tracking.robmots import RobMOTSDataset
    from fastervit_tpu_torch.tracking.tao import TAODataset
    from fastervit_tpu_torch.tracking.vis import YouTubeVISDataset
    return {"mots": MOTSChallengeDataset, "kitti_mots": KITTIMOTSDataset,
            "tao": TAODataset, "ytvis": YouTubeVISDataset,
            "davis": DAVISDataset, "robmots": RobMOTSDataset}


def make_dataset(kind: str, **kwargs):
    kinds = dict(DATASET_KINDS)
    if kind not in kinds:
        kinds.update(_lazy_kinds())
    if kind not in kinds:
        raise KeyError(f"unknown dataset kind {kind!r}; "
                       f"known: {sorted(kinds)}")
    return kinds[kind](**kwargs)


@dataclasses.dataclass
class EvalConfig:
    """Mirror of TrackEval's Evaluator config surface (eval.py:18-38)."""
    use_parallel: bool = False
    num_parallel_cores: int = 8
    output_folder: Optional[str] = None
    print_results: bool = True
    break_on_error: bool = True   # raise (True) or record + continue
    time_progress: bool = True


# ---- module-level pool workers (must be picklable) -------------------------

def _seq_task(args):
    ds, tracker, seq = args
    return seq, ds.sequence_data(tracker, seq)


def _tracker_task(args):
    ds, tracker, outdir = args
    return tracker, ds.evaluate(trackers=[tracker],
                                output_folder=outdir)[tracker]


def _uses_base_mot_evaluate(ds) -> bool:
    """True when ds inherits MOTChallengeDataset.evaluate unchanged, so the
    per-sequence parallel recipe reproduces it exactly."""
    return (isinstance(ds, MOTChallengeDataset)
            and type(ds).evaluate is MOTChallengeDataset.evaluate)


class Evaluator:
    """Sweeps datasets x trackers; returns (results, messages) like
    TrackEval's Evaluator.evaluate (trackeval/eval.py:78-198)."""

    def __init__(self, config: Optional[EvalConfig] = None):
        self.config = config or EvalConfig()

    def _dataset_output(self, name: str) -> Optional[str]:
        if not self.config.output_folder:
            return None
        out = os.path.join(self.config.output_folder, name)
        os.makedirs(out, exist_ok=True)
        return out

    def _eval_mot_parallel(self, ds, tracker: str, pool,
                           outdir: Optional[str]) -> Dict:
        """MOTChallengeDataset.evaluate semantics, sequences fanned out."""
        pairs = pool.map(_seq_task,
                         [(ds, tracker, s) for s in ds.seq_list])
        datas = dict(pairs)
        per_seq = {s: _all_metrics(datas[s]) for s in ds.seq_list}
        per_seq["COMBINED_SEQ"] = _all_metrics(
            combine_sequence_data([datas[s] for s in ds.seq_list]))
        if outdir:
            write_detailed_csv(
                os.path.join(outdir, f"{tracker}_detailed.csv"), per_seq)
        return per_seq

    def evaluate(self, datasets: Sequence[Tuple[str, object]],
                 trackers: Optional[List[str]] = None):
        """datasets: [(name, adapter), ...] (name keys the output tree).
        -> (results, messages): results[name][tracker] = adapter rows,
        messages[name][tracker] = 'Success' | error string."""
        cfg = self.config
        results: Dict[str, Dict] = {}
        messages: Dict[str, Dict[str, str]] = {}
        pool = None
        if cfg.use_parallel:
            pool = multiprocessing.get_context("spawn").Pool(
                cfg.num_parallel_cores)
        try:
            # Materialize the sweep plan up front so non-MOT
            # (dataset, tracker) tasks overlap across the WHOLE sweep (a
            # blocking pool.apply inside the tracker loop would run them
            # one at a time despite USE_PARALLEL).
            plan = []  # (name, ds, outdir, tracker)
            for name, ds in datasets:
                outdir = self._dataset_output(name)
                results[name], messages[name] = {}, {}
                for tracker in (trackers or list(ds.tracker_list)):
                    plan.append((name, ds, outdir, tracker))
            pending = {}
            if pool is not None:
                for name, ds, outdir, tracker in plan:
                    if not _uses_base_mot_evaluate(ds):
                        pending[(name, tracker)] = pool.apply_async(
                            _tracker_task, [(ds, tracker, outdir)])
            for name, ds, outdir, tracker in plan:
                t0 = time.perf_counter()
                try:
                    if (name, tracker) in pending:
                        res = pending[(name, tracker)].get()[1]
                    elif pool is not None:
                        res = self._eval_mot_parallel(
                            ds, tracker, pool, outdir)
                    else:
                        res = ds.evaluate(trackers=[tracker],
                                          output_folder=outdir)[tracker]
                    results[name][tracker] = res
                    messages[name][tracker] = "Success"
                except Exception as e:  # noqa: BLE001 — per-tracker gate
                    if cfg.break_on_error:
                        raise
                    results[name][tracker] = None
                    messages[name][tracker] = f"{type(e).__name__}: {e}"
                    traceback.print_exc()
                if cfg.time_progress:
                    print(f"[{name}] {tracker}: "
                          f"{messages[name][tracker]} "
                          f"({time.perf_counter() - t0:.2f}s)",
                          flush=True)
            for name, _ in datasets:
                outdir = self._dataset_output(name)
                if outdir:
                    with open(os.path.join(outdir, "summary.json"),
                              "w") as f:
                        json.dump(_jsonable(results[name]), f, indent=1)
                if cfg.print_results:
                    _print_dataset(name, results[name])
        finally:
            if pool is not None:
                pool.close()
                pool.join()
        return results, messages


def _jsonable(tree):
    if isinstance(tree, dict):
        return {str(k): _jsonable(v) for k, v in tree.items()}
    if hasattr(tree, "item"):
        return tree.item()
    return tree


def _leaf_rows(tree, prefix=""):
    """Yield (label, {metric: float}) rows from arbitrarily nested results
    (tracker -> [class ->] seq -> metrics)."""
    if isinstance(tree, dict) and tree and all(
            isinstance(v, (int, float)) or hasattr(v, "item")
            for v in tree.values()):
        yield prefix, tree
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_rows(v, f"{prefix}/{k}" if prefix else str(k))


def _print_dataset(name: str, res: Dict) -> None:
    print(f"=== {name} ===")
    for label, row in _leaf_rows(res):
        if not label.endswith("COMBINED_SEQ") and "/" in label:
            continue  # summary prints combined rows (+ flat rows)
        keys = [k for k in ("HOTA", "MOTA", "IDF1", "J&F", "mAP")
                if k in row]
        vals = " ".join(f"{k}={float(row[k]):.4f}" for k in keys)
        if not vals:  # fall back to the first few metrics
            vals = " ".join(f"{k}={float(v):.4f}"
                            for k, v in list(row.items())[:4])
        print(f"  {label}: {vals}")


def _parse_dataset_arg(spec: str) -> Tuple[str, object]:
    kv = {}
    for part in spec.split(","):
        if not part:
            continue
        k, _, v = part.partition("=")
        if not _:
            raise ValueError(f"--dataset expects k=v pairs, got {part!r}")
        kv[k.strip()] = v.strip()
    kind = kv.pop("kind", None)
    if kind is None:
        raise ValueError("--dataset needs kind=<adapter>")
    name = kv.pop("name", kind)
    # typed kwargs: ints stay ints, 'true'/'false' become bools
    for k, v in list(kv.items()):
        if v.lower() in ("true", "false"):
            kv[k] = v.lower() == "true"
        elif v.isdigit():
            kv[k] = int(v)
    return name, make_dataset(kind, **kv)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Evaluate tracker output folders against one or more "
        "benchmark adapters (TrackEval run_*.py analog)")
    ap.add_argument("--dataset", action="append", required=True,
                    metavar="kind=mot,gt_folder=...,trackers_folder=...[,k=v]",
                    help=f"repeatable; kinds: mot dancetrack head kitti bdd "
                         f"mots kitti_mots tao ytvis davis robmots")
    ap.add_argument("--trackers", default=None,
                    help="comma list; default: every tracker in each folder")
    ap.add_argument("--parallel", action="store_true",
                    help="TrackEval USE_PARALLEL")
    ap.add_argument("--cores", type=int, default=8)
    ap.add_argument("--output", default=None,
                    help="output tree root (detailed CSVs + summary.json)")
    ap.add_argument("--continue-on-error", action="store_true")
    args = ap.parse_args(argv)

    datasets = [_parse_dataset_arg(s) for s in args.dataset]
    ev = Evaluator(EvalConfig(
        use_parallel=args.parallel, num_parallel_cores=args.cores,
        output_folder=args.output,
        break_on_error=not args.continue_on_error))
    trackers = args.trackers.split(",") if args.trackers else None
    _, messages = ev.evaluate(datasets, trackers)
    failed = [m for per in messages.values() for m in per.values()
              if m != "Success"]
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
