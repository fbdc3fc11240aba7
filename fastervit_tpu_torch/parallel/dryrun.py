"""Dry runs of data parallelism, the counterpart of the JAX package's
`__graft_entry__.dryrun_multichip`: one full train step of each training
path, under DistributedDataParallel over a group of `--world-size`
processes, each on its rows of one fixed global batch
(`data_parallel.local_slice`), at narrow widths:

* classification: the fv0 structure (depths 2, 3, 6, 5; dim 16), an eval
  step, then two of the recipe's steps with mixup and SyncBatchNorm;
* detection: DINO's two-phase step, a matching pass without gradients,
  the host Hungarian on its costs, then the gradient pass on those
  assignments (`engine.make_detection_train_step`), the loss over the
  group's targets;
* tracking: MOTR's clip step (`motr.make_motr_clip_train_step`), the clip
  forward one DDP call (`motr.ClipForward`).

Each step reports its loss and gradient norm (and the classifier its
BatchNorm running statistics and eval sums), which must equal the
one-process step on the whole global batch, up to the order of sums. The
DropPath and dropout rates are 0 here: their masks are drawn a process at
a time, so they differ from one process's draws over the global batch.

    python -m fastervit_tpu_torch.parallel.dryrun --world-size 2 \\
        --device cpu [--out result.json]

`--world-size 1` runs in this process with no group. More than one
process are spawned here, joined over gloo on the CPU or NCCL on the
cards cuda:0 .. cuda:N-1.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import tempfile
from typing import Dict, List

import numpy as np
import torch

GLOBAL_BATCH = 4
SEED = 0
CLS_OVERRIDES = dict(dim=16, in_dim=8, num_heads=[1, 2, 4, 8],
                     num_classes=10, drop_path_rate=0.0)
DET_BACKBONE = dict(depths=[1, 1, 2, 1], num_heads=[1, 2, 4, 8], dim=32,
                    in_dim=16, drop_path_rate=0.0)
DET_CANVAS = (128, 128)
DET_HEAD = dict(num_classes=7, dim=64, num_queries=20, enc_layers=1,
                dec_layers=2)
DET_TARGETS = 5
MOTR_BACKBONE = dict(depths=[1, 1, 1, 1], dim=32, in_dim=16,
                     num_heads=[1, 2, 4, 8], drop_path_rate=0.0)
MOTR_CANVAS = (64, 96)
MOTR_KW = dict(num_classes=1, dim=64, num_detect_queries=4,
               num_track_queries=3, enc_layers=1, dec_layers=2)
MOTR_FRAMES, MOTR_TARGETS = 2, 3


def _rows(x: np.ndarray, rank: int, world: int, axis: int = 0) -> np.ndarray:
    n = x.shape[axis] // world
    return np.take(x, np.arange(rank * n, (rank + 1) * n), axis=axis)


def classification_step(device: torch.device, rank: int, world: int
                        ) -> Dict:
    """An eval step, then two recipe steps with mixup, of the narrow fv0.
    'bn_running' holds the BatchNorm running statistics after the first
    step (the initial weights' batch statistics): after an update they
    move with parameters whose gradient is zero up to rounding (a conv
    bias under BatchNorm, which AdamW moves by about ±lr whichever its
    sign), which the loss does not see. 'params' is the sum of the
    parameters after the steps, the same on every process (DDP hands each
    the same gradients)."""
    from fastervit_tpu_torch.models.layers import BatchNorm2d
    from fastervit_tpu_torch.models.registry import create_model
    from fastervit_tpu_torch.parallel import data_parallel
    from fastervit_tpu_torch.train.mixup import MixupConfig
    from fastervit_tpu_torch.train.steps import (TrainConfig,
                                                 create_train_state,
                                                 make_eval_step,
                                                 make_train_step)

    model = create_model("faster_vit_0_224", device=device,
                         generator=torch.Generator().manual_seed(SEED),
                         **CLS_OVERRIDES)
    rng = np.random.RandomState(SEED + 1)

    def batch():
        return data_parallel.local_slice(
            {"image": rng.randn(GLOBAL_BATCH, 224, 224, 3).astype(np.float32),
             "label": rng.randint(0, 10, GLOBAL_BATCH).astype(np.int64)},
            rank, world)

    sums = make_eval_step()(model, batch())
    out: Dict = {"eval": {k: float(data_parallel.sum_over_processes(v))
                          for k, v in sums.items()},
                 "loss": [], "grad_norm": []}
    cfg = TrainConfig(mixup=MixupConfig(num_classes=10), use_ema=False)
    state = create_train_state(model, cfg)
    state.ddp = data_parallel.wrap_model(model, device)
    step = make_train_step(cfg, lambda s: 1e-3, seed=SEED)
    for i in range(2):
        got = step(state, batch())
        out["loss"].append(float(got["loss"]))
        out["grad_norm"].append(float(got["grad_norm"]))
        if i == 0:
            out["bn_running"] = torch.cat(
                [torch.cat([m.running_mean, m.running_var])
                 for m in model.modules()
                 if isinstance(m, BatchNorm2d)]).cpu().tolist()
    out["params"] = float(sum(p.detach().double().sum()
                              for p in model.parameters()))
    return out


def _det_targets(rng: np.random.RandomState) -> List[Dict]:
    out = []
    for _ in range(GLOBAL_BATCH):
        n = rng.randint(1, DET_TARGETS + 1)
        out.append({"boxes": np.stack([rng.uniform(0.2, 0.8, n),
                                       rng.uniform(0.2, 0.8, n),
                                       rng.uniform(0.05, 0.3, n),
                                       rng.uniform(0.05, 0.3, n)],
                                      -1).astype(np.float32),
                    "labels": rng.randint(0, DET_HEAD["num_classes"],
                                          n).astype(np.int32)})
    return out


def detection_step(device: torch.device, rank: int, world: int) -> Dict:
    """DINO's two-phase step: matching pass, host Hungarian, gradient
    pass."""
    from fastervit_tpu_torch.detection import engine
    from fastervit_tpu_torch.detection.dino import DINODetector, init_weights
    from fastervit_tpu_torch.models.registry import get_config
    from fastervit_tpu_torch.parallel import data_parallel

    cfg = get_config("faster_vit_0_224", resolution=DET_CANVAS,
                     **DET_BACKBONE)
    with device:
        det = DINODetector(cfg, **DET_HEAD)
    init_weights(det, torch.Generator().manual_seed(SEED))
    det.eval()
    rng = np.random.RandomState(SEED + 2)
    x = rng.randn(GLOBAL_BATCH, 3, *DET_CANVAS).astype(np.float32)
    targets = _det_targets(rng)
    n = GLOBAL_BATCH // world
    images = torch.from_numpy(_rows(x, rank, world)).to(device)
    tgt = engine.targets_on(engine.pad_targets(
        targets[rank * n:(rank + 1) * n], DET_TARGETS), device)
    with torch.no_grad():                                   # matching pass
        costs_out = engine._f32(det(images))
        costs = engine.compute_costs(
            costs_out, tgt, len(engine.loss_layers(costs_out)[0]))
    assignment = engine.solve_assignments(costs, tgt["mask"])
    state = engine.DetectionTrainState(
        det, engine.create_detection_optimizer(det))
    state.ddp = data_parallel.wrap_model(det, device, sync_bn=False,
                                         find_unused_parameters=True)
    got = engine.make_detection_train_step()(state, images, tgt, assignment)
    return {"loss": float(got["loss"]), "grad_norm": float(got["grad_norm"])}


def tracking_step(device: torch.device, rank: int, world: int) -> Dict:
    """MOTR's clip step: the matching pass, clip_assignments, the gradient
    pass as one DDP call of ClipForward."""
    from fastervit_tpu_torch.detection.engine import DetectionTrainState
    from fastervit_tpu_torch.models.registry import get_config
    from fastervit_tpu_torch.parallel import data_parallel
    from fastervit_tpu_torch.tracking import motr

    cfg = get_config("faster_vit_0_any_res", resolution=MOTR_CANVAS,
                     **MOTR_BACKBONE)
    with device:
        det = motr.MOTRDetector(cfg, **MOTR_KW)
    motr.init_weights(det, torch.Generator().manual_seed(SEED))
    det.eval()
    rng = np.random.RandomState(SEED + 3)
    frames = rng.randn(MOTR_FRAMES, GLOBAL_BATCH, 3,
                       *MOTR_CANVAS).astype(np.float32)
    targets = []
    for f in range(MOTR_FRAMES):
        per_image = []
        for b in range(GLOBAL_BATCH):
            ids = [1, 2] if f == 0 else [2, 3]
            boxes = np.concatenate([rng.uniform(0.25, 0.75, (2, 2)),
                                    rng.uniform(0.1, 0.3, (2, 2))], -1)
            per_image.append({"labels": np.zeros(2, np.int32),
                              "boxes": boxes.astype(np.float32),
                              "track_ids": np.asarray(ids)})
        targets.append(per_image)
    n = GLOBAL_BATCH // world
    local = [tf[rank * n:(rank + 1) * n] for tf in targets]
    state = DetectionTrainState(det, motr.create_motr_optimizer(det))
    state.ddp = data_parallel.wrap_model(motr.ClipForward(det), device,
                                         sync_bn=False,
                                         find_unused_parameters=True)
    step = motr.make_motr_clip_train_step(max_targets=MOTR_TARGETS)
    got = step(state, torch.from_numpy(_rows(frames, rank, world, 1))
               .to(device), local)
    return {"loss": float(got["loss"]), "grad_norm": float(got["grad_norm"])}


def run_steps(device: torch.device, rank: int, world: int) -> Dict:
    return {"classification": classification_step(device, rank, world),
            "detection": detection_step(device, rank, world),
            "tracking": tracking_step(device, rank, world)}


def _worker(rank: int, world: int, address: str, device: str,
            out_dir: str) -> None:
    from fastervit_tpu_torch.parallel import distributed
    torch.set_num_threads(2)
    info = distributed.initialize(address, world, rank, device)
    try:
        got = run_steps(info["device"], rank, world)
    finally:
        torch.distributed.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(got, f)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun(world_size: int, device: str = "cpu") -> List[Dict]:
    """Each process's results, by rank (one entry for a world of 1, run in
    this process with no group)."""
    if world_size == 1:
        return [run_steps(torch.device(device), 0, 1)]
    import torch.multiprocessing as mp
    address = f"localhost:{_free_port()}"
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_worker, args=(world_size, address, device, tmp),
                           nprocs=world_size, start_method="spawn")
        results = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                results.append(json.load(f))
    return results


def main(argv=None) -> List[Dict]:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--world-size", type=int, default=2)
    p.add_argument("--device", default="cuda",
                   help="'cpu' (gloo) or 'cuda' (NCCL, a card a process)")
    p.add_argument("--out", default="", help="write the results as JSON")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass --device cpu")
    results = dryrun(args.world_size, args.device)
    for path, got in results[0].items():
        print(f"dryrun[{path}] world {args.world_size}: loss "
              f"{got['loss']}, grad norm {got['grad_norm']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"world_size": args.world_size, "ranks": results}, f)
    return results


if __name__ == "__main__":
    main()
