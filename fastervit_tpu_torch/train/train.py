"""ImageNet training CLI (port of fastervit_tpu/train/train.py; reference
fastervit/train.py:379-951): the card unless `--device cpu`, on one
process or data-parallel over many.

A config file sets the defaults and the command line overrides them
(reference train.py:75-77, 363-377). The configs (configs/*.yaml) are flat
`key: value` lists, read by a small parser of that form, since the machine
with the card has no YAML package.

    python -m fastervit_tpu_torch.train.train \
        --config configs/faster_vit_0_224_1k.yaml --synthetic --output out/

Fine-tuning from a reference checkpoint (a .pth.tar; a 21841-class head is
kept at init with a warning when --num-classes differs):

    python -m fastervit_tpu_torch.train.train --model faster_vit_4_21k_384 \
        --loadcheckpoint fv4_21k_224.pth.tar --synthetic -b 32 \
        --dtype bfloat16 --output out/

What runs: an ImageNet-layout folder (`--data-dir` with train/ and val/
class-per-subdir trees: data.train_loader.TrainLoader's crop, flip,
RandAugment and erasing, data.imagenet.EvalLoader's timm eval transform)
or synthetic loaders (`--synthetic`, or no --data-dir), the train
step of `fastervit_tpu_torch.train.steps` (mixup, bf16 autocast, MESA, clip,
adamw/lamb, EMA, --grad-checkpointing), the mixup-off final epochs, eval of
the model and of its EMA, the NaN guard, summary.csv and a snapshot of the
package's sources in <output>/code_copy; checkpoints (`utils.checkpoint`):
a warm start from --loadcheckpoint, one checkpoint an epoch with its eval
metric in <output>/checkpoints (the --checkpoint-hist best kept), a save
every --recovery-interval steps, a save and exit 75 on SIGTERM/SIGUSR1
(`utils.preemption`), and on launch the restore of --resume's newest
checkpoint or, with --auto-resume (the default), of the output directory's.
As in the JAX package, a resumed run restores the step, so the schedule and
the random draws go on where they stopped, but starts its epoch loop at 0
again (ROADMAP.md). --tensorboard writes scalars to <output>/tb[/
<experiment>], --log-wandb to Weights & Biases under --experiment's name;
each logs a warning and goes on where its package is missing.
--lmdb-dataset reads <data-dir>/train and <data-dir>/val from the LMDB
databases beside them (data/lmdb_dataset.py; the lmdb package is needed).

Data parallel (`parallel/`): launched by torchrun or SLURM, each process
joins the group (`parallel.distributed.initialize`: NCCL on the card
cuda:LOCAL_RANK, gloo with --device cpu), reads its share of the data
(the loaders' process_index/process_count; --batch-size is a process's
batch, as in the reference) and trains the model wrapped in
DistributedDataParallel with synchronised BatchNorm
(`parallel.data_parallel.wrap_model`); the schedule counts the global
batch, eval sums are added up over the processes, and only rank 0 logs,
writes checkpoints, the summary and the code snapshot.

    torchrun --nproc_per_node 8 -m fastervit_tpu_torch.train.train \
        --config configs/faster_vit_0_224_1k.yaml --data-dir ROOT
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
import os
import shutil
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from fastervit_tpu_torch.data.synthetic import SyntheticLoader
from fastervit_tpu_torch.models.registry import create_model
from fastervit_tpu_torch.parallel import data_parallel, distributed
from fastervit_tpu_torch.train.mixup import MixupConfig
from fastervit_tpu_torch.train.schedule import (ScheduleConfig,
                                                create_scheduler)
from fastervit_tpu_torch.train.steps import (TrainConfig, create_train_state,
                                             make_eval_step, make_train_step)
from fastervit_tpu_torch.utils.checkpoint import CheckpointManager
from fastervit_tpu_torch.utils.convert import load_checkpoint
from fastervit_tpu_torch.utils.metrics import (AverageMeter,
                                               TensorboardLogger, WandbLogger,
                                               update_summary)
from fastervit_tpu_torch.utils.preemption import (REQUEUE_EXIT_CODE,
                                                  PreemptionHandler,
                                                  maybe_auto_resume)

log = logging.getLogger("fastervit_tpu_torch.train")

def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-c", "--config", default="",
                   help="flat `key: value` YAML config with defaults")
    p.add_argument("--model", default="faster_vit_0_224")
    p.add_argument("--model-kwargs", default="",
                   help="JSON kwargs forwarded to create_model "
                        "(e.g. '{\"resolution\": 288}')")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on ('cuda', 'cuda:1', 'cpu')")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--lmdb-dataset", action="store_true",
                   help="LMDB-backed ImageNet (reference --lmdb_dataset, "
                        "utils/datasets.py:458-498)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("-b", "--batch-size", type=int, default=128)
    p.add_argument("--epochs", type=int, default=310)
    p.add_argument("--warmup-epochs", type=int, default=20)
    p.add_argument("--cooldown-epochs", type=int, default=10)
    p.add_argument("--sched", default="cosine")
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--min-lr", type=float, default=5e-6)
    p.add_argument("--warmup-lr", type=float, default=1e-6)
    p.add_argument("--data-len", type=int, default=1281167)
    p.add_argument("--opt", default="adamw")
    p.add_argument("--weight-decay", type=float, default=0.05)
    p.add_argument("--clip-grad", type=float, default=5.0)
    p.add_argument("--smoothing", type=float, default=0.1)
    p.add_argument("--bce-loss", action="store_true")
    p.add_argument("--mixup", type=float, default=0.8)
    p.add_argument("--cutmix", type=float, default=1.0)
    p.add_argument("--mixup-prob", type=float, default=1.0)
    p.add_argument("--mixup-switch-prob", type=float, default=0.5)
    p.add_argument("--mixup-off-epoch", type=int, default=0)
    p.add_argument("--model-ema", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--model-ema-decay", type=float, default=0.9998)
    p.add_argument("--mesa", type=float, default=0.0)
    p.add_argument("--mesa-start-ratio", type=float, default=0.25)
    p.add_argument("--drop-path", type=float, default=None)
    p.add_argument("--grad-checkpointing", action="store_true")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--resume", default="",
                   help="a checkpoint directory to restore the newest "
                        "checkpoint of")
    p.add_argument("--auto-resume", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="restore the newest checkpoint in the output dir on "
                        "launch (the requeue relaunch)")
    p.add_argument("--loadcheckpoint", default="",
                   help="warm start from a reference .pth.tar (keys of "
                        "another shape keep their init)")
    p.add_argument("--output", default="./output")
    p.add_argument("--log-interval", type=int, default=50)
    p.add_argument("--recovery-interval", type=int, default=0)
    p.add_argument("--checkpoint-hist", type=int, default=1)
    p.add_argument("--eval-metric", default="top1")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--tensorboard", action="store_true",
                   help="write scalars to <output>/tb")
    p.add_argument("--log-wandb", action="store_true",
                   help="log metrics to Weights & Biases if installed "
                        "(reference train.py:383-388)")
    p.add_argument("--experiment", default="",
                   help="the run's name: wandb's, and a tb subdirectory "
                        "(reference train.py:306-308)")
    return p


def _scalar(text: str):
    """A flat-YAML scalar: bool, int, float or string (quotes stripped)."""
    low = text.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("null", "~", ""):
        return None
    for kind in (int, float):
        try:
            return kind(text)
        except ValueError:
            pass
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    return text


def read_flat_yaml(path: str) -> Dict[str, object]:
    """Read a YAML file of top-level `key: value` lines (comments and blank
    lines allowed), the form of configs/*.yaml. Raises on anything else."""
    out: Dict[str, object] = {}
    with open(path) as f:
        for n, raw in enumerate(f, 1):
            line = raw.split(" #", 1)[0].rstrip()
            if not line.strip() or line.lstrip().startswith("#"):
                continue
            key, sep, value = line.partition(":")
            if not sep or raw[0].isspace() or not key.strip():
                raise ValueError(f"{path}:{n}: not a flat `key: value` line: "
                                 f"{raw.rstrip()!r}")
            out[key.strip()] = _scalar(value.strip())
    return out


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """Config file sets the defaults, the command line overrides them."""
    parser = build_argparser()
    args, _ = parser.parse_known_args(argv)
    if args.config:
        cfg = read_flat_yaml(args.config)
        known = {a.dest for a in parser._actions}
        parser.set_defaults(**{k: v for k, v in cfg.items() if k in known})
    return parser.parse_args(argv)


def make_loaders(args: argparse.Namespace, data_cfg, steps_per_epoch: int,
                 process_index: int = 0, process_count: int = 1):
    """(train, eval) loaders of this process's share: synthetic with
    --synthetic or without --data-dir (at most 32 train batches an epoch, 4
    eval batches; seeds 2r and 2r + 1 on rank r), else TrainLoader over
    <data-dir>/train and EvalLoader over <data-dir>/val (their LMDB
    databases with --lmdb-dataset), every process_count-th image from
    process_index's (JAX train.py:113-128)."""
    if args.synthetic or not args.data_dir:
        return (SyntheticLoader(data_cfg, args.batch_size,
                                num_batches=min(steps_per_epoch, 32),
                                num_classes=args.num_classes,
                                seed=2 * process_index),
                SyntheticLoader(data_cfg, args.batch_size, num_batches=4,
                                num_classes=args.num_classes,
                                seed=2 * process_index + 1))
    from fastervit_tpu_torch.data.imagenet import EvalLoader
    from fastervit_tpu_torch.data.train_loader import TrainLoader
    return (TrainLoader(os.path.join(args.data_dir, "train"), data_cfg,
                        args.batch_size, seed=args.seed,
                        process_index=process_index,
                        process_count=process_count,
                        use_lmdb=args.lmdb_dataset),
            EvalLoader(os.path.join(args.data_dir, "val"), data_cfg,
                       args.batch_size, process_index=process_index,
                       process_count=process_count,
                       use_lmdb=args.lmdb_dataset))


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is visible; "
                           "pass --device cpu to train on the CPU")
    if device.type == "cuda" and (device.index or 0) >= \
            torch.cuda.device_count():
        raise RuntimeError(f"--device {name}: only "
                           f"{torch.cuda.device_count()} CUDA device(s)")
    return device


def _snapshot_code(output_dir: str) -> None:
    """Copy the package's .py sources into output/code_copy (reference
    train.py:723-731)."""
    src = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    shutil.copytree(src, os.path.join(output_dir, "code_copy"),
                    dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))


def train(args: argparse.Namespace) -> dict:
    """Train as the arguments say. Returns {'best_<eval metric>': ...,
    'train_losses': the logged steps' losses, in order}."""
    _device(args.device)
    joins = not torch.distributed.is_initialized()
    dist_info = distributed.initialize(device=args.device)
    device = _device(str(dist_info["device"]))
    rank, world = dist_info["process_index"], dist_info["process_count"]
    main_process = rank == 0
    os.makedirs(args.output, exist_ok=True)
    if main_process:
        _snapshot_code(args.output)
    dtype = getattr(torch, args.dtype)
    overrides = {"num_classes": args.num_classes}
    if args.drop_path is not None:
        overrides["drop_path_rate"] = args.drop_path
    if args.model_kwargs:
        overrides.update(json.loads(args.model_kwargs))
    model = create_model(args.model, device=device,
                         generator=torch.Generator().manual_seed(args.seed),
                         **overrides)
    if args.loadcheckpoint:
        # shape-filtered warm start (reference train.py:527-540), before
        # the EMA copy is taken, as the reference's ModelEmaV2 is
        load_checkpoint(model, args.loadcheckpoint)

    sched_cfg = ScheduleConfig(
        sched=args.sched, lr=args.lr, min_lr=args.min_lr,
        warmup_lr=args.warmup_lr, epochs=args.epochs,
        warmup_epochs=args.warmup_epochs, cooldown_epochs=args.cooldown_epochs,
        data_len=args.data_len, batch_size=args.batch_size,
        world_size=world)
    schedule_fn, total_iters = create_scheduler(sched_cfg)
    steps_per_epoch = max(args.data_len // (args.batch_size * world), 1)
    num_epochs = math.ceil(total_iters / steps_per_epoch)

    mixup = None
    if args.mixup > 0 or args.cutmix > 0:
        mixup = MixupConfig(mixup_alpha=args.mixup, cutmix_alpha=args.cutmix,
                            prob=args.mixup_prob,
                            switch_prob=args.mixup_switch_prob,
                            label_smoothing=args.smoothing,
                            num_classes=args.num_classes)
    tcfg = TrainConfig(
        clip_grad=args.clip_grad, weight_decay=args.weight_decay, opt=args.opt,
        ema_decay=args.model_ema_decay, use_ema=args.model_ema,
        smoothing=args.smoothing, bce_loss=args.bce_loss, mixup=mixup,
        mesa=args.mesa,
        mesa_start_step=int(args.mesa_start_ratio * args.epochs
                            * steps_per_epoch),
        grad_checkpoint=args.grad_checkpointing)
    state = create_train_state(model, tcfg)
    ckpt = CheckpointManager(os.path.join(args.output, "checkpoints"),
                             max_history=args.checkpoint_hist,
                             recovery_interval=args.recovery_interval)
    if args.resume:
        if CheckpointManager(args.resume).restore(state) is not None:
            log.info("resumed at step %d", state.step)
    else:
        # requeue relaunch: restore the newest checkpoint in output/
        # (reference run_with_submitit.py:13-50 + train.py:505-516)
        state, _ = maybe_auto_resume(ckpt, state, args.auto_resume)
    state.ddp = data_parallel.wrap_model(state.model, device)
    train_step = make_train_step(tcfg, schedule_fn, dtype, args.seed)
    # mixup off for the final epochs (reference --mixup-off-epoch,
    # train.py:825-829)
    train_step_nomix = None
    if args.mixup_off_epoch and mixup is not None:
        train_step_nomix = make_train_step(
            dataclasses.replace(tcfg, mixup=None), schedule_fn, dtype,
            args.seed)
    eval_step = make_eval_step(dtype)

    train_loader, eval_loader = make_loaders(args, model.cfg.data,
                                             steps_per_epoch, rank, world)
    tb = TensorboardLogger(os.path.join(args.output, "tb")
                           if args.tensorboard and main_process else None,
                           run_name=args.experiment or None)
    wandb_log = WandbLogger(args.log_wandb and main_process,
                            run_name=args.experiment or None,
                            config=vars(args))

    def run_eval(m: torch.nn.Module) -> dict:
        # a process with no batch still takes part in the sums' reduction
        sums = {"loss_sum": torch.zeros((), device=device),
                "top1": torch.zeros((), dtype=torch.long, device=device),
                "top5": torch.zeros((), dtype=torch.long, device=device),
                "count": torch.zeros((), dtype=torch.long, device=device)}
        for batch in eval_loader:
            for k, v in eval_step(m, batch).items():
                sums[k] = sums[k] + v
        totals = {k: data_parallel.sum_over_processes(v).item()
                  for k, v in sums.items()}
        n = max(totals["count"], 1)
        return {"loss": totals["loss_sum"] / n,
                "top1": 100.0 * totals["top1"] / n,
                "top5": 100.0 * totals["top5"] / n}

    summary_path = os.path.join(args.output, "summary.csv")
    best = -float("inf")
    train_losses = []
    preempt = PreemptionHandler().install()
    try:
        for epoch in range(num_epochs):
            step_fn = train_step
            if (train_step_nomix is not None
                    and epoch >= num_epochs - args.mixup_off_epoch):
                step_fn = train_step_nomix
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            loss_m, rate_m = AverageMeter(), AverageMeter()
            t_last, i_last = time.perf_counter(), -1
            for i, batch in enumerate(train_loader):
                batch = {k: v for k, v in batch.items() if k != "valid"}
                metrics = step_fn(state, batch)
                if preempt.preempted:
                    # SIGTERM/SIGUSR1: save (rank 0), exit 75 so that the
                    # launcher requeues; the relaunch auto-resumes from here
                    if not main_process:
                        raise SystemExit(REQUEUE_EXIT_CODE)
                    preempt.checkpoint_and_exit(ckpt, state.step, state)
                if i % args.log_interval == 0 or i == len(train_loader) - 1:
                    loss = metrics["loss"].item()
                    if not np.isfinite(loss):
                        # NaN guard (reference train.py:794-810)
                        log.error("non-finite loss at epoch %d it %d",
                                  epoch, i)
                        raise FloatingPointError("training loss is non-finite")
                    now = time.perf_counter()
                    rate = args.batch_size * (i - i_last) / (now - t_last)
                    t_last, i_last = now, i
                    loss_m.update(loss)
                    rate_m.update(rate)
                    train_losses.append(loss)
                    if main_process:
                        log.info("epoch %d it %d/%d loss %.4f lr %.2e "
                                 "%.0f img/s", epoch, i, len(train_loader),
                                 loss, metrics["lr"], rate)
                        tb.log_scalar("train/loss", loss, state.step)
                        wandb_log.log({"train/loss": loss,
                                       "train/lr": metrics["lr"],
                                       "train/img_s": rate}, step=state.step)
                if main_process:
                    ckpt.maybe_save_recovery(state.step, state)

            eval_m = run_eval(state.model)
            if main_process:
                log.info("epoch %d eval: %s", epoch, eval_m)
            if state.ema_model is not None:
                ema_m = run_eval(state.ema_model)
                if main_process:
                    log.info("epoch %d EMA eval: %s", epoch, ema_m)
                if ema_m["top1"] >= eval_m["top1"]:
                    eval_m = {**ema_m, "ema": 1}
            if not np.isfinite(eval_m["loss"]):
                log.error("eval loss non-finite; aborting (NaN guard)")
                raise FloatingPointError("eval loss is non-finite")
            metric = eval_m[args.eval_metric]
            best = max(best, metric)
            if main_process:
                ckpt.save(state.step, state, metric=metric)
                update_summary(epoch, {"loss": loss_m.avg,
                                       "img_s": rate_m.avg},
                               eval_m, summary_path,
                               write_header=(epoch == 0))
                tb.log_scalar("eval/top1", eval_m["top1"], state.step)
                wandb_log.log({"eval/" + k: v for k, v in eval_m.items()},
                              step=state.step)
                tb.flush()
    finally:
        preempt.uninstall()
        tb.close()
        wandb_log.finish()
        if joins and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    ckpt.wait()
    return {"best_" + args.eval_metric: best, "train_losses": train_losses}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    logging.basicConfig(level=logging.INFO)
    return train(parse_args(argv))


if __name__ == "__main__":
    main()
