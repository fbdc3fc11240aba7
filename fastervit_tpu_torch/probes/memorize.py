"""The memorisation run: does the training stack train? faster_vit_0_224
with the fv0 recipe of configs/faster_vit_0_224_1k.yaml (AdamW, weight
decay 0.05, a cosine schedule with warm-up, mixup 0.8 / cutmix 1.0,
label smoothing 0.1, drop path 0.2, clip 5, EMA 0.9998) on a fixed
synthetic set (N(0, 1) images, labels uniform over the 1000 classes, from
numpy's RandomState(0)), at batch 128, in bf16 (autocast over f32
weights: K1 and K2 on the tensor cores, K2 rounding P and dl to bf16) and
in fp32 (K1 and K2 on scalar FMA), the two runs' steps in turns. Every
--every steps it records each run's train loss (the step's, mixup
included) and its top-1 over the whole set in eval mode without mixup,
the mean ms a step after the first (host clock around the step and its
loss's fetch) and the first step's ms (the kernels' build, if this
process makes it, and cuDNN's first calls). The epochs of the schedule
are passes over the set; the learning rate is the recipe's scaled to
the batch (5e-3 at 4096, so 1.5625e-4 at 128) unless --lr is given.

    python -m fastervit_tpu_torch.probes.memorize \\
        --out chiprun_out/memorize_fv0.json

It prints one JSON object (with the card's name and power limit) and
writes it to --out. With --device cpu, --model-kwargs, a smaller --images,
--batch and --steps, it runs on the CPU, untimed on the card's terms.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

RECIPE_LR, RECIPE_BATCH = 5e-3, 4096


def _card(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    from fastervit_tpu_torch.models.registry import create_model
    from fastervit_tpu_torch.train.mixup import MixupConfig
    from fastervit_tpu_torch.train.schedule import (ScheduleConfig,
                                                    create_scheduler)
    from fastervit_tpu_torch.train.steps import (TrainConfig,
                                                 create_train_state,
                                                 make_eval_step,
                                                 make_train_step)

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda")
    p.add_argument("--images", type=int, default=256)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--every", type=int, default=10)
    p.add_argument("--warmup-epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--model-kwargs", default="{}")
    p.add_argument("--dtypes", default="bfloat16,float32")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is visible; pass --device cpu")
    kwargs = json.loads(args.model_kwargs)
    classes = kwargs.get("num_classes", 1000)
    lr = args.lr or RECIPE_LR * args.batch / RECIPE_BATCH
    rng = np.random.RandomState(0)
    res = kwargs.get("resolution", 224)
    images = rng.randn(args.images, res, res, 3).astype(np.float32)
    labels = rng.randint(0, classes, args.images).astype(np.int64)
    per_epoch = args.images // args.batch
    sched_cfg = ScheduleConfig(
        lr=lr, epochs=-(-args.steps // per_epoch),
        warmup_epochs=args.warmup_epochs, cooldown_epochs=0,
        data_len=args.images, batch_size=args.batch)
    schedule, _ = create_scheduler(sched_cfg)
    cfg = TrainConfig(mixup=MixupConfig(num_classes=classes))
    eval_step = {}
    runs = {}
    for name in args.dtypes.split(","):
        dtype = getattr(torch, name)
        model = create_model("faster_vit_0_224", device=device,
                             generator=torch.Generator().manual_seed(0),
                             **kwargs)
        runs[name] = {"state": create_train_state(model, cfg),
                      "step": make_train_step(cfg, schedule, dtype, seed=0),
                      "ms": [], "steps": [], "loss": [], "top1": []}
        eval_step[name] = make_eval_step(dtype)

    def top1(name) -> float:
        hits = 0
        for i in range(0, args.images, args.batch):
            got = eval_step[name](runs[name]["state"].model,
                                  {"image": images[i:i + args.batch],
                                   "label": labels[i:i + args.batch]})
            hits += int(got["top1"])
        return 100.0 * hits / args.images

    for step in range(args.steps):
        i = (step % per_epoch) * args.batch
        batch = {"image": images[i:i + args.batch],
                 "label": labels[i:i + args.batch]}
        for name, run in runs.items():           # the dtypes in turns
            if device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = run["step"](run["state"], batch)
            loss = float(metrics["loss"])         # a sync
            run["ms"].append(1e3 * (time.perf_counter() - t0))
            if (step + 1) % args.every == 0 or step == 0:
                run["steps"].append(step + 1)
                run["loss"].append(loss)
                run["top1"].append(top1(name))
    out = {"probe": "memorize", "card": _card(device),
           "model": "faster_vit_0_224", "model_kwargs": kwargs,
           "images": args.images, "batch": args.batch, "steps": args.steps,
           "lr": lr, "recipe": "configs/faster_vit_0_224_1k.yaml",
           "runs": {name: {"steps": r["steps"], "loss": r["loss"],
                           "top1": r["top1"],
                           "first_step_ms": r["ms"][0],
                           "ms_per_step": (sum(r["ms"][1:])
                                           / max(1, len(r["ms"]) - 1))}
                    for name, r in runs.items()}}
    print(json.dumps(out))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
