"""Model validation (port of fastervit_tpu/validate.py; reference
fastervit/validate.py:152-447, rebuilt): top-1/5 and loss of one model, or
of every model a name wildcard matches, over an image folder (or its LMDB
database, --lmdb-dataset) or synthetic data, on one device; optionally the int8 serving model; a batch that runs
out of device memory is retried at half the batch size.

Usage (on the card unless --device cpu):
    python -m fastervit_tpu_torch.validate --model faster_vit_0_224 \
        --data-dir /path/to/imagenet/val --checkpoint weights.pth.tar
    python -m fastervit_tpu_torch.validate --int8 --dtype bfloat16 \
        --data-dir /path/to/imagenet/val --checkpoint weights.pth.tar
    python -m fastervit_tpu_torch.validate --synthetic --device cpu
"""
from __future__ import annotations

import argparse
import json
import logging
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from fastervit_tpu_torch.models.registry import create_model, list_models

log = logging.getLogger("fastervit_tpu_torch.validate")


def subset_logit_mask(classes, class_index_file: str, num_classes: int = 1000):
    """Logit mask for subset benchmarks (ImageNet-A/R have 200 of the 1k
    classes): classes present in the eval set keep their logits, the rest
    get -inf before the argmax, the standard subset-evaluation protocol.

    `class_index_file`: one wnid per line in 1k-index order (the sorted
    train class list); `classes`: the eval folder's class names. Returns
    (mask (num_classes,) f32, class_to_idx)."""
    with open(class_index_file) as f:
        all_classes = [l.strip() for l in f if l.strip()]
    class_to_idx = {c: i for i, c in enumerate(all_classes)}
    mask = torch.full((num_classes,), -float("inf"))
    mask[torch.as_tensor([class_to_idx[c] for c in classes])] = 0.0
    return mask, class_to_idx


def imagenet_v2_class_to_idx(classes):
    """ImageNet-V2 folder layout: the top-level folders are the 1k class
    indices as strings ("0".."999"), so the labels are the folder names
    parsed as ints, not the lexicographic enumeration an ImageFolder would
    give ("10" < "2"). Robustness protocol: README.md:286-367, V2 rows."""
    return {c: int(c) for c in classes}


def _model_device_dtype(model: nn.Module):
    """The device of the model's first tensor and the dtype of its first
    floating parameter."""
    first = next(model.parameters())
    dtype = next((p.dtype for p in model.parameters()
                  if p.is_floating_point()), torch.float32)
    return first.device, dtype


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def validate(model: nn.Module, loader, device=None,
             dtype: Optional[torch.dtype] = None,
             logit_mask: Optional[torch.Tensor] = None, tta: int = 0,
             real_labels=None) -> Dict[str, float]:
    """Evaluate `model` (put in eval mode) over `loader`'s batches ({'image'
    NHWC float32, 'label', 'valid'} numpy): returns {'top1', 'top5',
    'loss', 'img_s', 'count'}, counting only the valid rows. The images go
    to `device` in `dtype` (default: the model's device and parameter
    dtype); the loss and top-k are taken from the f32 logits.

    logit_mask (num_classes,) is added to the logits (subset benchmarks).
    tta > 1: the loader gives each image `tta` times in a row (EvalLoader
    (tta=2): the image, then its flip), and the logits are averaged per
    group (reference train.py:981-985). real_labels: a data.real_labels.
    RealLabels accumulator, handed each valid row's top-5.

    img_s leaves out the first batch, as the JAX package does (its compile;
    here the first call's kernel builds and cuDNN's choices), and the clock
    reads only after the device has finished each batch."""
    model_device, model_dtype = _model_device_dtype(model)
    device = torch.device(device) if device is not None else model_device
    dtype = dtype or model_dtype
    model.eval()
    if logit_mask is not None:
        logit_mask = logit_mask.to(device=device, dtype=torch.float32)
    totals = {"loss_sum": 0.0, "top1": 0, "top5": 0, "count": 0}
    images = 0
    t_start = None
    for i, batch in enumerate(loader):
        label = torch.as_tensor(np.asarray(batch["label"]), dtype=torch.long)
        valid = torch.as_tensor(np.asarray(batch["valid"]), dtype=torch.bool)
        if tta > 1:
            label, valid = label[::tta], valid[::tta]
        label, valid = label.to(device), valid.to(device)
        x = torch.from_numpy(np.ascontiguousarray(batch["image"]))
        x = x.to(device=device, dtype=dtype).permute(0, 3, 1, 2)
        logits = model(x).float()
        if logit_mask is not None:
            logits = logits + logit_mask
        if tta > 1:
            b, c = logits.shape
            logits = logits.reshape(b // tta, tta, c).mean(1)
        per_ex = -torch.log_softmax(logits, -1).gather(
            -1, label[:, None])[:, 0]
        k = min(5, logits.shape[-1])
        topk = logits.topk(k, -1).indices
        m = {"loss_sum": torch.where(valid, per_ex, 0.0).sum(),
             "top1": ((logits.argmax(-1) == label) & valid).sum(),
             "top5": ((topk == label[:, None]).any(-1) & valid).sum(),
             "count": valid.sum()}
        if real_labels is not None:
            real_labels.add_result(topk[valid].cpu().numpy())
        _sync(device)
        m = {key: v.item() for key, v in m.items()}
        if i == 0:
            t_start = time.perf_counter()  # the first batch is left out
        else:
            images += m["count"]
        for key in totals:
            totals[key] += m[key]
    dt = time.perf_counter() - t_start if t_start else float("inf")
    n = max(totals["count"], 1)
    return {"top1": 100.0 * totals["top1"] / n,
            "top5": 100.0 * totals["top5"] / n,
            "loss": totals["loss_sum"] / n,
            "img_s": images / dt if dt > 0 else 0.0,
            "count": totals["count"]}


def validate_with_batch_decay(make_loader: Callable[[int], object],
                              model: nn.Module, batch_size: int,
                              decay_step: int = 2, retries: int = 3,
                              **kw) -> Dict[str, float]:
    """`validate` over make_loader(batch_size); on running out of device
    memory (torch.cuda.OutOfMemoryError, where the JAX package catches
    RESOURCE_EXHAUSTED), again over a loader of batch_size // decay_step,
    up to `retries` times (reference validate.py:367-387 decay_batch_step,
    check_batch_size_retry)."""
    bs = batch_size
    for attempt in range(retries + 1):
        try:
            return validate(model, make_loader(bs), **kw)
        except torch.cuda.OutOfMemoryError:
            if attempt == retries:
                raise
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            bs = max(bs // decay_step, 1)
            log.warning("eval ran out of memory; retrying with "
                        "batch_size=%d", bs)
    raise RuntimeError("unreachable")


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is visible; "
                           "pass --device cpu to validate on the CPU")
    return device


def load_model(name: str, device: torch.device, dtype: torch.dtype,
               checkpoint: str = "", use_ema: bool = False,
               int8: bool = False) -> nn.Module:
    """The model to validate: built on `device` in f32, its weights from a
    reference checkpoint (.pth, .pth.tar, .pt; the EMA weights with
    use_ema), from a file of `utils.checkpoint.save_variables`, or random
    (seed 0) without one; then quantised (int8) from those f32 weights;
    then cast to `dtype`; in eval mode."""
    from fastervit_tpu_torch.ops.quant import quantize_model
    from fastervit_tpu_torch.utils.checkpoint import restore_variables
    from fastervit_tpu_torch.utils.convert import load_checkpoint
    model = create_model(name, device=device)
    if checkpoint.endswith((".pth", ".pth.tar", ".pt")):
        load_checkpoint(model, checkpoint, use_ema=use_ema)
    elif checkpoint:
        restore_variables(checkpoint, model)
    else:
        log.warning("no checkpoint: random weights (smoke test)")
    if int8:
        quantize_model(model)
    return model.to(dtype).eval()


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--model", default="faster_vit_0_224",
                   help="name or fnmatch wildcard for bulk validation")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--lmdb-dataset", action="store_true",
                   help="read data-dir's LMDB database (data/"
                        "lmdb_dataset.py), not its folders")
    p.add_argument("--checkpoint", default="",
                   help="reference .pth.tar, or a file of save_variables")
    p.add_argument("--use-ema", action="store_true",
                   help="take the checkpoint's EMA weights")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--device", default="cuda",
                   help="torch device ('cuda', 'cuda:1', 'cpu')")
    p.add_argument("--int8", action="store_true",
                   help="int8 serving path: weights quantised once, "
                        "activations at run time (ops/quant.py)")
    p.add_argument("--synthetic", action="store_true",
                   help="random data (smoke test / throughput only)")
    p.add_argument("--class-index-file", default="",
                   help="1k wnid list (one per line, index order) enabling "
                        "ImageNet-A/R-style subset evaluation")
    p.add_argument("--imagenet-v2", action="store_true",
                   help="data-dir uses the ImageNet-V2 layout (folders are "
                        "class indices '0'..'999')")
    return p


def main(argv: Optional[Sequence[str]] = None) -> list:
    p = build_argparser()
    args = p.parse_args(argv)
    device = _device(args.device)
    dtype = getattr(torch, args.dtype)
    names = list_models(args.model) or [args.model]
    results = []
    for name in names:
        model = load_model(name, device, dtype, args.checkpoint,
                           args.use_ema, args.int8)
        logit_mask = None
        if args.synthetic or not args.data_dir:
            from fastervit_tpu_torch.data.imagenet import SyntheticLoader

            def make_loader(bs):
                return SyntheticLoader(model.cfg.data, bs, num_batches=8,
                                       num_classes=model.cfg.num_classes)
        else:
            from fastervit_tpu_torch.data.imagenet import (EvalLoader,
                                                           index_image_folder)
            class_to_idx = None
            if args.imagenet_v2:
                if args.lmdb_dataset:
                    p.error("--imagenet-v2 reads the folder layout and "
                            "cannot combine with --lmdb-dataset")
                class_to_idx = imagenet_v2_class_to_idx(
                    index_image_folder(args.data_dir)[2])
            elif args.class_index_file:
                classes = index_image_folder(args.data_dir)[2]
                logit_mask, class_to_idx = subset_logit_mask(
                    classes, args.class_index_file, model.cfg.num_classes)

            def make_loader(bs):
                return EvalLoader(args.data_dir, model.cfg.data, bs,
                                  class_to_idx=class_to_idx,
                                  use_lmdb=args.lmdb_dataset)
        res = validate_with_batch_decay(make_loader, model, args.batch_size,
                                        logit_mask=logit_mask)
        res["model"] = name
        print(json.dumps(res))
        results.append(res)
        del model
    return results


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
