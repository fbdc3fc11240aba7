"""Data parallelism (port of fastervit_tpu/parallel/mesh.py): the
reference's NCCL DistributedDataParallel with SyncBatchNorm (SURVEY.md
§2.10), which the JAX package writes as a batch-sharded GSPMD mesh.

* `wrap_model`: BatchNorm synchronised over the group, then
  DistributedDataParallel. JAX's batch-sharded BatchNorm takes global-batch
  statistics (mesh.py:4-9), and so does `SyncBatchNorm2d`, which keeps the
  port's flax running-statistics rule (the biased variance); torch's
  nn.SyncBatchNorm would update them with the unbiased one.
* `local_slice`: a process's share of a global batch, the counterpart of
  `shard_batch_global` (mesh.py:48-63), for loaders that do not shard.
* `mirrored_flip`: mixup's partner batch. JAX flips the global batch
  (train/mixup.py:65, 78), so rank r's partners sit on rank P-1-r in
  reverse order; each rank swaps its batch with that rank's and flips it.
* `global_num_boxes`: the detection losses' normaliser over the group's
  targets (JAX's count is global under GSPMD, detection/dino.py:208, 264).

With no process group, or a group of one, every function here is the
single-process computation itself.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn
import torch.nn as nn

from fastervit_tpu_torch.models.layers import BatchNorm2d
from fastervit_tpu_torch.parallel.distributed import rank, world_size


class SyncBatchNorm2d(BatchNorm2d):
    """The port's BatchNorm2d with its training statistics taken over the
    whole group: the mean, then the biased variance about it, each an
    all-reduced f32 sum over every process's batch (differentiable, so the
    backward takes the other processes' terms too), and the running
    statistics updated by the flax rule from them. In eval mode, or with a
    group of one, it is BatchNorm2d itself."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or world_size() == 1:
            return super().forward(x)
        xf = x.float()
        count = torch.tensor([float(x.numel() // x.shape[1])],
                             device=x.device)
        count = dist_fn.all_reduce(count)
        mean = dist_fn.all_reduce(xf.sum((0, 2, 3))) / count
        centred = xf - mean[None, :, None, None]
        var = dist_fn.all_reduce(centred.square().sum((0, 2, 3))) / count
        if self.update_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(var, alpha=m)
                self.num_batches_tracked.add_(1)
        y = centred * torch.rsqrt(var + self.eps)[None, :, None, None]
        y = y * self.weight[None, :, None, None] \
            + self.bias[None, :, None, None]
        return y.to(x.dtype)


def convert_sync_batchnorm(model: nn.Module) -> nn.Module:
    """Make every BatchNorm2d of `model` a SyncBatchNorm2d, in place (the
    same parameters and buffers). Returns the model."""
    for m in model.modules():
        if type(m) is BatchNorm2d:
            m.__class__ = SyncBatchNorm2d
    return model


def wrap_model(model: nn.Module, device: torch.device,
               sync_bn: bool = True,
               find_unused_parameters: bool = False) -> Optional[nn.Module]:
    """Within a process group, `convert_sync_batchnorm` (with `sync_bn`)
    and DistributedDataParallel around `model` on `device`, which the
    train step's gradient pass calls while the bare model keeps the
    weights (its EMA, checkpoints and state_dict keys are the
    single-process ones). DDP averages the gradients over the processes
    and leaves buffers alone (the synchronised statistics agree already).
    Returns the wrapper, or None without a group."""
    if not dist.is_initialized():
        return None
    if sync_bn:
        convert_sync_batchnorm(model)
    ids = [device.index] if device.type == "cuda" else None
    return nn.parallel.DistributedDataParallel(
        model, device_ids=ids, broadcast_buffers=False,
        find_unused_parameters=find_unused_parameters)


def local_slice(batch: Mapping[str, object], process_index: int,
                process_count: int) -> dict:
    """This process's contiguous share of a global batch: rows
    [i·n, (i+1)·n) of each array, n = global batch / process_count (which
    must divide it). Rank r's rows of the global batch, the layout
    `mirrored_flip` assumes."""
    out = {}
    for k, v in batch.items():
        total = len(v)
        if total % process_count:
            raise ValueError(f"{k}: a global batch of {total} does not split "
                             f"over {process_count} processes")
        n = total // process_count
        out[k] = v[process_index * n:(process_index + 1) * n]
    return out


def mirrored_flip(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of the flipped global batch: rank P-1-r's batch,
    reversed, exchanged by one send and one receive (x.flip(0) with no
    group, or on the middle rank of an odd group)."""
    world = world_size()
    peer = world - 1 - rank()
    if peer == rank():
        return x.flip(0)
    x = x.contiguous()
    got = torch.empty_like(x)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer),
                                       dist.P2POp(dist.irecv, got, peer)]):
        req.wait()
    return got.flip(0)


def global_num_boxes(mask: torch.Tensor) -> torch.Tensor:
    """The detection losses' divisor: max(1, targets in `mask`), counted
    over the whole group and divided by its size (the reference criterion's
    all-reduced num_boxes), so that DDP's gradient average gives the
    gradient of the global-batch loss. Without a group, mask.sum()
    clamped to 1."""
    n = mask.sum()
    world = world_size()
    if world == 1:
        return n.clamp(min=1)
    n = n.float()
    dist.all_reduce(n)
    return (n / world).clamp(min=1)


def mean_over_processes(value: torch.Tensor) -> torch.Tensor:
    """A per-process scalar averaged over the group (a reported loss)."""
    world = world_size()
    if world == 1:
        return value
    value = value.detach().float().clone()
    dist.all_reduce(value)
    return value / world


def sum_over_processes(value: torch.Tensor) -> torch.Tensor:
    """A per-process sum added up over the group (eval sums)."""
    if world_size() == 1:
        return value
    value = value.detach().clone()
    dist.all_reduce(value)
    return value
