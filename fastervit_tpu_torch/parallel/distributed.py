"""Process-group initialisation (port of fastervit_tpu/parallel/
distributed.py; reference train.py:392-406 and dino/util/misc.py:475-520,
the torch.distributed bootstrap that JAX's version replaced).

One call a process. The rendezvous is resolved in JAX's order: the
arguments, then SLURM's variables, then torchrun's (RANK, WORLD_SIZE,
MASTER_ADDR, MASTER_PORT), else a single process with no group. The group
runs NCCL for a CUDA device and gloo for the CPU; each process takes the
card cuda:LOCAL_RANK (SLURM_LOCALID under SLURM). Loaders then take
(process_index, process_count), the DistributedSampler's split.
"""
from __future__ import annotations

import logging
import os
from typing import Mapping, NamedTuple, Optional

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

DEFAULT_PORT = "8476"   # jax.distributed's default coordinator port


class Rendezvous(NamedTuple):
    """Where the group meets: `address` "host:port" (None: no group),
    `num_processes`, `process_id`, and the process's card `local_rank`."""
    address: Optional[str]
    num_processes: Optional[int]
    process_id: Optional[int]
    local_rank: int


def resolve(coordinator_address: Optional[str] = None,
            num_processes: Optional[int] = None,
            process_id: Optional[int] = None,
            environ: Optional[Mapping[str, str]] = None) -> Rendezvous:
    """The rendezvous, resolved as JAX's `initialize` resolves it
    (fastervit_tpu/parallel/distributed.py:21-57): explicit arguments;
    then SLURM (SLURM_NTASKS, SLURM_PROCID, the first host of
    SLURM_STEP_NODELIST); then torchrun (WORLD_SIZE, RANK, MASTER_ADDR and
    MASTER_PORT, 8476 if unset). A host with no port gets MASTER_PORT, or
    8476. `environ` defaults to os.environ."""
    env = os.environ if environ is None else environ
    local_rank = int(env.get("LOCAL_RANK", env.get("SLURM_LOCALID", 0)))
    if num_processes is None and "SLURM_NTASKS" in env:
        num_processes = int(env["SLURM_NTASKS"])
        process_id = int(env.get("SLURM_PROCID", 0))
        if coordinator_address is None:
            nodelist = env.get("SLURM_STEP_NODELIST", "")
            coordinator_address = nodelist.split(",")[0].split("[")[0] or None
    if (num_processes is None and "MASTER_ADDR" in env
            and "RANK" in env):
        num_processes = int(env.get("WORLD_SIZE", "1"))
        process_id = int(env["RANK"])
        if coordinator_address is None:
            coordinator_address = (f"{env['MASTER_ADDR']}:"
                                   f"{env.get('MASTER_PORT', DEFAULT_PORT)}")
    if coordinator_address is not None and ":" not in coordinator_address:
        coordinator_address += ":" + env.get("MASTER_PORT", DEFAULT_PORT)
    return Rendezvous(coordinator_address, num_processes, process_id,
                      local_rank)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: str = "cuda") -> dict:
    """Join the process group if a cluster environment is found
    (`resolve`): `torch.distributed.init_process_group` at
    tcp://<address>, NCCL where `device` is a card and gloo on the CPU. A
    group that is already initialised is kept. Returns
    {'process_index', 'process_count', 'device'}: the rank, the world size
    and the device this process runs on, cuda:LOCAL_RANK for "cuda" (an
    explicit "cuda:N" or "cpu" is kept)."""
    rdv = resolve(coordinator_address, num_processes, process_id)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rdv.local_rank)
    join = (rdv.address is not None
            or rdv.num_processes not in (None, 1))
    if join and not dist.is_initialized():
        if rdv.address is None:
            raise RuntimeError(f"{rdv.num_processes} processes and no "
                               "address to meet at: set MASTER_ADDR")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://{rdv.address}",
            world_size=rdv.num_processes or 1, rank=rdv.process_id or 0)
        log.info("process group initialised: process %d/%d on %s",
                 dist.get_rank(), dist.get_world_size(), dev)
    return {"process_index": rank(), "process_count": world_size(),
            "device": dev}


def rank() -> int:
    """This process's rank in the group; 0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The group's size; 1 without a group."""
    return dist.get_world_size() if dist.is_initialized() else 1
