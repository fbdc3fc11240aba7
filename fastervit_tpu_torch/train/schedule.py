"""Iteration-based learning-rate schedules (port of
fastervit_tpu/train/schedule.py, itself the reference's vendored timm
schedulers): cosine (cycles + k-decay), tanh, step, multistep and poly, as
plain Python functions of the step, and the reduce-on-plateau controller.

The reference steps its scheduler per iteration, converting epochs to
iterations via data_len // global_batch (scheduler_factory.py:12-16,
train.py:332, 849-850); `create_scheduler` does the same. The arithmetic is
in float64, where the JAX functions use float32.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Callable, Sequence, Tuple

Schedule = Callable[[int], float]


def _warmup(t: float, base_lr: float, warmup_t: int,
            warmup_lr_init: float) -> float:
    """Linear warmup from warmup_lr_init to base_lr over warmup_t steps."""
    return warmup_lr_init + t * (base_lr - warmup_lr_init) / warmup_t


def _cycle(t: float, t_initial: int, cycle_mul: float
           ) -> Tuple[float, float, float]:
    """(cycle index, cycle length, step within the cycle)."""
    if cycle_mul != 1.0:
        i = math.floor(math.log(1 - t / t_initial * (1 - cycle_mul))
                       / math.log(cycle_mul))
        t_i = cycle_mul ** i * t_initial
        t_curr = t - (1 - cycle_mul ** i) / (1 - cycle_mul) * t_initial
    else:
        i = t // t_initial
        t_i = t_initial
        t_curr = t - t_initial * i
    return i, t_i, t_curr


def _with_warmup(fn: Schedule, base_lr: float, warmup_t: int,
                 warmup_lr_init: float) -> Schedule:
    if warmup_t <= 0:
        return fn
    return lambda step: (_warmup(float(step), base_lr, warmup_t,
                                 warmup_lr_init)
                         if step < warmup_t else fn(step))


def cosine_schedule(base_lr: float, t_initial: int, lr_min: float = 0.0,
                    cycle_mul: float = 1.0, cycle_decay: float = 1.0,
                    cycle_limit: int = 1, warmup_t: int = 0,
                    warmup_lr_init: float = 0.0, warmup_prefix: bool = False,
                    k_decay: float = 1.0) -> Schedule:
    """timm CosineLRScheduler. With warmup_prefix=False (the reference's
    default) the cosine is indexed by the total step count, so warmup
    overlaps its head."""
    def cosine(step: int) -> float:
        t = float(step) - (warmup_t if warmup_prefix else 0)
        i, t_i, t_curr = _cycle(t, t_initial, cycle_mul)
        if i >= cycle_limit:
            return lr_min
        lr_max = base_lr * cycle_decay ** i
        return lr_min + 0.5 * (lr_max - lr_min) * (
            1 + math.cos(math.pi * t_curr ** k_decay / t_i ** k_decay))
    return _with_warmup(cosine, base_lr, warmup_t, warmup_lr_init)


def tanh_schedule(base_lr: float, t_initial: int, lr_min: float = 0.0,
                  lb: float = -7.0, ub: float = 3.0, cycle_mul: float = 1.0,
                  cycle_decay: float = 1.0, cycle_limit: int = 1,
                  warmup_t: int = 0, warmup_lr_init: float = 0.0,
                  warmup_prefix: bool = False) -> Schedule:
    """timm TanhLRScheduler."""
    def tanh(step: int) -> float:
        t = float(step) - (warmup_t if warmup_prefix else 0)
        i, t_i, t_curr = _cycle(t, t_initial, cycle_mul)
        if i >= cycle_limit:
            return lr_min
        lr_max = base_lr * cycle_decay ** i
        tr = t_curr / t_i
        return lr_min + 0.5 * (lr_max - lr_min) * (
            1 - math.tanh(lb * (1.0 - tr) + ub * tr))
    return _with_warmup(tanh, base_lr, warmup_t, warmup_lr_init)


def step_schedule(base_lr: float, decay_t: int, decay_rate: float = 1.0,
                  warmup_t: int = 0, warmup_lr_init: float = 0.0) -> Schedule:
    """timm StepLRScheduler: lr = base · rate^(t // decay_t)."""
    return _with_warmup(lambda step: base_lr * decay_rate ** (step // decay_t),
                        base_lr, warmup_t, warmup_lr_init)


def multistep_schedule(base_lr: float, decay_t: Sequence[int],
                       decay_rate: float = 1.0, warmup_t: int = 0,
                       warmup_lr_init: float = 0.0) -> Schedule:
    """timm MultiStepLRScheduler: one decay at each milestone reached."""
    milestones = sorted(decay_t)
    return _with_warmup(
        lambda step: base_lr * decay_rate ** bisect.bisect_right(milestones,
                                                                 step),
        base_lr, warmup_t, warmup_lr_init)


def poly_schedule(base_lr: float, t_initial: int, power: float = 0.5,
                  lr_min: float = 0.0, cycle_mul: float = 1.0,
                  cycle_decay: float = 1.0, cycle_limit: int = 1,
                  warmup_t: int = 0, warmup_lr_init: float = 0.0,
                  k_decay: float = 1.0) -> Schedule:
    """timm PolyLRScheduler."""
    def poly(step: int) -> float:
        i, t_i, t_curr = _cycle(float(step), t_initial, cycle_mul)
        if i >= cycle_limit:
            return lr_min
        lr_max = base_lr * cycle_decay ** i
        return lr_min + (lr_max - lr_min) * (
            1 - t_curr ** k_decay / t_i ** k_decay) ** power
    return _with_warmup(poly, base_lr, warmup_t, warmup_lr_init)


class PlateauScheduler:
    """Reduce-on-plateau (timm PlateauLRScheduler semantics): a host-side
    controller; call step(epoch, metric) each epoch and read .lr."""

    def __init__(self, base_lr: float, decay_rate: float = 0.1,
                 patience_t: int = 10, lr_min: float = 0.0,
                 mode: str = "max", threshold: float = 1e-4,
                 cooldown_t: int = 0, warmup_t: int = 0,
                 warmup_lr_init: float = 0.0):
        self.lr = base_lr if warmup_t == 0 else warmup_lr_init
        self.base_lr = base_lr
        self.decay_rate = decay_rate
        self.patience_t = patience_t
        self.lr_min = lr_min
        self.mode = mode
        self.threshold = threshold
        self.cooldown_t = cooldown_t
        self.warmup_t = warmup_t
        self.warmup_lr_init = warmup_lr_init
        self._best = None
        self._bad_epochs = 0
        self._cooldown = 0

    def _improved(self, metric: float) -> bool:
        if self._best is None:
            return True
        if self.mode == "max":
            return metric > self._best + self.threshold
        return metric < self._best - self.threshold

    def step(self, epoch: int, metric: float) -> float:
        if epoch < self.warmup_t:
            frac = (epoch + 1) / max(1, self.warmup_t)
            self.lr = self.warmup_lr_init + frac * (self.base_lr
                                                    - self.warmup_lr_init)
            return self.lr
        if self._improved(metric):
            self._best = metric
            self._bad_epochs = 0
        elif self._cooldown > 0:
            self._cooldown -= 1
        else:
            self._bad_epochs += 1
            if self._bad_epochs > self.patience_t:
                self.lr = max(self.lr * self.decay_rate, self.lr_min)
                self._bad_epochs = 0
                self._cooldown = self.cooldown_t
        return self.lr


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    """The reference's scheduler flags (train.py:255-286, 330-335)."""
    sched: str = "cosine"
    lr: float = 5e-3
    min_lr: float = 5e-6
    warmup_lr: float = 1e-6
    epochs: int = 310
    warmup_epochs: int = 20
    cooldown_epochs: int = 10
    data_len: int = 1281167
    batch_size: int = 128
    world_size: int = 1
    decay_epochs: int = 100
    decay_milestones: tuple = (30, 60)
    decay_rate: float = 0.1
    lr_cycle_mul: float = 1.0
    lr_cycle_decay: float = 0.1
    lr_cycle_limit: int = 1
    lr_k_decay: float = 1.0


def create_scheduler(cfg: ScheduleConfig) -> Tuple[Schedule, int]:
    """The reference's scheduler_factory.create_scheduler: epochs become
    iterations; returns (schedule, total iterations incl. cooldown)."""
    n_iter = cfg.data_len // (cfg.batch_size * cfg.world_size)
    tot_iter = cfg.epochs * n_iter
    warmup_iters = cfg.warmup_epochs * n_iter
    cycle = dict(cycle_mul=cfg.lr_cycle_mul, cycle_decay=cfg.lr_cycle_decay,
                 cycle_limit=cfg.lr_cycle_limit)
    if cfg.sched == "cosine":
        fn = cosine_schedule(cfg.lr, tot_iter, lr_min=cfg.min_lr,
                             warmup_t=warmup_iters,
                             warmup_lr_init=cfg.warmup_lr,
                             k_decay=cfg.lr_k_decay, **cycle)
        if cfg.lr_cycle_mul == 1.0:
            cycle_iters = tot_iter * max(1, cfg.lr_cycle_limit)
        else:
            cycle_iters = int(math.floor(
                -tot_iter * (cfg.lr_cycle_mul ** max(1, cfg.lr_cycle_limit)
                             - 1) / (1 - cfg.lr_cycle_mul)))
        total = cycle_iters + cfg.cooldown_epochs * n_iter
    elif cfg.sched == "tanh":
        fn = tanh_schedule(cfg.lr, tot_iter, lr_min=cfg.min_lr,
                           warmup_t=warmup_iters,
                           warmup_lr_init=cfg.warmup_lr, **cycle)
        total = tot_iter + cfg.cooldown_epochs * n_iter
    elif cfg.sched == "step":
        fn = step_schedule(cfg.lr, cfg.decay_epochs * n_iter, cfg.decay_rate,
                           warmup_t=warmup_iters, warmup_lr_init=cfg.warmup_lr)
        total = tot_iter
    elif cfg.sched == "multistep":
        fn = multistep_schedule(cfg.lr,
                                [m * n_iter for m in cfg.decay_milestones],
                                cfg.decay_rate, warmup_t=warmup_iters,
                                warmup_lr_init=cfg.warmup_lr)
        total = tot_iter
    elif cfg.sched == "poly":
        fn = poly_schedule(cfg.lr, tot_iter, power=cfg.decay_rate,
                           lr_min=cfg.min_lr, warmup_t=warmup_iters,
                           warmup_lr_init=cfg.warmup_lr,
                           k_decay=cfg.lr_k_decay, **cycle)
        total = tot_iter + cfg.cooldown_epochs * n_iter
    else:
        raise ValueError(f"unknown schedule {cfg.sched!r}")
    return fn, total
