"""Training checkpoints on torch.save (port of
fastervit_tpu/utils/checkpoint.py, which wraps orbax; the reference's timm
CheckpointSaver and resume, train.py:505-516, 715-719, 938-940).

A checkpoint holds what a train step updates: the model's state_dict (its
parameters and its BatchNorm running statistics), the EMA model's, the
optimizer's and the step count (`TrainState`). Each save writes
`<directory>/<step>.pt`, through a temporary name and `os.replace`, so that
a save killed part way leaves no half file; its metric goes first to
`<directory>/<step>.json`. Retention is orbax's: with `max_history` > 0 the
`max_history` checkpoints with the best metrics are kept (a tie goes to the
later step), with 0 none. `latest_step` is the newest step kept, which after
retention need not be the last one saved. Saves are synchronous, so `wait`
and `close` have nothing to do; they keep the orbax manager's interface.
"""
from __future__ import annotations

import json
import logging
import os
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

log = logging.getLogger(__name__)


def _atomic_save(obj: Any, path: Path) -> None:
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _atomic_write_text(text: str, path: Path) -> None:
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


class CheckpointManager:
    """Keeps `max_history` checkpoints ranked by metric ('max' or 'min'),
    plus a save every `recovery_interval` steps (metric 0) for
    `maybe_save_recovery`, as the orbax manager does."""

    def __init__(self, directory: str, max_history: int = 1,
                 metric_mode: str = "max", recovery_interval: int = 0):
        if metric_mode not in ("max", "min"):
            raise ValueError(f"metric_mode {metric_mode!r}: 'max' or 'min'")
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_history = max_history
        self.metric_mode = metric_mode
        self.recovery_interval = recovery_interval

    def _path(self, step: int) -> Path:
        return self.directory / f"{step}.pt"

    def all_steps(self) -> List[int]:
        """The steps of the checkpoints on disk, in order."""
        return sorted(int(p.stem) for p in self.directory.glob("*.pt")
                      if p.stem.isdigit())

    def _metric(self, step: int) -> float:
        return json.loads((self.directory / f"{step}.json").read_text())[
            "metric"]

    def save(self, step: int, state, metric: Optional[float] = None) -> None:
        """Write `state` (a TrainState) as checkpoint `step`, then drop the
        checkpoints that retention does not keep."""
        step = int(step)
        _atomic_write_text(json.dumps(
            {"metric": float(metric if metric is not None else 0.0)}),
            self.directory / f"{step}.json")
        _atomic_save({
            "step": step,
            "model": state.model.state_dict(),
            "ema_model": (state.ema_model.state_dict()
                          if state.ema_model is not None else None),
            "optimizer": state.optimizer.state_dict(),
        }, self._path(step))
        for old in self._steps_to_remove():
            self._path(old).unlink()
            (self.directory / f"{old}.json").unlink(missing_ok=True)

    def _steps_to_remove(self) -> List[int]:
        """orbax's BestN: sort by metric (ascending for 'max', descending for
        'min', a stable sort in step order) and keep the last max_history."""
        steps = self.all_steps()
        if len(steps) <= self.max_history:
            return []
        ranked = sorted(steps, key=self._metric,
                        reverse=self.metric_mode == "min")
        keep = set(ranked[-self.max_history:]) if self.max_history else set()
        return [s for s in steps if s not in keep]

    def maybe_save_recovery(self, step: int, state) -> None:
        if self.recovery_interval and step % self.recovery_interval == 0:
            self.save(step, state)

    def restore(self, state, step: Optional[int] = None):
        """Load checkpoint `step` (the latest if None) into `state` in place:
        the model, the EMA model, the optimizer and the step. Returns
        `state`, or None when there is no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        ckpt: Dict[str, Any] = torch.load(self._path(step), map_location="cpu",
                                          weights_only=True)
        state.model.load_state_dict(ckpt["model"])
        if state.ema_model is not None:
            if ckpt["ema_model"] is None:
                raise ValueError(f"checkpoint {step} holds no EMA model")
            state.ema_model.load_state_dict(ckpt["ema_model"])
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = ckpt["step"]
        return state

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""

    def close(self) -> None:
        """Nothing is held open."""


def save_variables(path: str, model: torch.nn.Module) -> None:
    """One-shot save of a model's inference weights (its state_dict),
    through a temporary name."""
    path = Path(path).resolve()
    path.parent.mkdir(parents=True, exist_ok=True)
    _atomic_save(model.state_dict(), path)


def restore_variables(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load weights saved by `save_variables` into `model` (strict).
    Returns the model."""
    model.load_state_dict(torch.load(Path(path).resolve(), map_location="cpu",
                                     weights_only=True))
    return model
