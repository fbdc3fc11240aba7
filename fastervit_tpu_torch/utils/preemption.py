"""Preemption: a signal-triggered checkpoint and an automatic restore of the
newest checkpoint on relaunch (port of fastervit_tpu/utils/preemption.py;
the reference's SLURM requeue flow, dino/run_with_submitit.py:13-50 and
train.py:505-516).

A `PreemptionHandler` latches SIGTERM/SIGUSR1, the train loop polls it once
a step, saves through the `CheckpointManager` and exits with the
conventional requeue code (EX_TEMPFAIL, 75), so that a supervisor (SLURM
requeue, a k8s restart policy) relaunches the same command, which then
restores the newest checkpoint in the output directory.
"""
from __future__ import annotations

import logging
import signal
import sys
from typing import Iterable

log = logging.getLogger(__name__)

REQUEUE_EXIT_CODE = 75  # EX_TEMPFAIL: "try again"


class PreemptionHandler:
    """Latches preemption signals; poll `preempted` in the step loop."""

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,
                                                 signal.SIGUSR1)):
        self.preempted = False
        self._signals = tuple(signals)
        self._prev = {}

    def install(self) -> "PreemptionHandler":
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._on_signal)
        return self

    def uninstall(self) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()

    def _on_signal(self, signum, frame):
        log.warning("preemption signal %s received; will checkpoint and "
                    "requeue", signal.Signals(signum).name)
        self.preempted = True

    def checkpoint_and_exit(self, ckpt, step: int, state,
                            exit_code: int = REQUEUE_EXIT_CODE) -> None:
        """Save `state` as checkpoint `step`, synchronously, then exit with
        the requeue code. Never returns."""
        log.warning("preemption: saving checkpoint at step %d", step)
        ckpt.save(step, state)
        ckpt.wait()
        log.warning("preemption checkpoint complete; exiting %d for requeue",
                    exit_code)
        sys.exit(exit_code)


def maybe_auto_resume(ckpt, state, enabled: bool = True):
    """Restore the newest checkpoint in `ckpt`'s directory into `state` if
    one exists (the relaunch half of the requeue flow). Returns (state,
    resumed step or None)."""
    if not enabled:
        return state, None
    step = ckpt.latest_step()
    if step is None:
        return state, None
    restored = ckpt.restore(state, step=step)
    log.info("auto-resumed from checkpoint at step %d", step)
    return restored, step
