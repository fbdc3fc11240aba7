"""Named-section timers and cumulative function timing (port of
fastervit_tpu/utils/timing.py).

Reference patterns: dino/util/time_counter.py:4-32 (TimeCounter / TimeHolder
named-section timers) and motrv2/TrackEval/trackeval/_timing.py:11-35
(decorator-based cumulative timing behind a DO_TIMING flag), plus
`torch_trace`, a torch.profiler trace of a block written as a Chrome trace
(JAX's `jax_trace`). Wall timers time the host: a block that launches work
on the card ends before the card does unless it synchronises.
"""
from __future__ import annotations

import contextlib
import functools
import time
from collections import OrderedDict, defaultdict
from typing import Optional

DO_TIMING = False  # module-level switch for @time_function (TrackEval-style)
_cumulative = defaultdict(float)
_counts = defaultdict(int)


class TimeCounter:
    """Named-section wall timers (reference TimeCounter + TimeHolder)."""

    def __init__(self):
        self.clear()

    def clear(self):
        self.timedict = OrderedDict()
        self.basetime = time.perf_counter()

    @contextlib.contextmanager
    def timeit(self, name: str):
        t0 = time.perf_counter()
        yield
        self.timedict[name] = self.timedict.get(name, 0.0) + (
            time.perf_counter() - t0)

    def tock(self, name: str):
        """Record elapsed-since-previous-mark under `name`."""
        now = time.perf_counter()
        self.timedict[name] = (self.timedict.get(name, 0.0)
                               + (now - self.basetime))
        self.basetime = now

    def __str__(self):
        total = sum(self.timedict.values()) or 1.0
        return " ".join(f"{k}:{v:.4f}s({100 * v / total:.1f}%)"
                        for k, v in self.timedict.items())


def time_function(fn):
    """Cumulative per-function timing behind DO_TIMING (TrackEval
    _timing.time decorator semantics)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if not DO_TIMING:
            return fn(*args, **kwargs)
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            _cumulative[fn.__qualname__] += time.perf_counter() - t0
            _counts[fn.__qualname__] += 1

    return wrapped


def timing_report() -> str:
    return "\n".join(f"{k}: {_cumulative[k]:.4f}s over {_counts[k]} calls"
                     for k in sorted(_cumulative, key=_cumulative.get,
                                     reverse=True))


def reset_timing():
    _cumulative.clear()
    _counts.clear()


@contextlib.contextmanager
def torch_trace(log_dir: Optional[str]):
    """torch.profiler around a block, the host's activity and, where a card
    is visible, its kernels (CUPTI), written to <log_dir>/trace.json as a
    Chrome trace when the block ends; yields the profiler. Pass None to
    no-op (yields None)."""
    if not log_dir:
        yield None
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
