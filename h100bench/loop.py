"""The closed loop that serving and training share: a batch or step is
issued, its result is copied to pinned host memory behind it, and the host
waits for the oldest one only when `depth` are in flight (one queued
behind the one running, at 2). Each is timed by the host clock: issued
(the call), enqueued (the call returned, nothing synchronised) and done
(its result on the host), inside the benchmark's `h100bench.enqueue` and
`h100bench.wait` spans, which the trace reads."""
from __future__ import annotations

import collections
import time
from typing import Callable, Optional, Tuple

import torch

from h100bench import harness, tracing

# work(i) -> (a result tensor to bring to the host, images it carried)
Work = Callable[[int], Tuple[torch.Tensor, int]]


class Loop:
    def __init__(self, work: Work, depth: int, device: torch.device,
                 on_done: Optional[Callable[[int, torch.Tensor],
                                            None]] = None):
        self.work, self.device, self.on_done = work, device, on_done
        self.cuda = device.type == "cuda"
        self.depth = depth if self.cuda else 1
        self.host, self.events = [None] * self.depth, [None] * self.depth
        self.queue = collections.deque()
        self.issued = 0
        self.batches = []

    def issue(self, t0: float) -> None:
        i = self.issued
        slot = i % self.depth
        with torch.profiler.record_function(harness.SPAN_ENQUEUE):
            issue = time.perf_counter()
            out, images = self.work(i)
            if self.host[slot] is None:
                self.host[slot] = torch.empty(out.shape, dtype=out.dtype,
                                              pin_memory=self.cuda)
                self.events[slot] = torch.cuda.Event() if self.cuda else None
            self.host[slot].copy_(out, non_blocking=True)
            if self.cuda:
                self.events[slot].record()
            enqueued = time.perf_counter()
        self.queue.append((i, slot, issue - t0, enqueued - t0, images))
        self.issued += 1

    def finish(self, t0: float) -> None:
        i, slot, issue, enqueued, images = self.queue.popleft()
        with torch.profiler.record_function(harness.SPAN_WAIT):
            if self.cuda:
                self.events[slot].synchronize()
            done = time.perf_counter() - t0
        self.batches.append(harness.Batch(issue, enqueued, done, images))
        if self.on_done is not None:
            self.on_done(i, self.host[slot])

    def run(self, n: int = 0, seconds: float = 0.0) -> list:
        """Issue `n` batches, or batches for `seconds`, then drain. Returns
        this run's batches, timed from its start."""
        self.batches = []
        t0 = time.perf_counter()
        start = self.issued
        while (self.issued - start < n if n
               else time.perf_counter() - t0 < seconds):
            self.issue(t0)
            while len(self.queue) >= self.depth:
                self.finish(t0)
        while self.queue:
            self.finish(t0)
        return self.batches

    def traced(self, n: int):
        """`n` batches under the profiler; the reduced trace, or None if it
        recorded no device operation."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            self.run(n=n)
        return tracing.reduce(prof.events(),
                              (harness.SPAN_ENQUEUE, harness.SPAN_WAIT), n)
