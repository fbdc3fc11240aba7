"""The device trace of a traced stretch, reduced to what the metrics read.

`torch.profiler` records the host's ops and the benchmark's own
`record_function` spans, and, through CUPTI, every operation the card ran
(kernels, copies, sets), on one clock. From them: the union of the device
operations' intervals over the traced window (busy time; the rest is
idle), each operation's summed time by name, and the idle gaps, each
labelled with the benchmark span the host was in at the gap's middle.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

Interval = Tuple[float, float]   # seconds on the profiler's clock


@dataclasses.dataclass
class Trace:
    """window_s: from the first traced span's start to the last's end;
    busy_s: the union of device operations inside it; ops: (name, start,
    end) of every device operation inside it; gaps: (label, seconds) of
    each idle stretch; batches: the whole batches or steps traced."""
    window_s: float
    busy_s: float
    ops: List[Tuple[str, float, float]]
    gaps: List[Tuple[str, float]]
    batches: int

    def op_seconds(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, start, end in self.ops:
            out[name] = out.get(name, 0.0) + (end - start)
        return out

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        ops = sorted(self.op_seconds().items(), key=lambda kv: -kv[1])
        gaps = sorted(self.gaps, key=lambda g: -g[1])
        return {"device_ops": [[n[:200], t] for n, t in ops[:top]],
                "idle_gaps": [[n, t] for n, t in gaps[:top]]}


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Sorted, merged intervals."""
    out: List[List[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(s, e) for s, e in out]


def clip(intervals: Sequence[Interval], lo: float,
         hi: float) -> List[Interval]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def idle_gaps(busy: Sequence[Interval], lo: float,
              hi: float) -> List[Interval]:
    """The stretches of [lo, hi] that no busy interval covers."""
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def label_gaps(gaps: Sequence[Interval],
               spans: Sequence[Tuple[str, float, float]]
               ) -> List[Tuple[str, float]]:
    """(name of the span that holds the gap's middle, or "outside the
    loop's spans", gap length) for each gap."""
    spans = sorted(spans, key=lambda s: s[1])
    starts = [s[1] for s in spans]
    out = []
    for s, e in gaps:
        mid = (s + e) / 2
        i = bisect.bisect_right(starts, mid) - 1
        label = ("outside the loop's spans" if i < 0 or spans[i][2] < mid
                 else spans[i][0])
        out.append((label, e - s))
    return out


def reduce(events: Iterable, span_names: Sequence[str],
           batches: int) -> Optional["Trace"]:
    """A Trace from the profiler's events (`prof.events()`), or None if no
    device operation was recorded. The traced window runs from the first
    span's start to the last span's end."""
    names = set(span_names)
    spans, ops = [], []
    for e in events:
        start, end = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == torch.autograd.DeviceType.CUDA:
            annotation = (getattr(e, "is_user_annotation", False)
                          or e.name in names
                          or e.name.startswith(("ProfilerStep",
                                                "Optimizer.")))
            if not annotation:
                ops.append((e.name, start, end))
        elif e.name in names:
            spans.append((e.name, start, end))
    if not ops or not spans:
        return None
    lo = min(s for _, s, _ in spans)
    hi = max(e for _, _, e in spans)
    busy = union(clip([(s, e) for _, s, e in ops], lo, hi))
    ops = [(n, max(s, lo), min(e, hi)) for n, s, e in ops
           if e > lo and s < hi]
    return Trace(window_s=hi - lo, busy_s=sum(e - s for s, e in busy),
                 ops=ops, gaps=label_gaps(idle_gaps(busy, lo, hi), spans),
                 batches=batches)
