"""The device trace of a ``--trace 1`` run: ``torch.profiler``'s CUDA
activity over the window, its kernels on the loop's clock.

The profiler records device activity only (no host operators), so its cost
is CUPTI's per launch.  To put kernel times on the loop's clock, the
window opens with a synchronised device and a ``torch.cuda._sleep`` launch
(kernel ``spin_kernel``) whose device start is taken as the host time just
before it; the window closes with the device synchronised, so every kernel
of the window's steps is in the trace.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

MARK = "spin_kernel"

Kernel = Tuple[str, float, float]        # name, start, end (loop clock, s)


class DeviceTrace:
    def __init__(self, clock: Callable[[], float]):
        from torch.profiler import ProfilerActivity, profile
        self.clock = clock
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.t_mark: Optional[float] = None

    def start(self) -> None:
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t_mark = self.clock()
        torch.cuda._sleep(1000)

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def kernels(self) -> List[Kernel]:
        """Every device activity (kernels, copies, sets) of the trace, on
        the loop's clock, in start order; the marker left out."""
        raw = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            t0 = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1e3
            dur = e.duration_ns() if hasattr(e, "duration_ns") \
                else e.duration_us() * 1e3
            raw.append((e.name(), t0 * 1e-9, dur * 1e-9))
        raw.sort(key=lambda r: r[1])
        marks = [r for r in raw if MARK in r[0]]
        if not marks:
            raise RuntimeError("the device trace holds no marker kernel")
        off = self.t_mark - marks[0][1]
        return [(n, t + off, t + d + off) for n, t, d in raw
                if MARK not in n]


def union(intervals: Sequence[Tuple[float, float]]) -> List[List[float]]:
    """Merged [start, end] of sorted-or-not intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy(kernels: Sequence[Kernel], open_: float, close: float
         ) -> Tuple[float, List[List[float]]]:
    """Seconds of [open_, close) in which some device activity ran, and
    the merged intervals."""
    merged = union([(max(a, open_), min(b, close)) for _, a, b in kernels
                    if b > open_ and a < close])
    return sum(b - a for a, b in merged), merged


def device_ops(kernels: Sequence[Kernel], n: int = 10
               ) -> List[List]:
    """The ``n`` device operations that took the most time, by name."""
    tot: Dict[str, float] = collections.defaultdict(float)
    for name, a, b in kernels:
        tot[name[:120]] += b - a
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(merged: Sequence[Sequence[float]], open_: float, close: float,
              spans: Sequence[Tuple[str, float, float]], n: int = 10
              ) -> List[List]:
    """Idle device time by what the host was doing: each gap between
    merged busy intervals cut by the harness's spans (admission, decode
    enqueue, sync, sleep; "loop" where none was open), summed by label;
    and the longest single gap of each label."""
    edges = [open_] + [x for ab in merged for x in ab] + [close]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    spans = sorted(spans, key=lambda s: s[1])
    tot: Dict[str, float] = collections.defaultdict(float)
    longest: Dict[str, float] = collections.defaultdict(float)
    j = 0
    for a, b in gaps:
        while j < len(spans) and spans[j][2] <= a:
            j += 1
        t, k = a, j
        while t < b:
            if k < len(spans) and spans[k][2] <= t:
                k += 1
                continue
            if k < len(spans) and spans[k][1] <= t:
                label, end = spans[k][0], min(b, spans[k][2])
            else:
                label = "loop"
                end = min(b, spans[k][1]) if k < len(spans) else b
            tot[label] += end - t
            longest[label] = max(longest[label], end - t)
            t = end
    rows = [[f"{k} (all)", v] for k, v in tot.items()] + \
        [[f"{k} (longest)", v] for k, v in longest.items()]
    return sorted(rows, key=lambda r: -r[1])[:n]
