"""Pipelined multi-request execution (paper §III-C) — the PyTorch
counterpart of ``repro/core/pipeline.py``.

The paper keeps heterogeneous GPUs busy by running several requests
concurrently on separate CUDA streams with priority-aware scheduling
(earlier requests get more SM time, staggering their communication
phases).  The JAX reference had to emulate this on the host, since XLA
exposes neither user streams nor priorities; here the streams are real:

  * each in-flight request gets, on every CUDA logical device of the
    executable, a stream of its own with a priority: a request admitted
    behind k others gets the k-th highest priority (clamped to the
    card's range), so the oldest in flight run first on the card;
  * the runner drives the executor's indexed dispatch program (a flat
    slot environment per request, fused dispatch units); every unit is
    issued without a host sync, ordered across streams by events;
  * a host-side run queue issues the next unit of the *oldest*
    incomplete request first (``"priority"``), or round-robin
    (``"naive"``) for ablation;
  * straggler mitigation: with a wall-clock deadline per unit, a unit is
    issued on a worker thread, which then waits for its stream to finish
    it (on CUDA the deadline is on the unit's completion on the card,
    not on its issue); on expiry the unit is run again on a fallback
    logical device, after the work issued before the first try but not
    after the first try itself, and its result is kept.  Only a unit
    that writes no storage it did not create can run twice (its
    ``pure`` flag); a unit that writes a cache or a state in place runs
    once, without a deadline;
  * per-unit issue times and transfer counts are recorded.  On CUDA they
    are host issue times, not device times.
On the CPU there are no streams and the units of different requests
simply interleave.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor, TimeoutError as FTimeout
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree

from repro_torch.core.executor import LogicalDevice, Slots, StagedExecutable


@dataclasses.dataclass
class RequestState:
    rid: int
    args: tuple
    kwargs: dict
    slots: Optional[Slots] = None       # indexed env (executor fast path)
    next_unit: int = 0
    submitted: float = 0.0
    finished: float = 0.0
    output: Any = None
    priority: int = 0                   # CUDA stream priority

    @property
    def done(self) -> bool:
        return self.output is not None


@dataclasses.dataclass
class PipelineStats:
    completed: int = 0
    wall_seconds: float = 0.0
    stage_dispatches: int = 0           # fused dispatch units issued
    transfers: int = 0                  # cross-device hand-overs issued
    straggler_reexecs: int = 0
    per_request_latency: List[float] = dataclasses.field(default_factory=list)
    # host-side issue time accumulated per unit index (seconds); on CUDA
    # this is issue overhead, not device time.
    unit_dispatch_seconds: Dict[int, float] = dataclasses.field(
        default_factory=dict)

    @property
    def throughput(self) -> float:
        return self.completed / max(self.wall_seconds, 1e-9)

    def dispatch_overhead(self) -> float:
        """Total host seconds spent issuing work."""
        return sum(self.unit_dispatch_seconds.values())


def _wait_for(values) -> None:
    """Block the host until the device has produced ``values``, made on
    (or joined into) the current stream."""
    for t in pytree.tree_leaves(values):
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            torch.cuda.current_stream(t.device).synchronize()


def _finish(stream: Any) -> None:
    """Block the host until ``stream`` (a unit's, or None off CUDA) has
    run everything issued on it."""
    if stream is not None:
        stream.synchronize()


class PipelinedRunner:
    """Drives N in-flight requests through a StagedExecutable."""

    def __init__(self, executable: StagedExecutable,
                 max_inflight: int = 4,
                 scheduling: str = "priority",     # "priority" | "naive"
                 straggler_deadline: Optional[float] = None,
                 fallback_device: Optional[LogicalDevice] = None):
        assert scheduling in ("priority", "naive")
        self.exe = executable
        self.max_inflight = max_inflight
        self.scheduling = scheduling
        self.straggler_deadline = straggler_deadline
        self.fallback_device = fallback_device
        self._pool = (ThreadPoolExecutor(max_workers=2)
                      if straggler_deadline else None)
        self._cuda = any(d.device.type == "cuda" for d in executable.logical)
        # (lowest, highest) priority of the card: CUDA counts down
        self._priorities = (torch.cuda.Stream.priority_range()
                            if self._cuda else (0, 0))

    def _streams(self, ahead: int) -> Tuple[int, Optional[List[Any]]]:
        """Per-logical-device streams for a request admitted behind
        ``ahead`` in-flight requests, and their priority."""
        if not self._cuda:
            return 0, None
        low, high = self._priorities
        prio = min(high + ahead, low)
        return prio, [torch.cuda.Stream(d.device, priority=prio)
                      if d.device.type == "cuda" else None
                      for d in self.exe.logical]

    # ------------------------------------------------------------------ #
    def run(self, requests: Sequence[Tuple[tuple, dict]]) -> Tuple[
            List[Any], PipelineStats]:
        """Process all requests; returns (outputs in submit order, stats)."""
        stats = PipelineStats()
        t0 = time.perf_counter()
        states = [RequestState(rid=i, args=a, kwargs=k, submitted=t0)
                  for i, (a, k) in enumerate(requests)]
        pending = list(range(len(states)))      # not yet admitted
        inflight: List[int] = []
        n_units = self.exe.num_units
        rr = 0                                   # round-robin cursor

        while pending or inflight:
            while pending and len(inflight) < self.max_inflight:
                rid = pending.pop(0)
                st = states[rid]
                st.priority, streams = self._streams(len(inflight))
                st.slots = self.exe.init_slots(*st.args, **st.kwargs)
                st.slots.streams = streams
                inflight.append(rid)

            if self.scheduling == "priority":
                rid = min(inflight)              # oldest incomplete first
            else:
                rid = inflight[rr % len(inflight)]
                rr += 1
            st = states[rid]
            self._dispatch_unit(st, stats)
            stats.stage_dispatches += 1

            if st.next_unit >= n_units:
                st.output = self.exe.collect_slots(st.slots)
                # block to get an honest completion time
                _wait_for(st.output)
                st.finished = time.perf_counter()
                stats.per_request_latency.append(st.finished - st.submitted)
                stats.completed += 1
                inflight.remove(rid)

        stats.wall_seconds = time.perf_counter() - t0
        return [s.output for s in states], stats

    # ------------------------------------------------------------------ #
    def _dispatch_unit(self, st: RequestState, stats: PipelineStats):
        idx = st.next_unit
        t0 = time.perf_counter()
        if self.straggler_deadline is None \
                or not self.exe.program.fused[idx].pure:
            stats.transfers += self.exe.run_unit(st.slots, idx)
        else:
            before = self.exe.issued(st.slots)
            fut = self._pool.submit(self._run_blocking, st.slots, idx)
            made_on = None
            try:
                outs = fut.result(timeout=self.straggler_deadline)
            except FTimeout:
                fut.cancel()                 # if it has not started yet
                # Straggler: run the unit again on the fallback device
                # and keep that result (the unit is pure: it writes no
                # storage it did not create, so running it twice is safe)
                stats.straggler_reexecs += 1
                outs = self.exe.compute_unit(
                    st.slots, idx, device_override=self.fallback_device,
                    after=before)
                made_on = self.exe.unit_stream(st.slots, idx,
                                               self.fallback_device)
                _finish(made_on)
            stats.transfers += self.exe.store_unit(st.slots, idx, outs,
                                                   made_on)
        dt = time.perf_counter() - t0
        stats.unit_dispatch_seconds[idx] = \
            stats.unit_dispatch_seconds.get(idx, 0.0) + dt
        st.next_unit += 1

    def _run_blocking(self, slots: Slots, idx: int) -> List[Any]:
        outs = self.exe.compute_unit(slots, idx)
        _finish(self.exe.unit_stream(slots, idx))
        return outs
