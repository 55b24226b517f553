"""Online monitor: queueing-aware policy switching (paper §III-D).

Tracks per-request end-to-end latency and pure execution latency
(compute + communication, excluding queueing).  At each window boundary
(every ``W`` seconds of workload time) the ratio  L̄_req / L̄_exec  measures
queueing pressure:

  ratio <= beta  ->  latency-oriented policy (light load)
  ratio  > beta  ->  throughput-oriented policy (queueing dominates)

Each switch stalls all workers for ``switch_stall`` seconds at an
iteration boundary (the paper measures ~30 ms).  The monitor also
aggregates *kernel-group* latency — the time between consecutive
communication events — rather than per-kernel timing, matching the
paper's low-overhead monitoring granularity.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MonitorConfig:
    # Frozen: MonitorConfig() is used as a default argument (one shared
    # instance per process), so it must be immutable.
    window: float = 0.300        # W  (paper default 300 ms)
    beta: float = 1.5            # queueing threshold (paper default 1.5)
    switch_stall: float = 0.030  # worker sync stall per switch (paper ~30ms)
    min_samples: int = 1
    # Hysteresis band around beta: switch to throughput only above
    # beta*(1+h), back to latency only below beta*(1-h).  A ratio
    # hovering at beta would otherwise flap every window, paying the
    # switch stall each time for no routing benefit.
    hysteresis: float = 0.05


class OnlineMonitor:
    """Feed samples; read ``policy`` ("latency" | "throughput")."""

    def __init__(self, config: MonitorConfig = MonitorConfig(),
                 initial_policy: str = "latency"):
        self.cfg = config
        self.policy = initial_policy
        self.switches = 0
        self.stall_time = 0.0
        # O(1) incremental window accumulators (running sums in sample
        # order are bit-identical to summing the historical per-window
        # lists left-to-right, and drop the per-window list rebuilds)
        self._req_n = 0
        self._req_sum = 0.0
        self._exec_sum = 0.0
        self._grp_n = 0
        self._grp_sum = 0.0
        self._window_end: Optional[float] = None
        # (t, policy, ratio, mean_group_latency) per closed window with
        # enough samples; mean_group_latency aggregates the
        # record_kernel_group feed (0.0 when no group samples landed)
        self.history: List[Tuple[float, str, float, float]] = []

    # ------------------------------------------------------------------ #
    def record_request(self, now: float, request_latency: float,
                       exec_latency: float) -> None:
        if self._window_end is None:
            self._window_end = now + self.cfg.window
        self._req_n += 1
        self._req_sum += request_latency
        self._exec_sum += exec_latency
        if now >= self._window_end:    # _maybe_switch guard, hoisted
            self._maybe_switch(now)

    def record_kernel_group(self, seconds: float) -> None:
        """Latency of a kernel group = span between consecutive
        communication ops (cheap monitoring unit, paper §III-D)."""
        self._grp_n += 1
        self._grp_sum += seconds

    def tick(self, now: float) -> None:
        """Advance workload time without a sample (idle windows)."""
        if self._window_end is None:
            # A group that is idle from the start only ever sees ticks;
            # if they cannot open the first window, the monitor stays
            # inert forever and never re-evaluates once load arrives.
            self._window_end = now + self.cfg.window
            return
        self._maybe_switch(now)

    # ------------------------------------------------------------------ #
    def _maybe_switch(self, now: float) -> None:
        if self._window_end is None or now < self._window_end:
            return
        if self._req_n >= self.cfg.min_samples:
            n = self._req_n
            ratio = (self._req_sum / n) / max(self._exec_sum / n, 1e-12)
            up = self.cfg.beta * (1.0 + self.cfg.hysteresis)
            down = self.cfg.beta * (1.0 - self.cfg.hysteresis)
            if ratio > up:
                target = "throughput"
            elif ratio < down:
                target = "latency"
            else:                      # inside the band: hold (no flap)
                target = self.policy
            if target != self.policy:
                self.policy = target
                self.switches += 1
                self.stall_time += self.cfg.switch_stall
            grp = (self._grp_sum / self._grp_n if self._grp_n else 0.0)
            self.history.append((now, self.policy, ratio, grp))
        self._req_n = 0
        self._req_sum = 0.0
        self._exec_sum = 0.0
        self._grp_n = 0
        self._grp_sum = 0.0
        # advance in whole windows so long gaps don't cause switch storms
        k = max(1, int((now - self._window_end) / self.cfg.window) + 1)
        self._window_end += k * self.cfg.window
