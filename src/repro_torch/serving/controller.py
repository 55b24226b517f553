"""Closed-loop autoscaling: the controller that *decides*.

The deployment layer has every elasticity mechanism —
``Deployment.scale()``, the ``ControlEvent`` timeline, loss-free drain,
warm-up gating — but on its own the composition stays frozen at
construction while the workload generators produce diurnal/bursty traces
whose demand swings several-fold.  This module closes the loop: :class:`AutoscalePolicy` watches the DES's
windowed signals (shed rate, SLO misses, queue depth, per-group
utilization — the ``ClusterResult``/``OnlineMonitor`` vocabulary) and
issues the same up/down control events ``Deployment.scale`` builds,
against the spec's ``$/hr`` budget:

  * **scale up** from a parked reserve pool when the windowed shed
    rate or queue depth breach their thresholds — the best
    capacity-per-dollar reserve group that still fits the budget is
    activated behind a modeled warm-up delay;
  * **scale down** toward the cheapest composition that still clears
    the observed demand when the window is clean (no sheds, low
    backlog, low utilization) — the priciest group whose removal keeps
    ``capacity >= headroom * demand`` drains gracefully;
  * **hysteresis + cooldown** so the controller does not flap: up
    thresholds are inflated by ``(1 + hysteresis)`` and down
    thresholds deflated by ``(1 - hysteresis)`` (the
    ``MonitorConfig`` band idiom), and at most one action fires per
    ``cooldown`` seconds.

The controller plugs into ``Deployment.simulate(trace,
controller=...)``; the DES hands it a
:class:`~repro_torch.core.simulator.ControlSignals` snapshot every
``interval`` seconds of *simulated* time and merges the returned
events into the live timeline (``simulator.simulate_deployment``).

Billing is time-weighted: every group accrues ``$/hr`` only while
provisioned — founding groups from the trace start until drained,
reserve groups from the activation *decision* (warm-up time is paid
for, as on real clouds) until drained.  :meth:`AutoscalePolicy
.billed_dollars` and :func:`goodput_per_dollar` make the elastic run
comparable with static compositions, whose bill is simply
``price_rate * makespan``.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.simulator import (ClusterResult, ControlEvent,
                                  ControlSignals)


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Thresholds and pacing for :class:`AutoscalePolicy`.

    Signals are aggregated over a sliding ``window`` of decision
    epochs (``interval`` seconds each).  ``shed_hi`` and ``queue_hi``
    trigger scale-up; a window below ``queue_lo`` mean backlog *and*
    ``util_lo`` utilization with zero sheds allows scale-down.
    ``hysteresis`` widens the dead band between the two regimes
    (MonitorConfig idiom: up thresholds ``*(1+h)``, down ``*(1-h)``);
    ``cooldown`` spaces actions; ``warmup`` is the modeled delay
    before an activated group becomes routable; ``headroom`` keeps
    modeled capacity at ``headroom * observed demand`` after any
    scale-down.
    """
    interval: float = 1.0        # decision-epoch seconds (DES time)
    window: float = 4.0          # sliding-window span in seconds
    shed_hi: float = 0.0         # windowed shed fraction above -> up
    queue_hi: float = 1.0        # mean eligible-group backlog (s) -> up
    queue_lo: float = 0.25       # mean backlog below -> down allowed
    util_lo: float = 0.5         # mean eligible utilization below -> down
    hysteresis: float = 0.1
    cooldown: float = 2.0        # min seconds between actions
    warmup: float = 1.0          # modeled warm-up of an activated group
    headroom: float = 1.3        # capacity >= headroom * demand after down
    # KV-memory pressure: scale up when the windowed max per-group
    # KV-block utilization exceeds this.  None (default) ignores the
    # signal entirely — existing controller runs are bit-identical.
    # Only meaningful when the DES runs a KvPoolModel (otherwise
    # ControlSignals.kv_util is empty and the trigger never fires).
    kv_hi: Optional[float] = None

    def __post_init__(self):
        if self.interval <= 0.0:
            raise ValueError("interval must be > 0")
        if self.window < self.interval:
            raise ValueError("window must cover at least one interval")


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    """One controller action, for the audit log / benchmark table."""
    time: float
    action: str                  # "up" | "down"
    group: int
    reason: str
    price_rate: float            # active $/hr AFTER the action


class AutoscalePolicy:
    """Budget-aware up/down decisions from windowed DES signals.

    ``inventory`` lists reserve group templates (device-name lists,
    e.g. ``[["a100", "l40s"], ["l40s"]]``) that are *planned* up front
    but start parked (ineligible, unbilled).  The controller activates
    them under pressure and parks active groups when the window is
    clean — founding and reserve groups are treated uniformly once
    running, so the composition can shrink below the founding shape in
    a trough and regrow later.

    Protocol consumed by ``simulator.simulate_deployment``: attributes
    ``interval``/``reserve``; methods ``begin(t0)``,
    ``decide(signals)``, ``finish(t_end)``.  ``Deployment.simulate``
    calls :meth:`bind` first.  All state is reset per run, so one
    policy instance supports repeated apples-to-apples replays.
    """

    def __init__(self, config: AutoscaleConfig = AutoscaleConfig(),
                 inventory: Optional[Sequence[Sequence[str]]] = None):
        self.cfg = config
        self.inventory = [list(g) for g in (inventory or [])]
        self._dep = None
        self.reserve: List[int] = []     # parked group indices (live)
        self._price: Dict[int, float] = {}
        self._capacity: Dict[int, float] = {}
        self._budget: Optional[float] = None
        self._reset(0.0)

    # -------------------------------------------------------------- #
    @property
    def interval(self) -> float:
        return self.cfg.interval

    def bind(self, deployment) -> None:
        """Attach to a compiled Deployment (idempotent): provision the
        reserve pool and cache per-group price / modeled capacity."""
        if self._dep is deployment:
            return
        if self._dep is not None:
            raise ValueError("AutoscalePolicy is already bound to a "
                             "different deployment")
        self._dep = deployment
        self._initial_reserve = list(
            deployment.add_reserve(self.inventory))
        self._budget = deployment.spec.budget
        cluster = deployment.cluster()
        for i, g in enumerate(cluster.groups):
            self._price[i] = g.price
            self._capacity[i] = 1.0 / g.plans["throughput"].bottleneck
        # founding groups = everything NOT parked on the deployment;
        # reserves parked by a previously bound controller stay parked
        # (and unbilled) rather than masquerading as founders
        self._founders = [i for i in range(len(cluster.groups))
                          if i not in deployment._reserve]

    # -------------------------------------------------------------- #
    def _reset(self, t0: float) -> None:
        # O(1) window fold: arrivals/shed are integer counters, so the
        # running totals stay exact as epochs enter and leave the
        # deque; only the per-group pressure rows (which depend on the
        # CURRENT active set applied to each snapshot) still walk the
        # bounded window
        keep = max(1, int(round(self.cfg.window / self.cfg.interval)))
        self._win: Deque[ControlSignals] = deque(maxlen=keep)
        self._arr_sum = 0
        self._shed_sum = 0
        self._last_action = t0 - self.cfg.cooldown
        self._warm_at: Dict[int, float] = {}
        self.active: Dict[int, float] = {}   # group -> billing start
        self.decisions: List[ScaleDecision] = []
        self._bill: List[Tuple[int, float, Optional[float]]] = []
        self._horizon: Optional[float] = None

    def begin(self, t0: float) -> None:
        """Run start (called by the DES): founding groups go active
        and billed from ``t0``; the reserve pool parks."""
        if self._dep is None:
            raise ValueError("call bind(deployment) before a run — "
                             "Deployment.simulate(controller=...) does")
        self._reset(t0)
        self.reserve = list(self._initial_reserve)
        for i in self._founders:
            self.active[i] = t0
            self._warm_at[i] = t0

    def finish(self, t_end: float) -> None:
        """Run end: close every open billing interval at ``t_end``."""
        self._horizon = t_end
        for g, on in self.active.items():
            self._bill.append((g, on, None))

    # -------------------------------------------------------------- #
    @property
    def active_price_rate(self) -> float:
        return sum(self._price[g] for g in self.active)

    def billed_dollars(self, horizon: Optional[float] = None) -> float:
        """Time-weighted rental: each group accrues its $/hr only
        while provisioned (activation decision -> drain), warm-up
        included."""
        h = self._horizon if horizon is None else horizon
        if h is None:
            raise ValueError("run not finished; pass an explicit "
                             "horizon")
        closed = [(g, on, off if off is not None else h)
                  for g, on, off in self._bill]
        return sum(self._price[g] * max(0.0, min(off, h) - on) / 3600.0
                   for g, on, off in closed)

    # -------------------------------------------------------------- #
    def _windowed(self):
        win = self._win
        arr = self._arr_sum
        shed = self._shed_sum
        span = len(win) * self.cfg.interval
        demand = arr / max(span, 1e-12)
        shed_rate = shed / max(arr, 1)
        # queue/util over ACTIVE, WARM groups only: parked or warming
        # groups idle at zero and would dilute the pressure signal
        rows = []
        for s in win:
            idx = [g for g in self.active
                   if s.eligible[g] and self._warm_at[g] <= s.now]
            if idx:
                rows.append((sum(s.backlog[g] for g in idx) / len(idx),
                             sum(s.util[g] for g in idx) / len(idx)))
        backlog = sum(r[0] for r in rows) / len(rows) if rows else 0.0
        util = sum(r[1] for r in rows) / len(rows) if rows else 0.0
        return demand, shed_rate, backlog, util

    def _scale_up(self, now: float, reason: str) -> List[ControlEvent]:
        """Activate the best capacity-per-dollar reserve group that
        still fits the budget."""
        afford = [g for g in self.reserve
                  if self._budget is None
                  or self.active_price_rate + self._price[g]
                  <= self._budget + 1e-9]
        if not afford:
            return []
        g = max(afford, key=lambda i: (
            self._capacity[i] / max(self._price[i], 1e-12), -i))
        self.reserve.remove(g)
        self.active[g] = now                 # billed from the decision
        self._warm_at[g] = now + self.cfg.warmup
        self._last_action = now
        self.decisions.append(ScaleDecision(
            now, "up", g, reason, self.active_price_rate))
        return [ControlEvent(now + self.cfg.warmup, "up", g)]

    def _scale_down(self, now: float, demand: float,
                    reason: str) -> List[ControlEvent]:
        """Park the priciest warm group whose removal still leaves
        ``headroom * demand`` of modeled capacity."""
        warm = [g for g in self.active if self._warm_at[g] <= now]
        if len(warm) <= 1:
            return []                        # never drain the last group
        total_cap = sum(self._capacity[g] for g in self.active)
        need = self.cfg.headroom * demand
        drop = [g for g in warm if total_cap - self._capacity[g] >= need]
        if not drop:
            return []
        g = max(drop, key=lambda i: (self._price[i], i))
        self._bill.append((g, self.active.pop(g), now))
        self.reserve.append(g)
        self._last_action = now
        self.decisions.append(ScaleDecision(
            now, "down", g, reason, self.active_price_rate))
        return [ControlEvent(now, "down", g)]

    def decide(self, sig: ControlSignals) -> List[ControlEvent]:
        """One decision epoch: fold the new snapshot into the sliding
        window, then at most one action (after the cooldown)."""
        if len(self._win) == self._win.maxlen:
            old = self._win[0]
            self._arr_sum -= old.arrivals
            self._shed_sum -= old.shed
        self._win.append(sig)
        self._arr_sum += sig.arrivals
        self._shed_sum += sig.shed
        if sig.now - self._last_action < self.cfg.cooldown:
            return []
        demand, shed_rate, backlog, util = self._windowed()
        h = self.cfg.hysteresis
        if shed_rate > self.cfg.shed_hi * (1.0 + h) + 1e-12:
            return self._scale_up(
                sig.now, f"shed_rate={shed_rate:.3f}")
        if backlog > self.cfg.queue_hi * (1.0 + h):
            return self._scale_up(
                sig.now, f"backlog={backlog:.3f}s")
        if self.cfg.kv_hi is not None:
            # windowed MAX (not mean) per-group KV-block utilization:
            # one full pool delays admissions even while others idle
            kv = 0.0
            for s in self._win:
                if not s.kv_util:
                    continue
                for g in self.active:
                    if (g < len(s.kv_util) and s.eligible[g]
                            and self._warm_at[g] <= s.now):
                        kv = max(kv, s.kv_util[g])
            if kv > self.cfg.kv_hi * (1.0 + h):
                return self._scale_up(sig.now, f"kv_util={kv:.2f}")
        if (shed_rate == 0.0
                and backlog < self.cfg.queue_lo * (1.0 - h)
                and util < self.cfg.util_lo * (1.0 - h)):
            return self._scale_down(
                sig.now, demand,
                f"idle util={util:.2f} backlog={backlog:.3f}s")
        return []


def goodput_per_dollar(result: ClusterResult,
                       billed: Optional[float] = None) -> float:
    """Requests served within SLO per rental dollar.

    For a static composition (``billed=None``) the bill is
    ``price_rate * makespan``; an elastic run passes
    ``AutoscalePolicy.billed_dollars()``.  Reduces to the sizing
    objective ``goodput * 3600 / price_rate`` in the static case.
    """
    if billed is None:
        billed = result.price_rate * result.makespan / 3600.0
    return result.slo_ok / max(billed, 1e-12)
