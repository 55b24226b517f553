"""Typed fault plans, health-aware routing primitives, and
checkpoint-based session recovery — one chaos layer over both serving
backends.

Disaggregation multiplies failure surfaces: more groups, more KV bytes
crossing contended links.  This module makes the failure model a
first-class, *typed and seeded* object instead of the old
``failures=[(t, g)]`` hard-kill list:

* :class:`FaultPlan` — JSON-round-tripping chaos schedule.
  ``crash(t, group, recover_at=...)`` is a "fail" ControlEvent that can
  come back via the existing "up" path (the timeline validator
  distinguishes a recovery-"up" from a warm-up-"up");
  ``straggle(t0, t1, group, factor)`` opens a transient service-time
  window (a "slow" ControlEvent — the DES inflates every stage unit
  and the routers' service predictions, so JSED/PD observe the
  straggler); ``flaky_link(src, dst, p)`` makes each KV chunk on that
  directed link fail independently with probability ``p`` under a
  bounded-retry/backoff/deadline policy (``_stream_kv_flaky`` in the
  DES, :class:`ChaosLink` + shard checksums on live engines).

* :class:`GroupHealth` — per-group error-rate EWMA + a
  closed/open/half-open circuit breaker.  Routers fold
  ``penalty(g, now)`` into their scores and skip groups whose breaker
  is open, so a flapping group sheds load *before* it fails; during a
  brown-out (any breaker not closed) requests below a priority floor
  are shed first.

* :class:`RecoveryConfig` / :class:`CheckpointStore` — periodic
  lightweight checkpoints of resident decode sessions to a host-side
  store (interval- and dirty-token-gated).  On a crash, accepted
  in-flight sessions restore on survivors from the last checkpoint and
  replay deterministically instead of landing in ``dropped``; the DES
  mirrors this with a replay-cost model (see
  ``simulate_deployment(faults=...)``), the live path restores real
  :class:`~repro_torch.serving.kvpool.SessionState` snapshots with
  bit-identical greedy continuations.

Every random draw comes from a ``random.Random`` derived from the
plan's seed (no module-global state): same seed, same chaos —
regression-tested across both DES walks.
"""
from __future__ import annotations

import dataclasses
import json
import random
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.core.simulator import ControlEvent
from repro_torch.serving.kvpool import (KvSlice, SessionState, _state_to,
                                        kv_checksum)

__all__ = ["Crash", "Straggle", "FlakyLink", "FaultPlan", "FaultState",
           "RecoveryConfig", "BreakerConfig", "GroupHealth",
           "DeviceHealth", "ChaosLink", "CheckpointStore",
           "StraggleDetector"]


# ===================================================================== #
# Typed fault specs
# ===================================================================== #
@dataclasses.dataclass(frozen=True)
class Crash:
    """Hard group kill at ``t``; ``recover_at`` brings it back (the
    "up" path) — None is a permanent loss (the legacy ``failures=``
    semantics)."""
    t: float
    group: int
    recover_at: Optional[float] = None

    def validate(self) -> None:
        if self.group < 0:
            raise ValueError(f"crash group must be >= 0, got {self.group}")
        if self.recover_at is not None and self.recover_at <= self.t:
            raise ValueError(
                f"crash(t={self.t:g}) must recover strictly later, "
                f"got recover_at={self.recover_at:g}")


@dataclasses.dataclass(frozen=True)
class Straggle:
    """Transient service-time inflation: group ``group`` runs
    ``factor`` x slower over ``[t0, t1)``."""
    t0: float
    t1: float
    group: int
    factor: float

    def validate(self) -> None:
        if self.group < 0:
            raise ValueError(
                f"straggle group must be >= 0, got {self.group}")
        if self.t1 <= self.t0:
            raise ValueError(
                f"straggle window [{self.t0:g}, {self.t1:g}) is empty")
        if self.factor <= 0.0:
            raise ValueError(
                f"straggle factor must be > 0, got {self.factor}")


@dataclasses.dataclass(frozen=True)
class FlakyLink:
    """Per-chunk KV-transfer failure on the directed ``src -> dst``
    fabric link: each chunk fails independently with probability ``p``
    and is retried up to ``max_retries`` times with exponential
    backoff (``backoff * 2**attempt`` seconds between tries).  A chunk
    that exhausts its retries — or whose retry would start later than
    ``deadline`` seconds past prefill completion — aborts the handoff
    and the request re-prefills on the decode group."""
    src: int
    dst: int
    p: float
    seed: int = 0
    max_retries: int = 3
    backoff: float = 1e-3
    deadline: float = 1.0

    def validate(self) -> None:
        if self.src == self.dst:
            raise ValueError("flaky_link needs src != dst (same-group "
                             "handoffs never touch the fabric)")
        if min(self.src, self.dst) < 0:
            raise ValueError("flaky_link groups must be >= 0")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"flaky_link p must be in [0, 1], "
                             f"got {self.p}")
        if self.max_retries < 0 or self.backoff < 0.0 \
                or self.deadline <= 0.0:
            raise ValueError("flaky_link retry policy needs "
                             "max_retries >= 0, backoff >= 0, "
                             "deadline > 0")


@dataclasses.dataclass(frozen=True)
class RecoveryConfig:
    """Checkpoint-based session recovery knobs.

    ``interval`` — seconds between periodic checkpoints of resident
    decode sessions; a crash victim replays only the decode suffix
    after its last checkpoint.  ``min_dirty_tokens`` gates the LIVE
    store: a session is re-checkpointed only after generating that
    many tokens since its last snapshot (the DES replay-cost model
    uses ``interval`` alone).  ``restore_bw`` / ``base_latency`` price
    the host -> survivor restore the DES charges before replay."""
    interval: float = 0.25
    min_dirty_tokens: int = 1
    restore_bw: float = 2e9
    base_latency: float = 1e-3

    def validate(self) -> None:
        if self.interval <= 0.0 or self.min_dirty_tokens < 0 \
                or self.restore_bw <= 0.0 or self.base_latency < 0.0:
            raise ValueError(f"invalid RecoveryConfig {self}")


_PLAN_KEYS = frozenset({"seed", "crashes", "straggles", "flaky_links"})


@dataclasses.dataclass
class FaultPlan:
    """A seeded, typed, JSON-round-tripping chaos schedule.

    Builder verbs chain::

        plan = (FaultPlan(seed=7)
                .crash(3.0, group=1, recover_at=5.0)
                .straggle(1.0, 2.0, group=0, factor=3.0)
                .flaky_link(0, 1, p=0.05))

    ``Deployment.simulate(faults=plan)`` replays it in the DES;
    ``LaunchedDeployment.inject(plan)`` replays it against live
    engines.  ``bind()`` produces the fresh per-run mutable state
    (seeded RNGs, health breakers), so repeated runs of the same plan
    are bit-identical.
    """
    seed: int = 0
    crashes: List[Crash] = dataclasses.field(default_factory=list)
    straggles: List[Straggle] = dataclasses.field(default_factory=list)
    flaky_links: List[FlakyLink] = dataclasses.field(default_factory=list)

    # ------------------------------------------------------------ #
    # Builders
    # ------------------------------------------------------------ #
    def crash(self, t: float, group: int,
              recover_at: Optional[float] = None) -> "FaultPlan":
        c = Crash(float(t), int(group),
                  None if recover_at is None else float(recover_at))
        c.validate()
        self.crashes.append(c)
        return self

    def straggle(self, t0: float, t1: float, group: int,
                 factor: float) -> "FaultPlan":
        s = Straggle(float(t0), float(t1), int(group), float(factor))
        s.validate()
        for prev in self.straggles:
            if prev.group == s.group and s.t0 < prev.t1 \
                    and prev.t0 < s.t1:
                raise ValueError(
                    f"straggle windows overlap on group {s.group}: "
                    f"[{prev.t0:g},{prev.t1:g}) and [{s.t0:g},{s.t1:g})")
        self.straggles.append(s)
        return self

    def flaky_link(self, src: int, dst: int, p: float, seed: int = 0,
                   max_retries: int = 3, backoff: float = 1e-3,
                   deadline: float = 1.0) -> "FaultPlan":
        fl = FlakyLink(int(src), int(dst), float(p), int(seed),
                       int(max_retries), float(backoff),
                       float(deadline))
        fl.validate()
        if any(l.src == fl.src and l.dst == fl.dst
               for l in self.flaky_links):
            raise ValueError(f"duplicate flaky_link "
                             f"({fl.src} -> {fl.dst})")
        self.flaky_links.append(fl)
        return self

    def validate(self) -> None:
        for c in self.crashes:
            c.validate()
        for s in self.straggles:
            s.validate()
        for fl in self.flaky_links:
            fl.validate()

    # ------------------------------------------------------------ #
    # Timeline + per-run state
    # ------------------------------------------------------------ #
    def control_events(self) -> List[ControlEvent]:
        """The plan's crash/straggle schedule as ControlEvents (flaky
        links do not alter eligibility — they live on the KV path)."""
        evs: List[ControlEvent] = []
        for c in self.crashes:
            evs.append(ControlEvent(c.t, "fail", c.group))
            if c.recover_at is not None:
                evs.append(ControlEvent(c.recover_at, "up", c.group))
        for s in self.straggles:
            evs.append(ControlEvent(s.t0, "slow", s.group,
                                    factor=s.factor))
            evs.append(ControlEvent(s.t1, "slow", s.group, factor=1.0))
        return evs

    def bind(self, n_groups: int,
             recovery: Optional[RecoveryConfig] = None,
             health: Optional["GroupHealth"] = None) -> "FaultState":
        """Fresh per-run fault state: validated against the group
        count, with newly seeded per-link RNGs (same plan seed ->
        bit-identical chaos on every run)."""
        self.validate()
        for c in self.crashes:
            if c.group >= n_groups:
                raise ValueError(f"crash names group {c.group}; "
                                 f"deployment has {n_groups}")
        for s in self.straggles:
            if s.group >= n_groups:
                raise ValueError(f"straggle names group {s.group}; "
                                 f"deployment has {n_groups}")
        for fl in self.flaky_links:
            if max(fl.src, fl.dst) >= n_groups:
                raise ValueError(f"flaky_link ({fl.src} -> {fl.dst}) "
                                 f"exceeds {n_groups} groups")
        if recovery is not None:
            recovery.validate()
        if health is not None:
            health.bind(n_groups)
        return FaultState(self, n_groups, recovery, health)

    # ------------------------------------------------------------ #
    # JSON round trip
    # ------------------------------------------------------------ #
    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed,
            "crashes": [dataclasses.asdict(c) for c in self.crashes],
            "straggles": [dataclasses.asdict(s)
                          for s in self.straggles],
            "flaky_links": [dataclasses.asdict(fl)
                            for fl in self.flaky_links],
        }, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        d = json.loads(text)
        unknown = set(d) - _PLAN_KEYS
        if unknown:
            raise ValueError(f"unknown FaultPlan fields: "
                             f"{sorted(unknown)}")
        plan = cls(seed=int(d.get("seed", 0)),
                   crashes=[Crash(**c) for c in d.get("crashes", [])],
                   straggles=[Straggle(**s)
                              for s in d.get("straggles", [])],
                   flaky_links=[FlakyLink(**fl)
                                for fl in d.get("flaky_links", [])])
        plan.validate()
        return plan

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_json(f.read())


class _LinkState:
    """Per-run mutable state of one flaky link: the seeded RNG plus
    the retry policy ``_stream_kv_flaky`` charges."""

    def __init__(self, plan_seed: int, fl: FlakyLink):
        self.p = fl.p
        self.max_retries = fl.max_retries
        self.backoff = fl.backoff
        self.deadline = fl.deadline
        self.rng = random.Random(
            f"{plan_seed}:link:{fl.src}:{fl.dst}:{fl.seed}")


class FaultState:
    """One run's bound fault state (see :meth:`FaultPlan.bind`).

    The DES reads ``link(src, dst)`` on every phase-split handoff and
    ``recovery`` / ``health`` at crash time; the live injector
    additionally builds :class:`ChaosLink` wrappers (``live_link``)
    and reads ``straggle_factor`` for pacing."""

    def __init__(self, plan: FaultPlan, n_groups: int,
                 recovery: Optional[RecoveryConfig],
                 health: Optional["GroupHealth"]):
        self.plan = plan
        self.n_groups = n_groups
        self.recovery = recovery
        self.health = health
        self._links = {(fl.src, fl.dst): _LinkState(plan.seed, fl)
                       for fl in plan.flaky_links}
        self._live: Dict[Tuple[int, int], ChaosLink] = {}

    def link(self, src: int, dst: int) -> Optional[_LinkState]:
        return self._links.get((src, dst))

    def live_link(self, src: int, dst: int) -> Optional["ChaosLink"]:
        """The live (shard-level) counterpart of ``link`` — cached so
        retry counters accumulate across handoffs."""
        key = (src, dst)
        if key not in self._live:
            fl = next((f for f in self.plan.flaky_links
                       if (f.src, f.dst) == key), None)
            if fl is None:
                return None
            self._live[key] = ChaosLink(self.plan.seed, fl)
        return self._live[key]

    def control_events(self) -> List[ControlEvent]:
        return self.plan.control_events()

    def straggle_factor(self, group: int, t: float) -> float:
        for s in self.plan.straggles:
            if s.group == group and s.t0 <= t < s.t1:
                return s.factor
        return 1.0


# ===================================================================== #
# Health: error-rate EWMA + circuit breaker
# ===================================================================== #
@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    """Circuit-breaker tuning.  ``alpha`` weights each observation in
    the error EWMA; a closed breaker opens when the EWMA reaches
    ``open_threshold`` and stays open for ``cooldown`` seconds, then
    half-opens (probe traffic allowed); one error while half-open
    re-opens, one success closes.  ``penalty`` converts the error rate
    into seconds added to a router score (so a degrading group sheds
    load smoothly before its breaker ever trips)."""
    alpha: float = 0.3
    open_threshold: float = 0.5
    cooldown: float = 2.0
    penalty: float = 10.0


class GroupHealth:
    """Per-group error-rate EWMA + closed/open/half-open breaker.

    Wired twice: the DES records flaky-transfer errors and
    crash/recover flips (``simulate_deployment(faults=...)``), the
    live injector records shard corruption and engine crashes.  The
    SAME instance is handed to a router (``JSEDRouter(health=...)``,
    ``PDRouter(health=...)``) which skips open groups, penalizes
    degraded ones, and — given a ``brownout_priority`` floor — sheds
    low-priority requests while any breaker is not closed."""

    def __init__(self, n_groups: int = 0,
                 cfg: Optional[BreakerConfig] = None):
        self.cfg = cfg or BreakerConfig()
        self.bind(n_groups)

    def bind(self, n_groups: int) -> "GroupHealth":
        """Fresh state for ``n_groups`` groups (idempotent per run)."""
        self._rate = [0.0] * n_groups
        self._state = ["closed"] * n_groups
        self._until = [0.0] * n_groups      # open -> half_open time
        self._latched = [False] * n_groups  # hard failure: stays open
        return self

    def __len__(self) -> int:
        return len(self._state)

    def _tick(self, g: int, t: float) -> None:
        if self._state[g] == "open" and not self._latched[g] \
                and t >= self._until[g]:
            self._state[g] = "half_open"

    def record_error(self, g: int, t: float) -> None:
        self._tick(g, t)
        c = self.cfg
        self._rate[g] = (1.0 - c.alpha) * self._rate[g] + c.alpha
        if self._state[g] == "half_open" or (
                self._state[g] == "closed"
                and self._rate[g] >= c.open_threshold):
            self._state[g] = "open"
            self._until[g] = t + c.cooldown

    def record_ok(self, g: int, t: float) -> None:
        self._tick(g, t)
        self._rate[g] *= (1.0 - self.cfg.alpha)
        if self._state[g] == "half_open":
            self._state[g] = "closed"   # probe succeeded

    def trip(self, g: int, t: float) -> None:
        """Hard failure (group crash): latch the breaker open until
        :meth:`reset` (the recovery-"up")."""
        self._state[g] = "open"
        self._latched[g] = True
        self._rate[g] = 1.0

    def reset(self, g: int, t: float) -> None:
        """Recovery: unlatch — the group half-opens and must prove
        itself with a successful probe before closing."""
        self._latched[g] = False
        self._state[g] = "half_open"
        self._rate[g] *= 0.5

    def suspect(self, g: int, t: float) -> None:
        """Soft evidence of degradation with NO observed error (e.g. a
        straggle detector's inference from service-time drift):
        half-open the breaker so routers penalize the group and probe
        it, without latching.  A later :meth:`record_ok` closes it; a
        hard :meth:`trip` still overrides.  No-op while already
        open."""
        self._tick(g, t)
        if self._latched[g] or self._state[g] == "open":
            return
        self._state[g] = "half_open"
        self._rate[g] = max(self._rate[g], self.cfg.open_threshold)

    # -- router-facing probes -------------------------------------- #
    def state(self, g: int, t: float) -> str:
        self._tick(g, t)
        return self._state[g]

    def error_rate(self, g: int) -> float:
        return self._rate[g]

    def allow(self, g: int, t: float) -> bool:
        """False while the breaker is open (half-open allows probes)."""
        return self.state(g, t) != "open"

    def penalty(self, g: int, t: float) -> float:
        """Seconds added to a router score: proportional to the error
        EWMA, plus a surcharge while half-open (probe traffic only
        trickles back)."""
        p = self.cfg.penalty * self._rate[g]
        if self.state(g, t) == "half_open":
            p += self.cfg.penalty
        return p

    def degraded(self, t: float) -> bool:
        """True while ANY breaker is not closed — the brown-out signal
        priority shedding keys off."""
        return any(self.state(g, t) != "closed"
                   for g in range(len(self._state)))


@dataclasses.dataclass
class DeviceHealth:
    """Heartbeat-style device registry over :class:`GroupHealth`
    breakers: a failed device latches its breaker open (the runtime's
    hard-fail view — ``runtime/fault.py``'s ``ElasticExecutor`` routes
    through this)."""
    alive: List[bool]
    breakers: GroupHealth = dataclasses.field(default=None)  # type: ignore[assignment]

    def __post_init__(self):
        if self.breakers is None:
            self.breakers = GroupHealth(len(self.alive))

    def fail(self, idx: int) -> None:
        self.alive[idx] = False
        self.breakers.trip(idx, 0.0)

    def lost(self) -> set:
        return {i for i, a in enumerate(self.alive) if not a}


# ===================================================================== #
# Straggle detection: infer degradation nobody declared
# ===================================================================== #
class StraggleDetector:
    """Infers straggling groups from windowed DES signals and trips
    their :class:`GroupHealth` breakers to half-open — no injected
    fault required.

    Plugs into ``Deployment.simulate(controller=...)`` (the
    decision-epoch protocol): each epoch's :class:`ControlSignals`
    carries ``service_obs`` (service seconds the DES committed per
    group, straggle inflation included) and ``service_model`` (the
    same work priced by the group's un-degraded profile).  Their ratio
    is EWMA-smoothed per group; after ``min_epochs`` epochs with
    committed work, a ratio at or above ``threshold`` calls
    ``health.suspect`` (half-open: routers penalize and probe), and a
    flagged group whose smoothed ratio falls back to ``clear`` earns a
    ``health.record_ok`` (probe success: breaker closes).

    A healthy group's ratio is exactly 1.0 — the DES prices committed
    work with the same linear program the model uses — so false
    positives require an actual profile/behavior divergence, not
    noise.  Detections are recorded in ``self.detections`` as
    ``(time, group, smoothed_ratio)``.
    """

    def __init__(self, health: GroupHealth, *,
                 interval: float = 0.5,
                 threshold: float = 1.25,
                 clear: float = 1.05,
                 alpha: float = 0.5,
                 min_epochs: int = 2,
                 min_service: float = 1e-6):
        if interval <= 0.0:
            raise ValueError("interval must be > 0")
        if threshold <= clear:
            raise ValueError("threshold must exceed clear "
                             "(hysteresis band)")
        self.health = health
        self.interval = float(interval)
        self.threshold = float(threshold)
        self.clear = float(clear)
        self.alpha = float(alpha)
        self.min_epochs = int(min_epochs)
        self.min_service = float(min_service)
        self.detections: List[Tuple[float, int, float]] = []
        self._ewma: Dict[int, float] = {}
        self._epochs: Dict[int, int] = {}
        self.flagged: set = set()

    # controller protocol ------------------------------------------- #
    def bind(self, deployment) -> "StraggleDetector":
        return self

    def begin(self, t0: float) -> None:
        self._ewma.clear()
        self._epochs.clear()
        self.flagged.clear()
        self.detections = []

    def decide(self, sig):
        obs, mod = sig.service_obs, sig.service_model
        for g in range(len(obs)):
            if mod[g] <= self.min_service:
                continue                # no committed work this epoch
            ratio = obs[g] / mod[g]
            prev = self._ewma.get(g)
            ew = ratio if prev is None else \
                (1.0 - self.alpha) * prev + self.alpha * ratio
            self._ewma[g] = ew
            self._epochs[g] = self._epochs.get(g, 0) + 1
            if self._epochs[g] < self.min_epochs:
                continue
            if ew >= self.threshold:
                if g not in self.flagged:
                    self.flagged.add(g)
                    self.detections.append((sig.now, g, ew))
                self.health.suspect(g, sig.now)
            elif g in self.flagged and ew <= self.clear:
                self.flagged.discard(g)
                self.health.record_ok(g, sig.now)
        return ()

    def finish(self, t_end: float) -> None:
        return None


# ===================================================================== #
# Live-side chaos: flaky shard channel + checkpoint store
# ===================================================================== #
def corrupt_slice(sl: KvSlice) -> KvSlice:
    """Flip one byte of the shard's first leaf while KEEPING its
    original checksum — the receiver's :meth:`KvSlice.verify` must
    catch it."""
    return dataclasses.replace(sl, state=_flip_first_leaf(sl.state)[0])


def _flip_first_leaf(tree: Any) -> Tuple[Any, bool]:
    """``tree`` with the first byte of its first leaf (in
    :func:`kv_checksum`'s sorted-key order) flipped in a clone on the
    leaf's own device; the second value says whether a leaf was
    flipped."""
    if isinstance(tree, dict):
        out, done = dict(tree), False
        for key in sorted(tree):
            out[key], done = _flip_first_leaf(tree[key])
            if done:
                break
        return out, done
    arr = tree.detach().clone(memory_format=torch.contiguous_format)
    arr.reshape(-1).view(torch.uint8)[:1].bitwise_xor_(0xFF)
    return arr, True


class ChaosLink:
    """Seeded flaky channel over a :meth:`SessionManager.stream` shard
    generator — the live counterpart of the DES ``_stream_kv_flaky``.

    Each shard "transmission" fails independently with probability
    ``p`` and is retransmitted (counted in ``retries``) up to
    ``max_retries`` times; on exhaustion the link gives up
    retransmitting and delivers the shard CORRUPTED with its original
    checksum (counted in ``corrupted``) — the receiver detects the
    mismatch, rolls back, and the caller re-prefills on the decode
    engine."""

    def __init__(self, plan_seed: int, fl: FlakyLink):
        self.p = fl.p
        self.max_retries = fl.max_retries
        self.rng = random.Random(
            f"{plan_seed}:live:{fl.src}:{fl.dst}:{fl.seed}")
        self.retries = 0
        self.corrupted = 0

    def wrap(self, shards) -> Iterator[Any]:
        for item in shards:
            if isinstance(item, KvSlice) and self.p > 0.0:
                attempts = 0
                while self.rng.random() < self.p:
                    attempts += 1
                    if attempts > self.max_retries:
                        self.corrupted += 1
                        item = corrupt_slice(item)
                        break
                    self.retries += 1
            yield item


class CheckpointStore:
    """Host-side periodic checkpoint store for live engines.

    ``poll(engines, now)`` runs at most once per ``interval`` seconds:
    it takes a non-destructive :meth:`SessionManager.snapshot` of each
    engine and stores a host copy of every session that generated at
    least ``min_dirty_tokens`` tokens since its last checkpoint.  On a
    crash, ``restore(req, engine, now)`` truncates the request's
    output back to the checkpointed length and re-installs the saved
    state — greedy re-decode regenerates the truncated suffix
    bit-identically (the state is exact), so recovery is exact, not
    approximate."""

    def __init__(self, cfg: Optional[RecoveryConfig] = None):
        self.cfg = cfg or RecoveryConfig()
        self.cfg.validate()
        self._data: Dict[int, Dict[str, Any]] = {}
        self._next_t: Optional[float] = None
        self.checkpoints = 0            # snapshots actually stored
        self.stored_bytes = 0.0

    def __contains__(self, rid: int) -> bool:
        return rid in self._data

    def poll(self, engines, now: float, on_store=None) -> int:
        """``on_store(engine_idx, nbytes)`` (optional) observes every
        stored snapshot — the hook live fabric accounting uses to
        charge checkpoint shipping as bulk traffic."""
        if self._next_t is not None and now < self._next_t:
            return 0
        self._next_t = now + self.cfg.interval
        n = 0
        for gi, eng in enumerate(engines):
            sessions = eng.sessions if hasattr(eng, "sessions") else eng
            for req, st in sessions.snapshot(now):
                prev = self._data.get(st.rid)
                if prev is not None and \
                        st.pos - prev["pos"] < self.cfg.min_dirty_tokens:
                    continue
                self._data[st.rid] = {
                    "state": _state_to(st.state, "cpu", copy=True),
                    "last_tok": int(st.last_tok),
                    "pos": int(st.pos),
                    "budget": int(st.budget),
                    "nbytes": int(st.nbytes),
                    "out_len": len(req.output),
                }
                self.checkpoints += 1
                self.stored_bytes += float(st.nbytes)
                if on_store is not None:
                    on_store(gi, int(st.nbytes))
                n += 1
        return n

    def drop(self, rid: int) -> None:
        self._data.pop(rid, None)

    def restore(self, req, engine, now: Optional[float] = None) -> bool:
        """Re-install ``req``'s last checkpoint on ``engine``.  Rolls
        the request's client-visible output back to the checkpointed
        prefix (those tokens already streamed; the re-decoded suffix
        is bit-identical).  Returns False when no checkpoint exists or
        the engine cannot fit the session right now."""
        entry = self._data.get(req.rid)
        if entry is None:
            return False
        sessions = engine.sessions if hasattr(engine, "sessions") \
            else engine
        st = SessionState(
            rid=req.rid,
            state=entry["state"],
            last_tok=entry["last_tok"], pos=entry["pos"],
            budget=entry["budget"], nbytes=entry["nbytes"],
            done=False, first_token_pending=False,
            priority=getattr(req, "priority", 0))
        out_len = entry["out_len"]
        saved_tail = list(req.output[out_len:])
        del req.output[out_len:]
        if sessions.restore(req, st, now):
            return True
        req.output.extend(saved_tail)   # roll the truncation back
        return False
