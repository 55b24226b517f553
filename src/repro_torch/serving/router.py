"""Workload-aware request routing across heterogeneous Tessera replicas.

Scoring policy (join-shortest-expected-delay, JSED)
---------------------------------------------------
Each replica group runs its own Plan over its own device set, so the
*same* request costs a different amount on different replicas — an
H100+RTX pair drains a long-prompt request far faster than an A100+L40s
pair.  The router therefore scores every candidate replica with the
cost model the planner itself optimizes:

    score(replica) = backlog(replica, now) + predicted_service(req)

  * ``backlog`` — seconds until the replica's most-loaded resource
    (compute server or ingress link) frees up: the queueing delay a new
    arrival would actually see,
  * ``predicted_service`` — the unqueued execution latency of *this*
    request on *that* replica, from the per-stage cost model with the
    request's prompt/output lengths scaled in.

and joins the minimum — an expected-completion-time rule.  With
homogeneous replicas and equal-sized requests it degenerates to
join-shortest-queue; with heterogeneous replicas it rate-matches load
to capability (fast groups get proportionally more and bigger
requests), which is what lets the workload-aware router beat
round-robin on heterogeneous mixes (benchmarks/cluster_scaling.py).

Decode-session affinity: multi-turn requests carrying a ``session`` id
re-join the replica that holds their KV/decode state unless its backlog
exceeds the best candidate's by ``affinity_break`` seconds — then the
session migrates (modeling a KV refetch as preferable to queueing).

Admission control: routers accepting an ``slo_shed`` flag return ``-1``
(shed) when every eligible replica's expected completion delay exceeds
the request's per-request SLO — serving it anyway would burn capacity on
a request that is already lost, collapsing goodput under overload.

Phase-split routing (``PDRouter``): classifies replica groups into
prefill-heavy and decode-heavy roles from the cost model's per-group
profile, routes each request's prefill and decode to different groups
(an explicit KV-transfer edge connects them, see
``simulator.simulate_cluster_pd``), and rate-matches the two pools —
prefill admission is throttled by the decode pool's backlog so the
decode side never accumulates an unbounded queue of transferred KV
("Beyond the Buzz", arXiv 2506.05508).

Eligibility: the deployment layer (``serving/spec.py`` +
``simulator.simulate_deployment``) masks groups that are warming up,
draining, or failed by flipping ``ReplicaModel.eligible``; every router
skips ineligible groups and returns ``-1`` when none remain.  With all
groups eligible (the only state the legacy entry points can produce)
every decision is bit-identical to the pre-eligibility routers.

Routers only read replica state; :func:`repro_torch.core.simulator
.simulate_deployment` (or a real dispatch loop) owns the clock.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.simulator import ClusterRequest, ReplicaModel


def eligible_indices(replicas: Sequence[ReplicaModel]) -> List[int]:
    """Groups a router may currently send work to."""
    return [i for i in range(len(replicas))
            if getattr(replicas[i], "eligible", True)]


class Router:
    """Interface: pick a replica index for a request at time ``now``."""

    name = "base"

    def route(self, req: ClusterRequest,
              replicas: Sequence[ReplicaModel], now: float) -> int:
        raise NotImplementedError

    # simulate_cluster duck-types the router as a plain callable
    def __call__(self, req, replicas, now) -> int:
        return self.route(req, replicas, now)


class RoundRobinRouter(Router):
    """Workload-oblivious baseline: equal request counts per replica."""

    name = "round_robin"

    def __init__(self):
        self._next = 0

    def route(self, req, replicas, now) -> int:
        # advance the cursor past masked groups so the cycle covers
        # exactly the eligible set (identical to the legacy cycle when
        # everything is eligible)
        for _ in range(len(replicas)):
            idx = self._next % len(replicas)
            self._next += 1
            if getattr(replicas[idx], "eligible", True):
                return idx
        return -1


class LeastLoadedRouter(Router):
    """Join-shortest-queue on backlog seconds; size- and
    speed-oblivious (does not model the request's own cost)."""

    name = "least_loaded"

    def route(self, req, replicas, now) -> int:
        cand = eligible_indices(replicas)
        if not cand:
            return -1
        # explicit first-minimum loop == min(cand, key=(backlog, i))
        best = cand[0]
        best_b = replicas[best].backlog(now)
        for i in cand[1:]:
            b = replicas[i].backlog(now)
            if b < best_b:
                best, best_b = i, b
        return best


class JSEDRouter(Router):
    """Join-shortest-expected-delay with decode-session affinity and
    optional SLO-based admission control."""

    name = "jsed"

    def __init__(self, affinity_break: float = float("inf"),
                 slo_shed: bool = False,
                 session_affinity: bool = True,
                 kv_penalty: float = 0.0,
                 health=None,
                 brownout_priority: Optional[int] = None):
        # Migrate a session when staying costs this many more seconds
        # of backlog than the best replica; inf = never migrate.
        self.affinity_break = affinity_break
        # Shed a request when even the best replica cannot meet its SLO.
        self.slo_shed = slo_shed
        # False disables the home shortcut entirely — the measured
        # baseline for the affinity-ON-vs-OFF goodput comparison.
        self.session_affinity = session_affinity
        # Seconds of score penalty at 100% KV-block utilization; only
        # felt when the DES runs a KvPoolModel (replicas then carry a
        # kv_util_fn), so 0.0 and kv-less runs stay bit-identical.
        self.kv_penalty = kv_penalty
        # A serving.faults.GroupHealth: groups with an OPEN breaker are
        # skipped (fail-open when every breaker is open), degraded
        # groups pay health.penalty(i, now) seconds of score, and —
        # while ANY breaker is not closed — requests below
        # brownout_priority are shed first (brown-out ordering).
        # None keeps every decision bit-identical to the pre-health
        # router.
        self.health = health
        self.brownout_priority = brownout_priority
        # Bound by simulate_deployment when the spec carries a fabric:
        # a session abandoning its home then charges the QUEUED channel
        # tail of moving its resident state into the shed estimate.
        self._fabric = None
        self._session_home: Dict[int, int] = {}

    def bind_fabric(self, fstate) -> None:
        self._fabric = fstate

    def _queued_tail(self, req, src: Optional[int], dst: int,
                     now: float) -> float:
        """Seconds the session-state move src->dst spends on the shared
        fabric: committed time already ahead on the channel plus the
        transfer at the channel rate.  0.0 without a fabric, without a
        home, or when the move never leaves the island."""
        fs = self._fabric
        if fs is None or src is None or src == dst:
            return 0.0
        ch = fs.channel(src, dst)
        if ch is None:
            return 0.0
        return max(0.0, ch.head() - now) + ch.duration(req.kv_bytes)

    def score(self, req: ClusterRequest, replica: ReplicaModel,
              now: float) -> float:
        return replica.backlog(now) + replica.predicted_service(req)

    def _shed(self, req, replica, now, xfer: float = 0.0) -> bool:
        """Expected delays on the replica the request will ACTUALLY
        join (post-affinity) vs its SLO components.  Colocated expected
        TTFT = queueing + prefill-phase service (decode follows).
        ``xfer`` is the queued fabric tail of a session migration
        landing on this replica (0.0 keeps the math bit-identical to
        the fabric-less router)."""
        if not self.slo_shed:
            return False
        s = self.score(req, replica, now)
        if xfer:
            s += xfer
        if req.slo is not None and s > req.slo:
            return True
        if req.slo_ttft is None:
            return False
        t = (replica.backlog(now)
             + replica.predicted_phase_service(req, "prefill"))
        if xfer:
            t += xfer
        return t > req.slo_ttft

    def route(self, req, replicas, now) -> int:
        cand = eligible_indices(replicas)
        if not cand:
            return -1
        h = self.health
        if h is not None:
            if self.brownout_priority is not None and h.degraded(now) \
                    and getattr(req, "priority", 0) \
                    < self.brownout_priority:
                return -1       # brown-out: low priority sheds first
            ok = [i for i in cand if h.allow(i, now)]
            if ok:              # every breaker open -> fail open
                cand = ok
        # explicit first-minimum loop == min(cand, key=(score, i)):
        # this runs once per candidate group per request, so the
        # lambda/tuple-per-candidate overhead is the router hot path
        rep = replicas[cand[0]]
        best = cand[0]
        best_s = rep.backlog(now) + rep.predicted_service(req)
        if self.kv_penalty:
            kv = getattr(rep, "kv_util_fn", None)
            if kv is not None:
                best_s += self.kv_penalty * kv(now)
        if h is not None:
            best_s += h.penalty(best, now)
        for i in cand[1:]:
            rep = replicas[i]
            s = rep.backlog(now) + rep.predicted_service(req)
            if self.kv_penalty:
                kv = getattr(rep, "kv_util_fn", None)
                if kv is not None:
                    s += self.kv_penalty * kv(now)
            if h is not None:
                s += h.penalty(i, now)
            if s < best_s:
                best, best_s = i, s
        choice = best
        migrate_from: Optional[int] = None
        if self.session_affinity and req.session is not None:
            home = self._session_home.get(req.session)
            if home is not None and h is not None \
                    and not h.allow(home, now):
                # the home group's breaker is open: treat it like a
                # masked group — re-home on whatever JSED picks
                home = None
            if home is not None and not getattr(replicas[home],
                                                "eligible", True):
                # the home group drained or died; its resident state is
                # gone — the session re-homes on whatever JSED picks.
                # The stale entry is only dropped once the request is
                # actually ADMITTED: a shed must leave session state
                # untouched, or one rejected turn silently strips
                # affinity from every later turn of the session.
                home = None
            if home is not None:
                stay_cost = replicas[home].backlog(now)
                move_cost = replicas[best].backlog(now)
                if stay_cost - move_cost <= self.affinity_break:
                    choice = home
                else:
                    # affinity break: the resident state moves across
                    # the fabric before the new home can serve
                    migrate_from = home
        # the SLO check runs against the replica the request will
        # ACTUALLY join — affinity must not smuggle a doomed request
        # past admission control (a queued fabric crossing counts
        # toward the deadline like any other delay)
        xfer = self._queued_tail(req, migrate_from, choice, now)
        if self._shed(req, replicas[choice], now, xfer):
            return -1
        if self.session_affinity and req.session is not None:
            self._session_home[req.session] = choice
        return choice


class PDRouter(Router):
    """Phase-split router: prefill and decode on different groups.

    Role classification — on first routing decision, each group's
    unqueued prefill-phase and decode-phase service times for a
    scale-1 request are computed from its own plan's cost model
    (``ReplicaModel.predicted_phase_service``).  Groups are ranked by
    ``t_prefill / t_decode``: a LOW ratio means the group drains prompt
    FLOPs comparatively faster than bandwidth-bound decode (compute-rich
    hardware) and joins the prefill pool; the rest become the decode
    pool.  ``prefill_frac`` sets how many groups the prefill pool gets;
    explicit ``prefill_pool``/``decode_pool`` index lists override the
    automatic split (the P/D-ratio sweep in benchmarks/pd_split.py).

    Rate matching — before admitting a prefill, the chosen decode
    group's backlog is compared against ``max_kv_lag`` seconds; any
    excess delays the prefill admission by that amount.  The decode pool
    therefore consumes transferred KV at least as fast as prefill
    produces it (bounded resident-KV, ``ClusterResult.peak_kv_bytes``)
    instead of queueing state for requests whose decode is hours away.

    Routing within each pool is JSED restricted to the pool's members;
    with ``slo_shed`` the request is shed when the expected phase-split
    completion delay already exceeds its SLO (the expected TTFT
    includes the KV-transfer tail when an ``interconnect`` is given —
    the full serial transfer, or only the last chunk's tail under
    ``kv_chunks``-way overlapped streaming, matching the earlier
    effective KV-arrival the DES produces).

    Decode-session affinity (``session_affinity``): a follow-up turn
    of a multi-turn session runs BOTH phases on the decode group that
    already holds the session's resident KV/recurrent state — its
    prefill reuses the resident state in place instead of
    re-transferring across the fabric.  Avoided transfers are counted
    in ``transfers_avoided`` (surfaced per run in ``ClusterResult``).
    """

    name = "pd_split"

    def __init__(self, *, prefill_frac: float = 0.5,
                 prefill_pool: Optional[Sequence[int]] = None,
                 decode_pool: Optional[Sequence[int]] = None,
                 max_kv_lag: float = 0.25,
                 slo_shed: bool = False,
                 session_affinity: bool = False,
                 affinity_break: float = float("inf"),
                 interconnect=None,
                 kv_chunks: int = 1,
                 health=None,
                 brownout_priority: Optional[int] = None):
        assert 0.0 < prefill_frac < 1.0 or prefill_pool is not None
        self.prefill_frac = prefill_frac
        # same semantics as JSEDRouter: breaker-open groups drop out of
        # both pools (fail-open per pool), degraded groups pay a score
        # penalty, low-priority requests shed during a brown-out
        self.health = health
        self.brownout_priority = brownout_priority
        self.max_kv_lag = max_kv_lag
        self.slo_shed = slo_shed
        self.session_affinity = session_affinity
        # re-split a follow-up when staying home costs this many more
        # backlog seconds than the best decode candidate (inf = always
        # stay; the JSEDRouter affinity_break semantics)
        self.affinity_break = affinity_break
        self.interconnect = interconnect
        self.kv_chunks = max(int(kv_chunks), 1)
        self.transfers_avoided = 0
        # Bound by simulate_deployment when the spec carries a fabric
        # topology (serving.fabric.FabricState).  None keeps every
        # estimate on the point-to-point interconnect math.
        self._fabric = None
        # Migration handshake with the DES: when an affinity break
        # abandons a decode home, the admitted tuple decision leaves
        # the old home here so the simulator can enqueue the resident
        # state's move as bulk fabric traffic.  Consumed (and cleared)
        # by simulate_deployment's dispatch.
        self.pending_migration: Optional[int] = None
        self._migrate_from: Optional[int] = None
        self._session_decode: Dict[int, int] = {}
        self._pools: Optional[Tuple[List[int], List[int]]] = None
        if prefill_pool is not None or decode_pool is not None:
            assert prefill_pool and decode_pool, \
                "override both pools or neither"
            assert not set(prefill_pool) & set(decode_pool), \
                "pools must be disjoint"
            self._pools = (list(prefill_pool), list(decode_pool))

    # -------------------------------------------------------------- #
    def pools(self, replicas: Sequence[ReplicaModel]
              ) -> Tuple[List[int], List[int]]:
        """(prefill_pool, decode_pool) indices, classifying lazily."""
        if self._pools is None:
            self._pools = self._classify(replicas)
        return self._pools

    def _classify(self, replicas) -> Tuple[List[int], List[int]]:
        if len(replicas) < 2:       # degenerate: colocate on the one
            return [0], [0]
        probe = ClusterRequest(rid=-1, arrival=0.0)
        ratio = []
        for i, rep in enumerate(replicas):
            tp = rep.predicted_phase_service(probe, "prefill")
            td = rep.predicted_phase_service(probe, "decode")
            ratio.append((tp / max(td, 1e-12), i))
        ratio.sort()
        n_pre = min(max(int(round(self.prefill_frac * len(replicas))), 1),
                    len(replicas) - 1)
        pre = sorted(i for _, i in ratio[:n_pre])
        dec = sorted(i for _, i in ratio[n_pre:])
        return pre, dec

    def _best(self, pool: List[int], req, replicas, now,
              phase: str) -> int:
        # explicit first-minimum loop == min(pool, key=(delay, i))
        h = self.health
        rep = replicas[pool[0]]
        best = pool[0]
        best_s = (rep.backlog(now)
                  + rep.predicted_phase_service(req, phase))
        if h is not None:
            best_s += h.penalty(best, now)
        for i in pool[1:]:
            rep = replicas[i]
            s = rep.backlog(now) + rep.predicted_phase_service(req, phase)
            if h is not None:
                s += h.penalty(i, now)
            if s < best_s:
                best, best_s = i, s
        return best

    def bind_fabric(self, fstate) -> None:
        """Called by the DES when the deployment carries a fabric:
        shed estimates then charge the QUEUED channel tail (head-of-
        channel wait + contended transfer) instead of the unloaded
        point-to-point edge."""
        self._fabric = fstate

    def _transfer_tail(self, req, p: int, d: int,
                       now: float = 0.0) -> float:
        """Expected KV-transfer seconds landing in TTFT.  Serial: the
        whole edge.  Overlapped streaming: earlier chunks hide behind
        the remaining prefill compute, so only the last chunk's
        transfer outlives it (the compute-bound best case — the DES
        can only arrive at or before the serial edge, see
        simulator._stream_kv).  With a bound fabric the estimate is
        the QUEUED tail: time already committed ahead on the shared
        channel plus the transfer at the channel's (possibly
        contended) rate — so admission control sees congestion other
        requests and bulk traffic created, not the nameplate edge."""
        fs = self._fabric
        if fs is not None:
            ch = fs.channel(p, d)
            if ch is None:          # same group / same island: free
                return 0.0
            queued = max(0.0, ch.head() - now)
            serial = ch.duration(req.kv_bytes)
            if self.kv_chunks <= 1 or serial <= 0.0:
                return queued + serial
            return queued + min(serial, ch.latency
                                + (req.kv_bytes / self.kv_chunks) / ch.bw)
        ic = self.interconnect
        if ic is None:
            return 0.0
        serial = ic.transfer_time(req.kv_bytes, p, d)
        if self.kv_chunks <= 1 or serial <= 0.0:
            return serial
        return min(serial, ic.base_latency
                   + (req.kv_bytes / self.kv_chunks) / ic.bandwidth(p, d))

    # -------------------------------------------------------------- #
    def route(self, req, replicas, now):
        """Returns (prefill_idx, decode_idx, admit_at) — or -1 (shed),
        or a plain index when the pools degenerate to one group."""
        self.pending_migration = None       # handshake is per-decision
        self._migrate_from = None
        pre_pool, dec_pool = self.pools(replicas)
        # masked groups (warm-up / drain / failure) drop out of their
        # pool; a pool that empties collapses onto the other (the
        # survivors serve both phases colocated) so elasticity cannot
        # strand a phase
        pre_pool = [i for i in pre_pool
                    if getattr(replicas[i], "eligible", True)]
        dec_pool = [i for i in dec_pool
                    if getattr(replicas[i], "eligible", True)]
        if not pre_pool and not dec_pool:
            return -1
        if not pre_pool:
            pre_pool = dec_pool
        if not dec_pool:
            dec_pool = pre_pool
        h = self.health
        if h is not None:
            if self.brownout_priority is not None and h.degraded(now) \
                    and getattr(req, "priority", 0) \
                    < self.brownout_priority:
                return -1       # brown-out: low priority sheds first
            ok_pre = [i for i in pre_pool if h.allow(i, now)]
            ok_dec = [i for i in dec_pool if h.allow(i, now)]
            if ok_pre:          # fail open per pool
                pre_pool = ok_pre
            if ok_dec:
                dec_pool = ok_dec
        # A stale or abandoned home is only dropped once the request is
        # actually ADMITTED — shedding a request must leave session
        # state untouched (same invariant as JSEDRouter.route).
        drop_home = False
        if self.session_affinity and req.session is not None:
            home = self._session_decode.get(req.session)
            if home is not None and h is not None \
                    and not h.allow(home, now):
                # breaker open on the home group: re-split afresh
                home = None
            if home is not None and not getattr(replicas[home],
                                                "eligible", True):
                # resident state left with the group; re-split afresh
                drop_home = True
                home = None
            if home is not None:
                stay = replicas[home].backlog(now)
                best = min(replicas[i].backlog(now) for i in dec_pool)
                if stay - best <= self.affinity_break:
                    # follow-up turn: the decode group already holds
                    # this session's resident state — prefill reuses it
                    # in place, no cross-fabric re-transfer.  Admission
                    # control still applies: a follow-up that cannot
                    # meet its SLO on the home group is shed like any
                    # other request, not smuggled past the check.
                    if self.slo_shed:
                        rep = replicas[home]
                        t_first = (stay + rep.predicted_phase_service(
                            req, "prefill"))
                        total = t_first + rep.predicted_phase_service(
                            req, "decode")
                        if ((req.slo is not None and total > req.slo)
                                or (req.slo_ttft is not None
                                    and t_first > req.slo_ttft)):
                            return -1
                    self.transfers_avoided += 1
                    return home
                drop_home = True                        # migrate
                # the abandoned home still holds the session's resident
                # state; if this decision admits a split, the move
                # ships over the fabric as bulk traffic
                self._migrate_from = home
        p = self._best(pre_pool, req, replicas, now, "prefill")
        d = self._best(dec_pool, req, replicas, now, "decode")
        if p == d:
            if drop_home:
                del self._session_decode[req.session]
            return p
        # rate matching: delay prefill admission by the decode group's
        # backlog beyond the tolerated lag, so prefill production tracks
        # decode-side KV consumption
        lag = max(0.0, replicas[d].backlog(now) - self.max_kv_lag)
        if self.slo_shed:
            expect_ttft = (lag + replicas[p].backlog(now)
                           + replicas[p].predicted_phase_service(
                               req, "prefill")
                           + self._transfer_tail(req, p, d, now))
            expect = expect_ttft + replicas[d].predicted_phase_service(
                req, "decode")
            if req.slo is not None and expect > req.slo:
                return -1
            if req.slo_ttft is not None and expect_ttft > req.slo_ttft:
                return -1
        if self.session_affinity and req.session is not None:
            self._session_decode[req.session] = d
        # only an ADMITTED split migrates state — a shed above leaves
        # the handshake cleared and the session where it was
        self.pending_migration = self._migrate_from
        return p, d, now + lag


ROUTERS: Dict[str, type] = {}


def register_router(cls: type) -> type:
    """Add a Router class to the by-name registry used by
    :func:`make_router` and ``DeploymentSpec`` validation.  Usable as a
    decorator; returns the class.  Registering a duplicate name
    replaces the previous entry (latest wins), so downstream code can
    override a stock policy.
    """
    name = getattr(cls, "name", None)
    if not name or name == Router.name:
        raise ValueError(f"router class {cls!r} needs a distinct "
                         "class-level `name` to be registered")
    ROUTERS[name] = cls
    return cls


for _cls in (RoundRobinRouter, LeastLoadedRouter, JSEDRouter, PDRouter):
    register_router(_cls)


def make_router(name: str, **kw) -> Router:
    """Instantiate a registered router policy by name with kwargs —
    the constructor ``DeploymentSpec.router`` / ``router_kwargs``
    compile down to."""
    try:
        cls = ROUTERS[name]
    except KeyError:
        raise ValueError(f"unknown router {name!r}; "
                         f"pick from {sorted(ROUTERS)}") from None
    return cls(**kw)
