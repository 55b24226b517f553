"""Declarative deployment API: one spec, two backends (DES / engines).

Tessera's headline result is that *deployment shape* — which devices
group into which replica, how phases split across groups, how requests
route — is where heterogeneous wins live.  Before this module the repo
had four parallel entry points for exercising a shape
(``simulate_cluster``, ``simulate_cluster_pd``,
``TesseraCluster.simulate/simulate_pd`` and the hand-wired two-engine
handoff in ``examples/serve_pipeline.py``), which made shape *search*
and runtime *elasticity* impossible to express.  The redesign:

  * :class:`DeploymentSpec` — a serializable, validated description of
    a deployment: device inventory per replica group, inter-group
    fabric, router policy by name + kwargs (``router.ROUTERS``
    registry), phase-split/overlap config (``pd``, ``kv_chunks``,
    affinity via ``router_kwargs``), SLOs, a ``$/hr`` budget and an
    optional measured calibration (``costmodel.calibrate``).
    ``to_json``/``from_json`` round-trip exactly, so a deployment shape
    is a file you can diff, ship and search over.
  * ``spec.compile(graph)`` → :class:`Deployment`, one protocol with
    two backends:
      - :meth:`Deployment.simulate` drives the unified cluster DES
        (``simulator.simulate_deployment``) — subsumes both legacy
        simulate entry points with bit-identical event logs,
      - :meth:`Deployment.launch` instantiates real
        :class:`~repro_torch.serving.engine.ServingEngine` s — a single
        continuous-batching engine, or the prefill+decode pair wired
        through the (optionally streamed) KV handoff.
  * :meth:`Deployment.scale` — runtime autoscaling on the DES backend:
    removed groups drain (the router masks them, resident decode
    sessions finish — loss-free), added groups warm up for a modeled
    delay before becoming routable.
  * ``Deployment.simulate(failures=[(t, group)])`` — replica-level
    fault injection through the same masking machinery: the dead
    group's in-flight requests re-route across the survivors.

``serving/sizing.py`` builds composition search on top of this:
mutate ``spec.groups``, score by simulated goodput/$.
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch import DeviceLike, default_generator, resolve_device
from repro_torch.core.costmodel import CATALOG, Calibration, calibrate
from repro_torch.core.monitor import MonitorConfig
from repro_torch.core.simulator import (_EVENT_ORDER, ClusterRequest,
                                  ClusterResult, ControlEvent,
                                  Interconnect, KvPoolModel,
                                  simulate_deployment)
from repro_torch.serving.cluster import TesseraCluster
from repro_torch.serving.router import ROUTERS, make_router
from repro_torch.serving.workload import WorkloadRequest, assign_slos

_SLO_KEYS = frozenset({"base", "per_output_token", "ttft"})
_IC_KEYS = frozenset({"default_bw", "base_latency", "bw"})
_ENGINE_KEYS = frozenset({"slots", "max_len", "sync_every",
                          "temperature", "seed", "smoke",
                          "kv_block_tokens", "kv_pool_blocks",
                          "spill", "preempt_priority"})
_POLICIES = ("latency", "throughput")


def _field(default):
    return dataclasses.field(default_factory=default)


@dataclasses.dataclass
class DeploymentSpec:
    """Declarative description of one serving deployment.

    ``groups``: device-catalog names per replica group, e.g.
    ``[["h100", "rtxpro6000"], ["a100", "l40s"]]`` — names only (not
    DeviceSpec objects) so the spec serializes; resolution happens at
    compile.  ``router``/``router_kwargs`` name a registered policy
    (``repro_torch.serving.router.ROUTERS``) — affinity and pool overrides
    live in the kwargs.  ``pd`` selects phase-split simulation and the
    two-engine launch pairing; ``kv_chunks > 1`` streams each KV
    handoff overlapped with the remaining prefill.  ``slos`` (keys
    ``base``/``per_output_token``/``ttft``) are stamped onto every
    simulated trace; ``budget`` is a hard ``$/hr`` ceiling enforced at
    construction; ``calibration`` is a ``CALIBRATION`` payload (see
    ``costmodel.calibrate``) scaling the DES service profiles by
    measured wall/model ratios.  ``engine`` carries launch-time knobs
    (``slots``, ``max_len``, ``sync_every``, ``temperature``,
    ``seed``, ``smoke``) plus the paged-KV knobs
    (``kv_block_tokens``, ``kv_pool_blocks``, ``spill``,
    ``preempt_priority``) — setting ``kv_block_tokens`` turns on
    block-pooled session memory in BOTH backends: real engines page
    their KV, and the DES runs a matching ``KvPoolModel`` (per-group
    occupancy, delayed admission, prefix/session cache hits).

    Validated at construction; every field is JSON-serializable and
    ``from_json(spec.to_json()) == spec``.
    """

    groups: List[List[str]]
    arch: Optional[str] = None          # model architecture (launch +
    #                                     KV-size model)
    base_prompt: int = 1024             # token counts the graph was
    base_output: int = 128              # traced with (per-request scale)
    router: str = "jsed"
    router_kwargs: Dict[str, Any] = _field(dict)
    pd: bool = False                    # phase-split serving
    kv_chunks: int = 1                  # >1 = overlapped KV streaming
    interconnect: Dict[str, Any] = _field(dict)
    slos: Optional[Dict[str, float]] = None
    budget: Optional[float] = None      # $/hr ceiling over all groups
    calibration: Optional[Dict[str, float]] = None
    monitor: Optional[Dict[str, float]] = _field(dict)  # None disables
    initial_policy: str = "latency"
    anneal_iters: int = 1000            # planner effort per group
    bw_override: Optional[float] = None
    engine: Dict[str, Any] = _field(dict)
    # contended-fabric topology (serving.fabric.Topology dict form);
    # None keeps the point-to-point interconnect model bit-identical
    fabric: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------------ #
    def __post_init__(self):
        if not self.groups or any(not g for g in self.groups):
            raise ValueError("spec needs at least one non-empty "
                             "replica group")
        for g in self.groups:
            for name in g:
                if name not in CATALOG:
                    raise ValueError(
                        f"unknown device {name!r}; "
                        f"pick from {sorted(CATALOG)}")
        if self.router not in ROUTERS:
            raise ValueError(f"unknown router {self.router!r}; "
                             f"pick from {sorted(ROUTERS)}")
        if self.kv_chunks < 1:
            raise ValueError(f"kv_chunks must be >= 1, "
                             f"got {self.kv_chunks}")
        if self.kv_chunks > 1 and not self.pd:
            raise ValueError("kv_chunks > 1 streams the prefill->decode "
                             "KV handoff; it requires pd=True")
        if self.slos is not None:
            bad = set(self.slos) - _SLO_KEYS
            if bad:
                raise ValueError(f"unknown slo keys {sorted(bad)}; "
                                 f"pick from {sorted(_SLO_KEYS)}")
            if not any(v and v > 0 for v in self.slos.values()):
                raise ValueError("slos must set at least one positive "
                                 "deadline")
        bad = set(self.interconnect) - _IC_KEYS
        if bad:
            raise ValueError(f"unknown interconnect keys {sorted(bad)}; "
                             f"pick from {sorted(_IC_KEYS)}")
        for key in self.interconnect.get("bw") or {}:
            src, _, dst = str(key).partition("-")
            if not (src.isdigit() and dst.isdigit()):
                raise ValueError(
                    f"interconnect bw override key {key!r} must be "
                    "'src-dst' group indices, e.g. '0-1'")
        bad = set(self.engine) - _ENGINE_KEYS
        if bad:
            raise ValueError(f"unknown engine keys {sorted(bad)}; "
                             f"pick from {sorted(_ENGINE_KEYS)}")
        bt = self.engine.get("kv_block_tokens")
        pool = self.engine.get("kv_pool_blocks")
        if pool is not None and bt is None:
            raise ValueError("kv_pool_blocks requires kv_block_tokens")
        if bt is not None:
            if int(bt) < 1:
                raise ValueError(f"kv_block_tokens must be >= 1, "
                                 f"got {bt}")
            ml = int(self.engine.get("max_len", 64))
            if ml % int(bt):
                raise ValueError(f"kv_block_tokens={bt} must divide "
                                 f"max_len={ml}")
            if pool is not None and int(pool) < 1:
                raise ValueError(f"kv_pool_blocks must be >= 1, "
                                 f"got {pool}")
        if self.initial_policy not in _POLICIES:
            raise ValueError(f"initial_policy must be one of "
                             f"{_POLICIES}, got {self.initial_policy!r}")
        if self.fabric is not None:
            # full validation (keys, islands, reachability) + every
            # declared group must sit on some island
            topo = self.make_topology()
            for g in range(len(self.groups)):
                topo.island_of(g)
        if self.calibration is not None:
            calibrate(self.calibration)     # raises on a bad payload
        if self.monitor:
            MonitorConfig(**self.monitor)   # raises on unknown fields
        if self.budget is not None and self.price_rate > self.budget + 1e-9:
            raise ValueError(
                f"composition costs ${self.price_rate:.2f}/hr, over the "
                f"${self.budget:.2f}/hr budget")

    # ------------------------------------------------------------------ #
    @property
    def price_rate(self) -> float:
        """$/hr of the declared composition (catalog rental prices)."""
        return sum(CATALOG[n].price for g in self.groups for n in g)

    def make_interconnect(self) -> Interconnect:
        bw = {tuple(int(x) for x in str(k).split("-")): float(v)
              for k, v in (self.interconnect.get("bw") or {}).items()}
        return Interconnect(
            default_bw=float(self.interconnect.get("default_bw", 100e9)),
            base_latency=float(self.interconnect.get("base_latency",
                                                     20e-6)),
            bw=bw)

    def make_topology(self):
        """The contended-fabric :class:`~repro_torch.serving.fabric.Topology`
        (or ``None`` when the spec keeps point-to-point math)."""
        if self.fabric is None:
            return None
        from repro_torch.serving.fabric import Topology
        return Topology.from_dict(self.fabric)

    def calibration_model(self) -> Optional[Calibration]:
        return (calibrate(self.calibration)
                if self.calibration is not None else None)

    def kv_config(self) -> Optional[Dict[str, Any]]:
        """Resolved paged-KV knobs, or ``None`` when the spec doesn't
        page.  The ``slots=`` shim: without an explicit
        ``kv_pool_blocks`` the pool is sized to exactly the fixed-slot
        footprint (``slots * max_len / kv_block_tokens`` blocks), so
        turning paging on changes the memory LAYOUT, not the budget."""
        bt = self.engine.get("kv_block_tokens")
        if bt is None:
            return None
        bt = int(bt)
        slots = int(self.engine.get("slots", 4))
        max_len = int(self.engine.get("max_len", 64))
        pool = self.engine.get("kv_pool_blocks")
        pool = int(pool) if pool is not None else slots * (max_len // bt)
        return {"kv_block_tokens": bt, "kv_pool_blocks": pool,
                "spill": bool(self.engine.get("spill", True)),
                "preempt_priority":
                    bool(self.engine.get("preempt_priority", True))}

    def kv_model(self) -> Optional[KvPoolModel]:
        """DES occupancy model matching the engine knobs (``None``
        when not paging — the DES then runs bit-identically to before
        paging existed)."""
        kvc = self.kv_config()
        if kvc is None:
            return None
        return KvPoolModel(kvc["kv_block_tokens"],
                           kvc["kv_pool_blocks"],
                           base_prompt=self.base_prompt,
                           base_output=self.base_output)

    # ------------------------------------------------------------------ #
    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(dataclasses.asdict(self), indent=indent)

    @classmethod
    def from_json(cls, s: str) -> "DeploymentSpec":
        obj = json.loads(s)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(obj) - known
        if unknown:
            raise ValueError(f"unknown DeploymentSpec fields "
                             f"{sorted(unknown)}")
        return cls(**obj)

    def save(self, path) -> None:
        Path(path).write_text(self.to_json() + "\n")

    @classmethod
    def load(cls, path) -> "DeploymentSpec":
        return cls.from_json(Path(path).read_text())

    # ------------------------------------------------------------------ #
    def compile(self, graph=None, model_cfg=None) -> "Deployment":
        """Bind the spec to a kernel graph.  ``graph`` may be omitted
        when only :meth:`Deployment.launch` will be used (engines need
        the model, not the DDG); :meth:`Deployment.simulate` requires
        it.  ``model_cfg`` overrides the KV-size model (defaults to
        the config of ``spec.arch`` when set)."""
        return Deployment(self, graph, model_cfg)


# --------------------------------------------------------------------- #
class Deployment:
    """A compiled :class:`DeploymentSpec`: one protocol, two backends.

    * :meth:`simulate` — the cluster DES, with optional fault
      injection and the elasticity timeline :meth:`scale` builds.
    * :meth:`launch` — real ``ServingEngine`` s in the spec's shape.

    Replica-group planning (the expensive part) happens lazily on
    first ``simulate`` and is shared across repeated simulations;
    every simulate call replays against FRESH replica/router state, so
    one Deployment supports apples-to-apples comparisons.
    """

    def __init__(self, spec: DeploymentSpec, graph=None, model_cfg=None):
        self.spec = spec
        self.graph = graph
        self.model_cfg = model_cfg
        self._cluster: Optional[TesseraCluster] = None
        self._timeline: List[ControlEvent] = []
        self._extra_groups: List[List[str]] = []
        self._reserve: set = set()      # parked group indices (see
        #                                 add_reserve): planned, unbilled,
        #                                 ineligible until a controller
        #                                 activates them

    # ------------------------------------------------------------------ #
    @property
    def num_groups(self) -> int:
        return len(self.spec.groups) + len(self._extra_groups)

    @property
    def price_rate(self) -> float:
        """$/hr including scaled-in groups (drained groups still count:
        the spec does not model partial-hour billing).  Parked reserve
        groups are excluded — they accrue nothing until a controller
        activates them, and elastic runs bill time-weighted through
        ``AutoscalePolicy.billed_dollars``."""
        n0 = len(self.spec.groups)
        return self.spec.price_rate + sum(
            CATALOG[n].price
            for k, g in enumerate(self._extra_groups)
            if n0 + k not in self._reserve for n in g)

    def _resolved(self, group: Sequence[str]):
        cal = self.spec.calibration_model()
        devs = [CATALOG[n] for n in group]
        return cal.apply_all(devs) if cal is not None else devs

    def _model_cfg(self):
        if self.model_cfg is not None:
            return self.model_cfg
        if self.spec.arch:
            import repro_torch.configs as configs
            return configs.get(self.spec.arch)
        return None

    def cluster(self) -> TesseraCluster:
        """The planned cluster behind the DES backend (lazy)."""
        if self._cluster is None:
            if self.graph is None:
                raise ValueError("Deployment.simulate needs "
                                 "spec.compile(graph); this deployment "
                                 "was compiled without one")
            spec = self.spec
            mon = (MonitorConfig(**spec.monitor)
                   if spec.monitor is not None else None)
            all_groups = list(spec.groups) + self._extra_groups
            topo = spec.make_topology()
            bw_overrides = None
            if topo is not None:
                # kernel placement sees the fabric: each group plans
                # against its island bandwidth derated by contention
                # (extra/autoscaled groups fall back to bw_override)
                bw_overrides = [topo.planner_bw(g)
                                for g in range(len(spec.groups))]
            self._cluster = TesseraCluster(
                self.graph,
                [self._resolved(g) for g in all_groups],
                base_prompt=spec.base_prompt,
                base_output=spec.base_output,
                monitor_cfg=mon,
                initial_policy=spec.initial_policy,
                bw_override=spec.bw_override,
                bw_overrides=bw_overrides,
                anneal_iters=spec.anneal_iters,
                model_cfg=self._model_cfg(),
                interconnect=spec.make_interconnect())
        return self._cluster

    def _router(self, health=None):
        kw = dict(self.spec.router_kwargs)
        if health is not None:
            # health-aware degraded routing: the same GroupHealth the
            # DES records errors into is folded into the policy's
            # scores (jsed / pd_split accept it; a policy without a
            # health kwarg fails loudly here)
            kw["health"] = health
        if self.spec.router == "pd_split":
            # the PD router's shed estimate should charge the same
            # transfer tail the DES will produce
            kw.setdefault("interconnect", self.spec.make_interconnect())
            kw.setdefault("kv_chunks", self.spec.kv_chunks)
        # (with spec.fabric set, simulate_deployment later binds the
        # run's FabricState into the router via router.bind_fabric, so
        # shed estimates charge the QUEUED transfer tail)
        return make_router(self.spec.router, **kw)

    # ------------------------------------------------------------------ #
    def scale(self, *, add: Optional[Sequence[Sequence[str]]] = None,
              remove: Optional[Sequence[int]] = None,
              at: float = 0.0, warmup: float = 1.0) -> "Deployment":
        """Schedule runtime autoscaling on the DES backend.

        ``remove``: group indices that begin a graceful drain at
        ``at`` — the router masks them immediately, resident work
        (decode sessions included) finishes normally, and no accepted
        request is dropped as long as another group stays eligible.
        ``add``: device-name lists planned now but routable only from
        ``at + warmup`` (modeled weight-load + compile delay).  The
        timeline composes: call ``scale`` repeatedly to script a whole
        capacity schedule, then :meth:`simulate`.  Returns ``self``.

        Note: ``scale`` deliberately does NOT re-check ``spec.budget``
        — emergency capacity beyond the provisioning budget is an
        operator decision the spec cannot veto; :attr:`price_rate`
        reports the honest post-scale rate.

        Draining the ONLY eligible group is rejected: the scheduled
        timeline is replayed to ``at`` and the call raises when the
        removals would leave nothing routable (adds in the same call
        count if their warm-up completes by ``at``) — every arrival
        after such a drain would be shed, which is never what an
        autoscaler meant.  Schedule the replacement first, or later.
        """
        removals = []
        for g in (remove or []):
            g = int(g)
            if not 0 <= g < self.num_groups:
                raise ValueError(f"cannot remove group {g}; deployment "
                                 f"has {self.num_groups}")
            removals.append(g)
        for group in (add or []):
            for name in group:
                if name not in CATALOG:
                    raise ValueError(f"unknown device {name!r}; "
                                     f"pick from {sorted(CATALOG)}")
            idx = self.num_groups
            self._extra_groups.append(list(group))
            if self._cluster is not None:
                self._cluster.add_groups([self._resolved(group)])
            self._timeline.append(
                ControlEvent(float(at) + float(warmup), "up", idx))
        if removals:
            left = self._eligible_at(float(at)) - set(removals)
            if not left:
                raise ValueError(
                    f"scale(remove={removals}) would leave no eligible "
                    f"group at t={float(at)}; scale up first (or give "
                    f"the drain a later `at`)")
            for g in removals:
                self._timeline.append(ControlEvent(float(at), "down", g))
        return self

    def _eligible_at(self, t: float) -> set:
        """Which groups the scheduled timeline leaves routable at
        ``t``: reserve groups park, groups with a pending "up" start
        masked, then events at or before ``t`` replay in DES order."""
        pend_up = {e.group for e in self._timeline if e.kind == "up"}
        elig = {g for g in range(self.num_groups)
                if g not in self._reserve and g not in pend_up}
        for e in sorted(self._timeline, key=lambda e:
                        (e.time, _EVENT_ORDER[e.kind], e.group)):
            if e.time > t:
                break
            if e.kind == "up":
                elig.add(e.group)
            else:
                elig.discard(e.group)
        return elig

    # ------------------------------------------------------------------ #
    def add_reserve(self, groups: Sequence[Sequence[str]]) -> List[int]:
        """Provision parked reserve groups for a controller.

        Each group is planned immediately (plan-cache backed) but
        starts ineligible with no scheduled warm-up and accrues no
        cost: only a controller activation (an "up" control event)
        makes it routable and starts its billing clock.  Returns the
        new group indices.
        """
        idxs: List[int] = []
        for group in (groups or []):
            for name in group:
                if name not in CATALOG:
                    raise ValueError(f"unknown device {name!r}; "
                                     f"pick from {sorted(CATALOG)}")
            idx = self.num_groups
            self._extra_groups.append(list(group))
            self._reserve.add(idx)
            if self._cluster is not None:
                self._cluster.add_groups([self._resolved(group)])
            idxs.append(idx)
        return idxs

    # ------------------------------------------------------------------ #
    def prepare(self, trace: Sequence[WorkloadRequest]
                ) -> List[ClusterRequest]:
        """Preprocess a workload trace ONCE for repeated replays.

        Produces exactly the sorted ``ClusterRequest`` list
        :meth:`simulate` builds internally — spec SLOs stamped
        (overriding any the trace carried), arrival-sorted, per-request
        scales and KV sizes resolved — so callers replaying the same
        trace against many candidates (sizing search, controller
        sweeps) pay the conversion once and pass ``prepared=``.
        KV sizes are memoized by prompt length (the KV model is a pure
        function of it), which is most of the historical per-call cost.
        """
        cluster = self.cluster()
        slos = self.spec.slos
        if slos:
            slo_base = slos.get("base", 0.0) or 0.0
            slo_tok = slos.get("per_output_token", 0.0) or 0.0
            slo_ttft = slos.get("ttft")
            slo_comp = not (slo_base <= 0.0 and slo_tok <= 0.0)
        kv_memo: Dict[int, float] = {}
        kv_bytes = cluster.kv_bytes
        bp = cluster.base_prompt
        bo = cluster.base_output
        out: List[ClusterRequest] = []
        for r in sorted(trace, key=lambda r: (r.arrival, r.rid)):
            p = r.prompt_tokens
            kv = kv_memo.get(p)
            if kv is None:
                kv = kv_memo[p] = kv_bytes(p)
            if slos:
                slo = (slo_base + slo_tok * r.output_tokens
                       if slo_comp else None)
                ttft = slo_ttft
            else:
                slo, ttft = r.slo, r.slo_ttft
            out.append(ClusterRequest(
                rid=r.rid, arrival=r.arrival,
                scale_prompt=p / bp,
                scale_output=r.output_tokens / bo,
                session=r.session, kv_bytes=kv,
                slo=slo, slo_ttft=ttft,
                priority=getattr(r, "priority", 0)))
        return out

    def simulate(self, trace: Optional[Sequence[WorkloadRequest]] = None,
                 *,
                 failures: Optional[Sequence[Tuple[float, int]]] = None,
                 faults=None, recovery=None, health=None,
                 router=None, controller=None,
                 events: Optional[str] = "full",
                 reference: bool = False,
                 prepared: Optional[Sequence[ClusterRequest]] = None
                 ) -> ClusterResult:
        """Replay an open-loop trace on the DES backend.

        ``failures=[(t, group_idx), ...]`` hard-kills groups mid-trace
        (in-flight requests re-route, see
        ``simulator.simulate_deployment``); the autoscaling timeline
        from :meth:`scale` is applied on every call.  ``router``
        overrides the spec's policy with a caller-built instance
        (apples-to-apples replays); by default a FRESH router is built
        per call so no routing state leaks between replays.  When the
        spec declares ``slos`` they are stamped onto the trace
        (overriding any the trace already carried).

        ``faults`` (a ``serving.faults.FaultPlan``) is the typed
        superset of ``failures``: crashes with scheduled recovery,
        straggle windows, and flaky KV links, all seeded.  ``recovery``
        (a ``RecoveryConfig``) turns on checkpoint-based session
        recovery — crash victims restore from their last periodic
        checkpoint and replay the lost decode suffix on a survivor
        instead of landing in ``dropped``.  ``health`` (a
        ``GroupHealth``) is shared between the DES (which records
        transfer errors and crash/recover flips into it) and the
        per-call router (which folds its breaker state and penalties
        into scoring); ``recovery`` rides along only with ``faults``,
        while ``health`` may also come alone (a straggle detector
        tripping breakers with no injected fault) — a health-only run
        binds an empty fault plan, leaving the schedule bit-identical
        to a plain run.  The
        contradictory-timeline validation
        (``simulator.validate_timeline``) covers the merged
        ``scale`` + ``failures`` + ``faults`` schedule.

        ``controller`` (a ``serving.controller.AutoscalePolicy``)
        closes the loop: it is bound to this deployment (provisioning
        its parked reserve pool on first use), observes windowed DES
        signals every ``controller.interval`` simulated seconds, and
        injects scale up/down events into the live timeline.

        ``events`` selects event recording (``"full"`` | ``"agg"`` |
        ``None`` — see ``simulator.simulate_deployment``);
        ``reference=True`` replays on the historical per-unit walk
        (the parity oracle / benchmark baseline); ``prepared`` replaces
        ``trace`` with a :meth:`prepare` result so repeated replays
        skip the per-call trace preprocessing.
        """
        cluster = self.cluster()
        if controller is not None:
            controller.bind(self)
        if prepared is not None:
            creqs: Sequence[ClusterRequest] = prepared
        elif trace is None:
            raise ValueError("simulate needs a trace (or a "
                             "prepare()d one via prepared=)")
        elif reference:
            # historical prep path (per-replay SLO stamping + scalar
            # per-request conversion) so reference mode is an honest
            # end-to-end baseline, not just the reference walk
            if self.spec.slos:
                trace = assign_slos(trace, **self.spec.slos)
            creqs = [cluster.to_cluster_request(r)
                     for r in sorted(trace,
                                     key=lambda r: (r.arrival, r.rid))]
        else:
            creqs = self.prepare(trace)
        timeline = list(self._timeline)
        for (t, g) in (failures or []):
            g = int(g)
            if not 0 <= g < self.num_groups:
                raise ValueError(f"cannot fail group {g}; deployment "
                                 f"has {self.num_groups}")
            timeline.append(ControlEvent(float(t), "fail", g))
        fstate = None
        if faults is not None:
            from repro_torch.serving.faults import FaultPlan
            fstate = (faults.bind(self.num_groups, recovery=recovery,
                                  health=health)
                      if isinstance(faults, FaultPlan) else faults)
            timeline.extend(fstate.control_events())
        elif health is not None:
            # health-ALONE runs (e.g. a straggle detector tripping
            # breakers with no injected fault) bind an empty plan: its
            # link() is always None, so the schedule is bit-identical
            # to a plain run — only the breaker state is live.
            from repro_torch.serving.faults import FaultPlan
            fstate = FaultPlan().bind(self.num_groups, recovery=recovery,
                                      health=health)
        elif recovery is not None:
            raise ValueError("recovery= rides along with a faults= "
                             "plan; pass one")
        replicas = cluster.build_replicas()
        if reference:
            for rep in replicas:
                rep.reference = True
        return simulate_deployment(
            replicas, creqs, router or self._router(health=health),
            interconnect=cluster.interconnect,
            kv_chunks=self.spec.kv_chunks,
            timeline=timeline,
            controller=controller,
            start_ineligible=sorted(self._reserve),
            events=events,
            kv=self.spec.kv_model(),
            faults=fstate,
            fabric=self.spec.make_topology())

    # ------------------------------------------------------------------ #
    def launch(self, cfg=None, params=None,
               device: DeviceLike = None) -> "LaunchedDeployment":
        """Instantiate the spec's shape with REAL engines on ``device``
        (default the card; raises without one, and never falls back to
        the CPU).

        ``cfg``/``params`` default from ``spec.arch`` (smoke-sized
        unless ``spec.engine["smoke"]`` is false); parameters made here
        are drawn on ``device`` from a generator seeded with
        ``spec.engine["seed"]``.  The launch backend realizes the phase
        topology (single engine, or prefill+decode pair with serial or
        streamed KV handoff); it does not model the DES's queueing
        knobs (router, SLOs), which have no meaning for two local
        engines.
        """
        spec = self.spec
        dev = resolve_device(device)
        if cfg is None:
            if not spec.arch:
                raise ValueError("launch needs spec.arch or an "
                                 "explicit cfg")
            import repro_torch.configs as configs
            cfg = (configs.get_smoke(spec.arch)
                   if spec.engine.get("smoke", True)
                   else configs.get(spec.arch))
        if params is None:
            from repro_torch.models import model as M
            params = M.init_params(
                cfg, device=dev,
                generator=default_generator(
                    dev, int(spec.engine.get("seed", 0))))
        return LaunchedDeployment(spec, cfg, params, device=dev)


# --------------------------------------------------------------------- #
class LaunchedDeployment:
    """Real-engine backend of a :class:`DeploymentSpec`.

    ``pd=False``: one continuous-batching :class:`ServingEngine`.
    ``pd=True``: a prefill engine + decode engine wired through the KV
    handoff — serial ``prefill_handoff``/``admit_handoff`` export/
    import, or streamed (layer, chunk) shards overlapping the
    remaining prefill when ``kv_chunks > 1`` — the two-engine flow
    that previously existed only as example code.  Greedy decode is
    bit-identical to a single engine either way (asserted in
    tests/test_torch_deployment.py).  Every engine runs on ``device``
    and shares the one ``params``: no engine copies a weight.
    """

    def __init__(self, spec: DeploymentSpec, cfg, params,
                 device: DeviceLike = None):
        from repro_torch.serving.engine import ServingEngine
        self.spec = spec
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.wire_bytes = 0
        self.shards = 0
        self.migrations = 0
        ekw = spec.engine
        self.max_len = int(ekw.get("max_len", 64))
        common = dict(slots=int(ekw.get("slots", 4)),
                      max_len=self.max_len,
                      temperature=float(ekw.get("temperature", 0.0)),
                      seed=int(ekw.get("seed", 0)),
                      device=self.device)
        kvc = spec.kv_config()
        if kvc is not None:
            common.update(kv_block_tokens=kvc["kv_block_tokens"],
                          kv_pool_blocks=kvc["kv_pool_blocks"],
                          spill=kvc["spill"],
                          preempt_priority=kvc["preempt_priority"])
        sync_every = int(ekw.get("sync_every", 4))
        self._engine_kw = dict(common, sync_every=sync_every)
        self._actions: List[Dict[str, Any]] = []
        self._chaos = None              # bound FaultState (see inject)
        self._store = None              # CheckpointStore under recovery
        # live accounting twin of the DES fabric: counts real bytes per
        # channel and priority class (None without spec.fabric)
        self._fabric = None
        topo = spec.make_topology()
        if topo is not None:
            from repro_torch.serving.fabric import LiveFabric
            self._fabric = LiveFabric(topo, len(spec.groups))
        self.kv_retries = 0             # transparent shard retransmits
        self.kv_corrupted = 0           # shards delivered corrupted
        self.reprefills = 0             # handoffs re-prefilled on decode
        self.lost_sessions = 0          # sessions lost to crashes
        self.recovered_sessions = 0     # ... restored from checkpoints
        if spec.pd:
            chunk = (max(1, math.ceil(self.max_len / spec.kv_chunks))
                     if spec.kv_chunks > 1 else None)
            self.prefill_engine = ServingEngine(cfg, params,
                                                prefill_chunk=chunk,
                                                **common)
            self.decode_engine = ServingEngine(cfg, params,
                                               sync_every=sync_every,
                                               **common)
            self.engines = [self.prefill_engine, self.decode_engine]
        else:
            # one colocated engine per replica group: the pool the
            # live scale() drains / grows
            self.engines = [ServingEngine(cfg, params, **self._engine_kw)
                            for _ in spec.groups]
            self.engine = self.engines[0]
            self._routable = [True] * len(self.engines)

    # ------------------------------------------------------------------ #
    def inject(self, plan, recovery=None) -> "LaunchedDeployment":
        """Arm a ``serving.faults.FaultPlan`` against the REAL engines
        for the next :meth:`run` — the live counterpart of
        ``Deployment.simulate(faults=...)``.

        On the colocated pool (``pd=False``): ``crash`` hard-kills an
        engine's resident sessions mid-run (``sessions.crash`` — state
        unexported) and un-routes it until its ``recover_at``;
        ``straggle`` paces the engine's decode loop down by ``factor``
        over its window.  With ``recovery`` (a ``RecoveryConfig``) a
        ``CheckpointStore`` polls non-destructive session snapshots
        every ``interval`` seconds and crash victims restore on a
        survivor from their last checkpoint — the truncated suffix
        re-decodes bit-identically (greedy), so no accepted session is
        lost; without it victims restart from scratch.

        On the PD pair (``pd=True``, ``kv_chunks > 1``): ``flaky_link``
        wraps the streamed KV handoff in a :class:`ChaosLink` —
        per-shard failures retransmit up to the link's retry budget;
        a shard that exhausts it arrives corrupted, the receiver's
        checksum (``stream(checksum=True)``) catches it, and the
        request falls back to re-prefilling on the decode engine with
        bit-identical greedy tokens.  Crash/straggle chaos is rejected
        there: the pair is a fixed topology.
        """
        from repro_torch.serving.faults import CheckpointStore, GroupHealth
        if self.spec.pd and (plan.crashes or plan.straggles):
            raise ValueError("the pd pair is a fixed topology — only "
                             "flaky_link chaos applies; run crash/"
                             "straggle plans on the colocated pool "
                             "(pd=False)")
        n = len(self.engines)
        self._chaos = plan.bind(n, recovery=recovery,
                                health=GroupHealth(n))
        self._store = (CheckpointStore(recovery)
                       if recovery is not None else None)
        return self

    def scale(self, *, add: Optional[Sequence[Sequence[str]]] = None,
              remove: Optional[Sequence[int]] = None,
              at: float = 0.0, warmup: float = 0.0
              ) -> "LaunchedDeployment":
        """Schedule runtime autoscaling on the REAL engine pool — the
        same decision surface as ``Deployment.scale``, executed during
        the next :meth:`run`.

        ``remove``: engine indices that drain at ``at`` seconds into
        the run — the engine stops taking admissions, every resident
        mid-decode session is exported (``export_sessions``) and
        re-imported into a surviving engine (``import_session``), so
        no accepted request is dropped and greedy tokens are
        bit-identical to never having moved.  ``add``: device-name
        lists (cosmetic here — every launch engine runs the same local
        model) whose engines are built at ``at + warmup`` and
        primed (``ServingEngine.warmup``) BEFORE they become
        routable; warm-up is real first-call work on this backend, so
        ``warmup`` only delays when it starts.  Only the colocated
        pool scales (``pd=False``); the PD pair is a fixed topology.

        Removing every routable engine is rejected up front: the
        scheduled actions are replayed (adds count at their start
        time) and the call raises if any drain would leave nothing
        routable — schedule the replacement at or before the drain.
        """
        if self.spec.pd:
            raise ValueError("live scale() drives the colocated engine "
                             "pool; the pd=True prefill/decode pair is "
                             "a fixed topology")
        adds = [list(g) for g in (add or [])]
        for group in adds:
            for name in group:
                if name not in CATALOG:
                    raise ValueError(f"unknown device {name!r}; "
                                     f"pick from {sorted(CATALOG)}")
        n_total = len(self.engines) + sum(
            1 for a in self._actions if a["kind"] == "add") + len(adds)
        removals = []
        for g in (remove or []):
            g = int(g)
            if not 0 <= g < n_total or g in removals:
                raise ValueError(f"cannot remove engine {g}; pool has "
                                 f"{n_total} (scheduled adds included) "
                                 f"and repeats are not allowed")
            removals.append(g)
        planned = sorted(
            self._actions
            + [{"at": float(at) + float(warmup), "kind": "add"}
               for _ in adds]
            + [{"at": float(at), "kind": "remove", "group": g}
               for g in removals],
            key=lambda a: (a["at"], 0 if a["kind"] == "add" else 1))
        routable = sum(self._routable)
        for a in planned:
            routable += 1 if a["kind"] == "add" else -1
            if routable < 1:
                raise ValueError(
                    f"scale(remove={removals}) would drain the last "
                    f"routable engine at t={float(at)}; scale up first "
                    f"(or give the drain a later `at`)")
        self._actions = planned
        return self

    def _live_chan(self, src: int, dst: int):
        """The live fabric channel between two ENGINE indices, or None
        — without a fabric, for same-group/same-island hops, and for
        autoscaled engines past the founding groups (the topology only
        maps the groups the spec declared)."""
        fab = self._fabric
        if fab is None:
            return None
        n = len(self.spec.groups)
        if not (0 <= src < n and 0 <= dst < n):
            return None
        return fab.channel(src, dst)

    def _account_ckpt(self, gi: int, nbytes: int) -> None:
        """CheckpointStore ``on_store`` hook: snapshot bytes ride the
        fabric to the host as bulk traffic (skipped for autoscaled
        engines and host-less topologies — accounting must never make
        a checkpoint fail)."""
        fab = self._fabric
        if fab is None or not (0 <= gi < len(self.spec.groups)):
            return
        if fab.topo.host_island is None:
            return
        fab.account_ckpt(gi, int(nbytes))

    def _pick_engine(self):
        """The routable engine with the most free slots (host view;
        conservative between syncs), or None when every one is full."""
        best, best_free = None, 0
        for j, eng in enumerate(self.engines):
            if not self._routable[j]:
                continue
            free = eng.active.count(None)
            if free > best_free:
                best, best_free = eng, free
        return best

    def _apply_action(self, act: Dict[str, Any], clk) -> None:
        if act["kind"] == "add":
            from repro_torch.serving.engine import ServingEngine
            eng = ServingEngine(self.cfg, self.params, **self._engine_kw)
            eng.warmup()        # primed BEFORE routable flips
            self.engines.append(eng)
            self._routable.append(True)
            return
        g = act["group"]
        self._routable[g] = False     # no new admissions from here on
        for req, h in self.engines[g].export_sessions(clk()):
            self.wire_bytes += h["kv_bytes"]
            self.migrations += 1
            while True:
                tgt = self._pick_engine()
                if tgt is not None and tgt.import_session(req, h, clk()):
                    ch = self._live_chan(g, self.engines.index(tgt))
                    if ch is not None:
                        from repro_torch.serving.fabric import BULK
                        ch.account(int(h["kv_bytes"]), BULK)
                    break
                # every routable engine full: drain one decode step
                # everywhere and retry — a slot frees in finitely many
                # steps because resident budgets are finite
                for eng in self.engines:
                    eng.step(clk())

    def _run_pool(self, requests: Sequence) -> Dict[str, Any]:
        """Elastic multi-engine run: admit due arrivals to the
        least-loaded routable engine, apply due scale actions (AFTER
        admission, so an ``at=0`` drain deterministically exercises
        in-flight migration), step every engine with resident work."""
        t0 = time.perf_counter()

        def clk() -> float:
            return time.perf_counter() - t0

        pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
        acts = list(self._actions)
        self._actions = []
        chaos = self._chaos
        chaos_evs: List[Tuple[float, str, int]] = []
        if chaos is not None:
            for c in chaos.plan.crashes:
                chaos_evs.append((c.t, "crash", c.group))
                if c.recover_at is not None:
                    chaos_evs.append((c.recover_at, "revive", c.group))
            chaos_evs.sort()
        waiting: List[Any] = []     # checkpointed crash victims, until
        #                             a survivor has room to restore
        ticks = 0
        while pending or acts or chaos_evs or waiting \
                or any(e._any_active() for e in self.engines):
            now = clk()
            ticks += 1
            if self._store is not None:
                self._store.poll(self.engines, now,
                                 on_store=(self._account_ckpt
                                           if self._fabric is not None
                                           else None))
            while pending and pending[0].arrival <= now:
                eng = self._pick_engine()
                if eng is None:
                    break               # pool full; step below drains
                eng.admit_batch([pending.pop(0)], clk())
            while acts and acts[0]["at"] <= now:
                self._apply_action(acts.pop(0), clk)
            while chaos_evs and chaos_evs[0][0] <= now:
                _, kind, g = chaos_evs.pop(0)
                if kind == "crash":
                    self._routable[g] = False
                    chaos.health.trip(g, now)
                    for req in self.engines[g].sessions.crash(clk()):
                        self.lost_sessions += 1
                        if self._store is not None \
                                and req.rid in self._store:
                            waiting.append(req)
                        else:           # no checkpoint: from scratch
                            del req.output[:]
                            pending.append(req)
                    pending.sort(key=lambda r: (r.arrival, r.rid))
                else:                   # revive
                    self._routable[g] = True
                    chaos.health.reset(g, now)
            if waiting:
                still = []
                for req in waiting:
                    tgt = self._pick_engine()
                    if tgt is not None and \
                            self._store.restore(req, tgt, clk()):
                        self.recovered_sessions += 1
                    else:               # no room yet: retry next tick
                        still.append(req)
                waiting = still
            stepped = False
            for g, eng in enumerate(self.engines):
                if chaos is not None:
                    f = chaos.straggle_factor(g, now)
                    if f > 1.0 and ticks % max(int(round(f)), 1):
                        continue        # straggler: skip this tick
                if eng._any_active():
                    eng.step(clk())
                    stepped = True
            if not stepped:
                due = [r.arrival for r in pending[:1]] \
                    + [a["at"] for a in acts[:1]] \
                    + [e[0] for e in chaos_evs[:1]]
                if due:
                    time.sleep(min(0.05, max(0.0, min(due) - clk())))
        for eng in self.engines:
            eng.sync(clk())
        summaries = [e.stats.summary() for e in self.engines]
        agg = {k: sum(s[k] for s in summaries)
               for k in ("completed", "decode_steps", "host_syncs",
                         "prefill_batches")}
        done = sum(s["completed"] for s in summaries)
        for k in ("mean_ttft", "mean_tpot", "mean_norm_latency"):
            agg[k] = (sum(s[k] * s["completed"] for s in summaries)
                      / done if done else 0.0)
        out = {"engine": agg, "engines": summaries,
               "wire_bytes": self.wire_bytes, "shards": self.shards,
               "migrations": self.migrations,
               "routable": list(self._routable)}
        if chaos is not None:
            out.update(
                lost_sessions=self.lost_sessions,
                recovered_sessions=self.recovered_sessions,
                checkpoints=(self._store.checkpoints
                             if self._store is not None else 0))
        if self._fabric is not None:
            out["fabric"] = self._fabric.stats()
        return out

    # ------------------------------------------------------------------ #
    def _counted_native(self, gen):
        """Shard accounting for a native ``sessions.stream`` (KvSlice /
        SessionState items — the chaos-injected path keeps the typed
        shards so checksums survive to the receiver)."""
        from repro_torch.serving.kvpool import SessionState
        for item in gen:
            if not isinstance(item, SessionState):
                self.shards += 1
                self.wire_bytes += item.nbytes
            yield item

    def run(self, requests: Sequence) -> Dict[str, Any]:
        """Serve ``requests`` (engine ``Request`` objects, mutated in
        place with outputs/timestamps) to completion.  Returns a stats
        dict; for a PD pair the decode engine's stats are the
        user-visible ones (it streams every token)."""
        if not self.spec.pd:
            if len(self.engines) == 1 and not self._actions \
                    and self._chaos is None:
                # solo fast path: identical to the pre-elastic backend
                stats = self.engine.run(list(requests))
                return {"engine": stats.summary(), "wire_bytes": 0,
                        "shards": 0}
            return self._run_pool(requests)
        t0 = time.perf_counter()
        pre, dec = self.prefill_engine, self.decode_engine

        def clk() -> float:
            return time.perf_counter() - t0

        ordered = sorted(requests, key=lambda r: (r.arrival, r.rid))
        streamed = self.spec.kv_chunks > 1
        link = (self._chaos.live_link(0, 1)
                if streamed and self._chaos is not None else None)
        # live fabric channel prefill -> decode: the handoff's shards
        # are counted as URGENT (decode-blocking) traffic.  The channel
        # wraps OUTSIDE the chaos link, so it counts each shard as
        # delivered once (retransmits inside the link are the link's
        # own accounting, link.retries).
        fabch = self._live_chan(0, 1)
        if link is None and fabch is None:
            # the plain pair: the engine module's prefill -> decode loop
            from repro_torch.serving.engine import serve_pd
            wire, shards, _ = serve_pd(pre, dec, ordered, streamed)
            self.wire_bytes += wire
            self.shards += shards
        elif streamed:
            from repro_torch.serving.fabric import URGENT
            from repro_torch.serving.kvpool import ShardChecksumError
            for req in ordered:
                # chaos-injected and/or fabric-accounted handoff:
                # typed shards (checksummed only under chaos) through
                # the flaky channel.  Transient failures retransmit
                # inside the link; a shard that exhausts its retries
                # arrives corrupted and the receiver's checksum trips.
                shards = self._counted_native(
                    pre.sessions.stream(req, clk(),
                                        checksum=link is not None,
                                        klass=URGENT))
                if link is not None:
                    shards = link.wrap(shards)
                if fabch is not None:
                    shards = fabch.wrap(shards)
                try:
                    while not dec.sessions.receive(req, shards, clk()):
                        dec.step(clk())     # drain a slot, retry
                except ShardChecksumError:
                    # poisoned transfer: run BOTH phases on the decode
                    # engine instead.  The aborted stream never touched
                    # req.output, so the greedy tokens of the re-prefill
                    # are bit-identical to the fault-free run.
                    self.reprefills += 1
                    del req.output[:]
                    while not dec.admit_batch([req], clk()):
                        dec.step(clk())
            if link is not None:
                self.kv_retries = link.retries
                self.kv_corrupted = link.corrupted
        else:
            from repro_torch.serving.fabric import URGENT
            handoffs: List[Tuple[Any, Dict]] = []
            for req in ordered:
                h = pre.prefill_handoff(req, clk())
                if not h["done"]:
                    self.wire_bytes += h["kv_bytes"]
                    fabch.account(int(h["kv_bytes"]), URGENT)
                    handoffs.append((req, h))
            while handoffs:
                while handoffs and dec.admit_handoff(
                        handoffs[0][0], handoffs[0][1], clk()):
                    handoffs.pop(0)
                if handoffs:
                    dec.step(clk())
        while dec._any_active():
            dec.step(clk())
        dec.sync(clk())
        out = {"engine": dec.stats.summary(),
               "prefill": pre.stats.summary(),
               "wire_bytes": self.wire_bytes, "shards": self.shards}
        if self._chaos is not None:
            out.update(kv_retries=self.kv_retries,
                       kv_corrupted=self.kv_corrupted,
                       reprefills=self.reprefills)
        if self._fabric is not None:
            out["fabric"] = self._fabric.stats()
        return out
