"""Discrete-event simulator of disaggregated pipelined execution.

The container has no heterogeneous hardware, so the paper's performance
experiments (offline throughput, online latency, pipeline ablation,
bandwidth robustness, monitor sensitivity) are reproduced on a
discrete-event model driven by the *same* cost model the planner uses:

  * one compute server per device (stages serialize on it),
  * one ingress-link server per device (cut-edge transfers serialize on
    it, the paper's receiver-side M_g),
  * compute and communication on a device overlap (separate servers) —
    the premise of the paper's pipelined execution model,
  * scheduling: "priority" (oldest request first — the paper's
    priority-aware streams) or "fifo" (naive multi-streaming),
  * pipelining off = one request admitted at a time.

Simulated time is deterministic; no wall clocks are read.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import random
from itertools import repeat
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.graph import KernelGraph
from repro_torch.core.planner import Plan
from repro_torch.core.monitor import MonitorConfig, OnlineMonitor


@dataclasses.dataclass
class StageTask:
    """Per-request instance of a plan stage."""
    stage_idx: int
    device: int
    compute: float
    ingress: float          # serialized transfer time on the ingress link


def stage_tasks(graph: KernelGraph, plan: Plan, devices,
                bw_override: Optional[float] = None) -> List[StageTask]:
    tasks = []
    for st in plan.stages:
        nset = set(st.node_ids)
        ingress = 0.0
        for (i, j), b in graph.edges.items():
            if j in nset and plan.labels[i] != st.device:
                rep = max(graph.nodes[i].repeat, graph.nodes[j].repeat)
                ingress += devices[plan.labels[i]].transfer_time(
                    b, devices[st.device], bw_override, repeat=rep)
        tasks.append(StageTask(st.idx, st.device, st.compute_time, ingress))
    # recompute stage compute under (possibly) overridden devices
    for t, st in zip(tasks, plan.stages):
        t.compute = sum(devices[st.device].kernel_time(graph.nodes[k])
                        for k in st.node_ids)
    return tasks


@dataclasses.dataclass
class SimResult:
    makespan: float
    completed: int
    latencies: List[float]
    device_busy: List[float]        # compute-busy seconds per device
    link_busy: List[float]          # ingress-busy seconds per device
    switches: int = 0
    # Dispatch log: (kind, device, request, start, end) per scheduled
    # unit, in dispatch order.  Simulated time is pure arithmetic on the
    # inputs, so two runs with identical seed+trace+plan must produce
    # bit-identical logs (tests/test_torch_des.py holds them to the reference).
    events: List[Tuple[int, int, int, float, float]] = \
        dataclasses.field(default_factory=list)

    @property
    def throughput(self) -> float:
        return self.completed / max(self.makespan, 1e-12)

    @property
    def mean_latency(self) -> float:
        return sum(self.latencies) / max(len(self.latencies), 1)

    def p(self, q: float) -> float:
        xs = sorted(self.latencies)
        if not xs:
            return 0.0
        return xs[min(int(q * len(xs)), len(xs) - 1)]

    def busy_fraction(self, dev: int) -> float:
        return self.device_busy[dev] / max(self.makespan, 1e-12)


# --------------------------------------------------------------------- #
class _DES:
    """Core event loop shared by offline and online modes."""

    def __init__(self, tasks: List[StageTask], num_devices: int,
                 scheduling: str = "priority", pipelined: bool = True,
                 max_inflight: int = 16):
        self.tasks = tasks
        self.nG = num_devices
        self.scheduling = scheduling
        self.pipelined = pipelined
        self.max_inflight = max_inflight if pipelined else 1

        self.dev_free = [0.0] * num_devices
        self.link_free = [0.0] * num_devices
        self.dev_busy = [0.0] * num_devices
        self.link_busy = [0.0] * num_devices

    def run(self, arrivals: List[float],
            iters_per_request: int = 1,
            stall_windows: Optional[List[Tuple[float, float]]] = None
            ) -> SimResult:
        """arrivals[r] = submit time of request r (must be sorted).

        Each stage is two independently-scheduled units — a transfer on
        the receiver's ingress link, then compute on the device — so the
        link and device queues pack independently (committing both at
        once reserves idle gaps and under-utilizes both)."""
        n = len(arrivals)
        events: List[Tuple[int, int, int, float, float]] = []
        # unit list: (kind 0=link/1=dev, device, duration)
        units: List[Tuple[int, int, float]] = []
        for t in self.tasks:
            if t.ingress > 0:
                units.append((0, t.device, t.ingress))
            units.append((1, t.device, t.compute))
        total_units = len(units) * iters_per_request
        cursor = [0] * n
        ready_at = [a for a in arrivals]
        finish = [0.0] * n
        admitted: List[int] = []
        waiting = list(range(n))
        done = 0
        stall_windows = stall_windows or []

        # list scheduling: repeatedly dispatch the frontier unit with the
        # earliest feasible start.
        #  priority   — ties broken by request age (stream priority:
        #               staggers communication phases),
        #  fifo/naive — equalize progress (models SM fair sharing: all
        #               streams reach their comm phases together).
        while done < n:
            while waiting and len(admitted) < self.max_inflight:
                admitted.append(waiting.pop(0))
            best, best_start, best_key = None, math.inf, None
            for r in admitted:
                kind, dev, dur = units[cursor[r] % len(units)]
                res_free = (self.link_free if kind == 0
                            else self.dev_free)[dev]
                start = max(ready_at[r], res_free)
                if self.scheduling == "priority":
                    key = (round(start, 12), r)
                else:
                    key = (cursor[r], round(start, 12), r)
                if best_key is None or key < best_key:
                    best, best_start, best_key = r, start, key
            r = best
            kind, dev, dur = units[cursor[r] % len(units)]
            start = best_start
            for (w0, w1) in stall_windows:          # policy-switch stalls
                if w0 <= start < w1:
                    start = w1
            end = start + dur
            if kind == 0:
                self.link_free[dev] = end
                self.link_busy[dev] += dur
            else:
                self.dev_free[dev] = end
                self.dev_busy[dev] += dur
            events.append((kind, dev, r, start, end))
            ready_at[r] = end
            cursor[r] += 1
            if cursor[r] >= total_units:
                finish[r] = end
                admitted.remove(r)
                done += 1

        makespan = max(finish) - min(arrivals) if n else 0.0
        lats = [finish[r] - arrivals[r] for r in range(n)]
        return SimResult(makespan=makespan, completed=n, latencies=lats,
                         device_busy=self.dev_busy,
                         link_busy=self.link_busy, events=events)


# --------------------------------------------------------------------- #
def simulate_offline(graph: KernelGraph, plan: Plan, devices,
                     num_requests: int = 64,
                     scheduling: str = "priority",
                     pipelined: bool = True,
                     max_inflight: int = 16,
                     iters_per_request: int = 1,
                     bw_override: Optional[float] = None) -> SimResult:
    """All requests available at t=0; throughput = N / makespan."""
    tasks = stage_tasks(graph, plan, devices, bw_override)
    des = _DES(tasks, len(devices), scheduling, pipelined, max_inflight)
    return des.run([0.0] * num_requests, iters_per_request)


def simulate_online(graph: KernelGraph, plans: Dict[str, Plan], devices,
                    rate: float, num_requests: int = 200,
                    monitor: Optional[OnlineMonitor] = None,
                    seed: int = 0,
                    iters_per_request: int = 4,
                    bw_override: Optional[float] = None) -> SimResult:
    """Poisson arrivals at ``rate`` req/s; optional monitor switches
    between the provided {"latency": plan, "throughput": plan}."""
    rng = random.Random(seed)
    arrivals = []
    t = 0.0
    for _ in range(num_requests):
        t += rng.expovariate(rate)
        arrivals.append(t)

    if monitor is None:
        plan = plans.get("latency") or next(iter(plans.values()))
        tasks = stage_tasks(graph, plan, devices, bw_override)
        des = _DES(tasks, len(devices), "priority", True, 16)
        return des.run(arrivals, iters_per_request)

    # Windowed re-simulation with policy switching: requests arriving in
    # each window run under the policy the monitor chose at its start.
    # Exec latency baseline = unqueued single-request pass.
    result_lats: List[float] = []
    switches = 0
    stalls: List[Tuple[float, float]] = []
    cur_sched = monitor.policy
    # exec-only latency per policy (no queueing)
    exec_lat = {}
    for name, plan in plans.items():
        tasks = stage_tasks(graph, plan, devices, bw_override)
        exec_lat[name] = sum(t0.compute + t0.ingress
                             for t0 in tasks) * iters_per_request

    # process sequentially, windowed
    W = monitor.cfg.window
    idx = 0
    clock = 0.0
    des = None
    pending: List[float] = []
    makespan = 0.0
    seen_switches = 0
    while idx < len(arrivals) or pending:
        w_end = clock + W
        batch = []
        while idx < len(arrivals) and arrivals[idx] < w_end:
            batch.append(arrivals[idx])
            idx += 1
        batch = pending + batch
        pending = []
        if batch:
            plan = plans[monitor.policy if monitor.policy in plans
                         else "latency"]
            tasks = stage_tasks(graph, plan, devices, bw_override)
            pl = monitor.policy == "throughput"
            des = _DES(tasks, len(devices), "priority",
                       pipelined=pl, max_inflight=16 if pl else 2)
            sub = des.run(batch, iters_per_request, stall_windows=stalls)
            for a, l in zip(batch, sub.latencies):
                result_lats.append(l)
                monitor.record_request(a + l, l,
                                       exec_lat[monitor.policy
                                                if monitor.policy in exec_lat
                                                else "latency"])
                makespan = max(makespan, a + l)
        monitor.tick(w_end)
        if monitor.switches > seen_switches:
            # each switch stalls workers at the next iteration boundary
            stalls.append((w_end, w_end + monitor.cfg.switch_stall *
                           (monitor.switches - seen_switches)))
            seen_switches = monitor.switches
        clock = w_end

    return SimResult(makespan=makespan, completed=len(result_lats),
                     latencies=result_lats,
                     device_busy=[0.0] * len(devices),
                     link_busy=[0.0] * len(devices),
                     switches=monitor.switches)


# ===================================================================== #
# Cluster composition: many replicas, each its own discrete-event model #
# ===================================================================== #
#
# A *replica* is one disaggregated device group executing one Plan (its
# own compute + ingress-link servers, exactly the single-replica model
# above).  The cluster simulator composes N replica models under a
# router: arrivals are processed in time order, the router picks a
# replica using only information available at the arrival instant
# (queue backlog, predicted service time), and the request's stage
# units are scheduled FCFS against that replica's resource timelines.
# Compute and communication still overlap (separate servers), and
# consecutive requests pipeline through the replica's stages.
#
# Per-request heterogeneity: stage-unit durations are scaled by how
# much longer/shorter the request's prompt and output are than the
# lengths the plan's DDG was traced with (prefill work ~ prompt tokens,
# decode work ~ output tokens).

@dataclasses.dataclass(frozen=True)
class ClusterRequest:
    """Router-visible request: scales are relative to the plan's DDG."""
    rid: int
    arrival: float
    scale_prompt: float = 1.0       # prefill work multiplier
    scale_output: float = 1.0       # decode work multiplier
    session: Optional[int] = None   # decode-session affinity key
    kv_bytes: float = 0.0           # prefill->decode KV handoff size
    slo: Optional[float] = None     # completion deadline (s of latency)
    slo_ttft: Optional[float] = None    # first-token deadline (s)
    priority: int = 0               # brown-out shedding order (higher
    #                                 survives longer; see router health)


def _phase_scales(req: ClusterRequest, phase: str) -> Tuple[float, float]:
    """(scale_prompt, scale_output) with the other phase zeroed out."""
    if phase == "both":
        return req.scale_prompt, req.scale_output
    if phase == "prefill":
        return req.scale_prompt, 0.0
    if phase == "decode":
        return 0.0, req.scale_output
    raise ValueError(f"unknown phase {phase!r}")


@dataclasses.dataclass
class Interconnect:
    """Cross-replica fabric for KV-state handoff.

    ``default_bw`` models the datacenter fabric between replica groups
    (distinct from the intra-replica ``DeviceSpec.link_bw`` the planner
    cuts over); ``bw[(src, dst)]`` overrides individual directed pairs —
    the "bandwidth matrix" knob for rack-locality experiments.
    """
    default_bw: float = 100e9       # bytes/s between replica groups
    base_latency: float = 20e-6     # per-transfer setup cost (s)
    bw: Dict[Tuple[int, int], float] = \
        dataclasses.field(default_factory=dict)

    def bandwidth(self, src: int, dst: int) -> float:
        return self.bw.get((src, dst), self.default_bw)

    def transfer_time(self, nbytes: float, src: int, dst: int) -> float:
        if src == dst or nbytes <= 0.0:
            return 0.0
        return self.base_latency + nbytes / self.bandwidth(src, dst)


@dataclasses.dataclass(frozen=True)
class ReplicaUnit:
    kind: int           # 0 = ingress link, 1 = compute
    device: int         # replica-local device index
    duration: float     # seconds at scale 1.0
    decode_frac: float  # fraction of the unit scaled by scale_output

    def scaled(self, scale_prompt: float, scale_output: float) -> float:
        return self.duration * (self.decode_frac * scale_output
                                + (1.0 - self.decode_frac) * scale_prompt)


def replica_units(graph: KernelGraph, plan: Plan, devices,
                  bw_override: Optional[float] = None) -> List[ReplicaUnit]:
    """Stage tasks -> schedulable units with decode fractions."""
    units: List[ReplicaUnit] = []
    for task, stage in zip(stage_tasks(graph, plan, devices, bw_override),
                           plan.stages):
        comp_total = sum(devices[stage.device].kernel_time(graph.nodes[k])
                         for k in stage.node_ids)
        comp_decode = sum(devices[stage.device].kernel_time(graph.nodes[k])
                          for k in stage.node_ids
                          if graph.nodes[k].phase == "decode")
        frac = comp_decode / comp_total if comp_total > 0 else 0.0
        if task.ingress > 0:
            units.append(ReplicaUnit(0, task.device, task.ingress, frac))
        units.append(ReplicaUnit(1, task.device, task.compute, frac))
    return units


class UnitProgram:
    """Compiled structure-of-arrays form of one stage-unit list.

    ``ReplicaUnit.scaled`` is affine in ``(scale_prompt,
    scale_output)``, so a whole unit list reduces to three preallocated
    float64 arrays (duration, decode fraction, prefill fraction) plus
    the per-unit ``(kind, device)`` routing the walk needs.  Two things
    fall out of the compilation:

      * ``predicted_service`` / ``predicted_phase_service`` become the
        cached dot products ``sp * svc_pre + so * svc_dec`` — O(1) per
        routing probe instead of re-summing the unit list for every
        candidate group of every request;
      * the walk's per-unit durations come from ONE elementwise numpy
        expression over the arrays (``dur * (frac*so + omf*sp)``),
        which is bit-identical to calling ``scaled`` per unit because
        float64 ufuncs apply the same IEEE operations elementwise.

    Small unit lists (the common case: a handful of plan stages) fall
    below numpy's per-call overhead, so the walk evaluates the same
    affine expression in scalar Python under ``_VECTOR_MIN`` units —
    identical bits either way.

    Programs are cached process-wide by unit-list *content* (not
    identity — list ids can be recycled), so sizing-search candidates
    that share group templates reuse compiled programs across every
    DES replay.
    """

    __slots__ = ("n", "dur", "frac", "omf", "steps", "svc_pre",
                 "svc_dec", "_walk_plans")

    def __init__(self, units: Sequence[ReplicaUnit]):
        self._walk_plans: Dict[str, _WalkPlan] = {}
        self.n = len(units)
        self.dur = np.array([u.duration for u in units],
                            dtype=np.float64)
        self.frac = np.array([u.decode_frac for u in units],
                             dtype=np.float64)
        self.omf = 1.0 - self.frac      # prefill fraction, elementwise
        # (kind, device, has_prefill_share, duration, frac, omf) —
        # plain tuples so the scheduling loop stays attribute-free
        self.steps = [(u.kind, u.device, u.decode_frac < 1.0,
                       u.duration, u.decode_frac, 1.0 - u.decode_frac)
                      for u in units]
        # predicted_service(sp, so) == sp * svc_pre + so * svc_dec
        self.svc_pre = float(np.dot(self.dur, self.omf))
        self.svc_dec = float(np.dot(self.dur, self.frac))

    def service(self, sp: float, so: float) -> float:
        return sp * self.svc_pre + so * self.svc_dec

    def durations(self, sp: float, so: float) -> List[float]:
        """Per-unit ``scaled(sp, so)``, bit-identical to the loop."""
        if self.n < _VECTOR_MIN:
            return [d * (f * so + o * sp)
                    for _, _, _, d, f, o in self.steps]
        return (self.dur * (self.frac * so + self.omf * sp)).tolist()

    def walk_plan(self, phase: str) -> "_WalkPlan":
        wp = self._walk_plans.get(phase)
        if wp is None:
            wp = self._walk_plans[phase] = _WalkPlan(self, phase)
        return wp


class _WalkPlan:
    """Request-independent structure of one program's walk for one
    phase: which units run, and where the walk can actually *wait*.

    Along a walk the clock ``t`` is strictly increasing (every active
    unit has ``dur > 0``), and a resource's free timeline is only
    rewritten BY this walk to the then-current ``t``.  So ``max(t,
    free)`` can exceed ``t`` only at the FIRST active unit of each
    ``(kind, device)`` resource — everywhere else it returns ``t``
    exactly.  That turns the per-unit scheduling loop into one seeded
    ``np.cumsum`` per resource segment (numpy's cumsum accumulates
    sequentially, so the ends match the reference walk's chain of
    additions bit-for-bit), with busy/aggregate accumulators seeded the
    same way.

    Which units are active is request-independent: phase scales are
    strictly positive for the phases a request carries, so ``scaled(sp,
    so) > 0`` reduces to a predicate on the unit's stored duration and
    decode fraction.
    """

    __slots__ = ("n", "dur", "frac", "omf", "kinds", "devs",
                 "seg_bounds", "seg_res", "res_groups",
                 "pe_pos", "pe_dur", "pe_frac", "pe_omf")

    def __init__(self, prog: UnitProgram, phase: str):
        if phase == "prefill":          # so == 0: runs iff omf > 0
            mask = (prog.dur > 0.0) & (prog.omf > 0.0)
        elif phase == "decode":         # sp == 0: runs iff frac > 0
            mask = (prog.dur > 0.0) & (prog.frac > 0.0)
        else:                           # sp, so > 0: runs iff dur > 0
            mask = prog.dur > 0.0
        idx = np.nonzero(mask)[0]
        self.n = int(len(idx))
        self.dur = prog.dur[idx]
        self.frac = prog.frac[idx]
        self.omf = prog.omf[idx]
        steps = [prog.steps[i] for i in idx.tolist()]
        self.kinds = [s[0] for s in steps]
        self.devs = [s[1] for s in steps]
        # segment boundaries: a new segment at the first active
        # occurrence of each (kind, device) resource
        seg_bounds: List[int] = []
        seg_res: List[Tuple[int, int]] = []
        groups: Dict[Tuple[int, int], List[int]] = {}
        for p, r in enumerate(zip(self.kinds, self.devs)):
            ps = groups.get(r)
            if ps is None:
                groups[r] = [p]
                seg_bounds.append(p)
                seg_res.append(r)
            else:
                ps.append(p)
        seg_bounds.append(self.n)
        self.seg_bounds = seg_bounds
        self.seg_res = seg_res
        # per-resource positions (busy/free/aggregate updates)
        self.res_groups = [
            (k, d, np.asarray(ps, dtype=np.intp), ps[-1], len(ps))
            for (k, d), ps in groups.items()]
        # last active unit with a prefill share (TTFT anchor)
        pe = [p for p in range(self.n) if self.frac[p] < 1.0]
        if pe:
            self.pe_pos = pe[-1]
            self.pe_dur = float(self.dur[self.pe_pos])
            self.pe_frac = float(self.frac[self.pe_pos])
            self.pe_omf = float(self.omf[self.pe_pos])
        else:
            self.pe_pos = -1
            self.pe_dur = self.pe_frac = self.pe_omf = 0.0


#: below this many units the scalar path beats numpy's call overhead
_VECTOR_MIN = 24

#: below this many ACTIVE units the scalar walk loop beats the
#: segmented-cumsum walk's fixed numpy call overhead
_VECTOR_WALK_MIN = 48

_PROGRAM_CACHE: Dict[Tuple, UnitProgram] = {}


def compile_units(units: Sequence[ReplicaUnit]) -> UnitProgram:
    """Content-keyed process-wide program cache (plan-cache idiom)."""
    key = tuple((u.kind, u.device, u.duration, u.decode_frac)
                for u in units)
    prog = _PROGRAM_CACHE.get(key)
    if prog is None:
        prog = _PROGRAM_CACHE[key] = UnitProgram(units)
    return prog


@dataclasses.dataclass
class EventAggregate:
    """Reduction of a full event log: per ``(replica, kind, device)``
    dispatch counts and busy seconds.

    ``events="agg"`` runs keep exactly this instead of the per-unit
    tuple list (the tuples dominate memory at 1M requests); the
    accumulation order matches the append order of a full log, and each
    event contributes ``t1 - t0`` (not its pre-rounding duration), so
    ``EventAggregate.from_events(full_log)`` equals the aggregate an
    ``events="agg"`` run produced — bit-identically (tested).

    KV transfers aggregate under ``(dst_replica, KV_TRANSFER,
    src_replica)``, mirroring their event-tuple layout.
    """

    counts: Dict[Tuple[int, int, int], int] = \
        dataclasses.field(default_factory=dict)
    seconds: Dict[Tuple[int, int, int], float] = \
        dataclasses.field(default_factory=dict)

    def add(self, rep: int, kind: int, dev: int,
            t0: float, t1: float) -> None:
        key = (rep, kind, dev)
        counts = self.counts
        if key in counts:
            counts[key] += 1
            self.seconds[key] += t1 - t0
        else:
            counts[key] = 1
            self.seconds[key] = t1 - t0

    @property
    def total_events(self) -> int:
        return sum(self.counts.values())

    @property
    def total_seconds(self) -> float:
        return sum(self.seconds.values())

    @classmethod
    def from_events(cls, events: Sequence[Tuple]) -> "EventAggregate":
        agg = cls()
        for rep, _rid, kind, dev, t0, t1 in events:
            agg.add(rep, kind, dev, t0, t1)
        return agg


class ReplicaModel:
    """Incremental discrete-event model of one replica.

    Unlike :class:`_DES` (which needs the full arrival list up front),
    requests are submitted one at a time so a router can interleave
    scheduling decisions with queue evolution.  Each resource is a FCFS
    server; a submitted request walks its stage units in topological
    order, starting each unit at max(previous unit end, resource free).

    Two walk implementations share this state:

      * the default fast path executes the compiled
        :class:`UnitProgram` (scoring via cached dot products, O(1)
        ``backlog`` from a running free-timeline maximum),
      * ``reference=True`` restores the historical per-unit object walk
        (``_run_units_reference``), O(n) scoring and O(n) backlog scans
        — the honest "before" for benchmarks and the oracle the parity
        suite checks bit-identical event logs against.

    ``track_inflight=False`` drops the per-request finish-heap push
    (``queue_len`` bookkeeping) — the deployment DES disables it when
    no controller will ever call ``queue_len``.
    """

    def __init__(self, idx: int, num_devices: int,
                 unit_sets: Dict[str, List[ReplicaUnit]],
                 policy: str = "latency",
                 monitor: Optional[OnlineMonitor] = None,
                 price: float = 0.0):
        assert policy in unit_sets, f"no unit set for policy {policy!r}"
        self.idx = idx
        self.num_devices = num_devices
        self.unit_sets = unit_sets
        self.programs = {pol: compile_units(us)
                         for pol, us in unit_sets.items()}
        self.policy = policy
        self.monitor = monitor
        self.price = price              # $/hr of this device group
        self.reference = False          # historical walk + O(n) probes
        self.track_inflight = True      # maintain the queue_len heap
        # Routability flag owned by the deployment control timeline:
        # warm-up ("up" pending), drain ("down") and failure ("fail")
        # all mask the group by flipping this; routers skip ineligible
        # groups (see serving/router.py).
        self.eligible = True
        # Transient straggle multiplier owned by "slow" control events:
        # every stage unit (and the service predictions routers probe)
        # runs `slow` x longer while a window is open.  Exactly 1.0
        # outside windows; the walks guard on `!= 1.0` so fault-free
        # runs evaluate the identical float expressions.
        self.slow = 1.0
        self.dev_free = [0.0] * num_devices
        self.link_free = [0.0] * num_devices
        self.dev_busy = [0.0] * num_devices
        self.link_busy = [0.0] * num_devices
        self._max_free = 0.0            # == max(dev_free + link_free)
        self.completed = 0
        self.switches = 0
        self._finish: List[float] = []          # heap of inflight finishes

    # -------------------------------------------------------------- #
    def predicted_service(self, req: ClusterRequest,
                          policy: Optional[str] = None) -> float:
        """Unqueued execution latency of ``req`` on this replica."""
        sp, so = req.scale_prompt, req.scale_output
        if self.slow != 1.0:
            sp *= self.slow
            so *= self.slow
        if self.reference:
            units = self.unit_sets[policy or self.policy]
            return sum(u.scaled(sp, so) for u in units)
        return self.programs[policy or self.policy].service(sp, so)

    def backlog(self, now: float) -> float:
        """Seconds until the most-loaded resource drains (queue delay
        proxy: a new request cannot finish before its bottleneck
        resource frees up).  The fast path keeps a running maximum —
        free timelines only ever move forward — so a router probe is
        O(1) instead of rescanning both free-lists."""
        if self.reference:
            worst = max(max(self.dev_free), max(self.link_free))
        else:
            worst = self._max_free
        return max(0.0, worst - now)

    def queue_len(self, now: float) -> int:
        while self._finish and self._finish[0] <= now:
            heapq.heappop(self._finish)
        return len(self._finish)

    def predicted_phase_service(self, req: ClusterRequest,
                                phase: str,
                                policy: Optional[str] = None) -> float:
        """Unqueued latency of one phase of ``req`` on this replica.

        Phase filtering reuses each unit's decode fraction: the prefill
        phase runs the unit at ``scale_output=0`` and the decode phase at
        ``scale_prompt=0``, so prefill + decode == the colocated total.
        """
        sp, so = _phase_scales(req, phase)
        if self.slow != 1.0:
            sp *= self.slow
            so *= self.slow
        if self.reference:
            units = self.unit_sets[policy or self.policy]
            return sum(u.scaled(sp, so) for u in units)
        return self.programs[policy or self.policy].service(sp, so)

    # -------------------------------------------------------------- #
    def submit(self, req: ClusterRequest,
               events: Optional[List[Tuple]] = None, *,
               phase: str = "both",
               not_before: float = 0.0) -> float:
        """Schedule the request (or one phase of it); returns its finish
        time.  ``phase`` selects which share of each stage unit runs
        here: "both" (colocated), "prefill" (decode share zeroed) or
        "decode" (prefill share zeroed — a decode_only admission that
        starts from imported KV state).  ``not_before`` delays the first
        unit (KV-transfer arrival, rate-matched admission)."""
        return self._run_units(req, events, phase, not_before)[0]

    def _run_units(self, req: ClusterRequest,
                   events: Optional[List[Tuple]] = None,
                   phase: str = "both",
                   not_before: float = 0.0,
                   agg: Optional[EventAggregate] = None
                   ) -> Tuple[float, float, float]:
        """Walk the request's stage units; returns ``(finish,
        prefill_end, start)`` where ``prefill_end`` is when the last
        unit with any prefill share completes (the first token's
        timestamp for a colocated or prefill-phase submission) and
        ``start`` is when the first unit actually began (after
        queueing) — the anchor chunked KV streaming interpolates
        production progress from."""
        if self.reference:
            return self._run_units_reference(req, events, phase,
                                             not_before, agg)
        return self._run_units_program(req, events, phase,
                                       not_before, agg)

    def _run_units_program(self, req: ClusterRequest,
                           events: Optional[List[Tuple]],
                           phase: str, not_before: float,
                           agg: Optional[EventAggregate]
                           ) -> Tuple[float, float, float]:
        """Fast walk over the compiled program.  Bit-identical to
        ``_run_units_reference``: every arithmetic expression below is
        the same IEEE float64 expression the reference walk evaluates
        per unit (the parity suite asserts equal event logs)."""
        sp, so = _phase_scales(req, phase)
        if self.slow != 1.0:        # open straggle window
            sp *= self.slow
            so *= self.slow
        prog = self.programs[self.policy]
        if prog.n >= _VECTOR_WALK_MIN:
            wp = prog.walk_plan(phase)
            if wp.n >= _VECTOR_WALK_MIN:
                return self._run_units_vector(req, events, phase,
                                              not_before, agg, wp,
                                              sp, so)
        durs = prog.durations(sp, so)
        t = req.arrival
        if not_before > t:
            t = not_before
        prefill_end = t
        start_t: Optional[float] = None
        dev_free = self.dev_free
        link_free = self.link_free
        dev_busy = self.dev_busy
        link_busy = self.link_busy
        idx = self.idx
        rid = req.rid
        append = events.append if events is not None else None
        agg_add = agg.add if agg is not None else None
        for step, dur in zip(prog.steps, durs):
            if dur <= 0.0:
                continue            # unit fully belongs to the other phase
            kind, dev, pre_share, u_dur, u_frac, u_omf = step
            if kind == 0:
                start = link_free[dev]
                if t > start:
                    start = t
                end = start + dur
                link_free[dev] = end
                link_busy[dev] += dur
            else:
                start = dev_free[dev]
                if t > start:
                    start = t
                end = start + dur
                dev_free[dev] = end
                dev_busy[dev] += dur
            if start_t is None:
                start_t = start
            if append is not None:
                append((idx, rid, kind, dev, start, end))
            elif agg_add is not None:
                agg_add(idx, kind, dev, start, end)
            t = end
            if pre_share:
                # the unit's prefill share finishes first; its decode
                # share (repeated decode iterations) follows — a
                # request's own decode work cannot precede its first
                # token, so TTFT charges only the prefill share here
                prefill_end = start + u_dur * (u_frac * 0.0
                                               + u_omf * sp)
        if start_t is not None and t > self._max_free:
            # ends are monotone along the walk, so the final t is the
            # max the free timelines moved to
            self._max_free = t
        if self.track_inflight:
            heapq.heappush(self._finish, t)
        if phase != "prefill":      # the decode side owns completion
            self.completed += 1
        return t, prefill_end, (start_t if start_t is not None else t)

    def _run_units_vector(self, req: ClusterRequest,
                          events: Optional[List[Tuple]],
                          phase: str, not_before: float,
                          agg: Optional[EventAggregate],
                          wp: "_WalkPlan", sp: float, so: float
                          ) -> Tuple[float, float, float]:
        """Segmented-cumsum walk for long programs: the per-unit loop
        collapses to one seeded ``np.cumsum`` per resource segment (see
        ``_WalkPlan``); busy cells and aggregates accumulate through
        seeded cumsums too, so every value matches the per-unit walk
        bit-for-bit while the Python work scales with the number of
        distinct resources, not units."""
        durs = wp.dur * (wp.frac * so + wp.omf * sp)
        t = req.arrival
        if not_before > t:
            t = not_before
        t0v = t
        A = wp.n
        bounds = wp.seg_bounds
        dev_free = self.dev_free
        link_free = self.link_free
        ends = np.empty(A)
        head_starts: List[float] = []
        for j, (k, d) in enumerate(wp.seg_res):
            a = bounds[j]
            b = bounds[j + 1]
            free = link_free[d] if k == 0 else dev_free[d]
            start = free if free > t else t
            head_starts.append(start)
            seg = np.cumsum(np.concatenate(([start], durs[a:b])))
            ends[a:b] = seg[1:]
            t = float(seg[-1])
        starts = np.empty(A)
        starts[1:] = ends[:-1]
        for j, p in enumerate(bounds[:-1]):
            starts[p] = head_starts[j]
        dev_busy = self.dev_busy
        link_busy = self.link_busy
        for k, d, pos, last, cnt in wp.res_groups:
            end_last = float(ends[last])
            if k == 0:
                link_free[d] = end_last
                link_busy[d] = float(np.cumsum(np.concatenate(
                    ([link_busy[d]], durs[pos])))[-1])
            else:
                dev_free[d] = end_last
                dev_busy[d] = float(np.cumsum(np.concatenate(
                    ([dev_busy[d]], durs[pos])))[-1])
        if events is not None:
            events.extend(zip(repeat(self.idx), repeat(req.rid),
                              wp.kinds, wp.devs,
                              starts.tolist(), ends.tolist()))
        elif agg is not None:
            spans = ends - starts
            counts = agg.counts
            seconds = agg.seconds
            ridx = self.idx
            for k, d, pos, last, cnt in wp.res_groups:
                key = (ridx, k, d)
                if key in counts:
                    counts[key] += cnt
                    seed = seconds[key]
                else:
                    counts[key] = cnt
                    seed = 0.0
                seconds[key] = float(np.cumsum(np.concatenate(
                    ([seed], spans[pos])))[-1])
        if t > self._max_free:
            self._max_free = t
        if self.track_inflight:
            heapq.heappush(self._finish, t)
        if phase != "prefill":      # the decode side owns completion
            self.completed += 1
        if wp.pe_pos >= 0:
            prefill_end = float(starts[wp.pe_pos]) + wp.pe_dur * (
                wp.pe_frac * 0.0 + wp.pe_omf * sp)
        else:
            prefill_end = t0v
        return t, prefill_end, head_starts[0]

    def _run_units_reference(self, req: ClusterRequest,
                             events: Optional[List[Tuple]],
                             phase: str, not_before: float,
                             agg: Optional[EventAggregate] = None
                             ) -> Tuple[float, float, float]:
        """The historical per-unit object walk (the ``call_reference``
        idiom): kept verbatim as the oracle the fast path must reproduce
        bit-identically."""
        sp, so = _phase_scales(req, phase)
        if self.slow != 1.0:        # open straggle window
            sp *= self.slow
            so *= self.slow
        t = max(req.arrival, not_before)
        prefill_end = t
        start_t: Optional[float] = None
        for u in self.unit_sets[self.policy]:
            dur = u.scaled(sp, so)
            if dur <= 0.0:
                continue            # unit fully belongs to the other phase
            free = self.link_free if u.kind == 0 else self.dev_free
            busy = self.link_busy if u.kind == 0 else self.dev_busy
            start = max(t, free[u.device])
            if start_t is None:
                start_t = start
            end = start + dur
            free[u.device] = end
            busy[u.device] += dur
            if events is not None:
                events.append((self.idx, req.rid, u.kind, u.device,
                               start, end))
            elif agg is not None:
                agg.add(self.idx, u.kind, u.device, start, end)
            t = end
            if u.decode_frac < 1.0:
                prefill_end = start + u.scaled(sp, 0.0)
        if start_t is not None and t > self._max_free:
            self._max_free = t
        heapq.heappush(self._finish, t)
        if phase != "prefill":      # the decode side owns completion
            self.completed += 1
        return t, prefill_end, (start_t if start_t is not None else t)

    def maybe_switch(self, now: float) -> bool:
        """Adopt the monitor's policy; a switch stalls all workers for
        ``switch_stall`` at the next iteration boundary (modeled as a
        bump of every resource timeline)."""
        if self.monitor is None or self.monitor.policy == self.policy:
            return False
        if self.monitor.policy not in self.unit_sets:
            return False
        self.policy = self.monitor.policy
        stall = self.monitor.cfg.switch_stall
        for free in (self.dev_free, self.link_free):
            for d in range(self.num_devices):
                free[d] = max(free[d], now) + stall
        self._max_free = max(max(self.dev_free), max(self.link_free))
        self.switches += 1
        return True


@dataclasses.dataclass
class ClusterResult:
    makespan: float
    completed: int
    latencies: List[float]              # served requests, arrival order
    assignments: List[int]              # replica per request (-1 = shed)
    per_replica_completed: List[int]
    per_replica_busy: List[float]       # summed compute-busy seconds
    switches: int
    events: List[Tuple]                 # (replica, rid, kind, dev, t0, t1)
    price_rate: float = 0.0             # $/hr of all device groups
    ttfts: List[float] = dataclasses.field(default_factory=list)
    shed: int = 0                       # admission-control rejections
    slo_ok: int = 0                     # served within their SLO
    # phase-split extras (zero for colocated routing)
    transfers: int = 0                  # cross-replica KV handoffs
    transfer_seconds: float = 0.0       # summed KV time on the fabric
    peak_kv_bytes: float = 0.0          # max KV resident awaiting decode
    transfers_avoided: int = 0          # session-affine reuse of resident
    #                                     decode state (no re-transfer)
    # deployment-elasticity extras (zero without a control timeline)
    rerouted: int = 0                   # in-flight requests re-routed off
    #                                     a failed group (recovered)
    dropped: int = 0                    # accepted requests lost because
    #                                     no eligible group remained
    # fault-injection extras (zero without a ``faults=`` plan)
    kv_retries: int = 0                 # failed KV chunk transfers that
    #                                     were retried with backoff
    kv_refills: int = 0                 # aborted handoffs re-prefilled
    #                                     on the decode group
    recovered: int = 0                  # crash victims restored from a
    #                                     checkpoint (vs replayed fresh)
    # events="agg" replaces the tuple log with this reduction (None in
    # "full" mode; both None under events=None)
    event_agg: Optional[EventAggregate] = None
    # paged-KV occupancy extras (zero without a ``kv=`` model)
    kv_hits: int = 0                    # follow-up turns that reused a
    #                                     resident session's KV prefix
    kv_hit_tokens: float = 0.0          # prompt tokens NOT re-prefilled
    kv_delayed: int = 0                 # admissions delayed by block
    #                                     pressure
    kv_evictions: int = 0               # resident sessions evicted (LRU)
    peak_kv_blocks: Tuple[int, ...] = ()    # per-group peak block use
    # contended-fabric extras (zero without a ``fabric=`` topology)
    fabric_wait_seconds: float = 0.0    # urgent KV queueing behind other
    #                                     traffic on shared channels
    fabric_bulk_bytes: float = 0.0      # completed bulk-class bytes
    fabric_bulk_seconds: float = 0.0    # channel seconds bulk occupied
    ckpt_shipped: int = 0               # checkpoint snapshots that fully
    #                                     crossed to the host store

    @property
    def throughput(self) -> float:
        return self.completed / max(self.makespan, 1e-12)

    @property
    def goodput(self) -> float:
        """Served-within-SLO requests per second (== throughput when no
        request carries an SLO)."""
        return self.slo_ok / max(self.makespan, 1e-12)

    @property
    def mean_latency(self) -> float:
        return sum(self.latencies) / max(len(self.latencies), 1)

    @property
    def mean_ttft(self) -> float:
        return sum(self.ttfts) / max(len(self.ttfts), 1)

    def p(self, q: float) -> float:
        xs = sorted(self.latencies)
        if not xs:
            return 0.0
        return xs[min(int(q * len(xs)), len(xs) - 1)]

    @property
    def cost_efficiency(self) -> float:
        """Requests per dollar ( throughput / $-rate ), paper Table III's
        cost-efficiency axis generalized to replica groups."""
        return self.throughput * 3600.0 / max(self.price_rate, 1e-12)


def _meets_slo(req: ClusterRequest, lat: float, ttft: float) -> bool:
    """Both SLO components must hold (absent components always hold)."""
    return ((req.slo is None or lat <= req.slo)
            and (req.slo_ttft is None or ttft <= req.slo_ttft))


def simulate_cluster(replicas: Sequence[ReplicaModel],
                     trace: Sequence[ClusterRequest],
                     route_fn) -> ClusterResult:
    """Composed cluster simulation under ``route_fn``.

    ``route_fn(req, replicas, now) -> replica index`` is consulted once
    per request at its arrival instant; a negative index sheds the
    request (admission control — it never touches a replica and counts
    toward neither throughput nor goodput).  Requests must be sorted by
    arrival.  Deterministic: identical (trace, plans, router) produce a
    bit-identical event log and makespan.

    Thin shim over :func:`simulate_deployment` (no phase splitting, no
    control timeline) — event logs are bit-identical to the historical
    standalone loop.
    """
    return simulate_deployment(replicas, trace, route_fn)


# --------------------------------------------------------------------- #
# Phase-split (prefill/decode) cluster simulation
# --------------------------------------------------------------------- #
#
# A request's prefill and decode phases can run on DIFFERENT replica
# groups with an explicit KV-transfer edge between them: prefill fills
# the KV/recurrent state on the prefill group, the state crosses the
# inter-replica fabric (``Interconnect``), and the decode group starts a
# decode_only session from the imported state.  The transfer is a
# first-class DES event (kind 2) and its time lands in TTFT — the first
# token cannot be streamed from the decode group before the state
# arrives.  This is the paper's headline heterogeneous scenario:
# prefill on the compute-rich device pool, decode on the cheap
# bandwidth-rich one.

#: event-log kind for a cross-replica KV transfer; the tuple is
#: (dst_replica, rid, KV_TRANSFER, src_replica, t_start, t_end).
KV_TRANSFER = 2

#: event-log kind for a bulk fabric transfer (checkpoint ship, session
#: migration); the tuple is (dst_group_or_-1_for_host, rid, FABRIC_BULK,
#: src_group, t_start, t_end).  Only emitted with ``fabric=`` set.
FABRIC_BULK = 3

#: pseudo destination group for the host-side checkpoint store
#: (mirrors serving.fabric.HOST; core cannot import serving).
FABRIC_HOST = -1


def _stream_kv(ic: Interconnect, nbytes: float, src: int, dst: int,
               pre_start: float, pre_fin: float, chunks: int,
               chan=None) -> Tuple[float, List[Tuple[float, float]], float]:
    """KV-arrival time of a (possibly chunked) prefill→decode handoff.

    Returns ``(kv_at, fabric_events, fabric_busy_seconds)``.

    ``chunks <= 1`` is the serial edge: one transfer starting at
    ``pre_fin`` (the original serial semantics, bit-identical).  With ``chunks > 1``
    the prefill produces KV progressively — chunk c becomes available
    at the c/n point of the prefill span — and each chunk's transfer
    (``base_latency`` amortized per chunk) starts as soon as both the
    chunk and the fabric are ready, overlapping communication with the
    remaining prefill compute.  Only the tail that outlives the prefill
    lands in TTFT, so an optimal chunk size exists: large chunks defer
    too many bytes past ``pre_fin``, tiny chunks drown in per-transfer
    ``base_latency``.

    The sender knows every unit duration up front (simulated time), so
    it falls back to the serial schedule whenever chunking would lose —
    streamed ``kv_at`` is therefore NEVER later than the serial edge
    (property-tested).

    With ``chan`` (a fabric :class:`~repro_torch.serving.fabric.ChannelState`)
    the transfer is *channel-queued*: bandwidth/latency come from the
    shared channel, no attempt starts before the channel's urgent head,
    and the chosen schedule is committed to the channel so later
    transfers (and bulk traffic) pay for it.  The never-later property
    then holds against the serial edge *on the same loaded channel*.
    ``chan=None`` keeps the historical point-to-point math bit-exact.
    """
    if chan is not None:
        return _stream_kv_chan(chan, nbytes, pre_start, pre_fin, chunks)
    serial_dur = ic.transfer_time(nbytes, src, dst)
    serial = (pre_fin + serial_dur, [(pre_fin, pre_fin + serial_dur)],
              serial_dur)
    span = pre_fin - pre_start
    if chunks <= 1 or nbytes <= 0.0 or src == dst or span <= 0.0:
        return serial
    per = ic.base_latency + (nbytes / chunks) / ic.bandwidth(src, dst)
    done = pre_start
    evs: List[Tuple[float, float]] = []
    for c in range(1, chunks + 1):
        ready = pre_start + span * c / chunks
        s = max(ready, done)
        done = s + per
        evs.append((s, done))
    if done <= serial[0]:
        return done, evs, per * chunks
    return serial


def _stream_kv_chan(chan, nbytes: float, pre_start: float, pre_fin: float,
                    chunks: int
                    ) -> Tuple[float, List[Tuple[float, float]], float]:
    """Channel-queued :func:`_stream_kv`: same chunk logic, but every
    attempt also waits for the shared channel's urgent head, and the
    winning schedule is committed so the contention is visible to every
    later transfer on the channel."""
    if nbytes <= 0.0:
        return pre_fin, [(pre_fin, pre_fin)], 0.0
    uf0 = chan.head()
    serial_dur = chan.duration(nbytes)
    serial_s = max(pre_fin, uf0)
    serial = (serial_s + serial_dur,
              [(serial_s, serial_s + serial_dur)], serial_dur)
    span = pre_fin - pre_start
    if chunks <= 1 or span <= 0.0:
        chan.commit_urgent(serial[1], pre_fin, nbytes)
        return serial
    per = chan.latency + (nbytes / chunks) / chan.bw
    done = max(pre_start, uf0)
    evs: List[Tuple[float, float]] = []
    for c in range(1, chunks + 1):
        ready = pre_start + span * c / chunks
        s = max(ready, done)
        done = s + per
        evs.append((s, done))
    if done <= serial[0]:
        chan.commit_urgent(evs, pre_start + span / chunks, nbytes)
        return done, evs, per * chunks
    chan.commit_urgent(serial[1], pre_fin, nbytes)
    return serial


def _stream_kv_flaky(ic: Interconnect, nbytes: float, src: int, dst: int,
                     pre_start: float, pre_fin: float, chunks: int, link,
                     chan=None) -> Tuple[Optional[float],
                                         List[Tuple[float, float]], float,
                                         int]:
    """Fault-injected variant of :func:`_stream_kv`.

    ``link`` (see serving/faults.FaultState.link) carries the per-link
    failure probability ``p``, a seeded ``rng``, and the retry policy
    (``max_retries``, ``backoff``, ``deadline``).  Each chunk transfer
    fails independently with probability ``p``; a failed attempt still
    occupies the fabric for the full chunk time (the bytes moved, the
    checksum did not) and is retried after exponential backoff.  When
    a chunk exhausts its retries, or a retry would start past the
    transfer deadline (``pre_fin + deadline``), the handoff ABORTS:
    ``kv_at`` comes back ``None`` and the caller re-prefills on the
    decode group.  Returns ``(kv_at, events, busy_seconds, retries)``.

    With zero failure draws the schedule — including the never-later
    serial fallback — is bit-identical to :func:`_stream_kv`, and a
    fault-free transfer never aborts regardless of the deadline.

    With ``chan`` the transfer is channel-queued exactly as in
    :func:`_stream_kv_chan`: attempts (including failed ones — the
    bytes moved, the checksum did not) wait for and occupy the shared
    channel, and whatever schedule results is committed to it.
    """
    if nbytes <= 0.0 or src == dst:
        kv_at, evs, busy = _stream_kv(ic, nbytes, src, dst, pre_start,
                                      pre_fin, chunks, chan)
        return kv_at, evs, busy, 0
    span = pre_fin - pre_start
    streamed = chunks > 1 and span > 0.0
    n = chunks if streamed else 1
    if chan is not None:
        per = chan.latency + (nbytes / n) / chan.bw
    elif streamed:
        per = ic.base_latency + (nbytes / n) / ic.bandwidth(src, dst)
    else:
        per = ic.transfer_time(nbytes, src, dst)
    deadline = pre_fin + link.deadline
    rng = link.rng
    done = pre_start if streamed else pre_fin
    uf0 = 0.0
    if chan is not None:
        uf0 = chan.head()
        done = max(done, uf0)
    r0 = pre_start + span / n if streamed else pre_fin

    def _commit(spans: List[Tuple[float, float]]) -> None:
        if chan is not None and spans:
            chan.commit_urgent(spans, r0, nbytes)

    evs: List[Tuple[float, float]] = []
    busy = 0.0
    retries = 0
    failed_any = False
    for c in range(1, n + 1):
        ready = pre_start + span * c / n if streamed else pre_fin
        s = max(ready, done)
        attempt = 0
        while True:
            if failed_any and s + per > deadline:
                _commit(evs)
                return None, evs, busy, retries
            end = s + per
            evs.append((s, end))
            busy += per
            if rng.random() >= link.p:
                done = end
                break
            failed_any = True
            retries += 1
            attempt += 1
            if attempt > link.max_retries:
                _commit(evs)
                return None, evs, busy, retries
            s = end + link.backoff * (2.0 ** (attempt - 1))
    if not failed_any and streamed:
        if chan is not None:
            serial_dur = chan.duration(nbytes)
            serial_s = max(pre_fin, uf0)
        else:
            serial_dur = ic.transfer_time(nbytes, src, dst)
            serial_s = pre_fin
        if done > serial_s + serial_dur:
            serial_evs = [(serial_s, serial_s + serial_dur)]
            if chan is not None:
                chan.commit_urgent(serial_evs, pre_fin, nbytes)
            return serial_s + serial_dur, serial_evs, serial_dur, 0
    _commit(evs)
    return done, evs, busy, retries


def simulate_cluster_pd(replicas: Sequence[ReplicaModel],
                        trace: Sequence[ClusterRequest],
                        route_fn,
                        interconnect: Optional[Interconnect] = None,
                        kv_chunks: int = 1) -> ClusterResult:
    """Cluster simulation where the router may split phases.

    ``route_fn(req, replicas, now)`` returns either a plain replica
    index (colocated; negative = shed) or a 3-tuple ``(prefill_idx,
    decode_idx, admit_at)`` — ``admit_at >= now`` is the rate-matched
    prefill admission time (see router.PDRouter).  Deterministic like
    :func:`simulate_cluster`.

    ``kv_chunks > 1`` enables OVERLAPPED KV streaming: the single
    kind-2 transfer edge is replaced by per-chunk transfer events that
    run concurrently with the remaining prefill units (see
    :func:`_stream_kv`), so only the transfer tail lands in TTFT.
    Routers exposing a ``transfers_avoided`` counter (PDRouter
    session affinity) have the per-run delta reported in the result.

    Thin shim over :func:`simulate_deployment` (no control timeline) —
    event logs are bit-identical to the historical standalone loop.
    """
    return simulate_deployment(replicas, trace, route_fn,
                               interconnect=interconnect,
                               kv_chunks=kv_chunks)


# --------------------------------------------------------------------- #
# Unified deployment simulation: routing + phase split + elasticity
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class ControlEvent:
    """One entry of a deployment's elasticity timeline.

    ``kind``:
      * ``"up"``   — the group finishes warm-up at ``time`` and becomes
        routable (a group with a pending "up" starts ineligible),
      * ``"down"`` — graceful drain from ``time``: the router stops
        sending new requests there, resident work finishes normally,
      * ``"fail"`` — hard kill at ``time``: masked like "down", AND
        every in-flight request whose completion still depends on the
        group is re-routed across the survivors from ``time``,
      * ``"slow"`` — transient straggle: from ``time`` the group's
        stage units (and its service predictions, so routers observe
        the slowdown) are inflated by ``factor``; a later "slow" with
        ``factor=1.0`` ends the window.  Does not touch eligibility.

    An "up" whose group has an earlier "fail"/"down" in the SAME static
    timeline is a RECOVERY (crash-and-return): the group starts
    eligible and comes back at ``time``.  Only a group whose FIRST
    event is "up" starts masked (warm-up pending) — see
    :func:`validate_timeline`.
    """
    time: float
    kind: str                   # "up" | "down" | "fail" | "slow"
    group: int
    factor: float = 1.0         # service-time multiplier ("slow" only)

    def __post_init__(self):
        if self.kind not in ("up", "down", "fail", "slow"):
            raise ValueError(f"unknown control-event kind {self.kind!r}")
        if self.factor <= 0.0:
            raise ValueError(f"control-event factor must be > 0, "
                             f"got {self.factor!r}")


#: fail/down before up at the same instant: a group swapped in exactly
#: when another dies must not absorb the dead group's in-flight work
#: before its own warm-up event has fired.  "slow" applies after any
#: eligibility flip at the same instant.
_EVENT_ORDER = {"fail": 0, "down": 1, "up": 2, "slow": 3}


def validate_timeline(events: Sequence[ControlEvent], n_groups: int,
                      start_ineligible: Sequence[int] = ()) -> set:
    """Validate a STATIC control timeline; returns the groups that
    must start masked.

    Rejects contradictory timelines instead of silently replaying
    them: a "fail"/"down" for a group that is already down (duplicate
    fails, fail-after-down) and an "up" for a group that is already
    eligible both raise ``ValueError``.  A group whose FIRST
    eligibility event is "up" is warming up and starts masked; an "up"
    that FOLLOWS a "fail"/"down" is a recovery and must not mask the
    group from t=0 (the historical setup loop masked on ANY "up",
    which made crash-and-return timelines serve nothing before the
    crash).  "slow" events only have their group index checked.

    Controller-injected runtime events are not validated here — the
    controller reacts to live state the static timeline cannot see.
    """
    ordered = sorted(events, key=lambda e: (e.time, _EVENT_ORDER[e.kind],
                                            e.group))
    reserve = {int(g) for g in start_ineligible}
    state: Dict[int, bool] = {}
    start_masked: set = set()
    for e in ordered:
        if e.group < 0 or e.group >= n_groups:
            raise ValueError(f"control event {e} names group {e.group}; "
                             f"deployment has {n_groups}")
        if e.kind == "slow":
            continue
        if e.group not in state:
            if e.kind == "up" and e.group not in reserve:
                start_masked.add(e.group)
                state[e.group] = False
            else:
                # reserve groups already start masked; their
                # activation "up" needs no extra warm-up masking
                state[e.group] = e.group not in reserve
        if e.kind == "up":
            if state[e.group]:
                raise ValueError(
                    f"contradictory timeline: 'up' at t={e.time:g} for "
                    f"group {e.group}, which is already eligible")
            state[e.group] = True
        else:
            if not state[e.group]:
                raise ValueError(
                    f"contradictory timeline: {e.kind!r} at "
                    f"t={e.time:g} for group {e.group}, which is "
                    f"already down")
            state[e.group] = False
    return start_masked


@dataclasses.dataclass(frozen=True)
class ControlSignals:
    """Windowed cluster state handed to a deployment controller at each
    decision epoch of :func:`simulate_deployment`.

    Counters cover the epoch that just ended: ``arrivals`` fresh
    requests, ``shed`` of them rejected at admission, ``slo_miss`` of
    them admitted on a schedule that already misses an SLO component
    (the DES commits whole schedules at routing time, so the miss is
    known immediately).  Per-group vectors are indexed like the
    deployment's groups: ``backlog``/``queue_len`` are instantaneous at
    ``now``; ``util`` is the device-busy seconds *committed* during the
    epoch over the epoch's device-seconds, clamped to [0, 1] (committed
    work is the DES's analogue of measured occupancy); ``eligible`` is
    the routability mask.
    """
    now: float
    interval: float
    arrivals: int
    shed: int
    slo_miss: int
    backlog: Tuple[float, ...]
    queue_len: Tuple[int, ...]
    util: Tuple[float, ...]
    eligible: Tuple[bool, ...]
    # per-group KV-block utilization at ``now`` (empty without a
    # ``kv=`` occupancy model — the default keeps old callers intact)
    kv_util: Tuple[float, ...] = ()
    # per-group service-time accounting over the epoch: ``service_obs``
    # sums the service seconds the DES committed (including any straggle
    # inflation), ``service_model`` the same work priced by the group's
    # un-degraded profile.  Their ratio is the observable a straggle
    # detector thresholds on.  Empty tuples for old callers.
    service_obs: Tuple[float, ...] = ()
    service_model: Tuple[float, ...] = ()


# --------------------------------------------------------------------- #
# Paged-KV occupancy: the DES mirror of serving/kvpool.PagedKvCache
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class _KvGroup:
    """One group's block-pool state inside :class:`KvPoolModel`."""
    capacity: int
    free: int
    # (finish, seq, blocks, session, tokens) — sessions still decoding
    active: List[Tuple] = dataclasses.field(default_factory=list)
    # session -> [blocks, tokens, last_use]; insertion order == LRU
    resident: Dict = dataclasses.field(default_factory=dict)
    # rid -> (blocks, tokens) between admit() and release()
    pending: Dict[int, Tuple[int, int]] = \
        dataclasses.field(default_factory=dict)
    peak: int = 0


class KvPoolModel:
    """Per-group paged-KV occupancy for the DES.

    Each group owns ``pool_blocks`` blocks of ``block_tokens`` tokens.
    An admitted request holds ``ceil((prompt + output) / block_tokens)``
    blocks from admission to completion; a completed SESSION stays
    resident (cache retained) until block pressure evicts it LRU.
    Three observable effects feed the serving loop:

      * **prefix/session cache hits** — a follow-up turn routed to the
        group where its session is resident skips re-prefilling the
        cached prefix (``scale_prompt`` shrinks): the measured benefit
        side of decode-session affinity;
      * **delayed admission** — out of free blocks, a request waits for
        the earliest active finish (``kv_delayed`` counts these);
      * **memory-pressure signal** — per-group block utilization
        reaches routers (``kv_util_fn`` penalty) and controllers
        (:class:`ControlSignals.kv_util`).

    ``base_prompt``/``base_output`` convert request scales back to
    token counts (the inverse of ``HeteroCluster.to_cluster_request``).
    Deterministic, and strictly opt-in: ``simulate_deployment(kv=None)``
    is bit-identical to not having the model at all.
    """

    def __init__(self, block_tokens: int = 64, pool_blocks: int = 1024,
                 *, base_prompt: int = 1024, base_output: int = 256):
        assert block_tokens >= 1 and pool_blocks >= 1
        assert base_prompt >= 1 and base_output >= 1
        self.block_tokens = block_tokens
        self.pool_blocks = pool_blocks
        self.base_prompt = base_prompt
        self.base_output = base_output
        self._g: List[_KvGroup] = []
        self._seq = 0
        self.hits = 0
        self.hit_tokens = 0.0
        self.delayed = 0
        self.evictions = 0

    def bind(self, n_groups: int) -> "KvPoolModel":
        """Fresh per-group state for one simulation run (idempotent —
        a model instance can be reused across runs)."""
        self._g = [_KvGroup(self.pool_blocks, self.pool_blocks)
                   for _ in range(n_groups)]
        self._seq = 0
        self.hits = 0
        self.hit_tokens = 0.0
        self.delayed = 0
        self.evictions = 0
        return self

    # -------------------------------------------------------------- #
    def prompt_tokens(self, req: ClusterRequest) -> int:
        return max(1, round(req.scale_prompt * self.base_prompt))

    def _blocks(self, tokens: int) -> int:
        return max(1, -(-tokens // self.block_tokens))

    def _expire(self, st: _KvGroup, t: float) -> None:
        """Finished actives become resident (cache retained); a
        sessionless request's blocks free immediately."""
        while st.active and st.active[0][0] <= t:
            fin, _, blocks, session, tokens = heapq.heappop(st.active)
            if session is None:
                st.free += blocks
                continue
            old = st.resident.pop(session, None)
            if old is not None:
                st.free += old[0]
            st.resident[session] = [blocks, tokens, fin]

    # -------------------------------------------------------------- #
    def cached(self, g: int, session, t: float) -> int:
        """Tokens of ``session``'s KV resident on group ``g`` at ``t``
        (0 when absent).  Touches the entry's LRU position."""
        st = self._g[g]
        self._expire(st, t)
        ent = st.resident.pop(session, None)
        if ent is None:
            return 0
        ent[2] = t
        st.resident[session] = ent      # reinsert == move to MRU end
        return ent[1]

    def admit(self, g: int, req: ClusterRequest, at: float) -> float:
        """Reserve blocks for ``req`` on group ``g``; returns the
        admission time (``>= at`` — later when the request had to wait
        for blocks).  Pressure order: evict idle resident sessions
        LRU, then wait for the earliest active finish."""
        st = self._g[g]
        t = at
        self._expire(st, t)
        p = self.prompt_tokens(req)
        o = max(1, round(req.scale_output * self.base_output))
        need = min(self._blocks(p + o), st.capacity)
        if req.session is not None:
            # a resident prior turn re-admits: its blocks roll into
            # the new (accumulated-context) reservation
            old = st.resident.pop(req.session, None)
            if old is not None:
                st.free += old[0]
        delayed = False
        while st.free < need:
            if st.resident:
                lru = next(iter(st.resident))
                st.free += st.resident.pop(lru)[0]
                self.evictions += 1
                continue
            fin, _, blocks, _, _ = heapq.heappop(st.active)
            st.free += blocks
            if fin > t:
                t = fin
                delayed = True
        st.free -= need
        st.pending[req.rid] = (need, p + o)
        st.peak = max(st.peak, st.capacity - st.free)
        if delayed:
            self.delayed += 1
        return t

    def release(self, g: int, req: ClusterRequest,
                finish: float) -> None:
        """Hand the request's blocks to the finish heap: they free (or
        turn resident) once the decode completes at ``finish``."""
        st = self._g[g]
        ent = st.pending.pop(req.rid, None)
        if ent is None:
            return
        self._seq += 1
        heapq.heappush(st.active,
                       (finish, self._seq, ent[0], req.session, ent[1]))

    def clear(self, g: int) -> None:
        """Hard reset one group (its pool died with a failed group)."""
        self._g[g] = _KvGroup(self.pool_blocks, self.pool_blocks)

    # -------------------------------------------------------------- #
    def util_at(self, g: int, t: float) -> float:
        st = self._g[g]
        self._expire(st, t)
        return (st.capacity - st.free) / st.capacity

    def util_vec(self, t: float) -> Tuple[float, ...]:
        return tuple(self.util_at(g, t) for g in range(len(self._g)))

    def peaks(self) -> Tuple[int, ...]:
        return tuple(st.peak for st in self._g)


def simulate_deployment(replicas: Sequence[ReplicaModel],
                        trace: Sequence[ClusterRequest],
                        route_fn,
                        interconnect: Optional[Interconnect] = None,
                        kv_chunks: int = 1,
                        timeline: Sequence[ControlEvent] = (),
                        controller=None,
                        start_ineligible: Sequence[int] = (),
                        events: Optional[str] = "full",
                        kv: Optional[KvPoolModel] = None,
                        faults=None,
                        fabric=None) -> ClusterResult:
    """One DES entry point behind every serving surface.

    Subsumes :func:`simulate_cluster` (colocated routing) and
    :func:`simulate_cluster_pd` (phase-split routing with a KV-transfer
    edge): ``route_fn`` may return a plain index, ``-1``/``None``
    (shed), or a ``(prefill_idx, decode_idx, admit_at)`` tuple.  With
    an empty ``timeline`` the event log is bit-identical to the
    historical per-entry-point loops.

    ``timeline`` adds deployment elasticity (see :class:`ControlEvent`):
    groups can warm up, drain, or fail mid-trace.  Masking is the same
    mechanism for all three — the event flips ``ReplicaModel.eligible``
    and every router skips ineligible groups.  On a failure, in-flight
    requests whose completion still depended on the dead group (decode
    resident there, or KV not yet landed from a dead prefill source)
    are re-submitted through ``route_fn`` at the failure instant; their
    latency/TTFT then count from the ORIGINAL arrival (the client's
    view of a retried request).  Nothing is rolled back from any
    resource timeline: work a victim already performed is wasted (as
    on real machines), and a victim's PRE-BOOKED future work on
    surviving groups (e.g. the decode interval reserved for KV that a
    dead prefill source will never deliver) stays reserved too — the
    DES commits whole schedules at routing time and does not model
    cancellation, so survivors look conservatively busier during a
    failure than a cancelling runtime would.  A victim with no
    eligible group left to re-route to is counted in ``dropped``
    (accepted, then lost); a FRESH arrival the router rejects — for
    admission control or because no eligible group remains — counts in
    ``shed`` as always (it was never accepted).

    ``controller`` closes the loop: an object exposing ``interval``
    (decision-epoch seconds), ``begin(t0)``, ``decide(signals) ->
    iterable[ControlEvent]`` and ``finish(t_end)`` (see
    ``serving/controller.AutoscalePolicy``).  Every ``interval``
    seconds of simulated time it receives a :class:`ControlSignals`
    snapshot of the epoch just ended and may inject new control events
    (at or after ``now``) into the live timeline — the same masking
    machinery static timelines use.  ``start_ineligible`` lists groups
    that begin masked with no pending "up" event (a controller's
    parked reserve pool).

    ``events`` selects the recording mode: ``"full"`` (default) keeps
    the per-unit tuple log, ``"agg"`` keeps only the
    :class:`EventAggregate` reduction (the memory that matters at 1M
    requests), ``None`` records nothing.  The schedule itself is
    identical in every mode — recording is strictly observational.

    ``faults`` is a BOUND fault state (``serving.faults.FaultPlan
    .bind()``; crash/straggle events arrive via ``timeline``).  Three
    hooks, each strictly opt-in so ``faults=None`` runs stay
    bit-identical: per-link flaky KV transfers route through
    :func:`_stream_kv_flaky` (seeded retries, abort → re-prefill on
    the decode group, counted in ``kv_retries``/``kv_refills``);
    ``faults.recovery`` replays crash victims from their last periodic
    checkpoint (decode work before the checkpoint is NOT re-run, a
    host-restore delay is charged, and a victim with no eligible group
    is PARKED in the host store and replayed at the next "up" instead
    of dropping — still-parked requests at end of trace count as
    ``dropped``); ``faults.health`` observes transfer errors and
    eligibility flips (circuit breakers for health-aware routers).

    ``fabric`` (a ``serving.fabric.Topology``) replaces the
    point-to-point ``interconnect`` math for cross-group movement: KV
    handoffs become channel-queued urgent traffic on shared
    island/crossing channels, checkpoint ships (with
    ``faults.recovery``) and session migrations become preemptible
    bulk traffic on the SAME channels (``FABRIC_BULK`` events), and
    crash-replay progress counts checkpoints by their actual channel
    completion time instead of the unloaded periodic formula.
    Strictly opt-in: ``fabric=None`` runs are bit-identical to
    pre-fabric builds.

    Deterministic: identical (trace, plans, router, timeline,
    controller config, fault plan seed, fabric topology) produce a
    bit-identical event log.
    """
    if events not in ("full", "agg", None):
        raise ValueError(f"events must be 'full', 'agg' or None, "
                         f"got {events!r}")
    ic = interconnect or Interconnect()
    # Pending control events live in a heap so a controller can inject
    # events mid-run; the (time, kind-order, group, seq) key reproduces
    # the old sorted-list order exactly when nothing is injected.
    pend: List[Tuple[float, int, int, int, ControlEvent]] = []
    eseq = 0

    def push_event(e: ControlEvent) -> None:
        nonlocal eseq
        if e.group < 0 or e.group >= len(replicas):
            raise ValueError(f"control event {e} names group {e.group}; "
                             f"deployment has {len(replicas)}")
        heapq.heappush(pend, (e.time, _EVENT_ORDER[e.kind], e.group,
                              eseq, e))
        eseq += 1

    # Contradictory static timelines are rejected up front; only
    # groups whose FIRST event is "up" (warm-up pending) start masked,
    # so crash-and-recover timelines serve normally before the crash.
    start_masked = validate_timeline(timeline, len(replicas),
                                     start_ineligible)
    for e in sorted(timeline,
                    key=lambda e: (e.time, _EVENT_ORDER[e.kind], e.group)):
        push_event(e)
    for g in start_masked:
        replicas[g].eligible = False
    for g in start_ineligible:
        replicas[int(g)].eligible = False
    # Per-request mutable record, indexed by trace position.  "served"
    # records carry the request's CURRENT placement so a later failure
    # can find and re-route its victims.
    records: List[Optional[Dict]] = [None] * len(trace)
    ev_log: Optional[List[Tuple]] = [] if events == "full" else None
    agg: Optional[EventAggregate] = (EventAggregate()
                                     if events == "agg" else None)
    # queue_len is only ever probed by a controller epoch; without one
    # the per-request finish-heap push is pure churn
    track = controller is not None
    for rep in replicas:
        rep.track_inflight = track
    kv_resident: List[Tuple[float, float, float]] = []
    counters = {"shed": 0, "dropped": 0, "rerouted": 0,
                "transfers": 0, "transfer_seconds": 0.0,
                "kv_retries": 0, "kv_refills": 0, "recovered": 0}
    fstate = faults
    recovery = getattr(fstate, "recovery", None)
    health = getattr(fstate, "health", None)
    # (trace index, request to replay, ttft to preserve) of crash
    # victims waiting in the host-side checkpoint store for capacity
    parked: List[Tuple[int, ClusterRequest, Optional[float]]] = []
    avoided0 = int(getattr(route_fn, "transfers_avoided", 0))
    kvm = kv.bind(len(replicas)) if kv is not None else None
    # routers that look can see each group's block pressure; the
    # attribute is absent (not 0.0) when no kv model runs — and is
    # scrubbed on reuse — so kv-unaware runs stay bit-identical
    for gi, rep in enumerate(replicas):
        if kvm is not None:
            rep.kv_util_fn = (lambda t, g=gi: kvm.util_at(g, t))
        elif hasattr(rep, "kv_util_fn"):
            del rep.kv_util_fn
    # Contended fabric (strictly opt-in): bind the topology, point its
    # bulk-slice sink at whichever event record this run keeps, and let
    # a fabric-aware router charge queued transfer tails.
    fab = fabric.bind(len(replicas)) if fabric is not None else None
    if fab is not None:
        if ev_log is not None:
            def _bulk_sink(src, dst, rid, t0, t1,
                           _log=ev_log):
                _log.append((dst, rid, FABRIC_BULK, src, t0, t1))
        elif agg is not None:
            def _bulk_sink(src, dst, rid, t0, t1, _agg=agg):
                _agg.add(dst, FABRIC_BULK, src, t0, t1)
        else:
            def _bulk_sink(src, dst, rid, t0, t1):
                return None
        fab.sink = _bulk_sink
        if hasattr(route_fn, "bind_fabric"):
            route_fn.bind_fabric(fab)
    # Monotone tag source for bulk transfers (a crash victim's replay
    # must not collide with its first attempt's checkpoint tags).
    ship_seq = [0]

    def ship(i: int, g: int, d0: float, d1: float, kvb: float):
        """Enqueue this request's periodic checkpoint snapshots as
        bulk fabric traffic g -> host; returns the (group, seq, count)
        record crash recovery later counts completions against."""
        if fab is None or recovery is None:
            return None
        if d1 <= d0 or kvb <= 0.0:
            return None
        n_ship = int((d1 - d0) / recovery.interval)
        if n_ship <= 0:
            return None
        seq = ship_seq[0]
        ship_seq[0] += 1
        for k in range(1, n_ship + 1):
            fab.enqueue_bulk(g, FABRIC_HOST, trace[i].rid, kvb,
                             d0 + k * recovery.interval,
                             ("ckpt", seq, k))
        return (g, seq, n_ship)

    # Per-group service-seconds committed this control epoch: observed
    # (straggle-inflated) vs the un-degraded profile's price for the
    # same work.  Only maintained under a controller.
    svc_obs = [0.0] * len(replicas)
    svc_model = [0.0] * len(replicas)

    def note_service(rep: ReplicaModel, obs: float) -> None:
        svc_obs[rep.idx] += obs
        svc_model[rep.idx] += obs / rep.slow if rep.slow != 1.0 else obs

    def dispatch(i: int, req: ClusterRequest, now: float,
                 arrival0: float, fresh: bool) -> None:
        decision = route_fn(req, replicas, now)
        if not isinstance(decision, tuple):
            if decision is None or decision < 0:
                records[i] = {"served": False}
                counters["shed" if fresh else "dropped"] += 1
                return
            p_idx = d_idx = decision
            admit_at = req.arrival
        else:
            p_idx, d_idx, admit_at = decision
            admit_at = max(admit_at, req.arrival)
            if fab is not None:
                # A fabric-aware router that broke session affinity
                # flags the abandoned home so the resident state's
                # migration rides the fabric as bulk traffic.
                mig = getattr(route_fn, "pending_migration", None)
                if mig is not None:
                    route_fn.pending_migration = None
                    if mig != d_idx and req.kv_bytes > 0.0:
                        mseq = ship_seq[0]
                        ship_seq[0] += 1
                        fab.enqueue_bulk(mig, d_idx, req.rid,
                                         req.kv_bytes, now,
                                         ("mig", mseq))
        if kvm is not None:
            if req.session is not None and p_idx == d_idx:
                # follow-up turn landing on its resident group: the
                # cached prefix is not re-prefilled (session affinity's
                # measured benefit)
                got = kvm.cached(d_idx, req.session, admit_at)
                if got > 0:
                    p_tok = kvm.prompt_tokens(req)
                    eff = max(p_tok - got, 1)
                    if eff < p_tok:
                        kvm.hits += 1
                        kvm.hit_tokens += float(p_tok - eff)
                        req = dataclasses.replace(
                            req, scale_prompt=eff / kvm.base_prompt)
            # blocks live on the decode group from admission to finish;
            # under pressure the admission itself waits
            admit_at = kvm.admit(d_idx, req, admit_at)
        kv_i = None
        if p_idx == d_idx:
            rep = replicas[p_idx]
            finish, first_tok, _ = rep._run_units(req, ev_log, "both",
                                                  admit_at, agg)
            ttft_abs, kv_at = first_tok, None
            if track:
                note_service(rep, rep.predicted_service(req))
            if rep.monitor is not None:
                rep.monitor.record_request(
                    finish, finish - req.arrival,
                    rep.predicted_service(req))
                rep.maybe_switch(req.arrival)
        else:
            pre, dec = replicas[p_idx], replicas[d_idx]
            pre_fin, _, pre_start = pre._run_units(req, ev_log,
                                                   "prefill", admit_at,
                                                   agg)
            if track:
                note_service(pre,
                             pre.predicted_phase_service(req, "prefill"))
            link = fstate.link(p_idx, d_idx) if fstate is not None \
                else None
            chan = fab.channel(p_idx, d_idx) if fab is not None else None
            if link is None:
                kv_at, xfer_evs, busy = _stream_kv(
                    ic, req.kv_bytes, p_idx, d_idx, pre_start, pre_fin,
                    kv_chunks, chan)
            else:
                kv_at, xfer_evs, busy, nretry = _stream_kv_flaky(
                    ic, req.kv_bytes, p_idx, d_idx, pre_start, pre_fin,
                    kv_chunks, link, chan)
                counters["kv_retries"] += nretry
                if health is not None:
                    for _ in range(nretry):
                        health.record_error(p_idx, pre_fin)
                    if kv_at is not None:
                        health.record_ok(p_idx, pre_fin)
            for (x0, x1) in xfer_evs:
                if ev_log is not None:
                    ev_log.append((d_idx, req.rid, KV_TRANSFER, p_idx,
                                   x0, x1))
                elif agg is not None:
                    agg.add(d_idx, KV_TRANSFER, p_idx, x0, x1)
            counters["transfers"] += 1
            counters["transfer_seconds"] += busy
            if kv_at is None:
                # handoff aborted (retries exhausted / deadline blown):
                # the decode group re-prefills locally from the prompt.
                # The prefill group's work and the attempted transfers
                # are wasted, nothing became resident in flight, and a
                # later prefill-group death cannot hurt this request.
                counters["kv_refills"] += 1
                t_abort = xfer_evs[-1][1] if xfer_evs else pre_fin
                finish, first_tok, _ = dec._run_units(req, ev_log,
                                                      "both", t_abort,
                                                      agg)
                ttft_abs = first_tok
                if track:
                    note_service(dec, dec.predicted_service(req))
                if kvm is not None:
                    kvm.release(d_idx, req, finish)
                records[i] = {"served": True, "p": p_idx, "d": d_idx,
                              "finish": finish, "kv_at": None,
                              "kv_i": None, "d0": first_tok,
                              "lat": finish - arrival0,
                              "ttft": ttft_abs - arrival0,
                              "ship": ship(i, d_idx, first_tok, finish,
                                           req.kv_bytes)}
                return
            finish, _, _ = dec._run_units(req, ev_log, "decode", kv_at,
                                          agg)
            if track:
                note_service(dec,
                             dec.predicted_phase_service(req, "decode"))
            # first token streams from the decode group once the state
            # lands there — transfer time is part of TTFT
            ttft_abs = kv_at
            kv_i = len(kv_resident)
            kv_resident.append((kv_at, finish, req.kv_bytes))
            # each pool's monitor OBSERVES the queueing its own phase
            # caused (measured from when the work became available),
            # but split-routed replicas do NOT adopt policy flips: both
            # stored plans optimize whole-request objectives, so
            # flipping a pool between them mid-split degrades both
            # phases (measured in benchmarks/pd_split.py) — a pool's
            # plan choice is the router's role assignment.  Phase-
            # specific plans would make adaptation meaningful here;
            # until then the monitor's ratio history/would-be switches
            # stay visible without perturbing the schedule.
            if pre.monitor is not None:
                pre.monitor.record_request(
                    pre_fin, pre_fin - admit_at,
                    pre.predicted_phase_service(req, "prefill"))
            if dec.monitor is not None:
                dec.monitor.record_request(
                    finish, finish - kv_at,
                    dec.predicted_phase_service(req, "decode"))
        if kvm is not None:
            kvm.release(d_idx, req, finish)
        d0_anchor = ttft_abs if kv_at is None else kv_at
        records[i] = {"served": True, "p": p_idx, "d": d_idx,
                      "finish": finish, "kv_at": kv_at,
                      "kv_i": kv_i,
                      # decode-start anchor checkpoint recovery
                      # measures replay progress from
                      "d0": d0_anchor,
                      "lat": finish - arrival0,
                      "ttft": ttft_abs - arrival0,
                      "ship": ship(i, d_idx, d0_anchor, finish,
                                   req.kv_bytes)}

    def redispatch(i: int, req: ClusterRequest, arrival0: float,
                   keep_ttft: Optional[float]) -> None:
        """Re-submit a crash victim.  With recovery enabled a victim
        the router cannot place is PARKED (its checkpoint lives in the
        host store) and replayed at the next "up" event instead of
        dropping; ``keep_ttft`` preserves the client-visible TTFT of a
        checkpoint-restored session (its first token streamed long
        ago)."""
        dispatch(i, req, req.arrival, arrival0, fresh=False)
        rec = records[i]
        if not rec["served"]:
            if recovery is not None:
                counters["dropped"] -= 1
                parked.append((i, req, keep_ttft))
            return
        if keep_ttft is not None:
            rec["ttft"] = keep_ttft

    def apply_events(upto: float) -> None:
        while pend and pend[0][0] <= upto:
            e = heapq.heappop(pend)[-1]
            rep = replicas[e.group]
            if e.kind == "slow":
                rep.slow = e.factor
                continue
            if e.kind == "up":
                rep.eligible = True
                if health is not None:
                    health.reset(e.group, e.time)
                if parked:
                    waiting, parked[:] = list(parked), []
                    for (i, preq, keep_ttft) in waiting:
                        redispatch(i, dataclasses.replace(
                            preq, arrival=e.time),
                            trace[i].arrival, keep_ttft)
                continue
            rep.eligible = False
            if e.kind != "fail":
                continue            # graceful drain: residents finish
            if health is not None:
                health.trip(e.group, e.time)
            if kvm is not None:
                kvm.clear(e.group)  # the block pool died with the group
            for i, rec in enumerate(records):
                if rec is None or not rec["served"]:
                    continue
                hit = ((rec["d"] == e.group and rec["finish"] > e.time)
                       or (rec["p"] == e.group
                           and rec["kv_at"] is not None
                           and rec["kv_at"] > e.time))
                if not hit:
                    continue
                # the completion credited at first submission never
                # materialized on the dead group
                replicas[rec["d"]].completed -= 1
                if rec["kv_i"] is not None:
                    # the victim's resident-KV interval ends at the
                    # failure (decode group dead: state vanished with
                    # it; prefill source dead mid-transfer: the state
                    # never landed) — without this the re-routed
                    # transfer would double-count in peak_kv_bytes
                    a0, a1, w = kv_resident[rec["kv_i"]]
                    t1 = min(a1, e.time)
                    kv_resident[rec["kv_i"]] = \
                        (a0, t1, w) if a0 < t1 else (a0, a0, 0.0)
                counters["rerouted"] += 1
                if recovery is None:
                    dispatch(i, dataclasses.replace(trace[i],
                                                    arrival=e.time),
                             e.time, trace[i].arrival, fresh=False)
                    continue
                # checkpoint replay-cost model: decode work up to the
                # last periodic checkpoint (every `interval` seconds
                # from the decode start) is NOT re-run; the survivor
                # charges a host-restore delay and replays only the
                # post-checkpoint suffix.  A victim that never started
                # decoding (or died inside its first interval) has no
                # checkpoint and replays from scratch.
                vic = dataclasses.replace(trace[i], arrival=e.time)
                keep_ttft = None
                d0, d1 = rec["d0"], rec["finish"]
                if rec["d"] == e.group and e.time > d0 and d1 > d0:
                    if fab is not None:
                        # checkpoints only count once their snapshot
                        # fully crossed the (possibly contended)
                        # fabric to the host store
                        k = fab.ships_done(rec.get("ship"), e.time)
                    else:
                        k = math.floor((e.time - d0) / recovery.interval)
                    frac = min(k * recovery.interval / (d1 - d0), 1.0)
                    if frac > 0.0:
                        restore = (recovery.base_latency
                                   + trace[i].kv_bytes
                                   / recovery.restore_bw)
                        vic = dataclasses.replace(
                            trace[i], arrival=e.time + restore,
                            scale_prompt=0.0,
                            scale_output=(trace[i].scale_output
                                          * (1.0 - frac)))
                        keep_ttft = rec["ttft"]
                        counters["recovered"] += 1
                redispatch(i, vic, trace[i].arrival, keep_ttft)
            if fab is not None:
                # the dead group's memory is gone: whatever it had not
                # finished shipping will never ship (slices already on
                # the wire stay — that bandwidth was genuinely spent)
                fab.cancel_src(e.group, e.time)

    # ------------------------------------------------------------- #
    # closed-loop control: every `interval` seconds of simulated time
    # the controller sees the epoch's signals and may inject events
    if controller is not None:
        ctl_dt = float(getattr(controller, "interval", 0.0))
        if ctl_dt <= 0.0:
            raise ValueError("controller.interval must be > 0")
        ctl_t0 = min((r.arrival for r in trace), default=0.0)
        next_epoch = ctl_t0 + ctl_dt
        busy_prev = [sum(r.dev_busy) for r in replicas]
        ctl_counts = {"arrivals": 0, "shed": 0, "miss": 0}
        controller.begin(ctl_t0)

    def fire_epoch(te: float) -> None:
        apply_events(te)
        util = []
        for gi, rep in enumerate(replicas):
            busy = sum(rep.dev_busy)
            cap = ctl_dt * rep.num_devices
            util.append(min(1.0, max(0.0, (busy - busy_prev[gi]) / cap)))
            busy_prev[gi] = busy
        sig = ControlSignals(
            now=te, interval=ctl_dt,
            arrivals=ctl_counts["arrivals"], shed=ctl_counts["shed"],
            slo_miss=ctl_counts["miss"],
            backlog=tuple(r.backlog(te) for r in replicas),
            queue_len=tuple(r.queue_len(te) for r in replicas),
            util=tuple(util),
            eligible=tuple(r.eligible for r in replicas),
            kv_util=(kvm.util_vec(te) if kvm is not None else ()),
            service_obs=tuple(svc_obs),
            service_model=tuple(svc_model))
        ctl_counts.update(arrivals=0, shed=0, miss=0)
        for gi in range(len(replicas)):
            svc_obs[gi] = 0.0
            svc_model[gi] = 0.0
        for ev in (controller.decide(sig) or ()):
            if ev.time < te:
                raise ValueError(f"controller event {ev} is in the "
                                 f"past (now={te})")
            push_event(ev)

    for i, req in enumerate(trace):
        if controller is not None:
            while next_epoch <= req.arrival:
                fire_epoch(next_epoch)
                next_epoch += ctl_dt
        apply_events(req.arrival)
        if fab is not None:
            # Every future urgent booking has ready >= this arrival
            # (dispatch order), so the arrival is a safe watermark to
            # drain pending bulk below.
            fab.materialize(req.arrival)
        dispatch(i, req, req.arrival, req.arrival, fresh=True)
        if controller is not None:
            ctl_counts["arrivals"] += 1
            rec = records[i]
            if not rec["served"]:
                ctl_counts["shed"] += 1
            elif not _meets_slo(req, rec["lat"], rec["ttft"]):
                ctl_counts["miss"] += 1
    apply_events(math.inf)          # events after the last arrival
    if fab is not None:
        fab.flush()                 # drain every remaining bulk ship
    # victims still parked when the trace ends never found capacity
    counters["dropped"] += len(parked)

    latencies: List[float] = []
    ttfts: List[float] = []
    assignments: List[int] = []
    max_finish = 0.0
    slo_ok = 0
    for req, rec in zip(trace, records):
        if not rec["served"]:
            assignments.append(-1)
            continue
        assignments.append(rec["d"])
        latencies.append(rec["lat"])
        ttfts.append(rec["ttft"])
        if _meets_slo(req, rec["lat"], rec["ttft"]):
            slo_ok += 1
        max_finish = max(max_finish, rec["finish"])
    t0 = min((r.arrival for r in trace), default=0.0)
    if controller is not None:
        controller.finish(max(max_finish, t0))
    return ClusterResult(
        makespan=max_finish - t0 if trace else 0.0,
        completed=len(latencies),
        latencies=latencies,
        assignments=assignments,
        per_replica_completed=[r.completed for r in replicas],
        per_replica_busy=[sum(r.dev_busy) for r in replicas],
        switches=sum(r.switches for r in replicas),
        events=ev_log if ev_log is not None else [],
        event_agg=agg,
        price_rate=sum(r.price for r in replicas),
        ttfts=ttfts, shed=counters["shed"], slo_ok=slo_ok,
        transfers=counters["transfers"],
        transfer_seconds=counters["transfer_seconds"],
        peak_kv_bytes=_peak_concurrent(kv_resident),
        transfers_avoided=int(getattr(route_fn, "transfers_avoided", 0))
        - avoided0,
        rerouted=counters["rerouted"], dropped=counters["dropped"],
        kv_retries=counters["kv_retries"],
        kv_refills=counters["kv_refills"],
        recovered=counters["recovered"],
        kv_hits=kvm.hits if kvm is not None else 0,
        kv_hit_tokens=kvm.hit_tokens if kvm is not None else 0.0,
        kv_delayed=kvm.delayed if kvm is not None else 0,
        kv_evictions=kvm.evictions if kvm is not None else 0,
        peak_kv_blocks=kvm.peaks() if kvm is not None else (),
        fabric_wait_seconds=(fab.stats()["wait_seconds"]
                             if fab is not None else 0.0),
        fabric_bulk_bytes=(fab.stats()["bulk_bytes"]
                           if fab is not None else 0.0),
        fabric_bulk_seconds=(fab.stats()["bulk_seconds"]
                             if fab is not None else 0.0),
        ckpt_shipped=fab.ckpt_completed() if fab is not None else 0)


def _peak_concurrent(intervals: Sequence[Tuple[float, float, float]]
                     ) -> float:
    """Max summed weight over overlapping [t0, t1) intervals."""
    deltas: List[Tuple[float, float]] = []
    for t0, t1, w in intervals:
        deltas.append((t0, w))
        deltas.append((t1, -w))
    peak = cur = 0.0
    for _, dw in sorted(deltas):
        cur += dw
        peak = max(peak, cur)
    return peak
