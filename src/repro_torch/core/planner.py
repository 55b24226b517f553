"""Policy planner: kernel-to-device placement (paper §III-B).

Front-end over the solvers:
  * ``policy="latency"``  -> exact min-cut (2 devices) / alpha-expansion.
  * ``policy="throughput"`` -> min-max makespan heuristics (+ layer folding).

Output is a :class:`Plan`: per-kernel device labels plus the derived
*stage* decomposition — maximal runs of consecutive (topological) kernels
on the same device — which is what the executor compiles and the pipeline
scheduler dispatches.  Plans are cached per (graph-key, device-set,
policy, bandwidth) to support elastic re-planning (DESIGN.md §6).
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core import mincut
from repro_torch.core.costmodel import DeviceSpec
from repro_torch.core.graph import KernelGraph
from repro_torch.core.makespan import MakespanProblem, fold_and_solve, \
    solve_throughput


@dataclasses.dataclass
class Stage:
    """A maximal topological run of kernels placed on one device."""

    idx: int
    device: int
    node_ids: Tuple[int, ...]
    eqn_ids: Tuple[int, ...]        # raw jaxpr equation indices
    compute_time: float             # modeled
    recv_bytes: float               # bytes entering from other devices
    send_bytes: float


@dataclasses.dataclass
class Plan:
    """Placement + stage decomposition + modeled objective values."""

    labels: List[int]
    policy: str
    devices: Tuple[str, ...]
    stages: List[Stage]
    objective: float                 # solver objective (s)
    T: List[float]                   # per-device compute time
    M: List[float]                   # per-device incoming comm time
    cut_bytes: float
    cut_edges: int
    solve_seconds: float

    @property
    def bottleneck(self) -> float:
        return max(max(t, m) for t, m in zip(self.T, self.M))

    @property
    def steady_state_throughput(self) -> float:
        """Requests/s under ideal pipelining (paper's 1 / max W_g)."""
        return 1.0 / max(self.bottleneck, 1e-12)

    @property
    def unpipelined_latency(self) -> float:
        return sum(self.T) + sum(self.M)

    def cut_seconds(self, bw: float) -> float:
        """Per-request seconds this plan's cut bytes occupy a channel
        of ``bw`` bytes/s — how much shared-fabric capacity the kernel
        placement itself demands.  The quantity a contended topology
        scores placements against (see ``serving.fabric.Topology
        .planner_bw``)."""
        return self.cut_bytes / max(bw, 1e-12)

    def device_of(self, node: int) -> int:
        return self.labels[node]

    def summary(self) -> str:
        per_dev = {}
        for lbl, name in zip(range(len(self.T)), self.devices):
            cnt = sum(1 for l in self.labels if l == lbl)
            per_dev[name] = cnt
        return (f"Plan[{self.policy}] obj={self.objective * 1e3:.3f}ms "
                f"stages={len(self.stages)} cut={self.cut_bytes / 1e6:.2f}MB"
                f"/{self.cut_edges}e placement={per_dev}")


def contended_bw(bw: float, sharers: int) -> float:
    """Effective per-tenant bandwidth of a shared fabric channel: the
    channel's rate split evenly across its co-resident tenants (the
    fair-share steady state of the priority scheduler when every
    tenant keeps the channel busy).  The derating a topology applies
    before handing the planner a ``bw_override`` — kernel placement
    then balances cut bytes against the bandwidth a group will
    actually see, not the island's nameplate rate."""
    return bw / max(int(sharers), 1)


# --------------------------------------------------------------------- #
_PLAN_CACHE: Dict[Tuple, Plan] = {}


def graph_key(graph: KernelGraph) -> str:
    h = hashlib.sha1()
    for n in graph.nodes:
        h.update(repr(n.signature()).encode())
        h.update(repr(n.pinned).encode())
    for (i, j), b in sorted(graph.edges.items()):
        h.update(f"{i},{j},{b}".encode())
    return h.hexdigest()


def plan(graph: KernelGraph, devices: Sequence[DeviceSpec],
         policy: str = "throughput",
         bw_override: Optional[float] = None,
         use_folding: bool = True,
         anneal_iters: int = 4000,
         cache: bool = True) -> Plan:
    """Solve placement and derive stages. Deterministic."""
    key = (graph_key(graph), tuple(d.name for d in devices), policy,
           bw_override, use_folding, anneal_iters)
    if cache and key in _PLAN_CACHE:
        return _PLAN_CACHE[key]

    t0 = time.perf_counter()
    if policy == "latency":
        unary, pair, pins = mincut.latency_inputs_from_graph(
            graph, devices, bw_override)
        if len(devices) == 2:
            labels, obj = mincut.solve_latency_2dev(unary, pair, pins)
        else:
            labels, obj = mincut.solve_latency_multi(
                unary, pair, len(devices), pins)
    elif policy == "throughput":
        if use_folding:
            labels, obj = fold_and_solve(
                graph, devices, solve_throughput,
                bw_override=bw_override, anneal_iters=anneal_iters)
        else:
            labels, obj = solve_throughput(
                graph, devices, bw_override=bw_override,
                anneal_iters=anneal_iters)
    else:
        raise ValueError(f"unknown policy {policy!r}")
    solve_s = time.perf_counter() - t0

    p = _finalize(graph, devices, labels, obj, policy, bw_override, solve_s)
    if cache:
        _PLAN_CACHE[key] = p
    return p


def replan_on_failure(graph: KernelGraph, devices: Sequence[DeviceSpec],
                      lost: Set[int], old: Plan, **kw) -> Plan:
    """Elastic re-planning after device loss (kernel-granularity
    elasticity; DESIGN.md §6).  Pins that referenced lost devices are
    remapped to the surviving device with the most HBM."""
    surviving = [d for i, d in enumerate(devices) if i not in lost]
    if not surviving:
        raise RuntimeError("no surviving devices")
    import dataclasses as _dc
    remap = {}
    j = 0
    for i in range(len(devices)):
        if i not in lost:
            remap[i] = j
            j += 1
    fallback = max(range(len(surviving)),
                   key=lambda i: surviving[i].hbm_bytes)
    nodes = []
    for n in graph.nodes:
        pin = n.pinned
        if pin is not None:
            pin = remap.get(pin, fallback)
        nodes.append(_dc.replace(n, pinned=pin))
    g2 = KernelGraph(nodes, dict(graph.edges), name=graph.name + "+elastic")
    return plan(g2, surviving, policy=old.policy, **kw)


# --------------------------------------------------------------------- #
def _finalize(graph, devices, labels, obj, policy, bw_override,
              solve_s) -> Plan:
    prob = MakespanProblem(graph, devices, bw_override)
    T, M = prob.loads(labels)
    cut_b = 0.0
    cut_e = 0
    for (i, j), b in graph.edges.items():
        if labels[i] != labels[j]:
            cut_b += b
            cut_e += 1
    stages = build_stages(graph, labels, devices, bw_override)
    return Plan(labels=list(labels), policy=policy,
                devices=tuple(d.name for d in devices), stages=stages,
                objective=obj, T=T, M=M, cut_bytes=cut_b, cut_edges=cut_e,
                solve_seconds=solve_s)


def build_stages(graph: KernelGraph, labels: Sequence[int], devices,
                 bw_override: Optional[float] = None) -> List[Stage]:
    """Maximal consecutive same-device runs in topological order."""
    stages: List[Stage] = []
    cur_dev, cur_nodes = None, []

    def flush():
        if not cur_nodes:
            return
        nids = tuple(cur_nodes)
        nset = set(nids)
        eqns: List[int] = []
        comp = 0.0
        for k in nids:
            eqns.extend(graph.nodes[k].eqn_ids)
            comp += devices[cur_dev].kernel_time(graph.nodes[k])
        recv = sum(b for (i, j), b in graph.edges.items()
                   if j in nset and labels[i] != cur_dev)
        send = sum(b for (i, j), b in graph.edges.items()
                   if i in nset and labels[j] != cur_dev)
        stages.append(Stage(idx=len(stages), device=cur_dev,
                            node_ids=nids, eqn_ids=tuple(sorted(eqns)),
                            compute_time=comp, recv_bytes=recv,
                            send_bytes=send))

    for n in graph.nodes:
        d = labels[n.idx]
        if d != cur_dev:
            flush()
            cur_dev, cur_nodes = d, [n.idx]
        else:
            cur_nodes.append(n.idx)
    flush()
    return stages
