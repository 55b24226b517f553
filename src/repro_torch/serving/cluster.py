"""Cluster-scale serving: N heterogeneous Tessera replica groups.

A *replica group* is one disaggregated device set (e.g. an A100+L40s
pair) running the model under its own Plan; a cluster is many such
groups — possibly of different device types and sizes — behind a
router (``repro_torch.serving.router``).  This is the layer the paper's
16-GPU experiments live at: per-replica kernel-granularity
disaggregation (the planner), cross-replica workload-aware routing
(HexGen-2-style rate matching), and per-replica online policy
switching (the monitor).

Per replica group this module precomputes:
  * a Plan per policy ("latency", "throughput") via the planner's
    process-wide plan cache — the same cache elastic re-planning uses,
    so a monitor-triggered policy flip is a cache hit, not a re-solve,
  * the stage-unit timeline for the discrete-event model
    (``repro_torch.core.simulator.ReplicaModel``),
  * an :class:`OnlineMonitor` that flips the replica between policies
    when its queueing ratio crosses beta (with hysteresis).

``simulate`` builds FRESH replica state each call, so one cluster can
be replayed under different routers/traces for apples-to-apples
comparisons; everything downstream is deterministic in (trace, plans,
router).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import planner
from repro_torch.core.costmodel import CATALOG, DeviceSpec
from repro_torch.core.graph import KernelGraph
from repro_torch.core.monitor import MonitorConfig, OnlineMonitor
from repro_torch.core.simulator import (ClusterRequest, ClusterResult,
                                  Interconnect, ReplicaModel, ReplicaUnit,
                                  replica_units, simulate_cluster,
                                  simulate_cluster_pd)
from repro_torch.models.config import ModelConfig
from repro_torch.serving.workload import WorkloadRequest

POLICIES = ("latency", "throughput")


def resolve_devices(group: Sequence) -> List[DeviceSpec]:
    """Accept DeviceSpecs or catalog names."""
    out = []
    for d in group:
        if hasattr(d, "kernel_time"):
            out.append(d)
        elif d in CATALOG:
            out.append(CATALOG[d])
        else:
            raise ValueError(f"unknown device {d!r}; "
                             f"pick from {sorted(CATALOG)}")
    return out


@dataclasses.dataclass
class ReplicaGroup:
    """Static description + per-policy plans of one device group."""

    idx: int
    devices: List[DeviceSpec]
    plans: Dict[str, "planner.Plan"]
    units: Dict[str, List[ReplicaUnit]]

    @property
    def price(self) -> float:
        return sum(d.price for d in self.devices)

    def describe(self) -> str:
        names = "+".join(d.name for d in self.devices)
        obj = {p: f"{pl.objective * 1e3:.2f}ms"
               for p, pl in self.plans.items()}
        return f"replica[{self.idx}] {names} {obj}"


class TesseraCluster:
    """N replica groups serving one model graph.

    ``replica_devices``: one device list (specs or catalog names) per
    replica group, e.g. ``[["a100", "l40s"], ["h100", "rtxpro6000"]]``.
    ``base_prompt``/``base_output`` are the token counts the graph was
    traced with; per-request stage times scale relative to them.
    """

    def __init__(self, graph: KernelGraph,
                 replica_devices: Sequence[Sequence],
                 *,
                 base_prompt: int = 1024,
                 base_output: int = 128,
                 policies: Tuple[str, ...] = POLICIES,
                 monitor_cfg: Optional[MonitorConfig] = MonitorConfig(),
                 initial_policy: str = "latency",
                 bw_override: Optional[float] = None,
                 bw_overrides: Optional[Sequence[Optional[float]]] = None,
                 anneal_iters: int = 1000,
                 model_cfg: Optional[ModelConfig] = None,
                 interconnect: Optional[Interconnect] = None):
        assert replica_devices, "need at least one replica group"
        assert initial_policy in policies
        self.graph = graph
        self.base_prompt = max(base_prompt, 1)
        self.base_output = max(base_output, 1)
        self.monitor_cfg = monitor_cfg
        self.initial_policy = initial_policy
        self.model_cfg = model_cfg
        self.interconnect = interconnect or Interconnect()
        self.policies = tuple(policies)
        self.bw_override = bw_override
        # per-group planner bandwidth (index-aligned with the founding
        # groups; e.g. a fabric topology's contended island bandwidth).
        # Groups past the list — autoscaled additions — fall back to
        # the scalar ``bw_override``.
        self.bw_overrides = (list(bw_overrides)
                             if bw_overrides is not None else None)
        self.anneal_iters = anneal_iters
        self.groups: List[ReplicaGroup] = []
        self.add_groups(replica_devices)

    def add_groups(self, replica_devices: Sequence[Sequence]
                   ) -> List[ReplicaGroup]:
        """Plan and append replica groups (the autoscaling add path —
        a scaled-in group is planned exactly like a founding one).
        Returns the new :class:`ReplicaGroup` records."""
        new: List[ReplicaGroup] = []
        for group in replica_devices:
            devices = resolve_devices(group)
            gi = len(self.groups)
            ov = self.bw_override
            if self.bw_overrides is not None and gi < len(self.bw_overrides):
                if self.bw_overrides[gi] is not None:
                    ov = self.bw_overrides[gi]
            # Identical device sets hit the planner's plan cache, so a
            # 16-device cluster of 8 identical pairs solves each policy
            # once — the same path monitor-triggered re-planning takes.
            plans = {pol: planner.plan(self.graph, devices, policy=pol,
                                       bw_override=ov,
                                       anneal_iters=self.anneal_iters)
                     for pol in self.policies}
            units = {pol: replica_units(self.graph, plan, devices, ov)
                     for pol, plan in plans.items()}
            g = ReplicaGroup(gi, devices, plans, units)
            self.groups.append(g)
            new.append(g)
        return new

    # -------------------------------------------------------------- #
    @property
    def num_devices(self) -> int:
        return sum(len(g.devices) for g in self.groups)

    @property
    def price_rate(self) -> float:
        return sum(g.price for g in self.groups)

    @property
    def capacity(self) -> float:
        """Aggregate steady-state throughput (req/s at scale 1): the sum
        of each group's pipelined ceiling 1 / max_g W_g."""
        return sum(1.0 / g.plans["throughput"].bottleneck
                   for g in self.groups)

    def describe(self) -> str:
        return "\n".join(g.describe() for g in self.groups)

    # -------------------------------------------------------------- #
    def kv_bytes(self, prompt_tokens: int) -> float:
        """Size of the prefill->decode KV-state handoff for one request.

        Attention families carry per-token K and V planes
        (layers x kv_heads x head_dim x 2 x dtype bytes per token);
        recurrent families (ssm) hand off a fixed-size state; hybrids
        both.  Falls back to a per-token heuristic matching the request
        graph's KV-handoff edge when no model config was provided.
        """
        cfg = self.model_cfg
        if cfg is None:
            return float(2 * 2 * 128 * prompt_tokens)   # heuristic
        dt = cfg.torch_dtype.itemsize
        total = 0.0
        if cfg.family in ("dense", "moe", "vlm", "encdec"):
            # sliding-window caches are ring buffers whose slot layout
            # depends on absolute positions, so the handoff ships the
            # WHOLE ring (export_kv never trims it), not just the
            # filled prefix
            tok = cfg.sliding_window or prompt_tokens
            total += (2 * cfg.num_layers * cfg.num_kv_heads
                      * cfg.head_dim * dt * tok)
        elif cfg.family == "ssm":       # rwkv6: wkv fp32 + 2 shift rows
            total += cfg.num_layers * (
                cfg.rwkv_heads * cfg.rwkv_head_dim ** 2 * 4
                + 2 * cfg.d_model * dt)
        elif cfg.family == "hybrid":    # mamba state + shared-attn KV
            n_attn = (cfg.num_layers + cfg.hybrid_attn_every - 1) \
                // cfg.hybrid_attn_every
            total += cfg.num_layers * (
                cfg.ssm_heads * cfg.ssm_state * cfg.ssm_head_dim * 4
                + (cfg.conv_width - 1)
                * (cfg.d_inner + 2 * cfg.ssm_state) * dt)
            total += (2 * n_attn * cfg.num_kv_heads * cfg.head_dim
                      * dt * prompt_tokens)
        return total

    def to_cluster_request(self, req: WorkloadRequest) -> ClusterRequest:
        return ClusterRequest(
            rid=req.rid, arrival=req.arrival,
            scale_prompt=req.prompt_tokens / self.base_prompt,
            scale_output=req.output_tokens / self.base_output,
            session=req.session,
            kv_bytes=self.kv_bytes(req.prompt_tokens),
            slo=req.slo, slo_ttft=req.slo_ttft,
            priority=getattr(req, "priority", 0))

    def build_replicas(self) -> List[ReplicaModel]:
        """Fresh mutable replica state (queues, monitors, policies)."""
        replicas = []
        for g in self.groups:
            monitor = (OnlineMonitor(self.monitor_cfg,
                                     initial_policy=self.initial_policy)
                       if self.monitor_cfg is not None else None)
            replicas.append(ReplicaModel(
                g.idx, len(g.devices), g.units,
                policy=self.initial_policy, monitor=monitor,
                price=g.price))
        return replicas

    def simulate(self, trace: Sequence[WorkloadRequest],
                 router) -> ClusterResult:
        """Route + replay ``trace``; ``router`` is any callable
        ``(req, replicas, now) -> index`` (see serving/router.py)."""
        creqs = [self.to_cluster_request(r)
                 for r in sorted(trace, key=lambda r: (r.arrival, r.rid))]
        return simulate_cluster(self.build_replicas(), creqs, router)

    def simulate_pd(self, trace: Sequence[WorkloadRequest],
                    router, kv_chunks: int = 1) -> ClusterResult:
        """Phase-split replay: ``router`` may return ``(prefill_idx,
        decode_idx, admit_at)`` (see router.PDRouter); KV-transfer time
        between groups comes from this cluster's ``interconnect``.
        ``kv_chunks > 1`` streams each handoff as that many chunks
        overlapped with the remaining prefill compute (see
        simulator.simulate_cluster_pd)."""
        creqs = [self.to_cluster_request(r)
                 for r in sorted(trace, key=lambda r: (r.arrival, r.rid))]
        return simulate_cluster_pd(self.build_replicas(), creqs, router,
                                   self.interconnect, kv_chunks)
