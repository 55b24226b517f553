"""Disaggregated executor: run a traced step split across devices per a
Plan (paper §III-C) — the PyTorch counterpart of
``repro/core/executor.py``.

A *logical device* (``LogicalDevice``) is a torch device and the CUDA
stream its stages run on.  Two logical devices may share one physical
card, each with its own stream: then the stages really run on two
streams of one card and the cross-stream ordering is exercised for
real, with one copy of the weights (``.to`` of a tensor already on the
device returns that tensor).  On the CPU both are ``cpu`` with no
stream.

Hot path (the *dispatch program*, built once per executable):

  * The plan's stages are cut out of the exported ATen graph as
    ``fx.GraphModule``s, one per *dispatch unit*: consecutive plan stages
    mapped to the same logical device (the same object) are fused into
    one unit.  The per-request value environment is a flat list indexed
    by integer slots, resolved at build time.
  * A unit waits, on its own stream, for the events of the earlier units
    on other streams that it depends on: the plan graph's edges, which
    carry the value dependencies and the read/write-set dependencies of
    in-place writes (a KV cache row, a recurrent state).  The caller's
    stream is joined at the start and at the end, so a call orders
    against the caller's work like any other op, with no host sync.
  * A value that crosses to another logical device is handed over when
    its producer has been issued: on the same card it is the same tensor
    (recorded on the consumer's stream for the allocator); on another
    card it is copied ``non_blocking`` on the consumer's stream after the
    producer's event — the transfer prefetch.
  * Weights (graph inputs a unit reads) are placed on each physical
    device once, cached under a stable ``(slot, device)`` key; an input
    that the step writes in place (a cache) is never copied: it must be
    on its unit's device already.

``call_reference`` keeps a plain walk of the whole graph: one module per
plan stage, run in order on the caller's stream.  Parity tests and the
straggler path use it or the unit functions directly.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import torch
import torch.fx as fx
import torch.utils._pytree as pytree

from repro_torch import resolve_device
from repro_torch.core.analyzer import TracedGraph
from repro_torch.core.planner import Plan, Stage


@dataclasses.dataclass(frozen=True, eq=False)
class LogicalDevice:
    """A logical plan device: a torch device and the stream its units run
    on (None: the caller's current stream).  Logical devices compare by
    identity: stages fuse only when mapped to the same object."""
    device: torch.device
    stream: Optional[Any] = None
    name: str = ""

    def __repr__(self) -> str:
        return self.name or f"LogicalDevice({self.device})"


def logical_devices(n: int, device: Any = None) -> List[LogicalDevice]:
    """``n`` logical devices on one physical ``device`` (``cuda`` unless
    the caller names another; raises without a card); on CUDA each gets a
    stream of its own."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return [LogicalDevice(dev, torch.cuda.Stream(dev)
                          if dev.type == "cuda" else None, name=f"{dev}/{i}")
            for i in range(n)]


def as_logical(d: Any) -> LogicalDevice:
    return d if isinstance(d, LogicalDevice) else LogicalDevice(
        torch.device(d))


def _stage_module(nodes: Sequence[fx.Node], ext: Sequence[fx.Node],
                  outs: Sequence[fx.Node],
                  device: Optional[torch.device]) -> fx.GraphModule:
    """A GraphModule running ``nodes`` (in order) from the values ``ext``
    to the tuple ``outs``; tensors the trace created on a device are
    created on ``device``."""
    g = fx.Graph()
    env: Dict[fx.Node, fx.Node] = {}
    for v in ext:
        env[v] = g.placeholder(v.name)
    for n in nodes:
        new = g.node_copy(n, lambda a: env[a])
        if device is not None and isinstance(new.kwargs.get("device"),
                                             torch.device):
            new.kwargs = {**new.kwargs, "device": device}
        env[n] = new
    g.output(tuple(env[v] for v in outs))
    g.lint()
    return fx.GraphModule(torch.nn.Module(), g)


def _boundaries(groups: Sequence[Sequence[fx.Node]],
                graph_outs: Set[fx.Node]):
    """For groups of nodes run one after another: each group's external
    inputs (first-use order), its exports (values another group or the
    graph's output reads) and, per value, the groups that read it."""
    consumers: Dict[fx.Node, Set[int]] = {}
    exts: List[List[fx.Node]] = []
    for u, nodes in enumerate(groups):
        defined = set(nodes)
        ext: Dict[fx.Node, None] = {}
        for n in nodes:
            for a in pytree.tree_leaves((n.args, n.kwargs)):
                if isinstance(a, fx.Node):
                    consumers.setdefault(a, set()).add(u)
                    if a not in defined:
                        ext[a] = None
        exts.append(list(ext))
    outs = [[n for n in nodes if (consumers.get(n, set()) - {u})
             or n in graph_outs] for u, nodes in enumerate(groups)]
    return exts, outs, consumers


@dataclasses.dataclass
class CompiledStage:
    """One plan stage as a module (the reference path)."""
    stage: Stage
    fn: Any
    invars: Tuple[fx.Node, ...]
    outvars: Tuple[fx.Node, ...]
    device: LogicalDevice


@dataclasses.dataclass
class FusedStage:
    """One dispatch unit: a run of plan stages on one logical device."""
    idx: int
    stage_idxs: Tuple[int, ...]
    fn: Any                          # fx.GraphModule
    device: LogicalDevice
    ld: int                          # index of the logical device
    in_slots: Tuple[int, ...]
    in_weight: Tuple[bool, ...]      # graph input: cached placement
    out_slots: Tuple[int, ...]
    # (output position, destination logical device index, slot)
    transfers: Tuple[Tuple[int, int, int], ...]
    waits: Tuple[int, ...]           # earlier units on other logical devices
    pure: bool                       # writes no storage made before it
    first: bool                      # first unit on its logical device
    call: Any = None                 # fn's forward, without module hooks

    def __post_init__(self):
        self.call = self.fn.forward


@dataclasses.dataclass
class DispatchProgram:
    num_slots: int
    arg_slots: Tuple[int, ...]       # slot per placeholder
    fused: List[FusedStage]
    out_slots: Tuple[Optional[int], ...]
    out_literals: Tuple[Any, ...]
    records: Tuple[bool, ...]        # unit records an event after it runs


class Slots(list):
    """One request's flat value environment, with the streams its logical
    devices run on (per request under the pipelined runner) and the
    events of its units."""
    streams: Optional[List[Any]] = None
    events: Optional[List[Any]] = None
    entry: Any = None


class StagedExecutable:
    """Callable that reproduces ``fn(*args)`` with disaggregated stages.

    ``device_map``: logical plan device id -> ``LogicalDevice`` (or a
    torch device).  Mapping two plan devices to one object fuses their
    stages into one dispatch unit."""

    def __init__(self, traced: TracedGraph, plan: Plan,
                 device_map: Sequence[Any]):
        self.traced = traced
        self.plan = plan
        self.device_map = [as_logical(d) for d in device_map]
        self._weight_cache: Dict[Tuple[int, torch.device],
                                 Tuple[Any, Any]] = {}
        self.weight_places = 0
        self._ref_stages: Optional[List[CompiledStage]] = None
        self._build()

    # ------------------------------------------------------------------ #
    def _build(self) -> None:
        tg = self.traced
        graph = tg.fx_graph
        self._order = {n: i for i, n in enumerate(graph.nodes)}
        self._placeholders = [n for n in graph.nodes if n.op == "placeholder"]
        out_node = next(n for n in graph.nodes if n.op == "output")
        self._graph_outs = list(pytree.tree_leaves(out_node.args[0]))
        self._graph_out_vars: Set[fx.Node] = {
            v for v in self._graph_outs if isinstance(v, fx.Node)}
        eqn_of = {n: e for e, n in enumerate(tg.eqns)}
        self._written_inputs = {
            p for p in self._placeholders
            if any(r in w for w in tg.writes.values()
                   for r in tg.roots.get(p, ()))}

        # plan stage -> logical device index; fusion by identity
        ld_index: Dict[int, int] = {}
        lds: List[LogicalDevice] = []
        for d in self.device_map:
            if id(d) not in ld_index:
                ld_index[id(d)] = len(lds)
                lds.append(d)
        self.logical = lds
        stage_ld = [ld_index[id(self.device_map[st.device])]
                    for st in self.plan.stages]
        groups: List[List[int]] = []
        for i in range(len(self.plan.stages)):
            if groups and stage_ld[groups[-1][-1]] == stage_ld[i]:
                groups[-1].append(i)
            else:
                groups.append([i])

        unit_nodes = [self._nodes_of(g) for g in groups]
        unit_of = {n: u for u, nodes in enumerate(unit_nodes) for n in nodes}
        exts, outs, consumers = _boundaries(unit_nodes,
                                            self._graph_out_vars)

        slot_of: Dict[Any, int] = {}

        def alloc(key) -> int:
            if key not in slot_of:
                slot_of[key] = len(slot_of)
            return slot_of[key]

        arg_slots = tuple(alloc(p) for p in self._placeholders)
        for out in outs:
            for v in out:
                alloc(v)

        unit_ld = [stage_ld[g[0]] for g in groups]
        # a value crossing to another physical device gets a slot there
        for v, cons in consumers.items():
            if v not in unit_of:
                continue
            src = lds[unit_ld[unit_of[v]]].device
            for c in cons:
                if lds[unit_ld[c]].device != src:
                    alloc((v, unit_ld[c]))

        # unit-level dependencies from the plan graph's edges
        stage_of_node = {k: s.idx for s in self.plan.stages
                         for k in s.node_ids}
        unit_of_stage = {s: u for u, g in enumerate(groups) for s in g}
        deps: List[Set[int]] = [set() for _ in groups]
        for (i, j) in tg.graph.edges:
            ui = unit_of_stage[stage_of_node[i]]
            uj = unit_of_stage[stage_of_node[j]]
            if ui != uj and unit_ld[ui] != unit_ld[uj]:
                deps[uj].add(ui)

        fused: List[FusedStage] = []
        for u, g in enumerate(groups):
            ld = lds[unit_ld[u]]
            in_slots, in_weight = [], []
            for v in exts[u]:
                if v not in unit_of:                 # a graph input
                    in_slots.append(slot_of[v])
                    in_weight.append(True)
                else:
                    key = (v, unit_ld[u])
                    in_slots.append(slot_of.get(key, slot_of.get(v)))
                    in_weight.append(False)
            transfers = []
            for pos, v in enumerate(outs[u]):
                dests = {unit_ld[c] for c in consumers.get(v, ())
                         if c != u and unit_ld[c] != unit_ld[u]}
                for d in sorted(dests):
                    transfers.append((pos, d, slot_of.get((v, d),
                                                          slot_of[v])))
            # re-running the unit is safe iff every storage it writes is
            # one it creates
            mine = {eqn_of[n] for n in unit_nodes[u] if n in eqn_of}
            pure = all(tg.created.get(r) in mine
                       for e in mine for r in tg.writes.get(e, ()))
            fused.append(FusedStage(
                idx=u, stage_idxs=tuple(g),
                fn=_stage_module(unit_nodes[u], exts[u], outs[u],
                                 ld.device),
                device=ld, ld=unit_ld[u], in_slots=tuple(in_slots),
                in_weight=tuple(in_weight),
                out_slots=tuple(slot_of[v] for v in outs[u]),
                transfers=tuple(transfers),
                waits=tuple(sorted(deps[u])), pure=pure,
                first=unit_ld[u] not in unit_ld[:u]))
        records = [False] * len(fused)
        for fs in fused:
            for w in fs.waits:
                records[w] = True
        last: Dict[int, int] = {}
        for fs in fused:
            last[fs.ld] = fs.idx
        for u in last.values():
            records[u] = True
        self._last_units = tuple(sorted(last.values()))
        out_slots: List[Optional[int]] = []
        out_literals: List[Any] = []
        for v in self._graph_outs:
            if isinstance(v, fx.Node):
                out_slots.append(alloc(v))
                out_literals.append(None)
            else:
                out_slots.append(None)
                out_literals.append(v)
        self.program = DispatchProgram(
            num_slots=len(slot_of), arg_slots=arg_slots, fused=fused,
            out_slots=tuple(out_slots), out_literals=tuple(out_literals),
            records=tuple(records))
        self._slot_of = slot_of
        self._on_cuda = any(d.device.type == "cuda" for d in lds)

    def _nodes_of(self, stage_idxs: Sequence[int]) -> List[fx.Node]:
        """The fx nodes of some plan stages (with the ``getitem`` nodes
        that unpack their outputs), in graph order."""
        out = []
        for s in stage_idxs:
            for e in self.plan.stages[s].eqn_ids:
                out.append(self.traced.eqns[e])
                out.extend(self.traced.attached.get(e, ()))
        return sorted(out, key=self._order.__getitem__)

    # ------------------------------------------------------------------ #
    # Inputs
    # ------------------------------------------------------------------ #
    def _flat_inputs(self, args, kwargs) -> List[Any]:
        flat, spec = pytree.tree_flatten((tuple(args), kwargs))
        if spec != self.traced.in_spec:
            raise TypeError(f"argument structure {spec} != traced "
                            f"{self.traced.in_spec}")
        ep = self.traced.program
        vals = []
        for kind, key in self.traced.inputs:
            if kind == "user":
                vals.append(flat[key])
            elif kind == "constant":
                vals.append(ep.constants[key])
            else:
                vals.append(ep.state_dict[key])
        return vals

    def init_slots(self, *args, **kwargs) -> Slots:
        """Seed the flat slot environment for one request (and, on CUDA,
        mark the caller's stream, which every unit's stream joins)."""
        slots = Slots([None] * self.program.num_slots)
        for sl, val in zip(self.program.arg_slots,
                           self._flat_inputs(args, kwargs)):
            slots[sl] = val
        if self._on_cuda:
            slots.entry = torch.cuda.current_stream().record_event()
            slots.events = [None] * self.num_units
        return slots

    def _place_arg(self, slot: int, val: Any, dev: torch.device) -> Any:
        """A graph input on ``dev``: the tensor itself when it is there
        already, else one copy per (slot, device), kept."""
        if not isinstance(val, torch.Tensor) or val.device == dev:
            return val
        if self._placeholders[slot] in self._written_inputs:
            # (placeholders hold the first slots, in order)
            raise ValueError(
                f"input {self._placeholders[slot].name} is written in "
                f"place and lives on {val.device}, not {dev}: pin its "
                "readers and writers to its device")
        key = (slot, dev)
        cached = self._weight_cache.get(key)
        if cached is not None and cached[0] is val:
            return cached[1]
        placed = val.to(dev, non_blocking=True)
        self.weight_places += 1
        self._weight_cache[key] = (val, placed)
        return placed

    # ------------------------------------------------------------------ #
    # Indexed fast path
    # ------------------------------------------------------------------ #
    def _stream(self, slots: Slots, ld: int) -> Any:
        if slots.streams is not None:
            return slots.streams[ld]
        s = self.logical[ld].stream
        return s if s is not None else torch.cuda.current_stream(
            self.logical[ld].device)

    def _inputs(self, slots: Slots, fs: FusedStage,
                device: torch.device, moved: bool) -> List[Any]:
        """A unit's inputs on ``device``: weights through the placement
        cache, and (``moved``: a straggler rerun elsewhere) every other
        tensor copied there."""
        ins = []
        for sl, w in zip(fs.in_slots, fs.in_weight):
            v = slots[sl]
            if w:
                v = self._place_arg(sl, v, device)
            elif moved and isinstance(v, torch.Tensor):
                v = v.to(device)
            ins.append(v)
        return ins

    def _launch(self, slots: Slots, fs: FusedStage, stream: Any,
                device: torch.device, after: Optional[Sequence[Any]]) -> Any:
        """Order ``stream`` (the current stream) after what the unit
        depends on, then gather its inputs on ``device`` and issue it.  A
        rerun waits for ``after`` in place of the unit's own waits."""
        if fs.first or after is not None:
            stream.wait_event(slots.entry)
        for e in (after if after is not None else
                  (slots.events[w] for w in fs.waits)):
            if e is not None:
                stream.wait_event(e)
        return fs.call(*self._inputs(slots, fs, device, after is not None))

    def unit_stream(self, slots: Slots, unit_idx: int,
                    device_override: Optional[LogicalDevice] = None) -> Any:
        """The CUDA stream ``compute_unit`` issues the unit on in the
        calling thread, or None where the unit runs on the CPU."""
        fs = self.program.fused[unit_idx]
        ld = device_override or fs.device
        if slots.entry is None or ld.device.type != "cuda":
            return None
        if device_override is None:
            return self._stream(slots, fs.ld)
        return ld.stream or torch.cuda.current_stream(ld.device)

    def issued(self, slots: Slots) -> List[Any]:
        """Events marking the work issued so far on every stream of the
        request (empty off CUDA): what a rerun of the next unit waits for,
        taken before the unit's first issue so the rerun does not wait
        for it."""
        if slots.entry is None:
            return []
        return [self._stream(slots, ld).record_event()
                for ld, d in enumerate(self.logical)
                if d.device.type == "cuda"]

    def compute_unit(self, slots: Slots, unit_idx: int,
                     device_override: Optional[LogicalDevice] = None,
                     after: Sequence[Any] = ()) -> List[Any]:
        """Issue one unit's work (asynchronously on CUDA, on
        ``unit_stream``) and return its outputs, on the unit's device; the
        slots are not touched.  ``device_override`` runs it on another
        logical device (straggler mitigation) after the events ``after``
        (``issued``): its inputs move there and its outputs move back, on
        that device's stream."""
        fs = self.program.fused[unit_idx]
        rerun = device_override is not None
        ld = device_override if rerun else fs.device
        stream = self.unit_stream(slots, unit_idx, device_override)
        if stream is None:
            for e in after:                  # a CUDA unit rerun off CUDA
                e.synchronize()
            return self._home(fs, ld, fs.call(
                *self._inputs(slots, fs, ld.device, rerun)))
        with torch.cuda.stream(stream):
            return self._home(fs, ld, self._launch(
                slots, fs, stream, ld.device, list(after) if rerun else None))

    @staticmethod
    def _home(fs: FusedStage, ld: LogicalDevice, outs: Any) -> List[Any]:
        """A unit's outputs on its own device (a rerun on ``ld`` moves them
        back, on the current stream)."""
        if ld.device != fs.device.device:
            outs = [o.to(fs.device.device) if isinstance(o, torch.Tensor)
                    else o for o in outs]
        return list(outs)

    def store_unit(self, slots: Slots, unit_idx: int, outs: Sequence[Any],
                   made_on: Any = None) -> int:
        """Bind a unit's outputs, mark its completion (on ``made_on``, the
        stream that made them: by default the unit's own) and hand its
        exports to their consumers' logical devices; returns #transfers."""
        fs = self.program.fused[unit_idx]
        for sl, val in zip(fs.out_slots, outs):
            slots[sl] = val
        cuda = slots.entry is not None and fs.device.device.type == "cuda"
        if cuda and made_on is not None:
            # made on another stream (a rerun): the unit's own stream
            # reads them next, which the allocator must know
            for val in outs:
                if isinstance(val, torch.Tensor) and val.is_cuda:
                    val.record_stream(self._stream(slots, fs.ld))
        if cuda and self.program.records[unit_idx]:
            slots.events[unit_idx] = (made_on or self._stream(
                slots, fs.ld)).record_event()
        for pos, dld, dsl in fs.transfers:
            val = outs[pos]
            dst = self.logical[dld]
            if not isinstance(val, torch.Tensor):
                slots[dsl] = val
            elif dst.device == val.device:
                if cuda:
                    val.record_stream(self._stream(slots, dld))
                slots[dsl] = val
            elif dst.device.type == "cuda" and cuda:
                stream = self._stream(slots, dld)
                with torch.cuda.stream(stream):
                    stream.wait_event(slots.events[unit_idx])
                    slots[dsl] = val.to(dst.device, non_blocking=True)
            else:
                slots[dsl] = val.to(dst.device)
        return len(fs.transfers)

    def run_unit(self, slots: Slots, unit_idx: int,
                 device_override: Optional[LogicalDevice] = None) -> int:
        """Dispatch one fused unit (async on CUDA); returns #transfers."""
        return self.store_unit(slots, unit_idx, self.compute_unit(
            slots, unit_idx, device_override))

    def collect_slots(self, slots: Slots):
        """The call's outputs; on CUDA the caller's stream first joins
        every logical device's stream."""
        if slots.entry is not None:
            current = torch.cuda.current_stream()
            for u in self._last_units:
                if slots.events[u] is not None:
                    current.wait_event(slots.events[u])
        results = [slots[sl] if sl is not None else lit
                   for sl, lit in zip(self.program.out_slots,
                                      self.program.out_literals)]
        if slots.entry is not None:
            current = torch.cuda.current_stream()
            for r in results:
                if isinstance(r, torch.Tensor) and r.device.type == "cuda":
                    r.record_stream(current)
        return pytree.tree_unflatten(results, self.traced.out_spec)

    def unit_outputs(self, slots: Slots, unit_idx: int) -> List[Any]:
        fs = self.program.fused[unit_idx]
        return [slots[sl] for sl in fs.out_slots]

    @property
    def num_units(self) -> int:
        return len(self.program.fused)

    def __call__(self, *args, **kwargs):
        slots = self.init_slots(*args, **kwargs)
        if slots.entry is None:
            for i in range(len(self.program.fused)):
                self.run_unit(slots, i)
            return self.collect_slots(slots)
        # CUDA: switch the current stream once per unit, and back to the
        # caller's at the end (``run_unit`` restores it after each unit)
        caller = torch.cuda.current_stream()
        try:
            for fs in self.program.fused:
                stream = self._stream(slots, fs.ld)
                torch.cuda.set_stream(stream)
                outs = self._launch(slots, fs, stream, fs.device.device,
                                    None)
                self.store_unit(slots, fs.idx, outs)
        finally:
            torch.cuda.set_stream(caller)
        return self.collect_slots(slots)

    # ------------------------------------------------------------------ #
    # Reference path: one module per plan stage, on the caller's stream
    # ------------------------------------------------------------------ #
    @property
    def stages(self) -> List[CompiledStage]:
        if self._ref_stages is None:
            per_stage = [self._nodes_of([st.idx]) for st in self.plan.stages]
            exts, outs, _ = _boundaries(per_stage, self._graph_out_vars)
            self._ref_stages = []
            for st, nodes, ext, out in zip(self.plan.stages, per_stage,
                                           exts, outs):
                ld = self.device_map[st.device]
                self._ref_stages.append(CompiledStage(
                    stage=st, fn=_stage_module(nodes, ext, out, ld.device),
                    invars=tuple(ext), outvars=tuple(out), device=ld))
        return self._ref_stages

    def call_reference(self, *args, **kwargs):
        """Run a request through a plain per-stage walk of the graph."""
        env: Dict[fx.Node, Any] = dict(zip(
            self._placeholders, self._flat_inputs(args, kwargs)))
        for cs in self.stages:
            ins = []
            for v in cs.invars:
                val = env[v]
                if isinstance(val, torch.Tensor) \
                        and val.device != cs.device.device:
                    val = self._place_arg(self._slot_of[v], val,
                                          cs.device.device) \
                        if v.op == "placeholder" else val.to(cs.device.device)
                ins.append(val)
            for v, val in zip(cs.outvars, cs.fn(*ins)):
                env[v] = val
        results = [env[v] if isinstance(v, fx.Node) else v
                   for v in self._graph_outs]
        return pytree.tree_unflatten(results, self.traced.out_spec)

    # ------------------------------------------------------------------ #
    def stage_summary(self) -> str:
        lines = []
        for st in self.plan.stages:
            lines.append(
                f"  stage {st.idx:3d} dev={self.plan.devices[st.device]:<10}"
                f" kernels={len(st.node_ids):4d}"
                f" t={st.compute_time * 1e6:9.1f}us"
                f" recv={st.recv_bytes / 1e6:8.3f}MB"
                f" send={st.send_bytes / 1e6:8.3f}MB")
        lines.append(
            f"  fused: {len(self.plan.stages)} stages -> "
            f"{len(self.program.fused)} dispatch units")
        return "\n".join(lines)


def build_executable(traced: TracedGraph, plan: Plan,
                     device_map: Optional[Sequence[Any]] = None
                     ) -> StagedExecutable:
    """Compile a traced graph + plan into a disaggregated executable.

    When ``device_map`` is None every stage runs on one logical device on
    the device the step was traced on (one dispatch unit per call) —
    useful for validating the stage decomposition itself."""
    if device_map is None:
        dev = _traced_device(traced)
        one = LogicalDevice(dev)
        device_map = [one] * (max(plan.labels) + 1 if plan.labels else 1)
    return StagedExecutable(traced, plan, device_map)


def _traced_device(traced: TracedGraph) -> torch.device:
    for n in traced.fx_graph.nodes:
        v = n.meta.get("val")
        if isinstance(v, torch.Tensor):
            return v.device
    raise ValueError("the traced graph holds no tensor value to take a "
                     "device from: pass a device_map")
