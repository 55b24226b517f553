"""Kernel graph: the data-dependency graph (DDG) Tessera plans over.

The paper extracts this graph from instrumented PTX; here it is derived
from a jaxpr (see ``analyzer.py``), so every node carries exact FLOP and
byte counts and every edge carries the exact transfer size of the buffer
that crosses it (Read-After-Write dependency).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class KernelNode:
    """One schedulable kernel (a jaxpr equation or a fused group of them)."""

    idx: int                      # topological index (jaxprs are topo-sorted)
    name: str                     # primitive name, e.g. "dot_general"
    flops: float                  # floating point operations
    bytes_accessed: float         # HBM traffic estimate (reads + writes)
    out_bytes: float              # bytes of produced buffers (transfer size)
    # Tags used by the coarse-grained baselines and by layer folding:
    phase: str = ""               # "prefill" | "decode" | "" (PD baseline)
    block: str = ""               # "attention" | "ffn" | "moe" | "ssm" | ...
    layer: int = -1               # layer index, -1 = not part of a layer
    pinned: Optional[int] = None  # device id this node MUST run on (KV etc.)
    fused: int = 1                # how many raw equations were fused in
    repeat: int = 1               # launch multiplicity (decode iterations)
    eqn_ids: Tuple[int, ...] = ()  # raw equation indices composing this node

    @property
    def intensity(self) -> float:
        """Operational intensity (FLOP/byte) — the roofline x-axis."""
        return self.flops / max(self.bytes_accessed, 1.0)

    def signature(self) -> Tuple:
        """Structural signature used for layer folding (paper §V-D)."""
        return (self.name, round(self.flops), round(self.bytes_accessed),
                round(self.out_bytes), self.block)


@dataclasses.dataclass
class KernelGraph:
    """DDG: nodes in topological order + RAW edges annotated with bytes.

    ``edges[(i, j)] = nbytes`` means node j reads nbytes produced by node i.
    Edges are deduplicated (multiple buffers between the same pair sum up).
    """

    nodes: List[KernelNode]
    edges: Dict[Tuple[int, int], float]
    name: str = "ddg"

    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        return len(self.nodes)

    @property
    def num_edges(self) -> int:
        return len(self.edges)

    def successors(self, i: int) -> List[int]:
        return [j for (a, j) in self.edges if a == i]

    def predecessors(self, j: int) -> List[int]:
        return [i for (i, b) in self.edges if b == j]

    def adjacency(self) -> Tuple[Dict[int, List[Tuple[int, float]]],
                                 Dict[int, List[Tuple[int, float]]]]:
        """(out_adj, in_adj) as {node: [(other, bytes), ...]}."""
        out: Dict[int, List[Tuple[int, float]]] = {n.idx: [] for n in self.nodes}
        inn: Dict[int, List[Tuple[int, float]]] = {n.idx: [] for n in self.nodes}
        for (i, j), b in self.edges.items():
            out[i].append((j, b))
            inn[j].append((i, b))
        return out, inn

    def total_flops(self) -> float:
        return sum(n.flops for n in self.nodes)

    def total_bytes(self) -> float:
        return sum(n.bytes_accessed for n in self.nodes)

    # ------------------------------------------------------------------ #
    def validate(self) -> None:
        """Invariants: topo order respected, edge endpoints exist."""
        ids = {n.idx for n in self.nodes}
        assert ids == set(range(len(self.nodes))), "node idx must be dense"
        for (i, j), b in self.edges.items():
            assert i in ids and j in ids, f"dangling edge ({i},{j})"
            assert i < j, f"edge ({i},{j}) violates topological order"
            assert b >= 0

    # ------------------------------------------------------------------ #
    def fuse_elementwise(self) -> "KernelGraph":
        """Merge cheap single-consumer elementwise producers into consumers.

        XLA fuses elementwise chains into their consumers; planning at raw
        eqn granularity would overstate both kernel counts and transfer
        opportunities (DESIGN.md §2).  A node is absorbed into its consumer
        when it (a) is elementwise-ish (zero-FLOP reshapes/converts or
        O(n) math), (b) has exactly one consumer, and (c) shares no other
        placement constraint (not pinned differently).
        """
        out_adj, _ = self.adjacency()
        consumers = {n.idx: [j for j, _ in out_adj[n.idx]] for n in self.nodes}
        # Union-find: each raw node -> representative (its final consumer).
        parent = list(range(len(self.nodes)))

        def find(x: int) -> int:
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for n in self.nodes:
            cs = consumers[n.idx]
            if len(cs) != 1:
                continue
            c = cs[0]
            if not _fusible(n):
                continue
            cn = self.nodes[c]
            if n.pinned is not None and cn.pinned is not None \
                    and n.pinned != cn.pinned:
                continue
            # Never fuse across layer/block boundaries: folding (paper
            # §V-D) relies on repeated layers staying structurally
            # identical, and tags staying meaningful.
            if n.layer != cn.layer or n.block != cn.block \
                    or n.phase != cn.phase:
                continue
            parent[find(n.idx)] = find(c)

        groups: Dict[int, List[int]] = {}
        for n in self.nodes:
            groups.setdefault(find(n.idx), []).append(n.idx)

        # New node per group, ordered by representative's topo position.
        reps = sorted(groups)
        remap = {}
        new_nodes: List[KernelNode] = []
        for new_idx, rep in enumerate(reps):
            members = groups[rep]
            rep_node = self.nodes[rep]
            pin = None
            eqn_ids: List[int] = []
            for m in members:
                remap[m] = new_idx
                mn = self.nodes[m]
                if mn.pinned is not None:
                    pin = mn.pinned
                eqn_ids.extend(mn.eqn_ids or (m,))
            new_nodes.append(KernelNode(
                idx=new_idx,
                name=rep_node.name,
                flops=sum(self.nodes[m].flops for m in members),
                bytes_accessed=sum(self.nodes[m].bytes_accessed
                                   for m in members),
                out_bytes=rep_node.out_bytes,
                phase=rep_node.phase,
                block=rep_node.block,
                layer=rep_node.layer,
                pinned=pin,
                fused=sum(self.nodes[m].fused for m in members),
                eqn_ids=tuple(sorted(eqn_ids)),
            ))
        new_edges: Dict[Tuple[int, int], float] = {}
        for (i, j), b in self.edges.items():
            a, c = remap[i], remap[j]
            if a == c:
                continue
            # Producer-into-consumer fusion can only move endpoints forward,
            # so topological order (a < c) is preserved.
            key = (a, c)
            new_edges[key] = new_edges.get(key, 0.0) + b
        g = KernelGraph(new_nodes, new_edges, name=self.name + "+fused")
        g.validate()
        return g

    # ------------------------------------------------------------------ #
    def layer_signature_groups(self) -> Dict[Tuple, List[int]]:
        """Group layer ids by identical structural signature (folding)."""
        sigs: Dict[Tuple, List[int]] = {}
        by_layer: Dict[int, List[KernelNode]] = {}
        for n in self.nodes:
            if n.layer >= 0:
                by_layer.setdefault(n.layer, []).append(n)
        for layer, nodes in by_layer.items():
            sig = tuple(sorted(n.signature() for n in nodes))
            h = hashlib.sha1(repr(sig).encode()).hexdigest()
            sigs.setdefault(h, []).append(layer)
        return sigs

    def stats(self) -> Dict[str, Any]:
        return dict(
            nodes=len(self.nodes),
            edges=len(self.edges),
            gflops=self.total_flops() / 1e9,
            gbytes=self.total_bytes() / 1e9,
            pinned=sum(1 for n in self.nodes if n.pinned is not None),
        )


_ELEMENTWISE_LIKE = frozenset({
    "add", "sub", "mul", "div", "max", "min", "pow", "exp", "log", "tanh",
    "logistic", "rsqrt", "sqrt", "neg", "sign", "abs", "floor", "ceil",
    "convert_element_type", "reshape", "broadcast_in_dim", "transpose",
    "squeeze", "slice", "concatenate", "select_n", "stop_gradient",
    "integer_pow", "erf", "expand_dims", "rem", "and", "or", "not", "xor",
    "eq", "ne", "lt", "le", "gt", "ge", "iota", "clamp", "cos", "sin",
    "cumsum", "cumprod", "copy", "pad", "rev", "dynamic_slice",
    "dynamic_update_slice", "real", "imag", "is_finite", "square",
})


def _fusible(n: KernelNode) -> bool:
    return n.name in _ELEMENTWISE_LIKE and n.pinned is None
