"""Throughput-policy placement: minimize max_g max(T_g, M_g).

The paper's throughput objective (§III-B): under steady-state pipelined
execution each device alternates compute and communication, so its stage
time is W_g = max(T_g, M_g) with
    T_g = sum of kernel times assigned to g,
    M_g = sum of transfer costs over incoming cut edges of g,
and system throughput is 1 / max_g W_g.

The MILP is NP-hard (min-max makespan with communication); the paper uses
Gurobi offline.  We implement:
  * three construction seeds (best-device, topological LPT, roofline split),
  * first-improvement local search over single-node moves,
  * simulated annealing refinement (seeded, deterministic),
  * layer folding (paper §V-D): repeated layers are planned once and the
    placement broadcast to structurally identical siblings.
An exact branch-and-bound oracle (bnb.py) verifies optimality on small
graphs in the test suite.
"""
from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.graph import KernelGraph


class MakespanProblem:
    """Pre-indexed incremental evaluator of W(x)."""

    def __init__(self, graph: KernelGraph, devices,
                 bw_override: Optional[float] = None):
        self.graph = graph
        self.devices = devices
        self.nG = len(devices)
        self.n = len(graph)
        self.t = [[dev.kernel_time(nd) for dev in devices]
                  for nd in graph.nodes]
        # edge transfer cost per (device_u, device_g) pair
        self.edges = list(graph.edges.items())   # ((i, j), bytes)
        self.c = {}
        for (i, j), nb in self.edges:
            rep = max(graph.nodes[i].repeat, graph.nodes[j].repeat)
            for u in range(self.nG):
                for g in range(self.nG):
                    if u != g:
                        self.c[(i, j, u, g)] = devices[u].transfer_time(
                            nb, devices[g], bw_override, repeat=rep)
        self.out_edges: List[List[Tuple[int, float]]] = [[] for _ in range(self.n)]
        self.in_edges: List[List[Tuple[int, float]]] = [[] for _ in range(self.n)]
        for (i, j), nb in self.edges:
            self.out_edges[i].append((j, nb))
            self.in_edges[j].append((i, nb))
        self.pins = {nd.idx: nd.pinned for nd in graph.nodes
                     if nd.pinned is not None}

    # -- objective ----------------------------------------------------- #
    def loads(self, x: Sequence[int]) -> Tuple[List[float], List[float]]:
        T = [0.0] * self.nG
        M = [0.0] * self.nG
        for k in range(self.n):
            T[x[k]] += self.t[k][x[k]]
        for (i, j), nb in self.edges:
            u, g = x[i], x[j]
            if u != g:
                M[g] += self.c[(i, j, u, g)]
        return T, M

    def objective(self, x: Sequence[int]) -> float:
        T, M = self.loads(x)
        return max(max(t, m) for t, m in zip(T, M))

    def valid(self, x: Sequence[int]) -> bool:
        return all(x[k] == d for k, d in self.pins.items())

    # -- seeds ---------------------------------------------------------- #
    def seed_best_device(self) -> List[int]:
        x = [min(range(self.nG), key=lambda g: self.t[k][g])
             for k in range(self.n)]
        self._apply_pins(x)
        return x

    def seed_lpt(self) -> List[int]:
        """Topological greedy: place each node on the device minimizing the
        incremental bottleneck (classic LPT adapted with comm costs)."""
        x = [-1] * self.n
        T = [0.0] * self.nG
        M = [0.0] * self.nG
        for k in range(self.n):
            pin = self.pins.get(k)
            cands = [pin] if pin is not None else range(self.nG)
            best_g, best_w = None, math.inf
            for g in cands:
                dT = self.t[k][g]
                dM = 0.0
                for (i, _nb) in self.in_edges[k]:
                    if x[i] >= 0 and x[i] != g:
                        dM += self.c[(i, k, x[i], g)]
                w = max(max(T[g] + dT, M[g] + dM),
                        max(max(T), max(M)) if self.n else 0.0)
                if w < best_w:
                    best_w, best_g = w, g
            x[k] = best_g
            T[best_g] += self.t[k][best_g]
            for (i, _nb) in self.in_edges[k]:
                if x[i] != best_g:
                    M[best_g] += self.c[(i, k, x[i], best_g)]
        return x

    def seed_roofline_split(self) -> List[int]:
        """Compute-bound kernels -> highest peak-FLOPs device;
        memory-bound -> highest-bandwidth device (paper Fig. 3 intuition)."""
        g_flops = max(range(self.nG),
                      key=lambda g: self.devices[g].peak_flops)
        g_bw = max(range(self.nG), key=lambda g: self.devices[g].hbm_bw)
        x = []
        for nd in self.graph.nodes:
            ridge = (self.devices[g_flops].peak_flops /
                     self.devices[g_flops].hbm_bw)
            x.append(g_flops if nd.intensity >= ridge else g_bw)
        self._apply_pins(x)
        return x

    def _apply_pins(self, x: List[int]) -> None:
        for k, d in self.pins.items():
            x[k] = d

    # -- local search ---------------------------------------------------#
    def local_search(self, x: List[int], max_passes: int = 12) -> List[int]:
        x = list(x)
        cur = self.objective(x)
        for _ in range(max_passes):
            improved = False
            for k in range(self.n):
                if k in self.pins:
                    continue
                old = x[k]
                for g in range(self.nG):
                    if g == old:
                        continue
                    x[k] = g
                    w = self.objective(x)
                    if w < cur - 1e-15:
                        cur = w
                        old = g
                        improved = True
                x[k] = old
            if not improved:
                break
        return x

    def anneal(self, x: List[int], iters: int = 4000,
               seed: int = 0) -> List[int]:
        rng = random.Random(seed)
        x = list(x)
        cur = self.objective(x)
        best, best_w = list(x), cur
        free = [k for k in range(self.n) if k not in self.pins]
        if not free or self.nG < 2:
            return best
        t0 = cur * 0.2 + 1e-12
        for it in range(iters):
            temp = t0 * (1.0 - it / iters) + 1e-15
            k = rng.choice(free)
            g = rng.randrange(self.nG)
            if g == x[k]:
                continue
            old = x[k]
            x[k] = g
            w = self.objective(x)
            if w < cur or rng.random() < math.exp((cur - w) / temp):
                cur = w
                if w < best_w:
                    best_w, best = w, list(x)
            else:
                x[k] = old
        return best


def solve_throughput(graph: KernelGraph, devices,
                     bw_override: Optional[float] = None,
                     anneal_iters: int = 4000,
                     seed: int = 0) -> Tuple[List[int], float]:
    """Best placement over all seeds + refinement. Deterministic."""
    prob = MakespanProblem(graph, devices, bw_override)
    cands = [prob.seed_best_device(), prob.seed_lpt(),
             prob.seed_roofline_split()]
    best, best_w = None, math.inf
    for x in cands:
        x = prob.local_search(x)
        w = prob.objective(x)
        if w < best_w:
            best, best_w = x, w
    x = prob.anneal(best, iters=anneal_iters, seed=seed)
    x = prob.local_search(x)
    w = prob.objective(x)
    if w < best_w:
        best, best_w = x, w
    assert prob.valid(best)
    return best, best_w


# --------------------------------------------------------------------- #
# Layer folding (paper §V-D): plan one representative of each group of
# structurally identical layers and broadcast the placement.
# --------------------------------------------------------------------- #
def fold_and_solve(graph: KernelGraph, devices, solver,
                   **solver_kwargs) -> Tuple[List[int], float]:
    """``solver(graph, devices, **kwargs) -> (labels, obj)`` applied to a
    folded problem.  Nodes of non-representative layers inherit the
    placement of the structurally matching node in the representative.
    Falls back to the full solve when folding finds no repetition.
    """
    groups = graph.layer_signature_groups()
    rep_layers = {min(layers): layers for layers in groups.values()
                  if len(layers) > 1}
    if not rep_layers:
        return solver(graph, devices, **solver_kwargs)

    folded_members = {l for layers in rep_layers.values() for l in layers}
    keep = [n.idx for n in graph.nodes
            if n.layer not in folded_members or n.layer in rep_layers]
    keep_set = set(keep)
    remap = {old: new for new, old in enumerate(keep)}

    # Map any node in a folded (non-representative) layer to the node at
    # the same intra-layer position in its representative.
    by_layer: Dict[int, List[int]] = {}
    for n in graph.nodes:
        by_layer.setdefault(n.layer, []).append(n.idx)
    layer_rep = {}
    for rep, layers in rep_layers.items():
        for l in layers:
            layer_rep[l] = rep
    to_rep: Dict[int, int] = {}
    for n in graph.nodes:
        rep = layer_rep.get(n.layer)
        if rep is None or n.layer == rep:
            to_rep[n.idx] = n.idx
        else:
            pos = by_layer[n.layer].index(n.idx)
            to_rep[n.idx] = by_layer[rep][pos]

    import dataclasses as _dc
    rep_count = {rep: len(layers) for rep, layers in rep_layers.items()}
    sub_nodes = []
    for old in keep:
        nd = graph.nodes[old]
        mult = rep_count.get(nd.layer, 1)
        sub_nodes.append(_dc.replace(
            nd, idx=remap[old],
            flops=nd.flops * mult,
            bytes_accessed=nd.bytes_accessed * mult,
            eqn_ids=nd.eqn_ids))
    # Edges: remap endpoints onto representatives so every cut cost in the
    # full graph is represented (scaled by its multiplicity) in the folded
    # one.  Without this, M_g is undercounted by the fold factor and the
    # solver over-cuts.
    sub_edges: Dict[Tuple[int, int], float] = {}
    for (i, j), b in graph.edges.items():
        ri, rj = to_rep[i], to_rep[j]
        if ri == rj:
            continue                    # inter-layer copy of a fold: the
                                        # same-position self edge is moot
        a, c = remap[ri], remap[rj]
        if a == c:
            continue
        key = (min(a, c), max(a, c))
        sub_edges[key] = sub_edges.get(key, 0.0) + b
    sub = KernelGraph(sub_nodes, sub_edges, name=graph.name + "+folded")
    labels_sub, _ = solver(sub, devices, **solver_kwargs)

    # Broadcast placement: match nodes by (layer-relative position).
    by_layer: Dict[int, List[int]] = {}
    for n in graph.nodes:
        by_layer.setdefault(n.layer, []).append(n.idx)
    labels = [0] * len(graph)
    for old in keep:
        labels[old] = labels_sub[remap[old]]
    for rep, layers in rep_layers.items():
        rep_nodes = by_layer[rep]
        for l in layers:
            if l == rep:
                continue
            for pos, old in enumerate(by_layer[l]):
                labels[old] = labels[rep_nodes[pos]]
    # Honor pins on non-representative layers.
    for n in graph.nodes:
        if n.pinned is not None:
            labels[n.idx] = n.pinned
    prob = MakespanProblem(graph, devices,
                           solver_kwargs.get("bw_override"))
    return labels, prob.objective(labels)
