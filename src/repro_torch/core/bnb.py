"""Exact branch-and-bound placement oracle (small graphs only).

Used by the test suite to certify that the min-cut solver is globally
optimal (it must match this oracle exactly on the latency objective) and
that the makespan heuristics land within a small factor of optimal.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.graph import KernelGraph
from repro_torch.core.makespan import MakespanProblem


def solve_exact(graph: KernelGraph, devices, objective: str = "throughput",
                bw_override: Optional[float] = None,
                node_limit: int = 18) -> Tuple[List[int], float]:
    """Exhaustive DFS with admissible pruning. O(|G|^n) worst case."""
    n = len(graph)
    if n > node_limit:
        raise ValueError(f"graph too large for exact solve ({n} nodes)")
    prob = MakespanProblem(graph, devices, bw_override)
    nG = prob.nG
    best_x: List[int] = []
    best_w = math.inf
    x = [0] * n
    t_min = [min(prob.t[k]) for k in range(n)]

    def lat_partial(k: int) -> float:
        """Latency objective of prefix [0, k) + admissible remainder."""
        e = sum(prob.t[i][x[i]] for i in range(k))
        for (i, j), _nb in prob.edges:
            if i < k and j < k and x[i] != x[j]:
                e += prob.c[(i, j, x[i], x[j])]
        return e + sum(t_min[k:])

    def thr_partial(k: int) -> float:
        T = [0.0] * nG
        M = [0.0] * nG
        for i in range(k):
            T[x[i]] += prob.t[i][x[i]]
        for (i, j), _nb in prob.edges:
            if i < k and j < k and x[i] != x[j]:
                M[x[j]] += prob.c[(i, j, x[i], x[j])]
        lb1 = max(max(t, m) for t, m in zip(T, M))
        lb2 = (sum(T) + sum(t_min[k:])) / nG      # average-load bound
        return max(lb1, lb2)

    bound = lat_partial if objective == "latency" else thr_partial

    def full(xx: List[int]) -> float:
        if objective == "latency":
            e = sum(prob.t[i][xx[i]] for i in range(n))
            for (i, j), _nb in prob.edges:
                if xx[i] != xx[j]:
                    e += prob.c[(i, j, xx[i], xx[j])]
            return e
        return prob.objective(xx)

    def dfs(k: int) -> None:
        nonlocal best_w, best_x
        if k == n:
            w = full(x)
            if w < best_w:
                best_w, best_x = w, list(x)
            return
        pin = prob.pins.get(k)
        for g in ([pin] if pin is not None else range(nG)):
            x[k] = g
            if bound(k + 1) < best_w - 1e-15:
                dfs(k + 1)
        x[k] = 0

    dfs(0)
    return best_x, best_w
