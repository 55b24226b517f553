"""Heterogeneous replica *sizing*: which devices to group, under $/hr.

The cluster layer routes across a GIVEN set of replica groups; this
module searches over the composition itself — which devices from an
inventory pair into which groups — for a rental budget, scored by the
deployment DES.  This is the ROADMAP item HexGen-2 solves with a
genetic scheduler; here the search is a greedy seed refined by
simulated-annealing mutations (swap / add / drop a group), which is
the same shape at the scale this repo simulates (inventories of a few
device types, compositions of 2–8 groups).

Objective: **goodput per dollar** — requests served within BOTH SLO
components per $ of rental (``ClusterResult.goodput * 3600 /
price_rate``).  A fixed open-loop trace is the demand; a composition
wins by serving that demand within SLOs on cheaper hardware, not by
provisioning capacity nobody asked for.  Every candidate is scored by
a full deterministic DES replay, so the search is reproducible
bit-for-bit from (inventory, budget, trace, seed).

Search moves reuse the process-wide plan cache: a candidate that
re-uses an already-planned group template costs only a DES replay
(milliseconds), so the annealing loop stays cheap even though every
score is a real simulation.
"""
from __future__ import annotations

import dataclasses
import math
import random
from collections import Counter
from itertools import combinations_with_replacement
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import planner
from repro_torch.core.costmodel import CATALOG
from repro_torch.core.simulator import ClusterResult
from repro_torch.serving.spec import DeploymentSpec

GroupTemplate = Tuple[str, ...]         # sorted device names, one group


@dataclasses.dataclass
class SizingResult:
    """Outcome of :func:`search_composition`."""
    spec: DeploymentSpec                # best composition found
    score: float                        # goodput/$ (req per dollar)
    result: ClusterResult               # DES result of the best spec
    seed_score: float                   # greedy seed's score
    evals: int                          # distinct compositions scored
    # (iter, candidate, best) — exactly iters + 1 rows, one per
    # iteration including the seed; infeasible mutations carry the
    # incumbent score forward instead of dropping the row
    history: List[Tuple[int, float, float]]
    # finalists re-scored on the full trace (0 unless ``subsample``
    # triggered the confirm tier)
    confirmed: int = 0

    @property
    def composition(self) -> List[List[str]]:
        return self.spec.groups


def group_price(template: Sequence[str]) -> float:
    return sum(CATALOG[n].price for n in template)


def group_templates(inventory: Dict[str, int],
                    max_group: int = 2,
                    min_group: int = 1) -> List[GroupTemplate]:
    """Candidate replica-group shapes drawable from the inventory:
    every multiset of min_group..max_group device types with enough
    stock (``min_group=2`` restricts the search to true multi-device
    groups — the paper's disaggregated deployments)."""
    if not 1 <= min_group <= max_group:
        raise ValueError(f"need 1 <= min_group <= max_group, got "
                         f"{min_group}..{max_group}")
    names = sorted(n for n, c in inventory.items() if c > 0)
    for n in names:
        if n not in CATALOG:
            raise ValueError(f"unknown device {n!r}; "
                             f"pick from {sorted(CATALOG)}")
    out: List[GroupTemplate] = []
    for k in range(min_group, max_group + 1):
        for combo in combinations_with_replacement(names, k):
            need = Counter(combo)
            if all(inventory[n] >= c for n, c in need.items()):
                out.append(tuple(combo))
    return out


def _fits(comp: Sequence[GroupTemplate], inventory: Dict[str, int],
          budget: float) -> bool:
    used: Counter = Counter()
    for t in comp:
        used.update(t)
    if any(used[n] > inventory.get(n, 0) for n in used):
        return False
    return sum(group_price(t) for t in comp) <= budget + 1e-9


def modeled_capacity(template: GroupTemplate, graph,
                     anneal_iters: int = 300) -> float:
    """Steady-state req/s ceiling of one group: 1 / pipelined
    bottleneck of its throughput plan (plan-cache backed)."""
    devices = [CATALOG[n] for n in template]
    plan = planner.plan(graph, devices, policy="throughput",
                        anneal_iters=anneal_iters)
    return 1.0 / max(plan.bottleneck, 1e-12)


def greedy_composition(inventory: Dict[str, int], budget: float, graph,
                       *, max_group: int = 2, min_group: int = 1,
                       anneal_iters: int = 300) -> List[GroupTemplate]:
    """Greedy seed: repeatedly add the feasible group template with the
    best modeled capacity-per-dollar until neither budget nor inventory
    admits another group."""
    templates = group_templates(inventory, max_group, min_group)
    if not templates:
        raise ValueError("inventory admits no group template")
    ratio = {t: modeled_capacity(t, graph, anneal_iters) / group_price(t)
             for t in templates}
    order = sorted(templates, key=lambda t: (-ratio[t], t))
    comp: List[GroupTemplate] = []
    progress = True
    while progress:
        progress = False
        for t in order:
            if _fits(comp + [t], inventory, budget):
                comp.append(t)
                progress = True
                break
    if not comp:
        raise ValueError(f"budget ${budget}/hr cannot afford any group "
                         f"(cheapest template costs "
                         f"${min(group_price(t) for t in templates):.2f})")
    return comp


def uniform_composition(inventory: Dict[str, int], budget: float, graph,
                        *, template: Optional[Sequence[str]] = None,
                        max_group: int = 2,
                        anneal_iters: int = 300) -> List[List[str]]:
    """The naive same-budget baseline: fill the budget with copies of
    ONE group template — by default the highest modeled-capacity
    feasible one (the "just buy the big pairs" strategy the paper's
    heterogeneous compositions are measured against)."""
    if template is None:
        templates = group_templates(inventory, max_group)
        afford = [t for t in templates
                  if group_price(t) <= budget + 1e-9]
        if not afford:
            raise ValueError("budget cannot afford any group")
        template = max(afford, key=lambda t: (
            modeled_capacity(t, graph, anneal_iters), t))
    t = tuple(template)
    comp: List[GroupTemplate] = []
    while _fits(comp + [t], inventory, budget):
        comp.append(t)
    if not comp:
        raise ValueError(f"template {t} never fits budget/inventory")
    return [list(g) for g in comp]


# --------------------------------------------------------------------- #
def search_composition(inventory: Dict[str, int], budget: float,
                       trace, graph, *,
                       iters: int = 60, seed: int = 0,
                       max_group: int = 2, min_group: int = 1,
                       temperature: float = 0.08,
                       spec_kwargs: Optional[Dict[str, Any]] = None,
                       subsample: Optional[int] = None,
                       confirm_top: int = 3,
                       reference: bool = False
                       ) -> SizingResult:
    """Search replica-group compositions for ``budget`` $/hr.

    ``inventory`` maps device-catalog names to available counts;
    ``trace`` is the demand (a ``serving.workload`` trace — give it or
    the spec SLOs so goodput is meaningful); ``graph`` the request DDG
    the planner places.  ``spec_kwargs`` are forwarded into every
    candidate :class:`DeploymentSpec` (router, slos, pd, monitor,
    calibration, ...) — the search varies ONLY ``groups``.

    Greedy seed (capacity/$ ordering) + ``iters`` simulated-annealing
    mutations: swap one group for a random feasible template, add a
    template, or drop a group.  Every candidate is scored by a DES
    replay; annealing accepts uphill always and downhill with
    probability ``exp(rel_delta / T)``, T decaying to 0 over the run.
    Deterministic in all arguments.

    Candidate replays share one prepared request list (SLO assignment,
    token scales and KV sizes depend on the spec's graph/slos — never
    on groups) and skip event recording; only the returned incumbent is
    replayed with full logs.  ``subsample`` scores candidates on the
    first N prepared requests only (a deterministic prefix — the demand
    process is unchanged, just truncated) and then confirms the
    ``confirm_top`` best-scoring distinct compositions, plus the
    annealing incumbent, on the full trace; the final incumbent is the
    confirm-tier argmax.  ``reference=True`` restores the
    pre-vectorization search wholesale — reference walk, per-replay
    trace prep, full event logs, no subsampling — the honest "before"
    for benchmarks.
    """
    skw = dict(spec_kwargs or {})
    skw.setdefault("router", "jsed")
    skw["budget"] = budget
    rng = random.Random(f"sizing:{seed}")
    templates = group_templates(inventory, max_group, min_group)

    cur = greedy_composition(inventory, budget, graph,
                             max_group=max_group, min_group=min_group)
    prepared_full = DeploymentSpec(
        groups=[list(t) for t in cur],
        **skw).compile(graph).prepare(trace)
    if subsample is not None and 0 < subsample < len(prepared_full):
        prepared_score = prepared_full[:subsample]
    else:
        prepared_score = prepared_full

    # key -> (subsample score, spec, compiled deployment); keeping the
    # Deployment means a composition is compiled (cluster built, group
    # plans looked up, units assembled) exactly once no matter how many
    # times the annealer, the confirm tier or the final replay visit it
    cache: Dict[Tuple, Tuple[float, DeploymentSpec, Any]] = {}

    def replay(dep, prepared, events: Optional[str]) -> ClusterResult:
        if reference:
            # the historical route end to end: per-replay trace prep
            # and a full event log — exactly what evaluate() cost
            # before the fast core, so benchmarks against it are honest
            return dep.simulate(trace, events="full", reference=True)
        return dep.simulate(events=events, prepared=prepared)

    def evaluate(comp: Sequence[GroupTemplate]):
        key = tuple(sorted(comp))
        if key not in cache:
            spec = DeploymentSpec(groups=[list(t) for t in comp], **skw)
            dep = spec.compile(graph)
            res = replay(dep, prepared_score, None)
            score = res.goodput * 3600.0 / max(spec.price_rate, 1e-12)
            cache[key] = (score, spec, dep)
        return cache[key]

    def mutate(comp: List[GroupTemplate]
               ) -> Optional[List[GroupTemplate]]:
        op = rng.choice(("swap", "swap", "add", "drop"))
        cand = list(comp)
        if op == "swap":
            cand[rng.randrange(len(cand))] = rng.choice(templates)
        elif op == "add":
            cand.append(rng.choice(templates))
        elif len(cand) > 1:
            cand.pop(rng.randrange(len(cand)))
        else:
            return None
        return cand if _fits(cand, inventory, budget) else None

    cur_score, _, _ = evaluate(cur)
    seed_score = cur_score
    best, best_score = list(cur), cur_score
    history: List[Tuple[int, float, float]] = [(0, cur_score, best_score)]
    for it in range(1, iters + 1):
        T = temperature * (1.0 - it / (iters + 1))
        cand = mutate(cur)
        if cand is None:
            # infeasible mutation: nothing was scored, but the row is
            # still recorded (candidate column carries the incumbent,
            # best column carries best_score) so history is always
            # iters + 1 rows and indices align with the iteration count
            history.append((it, cur_score, best_score))
            continue
        s, _, _ = evaluate(cand)
        rel = (s - cur_score) / max(cur_score, 1e-12)
        if s >= cur_score or rng.random() < math.exp(rel / max(T, 1e-9)):
            cur, cur_score = cand, s
        if s > best_score:
            best, best_score = list(cand), s
        history.append((it, s, best_score))
    evals = len(cache)

    confirmed = 0
    if prepared_score is not prepared_full:
        # confirm tier: re-score the subsample's finalists (and the
        # annealing incumbent, in case it slipped out of the top-K) on
        # the FULL trace; ties break on the composition key so the
        # incumbent is deterministic
        finalists = sorted(cache, key=lambda k: (-cache[k][0], k))
        finalists = finalists[:max(1, confirm_top)]
        bkey = tuple(sorted(best))
        if bkey not in finalists:
            finalists.append(bkey)
        full_scores: Dict[Tuple, float] = {}
        for k in finalists:
            spec, dep = cache[k][1], cache[k][2]
            res = replay(dep, prepared_full, None)
            full_scores[k] = (res.goodput * 3600.0
                              / max(spec.price_rate, 1e-12))
        confirmed = len(full_scores)
        best = list(min(full_scores, key=lambda k: (-full_scores[k], k)))

    bkey = tuple(sorted(best))
    spec, dep = cache[bkey][1], cache[bkey][2]
    result = replay(dep, prepared_full, "full")
    score = result.goodput * 3600.0 / max(spec.price_rate, 1e-12)
    return SizingResult(spec=spec, score=score, result=result,
                        seed_score=seed_score, evals=evals,
                        history=history, confirmed=confirmed)
