"""The port's framework-neutral core (graph, costmodel, mincut, makespan,
bnb, planner, monitor) against the reference's: on the same kernel
graphs both give bit-identical placements, stages, objectives,
bottlenecks and summaries, for both policies; and the port's copies pass
the reference's own planner and monitor cases."""
import dataclasses
import random

import pytest

pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:      # collect without hypothesis (tier-1 guard)
    from _hypothesis_stub import given, settings, strategies as st

from repro.core import monitor as JMON  # noqa: E402
from repro.core import planner as JP  # noqa: E402
from repro.core.costmodel import CATALOG as JCAT  # noqa: E402
from repro_torch.core import bnb, planner  # noqa: E402
from repro_torch.core import monitor as TMON  # noqa: E402
from repro_torch.core.costmodel import (CATALOG, PAPER_PAIRS,  # noqa: E402
                                        graph_time_on)
from repro_torch.core.graph import KernelGraph, KernelNode  # noqa: E402
from repro_torch.core.makespan import (MakespanProblem,  # noqa: E402
                                       fold_and_solve, solve_throughput)

from _torch_parity import to_port  # noqa: E402
from conftest import random_dag  # noqa: E402

PAIR = PAPER_PAIRS[1]                       # ("h100", "rtxpro6000")
DEVS2 = [CATALOG["a100"], CATALOG["l40s"]]
DEVS3 = [CATALOG["a100"], CATALOG["l40s"], CATALOG["h100"]]


def _stages(p):
    return [dataclasses.astuple(s) for s in p.stages]


def _same_plan(jp, tp):
    assert tp.labels == jp.labels
    assert _stages(tp) == _stages(jp)
    assert tp.objective == jp.objective
    assert tp.bottleneck == jp.bottleneck
    assert (tp.T, tp.M, tp.cut_bytes, tp.cut_edges) == \
        (jp.T, jp.M, jp.cut_bytes, jp.cut_edges)
    assert tp.summary() == jp.summary()


# --------------------------------------------------------------------- #
# Bit-identical plans
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("policy", ["latency", "throughput"])
@pytest.mark.parametrize("pin_frac", [0.0, 0.25])
@pytest.mark.parametrize("n,seed", [(10, 0), (10, 1), (16, 2), (24, 3),
                                    (40, 4), (60, 5)])
def test_plan_bit_identical_to_reference(n, seed, pin_frac, policy):
    g = random_dag(n, seed=seed, pin_frac=pin_frac)
    jp = JP.plan(g, [JCAT[d] for d in PAIR], policy=policy, cache=False,
                 anneal_iters=1000)
    tp = planner.plan(to_port(g), [CATALOG[d] for d in PAIR],
                      policy=policy, cache=False, anneal_iters=1000)
    _same_plan(jp, tp)


@pytest.mark.parametrize("bw", [1e3, 1e9, 200e9])
def test_plan_bit_identical_under_bw_override(bw):
    g = random_dag(20, seed=11, pin_frac=0.1)
    for policy in ("latency", "throughput"):
        jp = JP.plan(g, [JCAT[d] for d in PAIR], policy=policy,
                     cache=False, bw_override=bw, anneal_iters=500)
        tp = planner.plan(to_port(g), [CATALOG[d] for d in PAIR],
                          policy=policy, cache=False, bw_override=bw,
                          anneal_iters=500)
        _same_plan(jp, tp)


def test_plan_bit_identical_three_devices_and_folding():
    """alpha-expansion (3 devices) and the folded throughput solve on a
    stack of identical layers."""
    g = random_dag(9, seed=4)
    names = ("a100", "l40s", "h100")
    jp = JP.plan(g, [JCAT[d] for d in names], policy="latency",
                 cache=False)
    tp = planner.plan(to_port(g), [CATALOG[d] for d in names],
                      policy="latency", cache=False)
    _same_plan(jp, tp)
    tg, _ = _stack(to_port(random_dag(6, seed=4)), 8)
    jg = _stack_ref(random_dag(6, seed=4), 8)
    jp = JP.plan(jg, [JCAT[d] for d in PAIR], policy="throughput",
                 cache=False)
    tp = planner.plan(tg, [CATALOG[d] for d in PAIR],
                      policy="throughput", cache=False)
    _same_plan(jp, tp)


def _stack(base: KernelGraph, L: int):
    nodes, edges = [], {}
    for layer in range(L):
        off = layer * len(base)
        for n in base.nodes:
            nodes.append(dataclasses.replace(n, idx=off + n.idx,
                                             layer=layer,
                                             eqn_ids=(off + n.idx,)))
        for (i, j), b in base.edges.items():
            edges[(off + i, off + j)] = b
        if layer > 0:
            edges[(off - 1, off)] = 1e5
    g = KernelGraph(nodes, edges, name="stack")
    g.validate()
    return g, len(base)


def _stack_ref(base, L: int):
    from repro.core.graph import KernelGraph as JKG
    g, _ = _stack(to_port(base), L)
    from repro.core.graph import KernelNode as JKN
    return JKG([JKN(**dataclasses.asdict(n)) for n in g.nodes],
               dict(g.edges), name=g.name)


def test_graph_helpers_match_reference():
    g = random_dag(30, seed=7, pin_frac=0.2)
    tg = to_port(g)
    assert tg.stats() == g.stats()
    assert tg.layer_signature_groups() == g.layer_signature_groups()
    jf, tf = g.fuse_elementwise(), tg.fuse_elementwise()
    assert [dataclasses.astuple(n) for n in tf.nodes] == \
        [dataclasses.astuple(n) for n in jf.nodes]
    assert tf.edges == jf.edges
    assert JP.graph_key(g) == planner.graph_key(tg)
    for name in CATALOG:
        assert [CATALOG[name].kernel_time(n) for n in tg.nodes] == \
            [JCAT[name].kernel_time(n) for n in g.nodes]


# --------------------------------------------------------------------- #
# The reference's planner cases, on the port
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", range(4))
def test_mincut_matches_exact_latency(seed):
    g = to_port(random_dag(10, seed=seed, pin_frac=0.2))
    p = planner.plan(g, DEVS2, policy="latency", cache=False)
    _, w_exact = bnb.solve_exact(g, DEVS2, objective="latency")
    assert p.objective == pytest.approx(w_exact, rel=1e-9)


@pytest.mark.parametrize("seed", range(3))
def test_alpha_expansion_matches_exact_3dev(seed):
    g = to_port(random_dag(9, seed=seed))
    p = planner.plan(g, DEVS3, policy="latency", cache=False)
    _, w_exact = bnb.solve_exact(g, DEVS3, objective="latency")
    assert p.objective <= w_exact * 1.001


@pytest.mark.parametrize("seed", range(4))
def test_throughput_heuristic_near_optimal(seed):
    g = to_port(random_dag(10, seed=seed, pin_frac=0.2))
    p = planner.plan(g, DEVS2, policy="throughput", cache=False,
                     anneal_iters=2000)
    _, w_exact = bnb.solve_exact(g, DEVS2, objective="throughput")
    assert p.objective <= w_exact * 1.05
    assert p.objective >= w_exact * (1 - 1e-9)


def test_pins_are_respected():
    g = to_port(random_dag(12, seed=3, pin_frac=0.4))
    for policy in ("latency", "throughput"):
        p = planner.plan(g, DEVS2, policy=policy, cache=False)
        for n in g.nodes:
            if n.pinned is not None:
                assert p.labels[n.idx] == n.pinned


def test_every_kernel_assigned_exactly_once():
    g = to_port(random_dag(30, seed=5))
    p = planner.plan(g, DEVS2, policy="throughput", cache=False)
    assert len(p.labels) == len(g)
    assert set(p.labels) <= {0, 1}
    covered = sorted(k for s in p.stages for k in s.node_ids)
    assert covered == list(range(len(g)))


def test_throughput_objective_definition():
    g = to_port(random_dag(15, seed=7))
    prob = MakespanProblem(g, DEVS2)
    x = [k % 2 for k in range(len(g))]
    T, M = prob.loads(x)
    assert prob.objective(x) == pytest.approx(
        max(max(T[0], M[0]), max(T[1], M[1])))


def test_homogeneous_fallback_no_cut():
    g = to_port(random_dag(14, seed=2))
    p = planner.plan(g, DEVS2, policy="latency", cache=False,
                     bw_override=1e3)
    assert p.cut_edges == 0
    assert len(set(p.labels)) == 1


def test_bandwidth_sensitivity_monotone_cut():
    g = to_port(random_dag(25, seed=11))
    objs = [planner.plan(g, DEVS2, policy="latency", cache=False,
                         bw_override=bw).objective
            for bw in (1e6, 1e9, 25e9, 200e9)]
    assert objs == sorted(objs, reverse=True)


def test_layer_folding_quality():
    g, _ = _stack(to_port(random_dag(6, seed=4)), 6)
    direct, w_direct = solve_throughput(g, DEVS2, anneal_iters=3000)
    folded, w_folded = fold_and_solve(g, DEVS2, solve_throughput,
                                      anneal_iters=3000)
    assert w_folded <= w_direct * 2.0
    assert MakespanProblem(g, DEVS2).objective(folded) == \
        pytest.approx(w_folded)


def test_elastic_replan_on_device_loss():
    g = to_port(random_dag(20, seed=6, pin_frac=0.2, num_devices=3))
    p3 = planner.plan(g, DEVS3, policy="throughput", cache=False)
    p2 = planner.replan_on_failure(g, DEVS3, lost={2}, old=p3, cache=False)
    assert set(p2.labels) <= {0, 1}
    assert len(p2.labels) == len(g)


def test_plan_cache_hit():
    g = to_port(random_dag(15, seed=8))
    assert planner.plan(g, DEVS2, policy="throughput") is \
        planner.plan(g, DEVS2, policy="throughput")


def test_gpu_pair_heterogeneity_is_exploited():
    """On the H100 + RTX Pro 6000 pair a mix of compute-bound GEMMs and
    bandwidth-bound elementwise kernels plans below either device alone
    (modeled times)."""
    nodes = []
    for i in range(16):
        if i % 2 == 0:
            nodes.append(KernelNode(i, "dot_general", flops=2e11,
                                    bytes_accessed=1e8, out_bytes=1e6,
                                    eqn_ids=(i,)))
        else:
            nodes.append(KernelNode(i, "add", flops=1e8,
                                    bytes_accessed=4e9, out_bytes=1e6,
                                    eqn_ids=(i,)))
    g = KernelGraph(nodes, {(i, i + 1): 1e5 for i in range(15)})
    devs = [CATALOG[d] for d in PAIR]
    p = planner.plan(g, devs, policy="throughput", cache=False)
    assert p.objective < min(graph_time_on(g, d) for d in devs)


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 10_000), n=st.integers(4, 24),
       policy=st.sampled_from(["latency", "throughput"]),
       pin_frac=st.sampled_from([0.0, 0.25]))
def test_property_plan_matches_reference(seed, n, policy, pin_frac):
    g = random_dag(n, seed=seed, pin_frac=pin_frac)
    jp = JP.plan(g, [JCAT[d] for d in PAIR], policy=policy, cache=False,
                 anneal_iters=300)
    tp = planner.plan(to_port(g), [CATALOG[d] for d in PAIR],
                      policy=policy, cache=False, anneal_iters=300)
    _same_plan(jp, tp)
    covered = sorted(k for s in tp.stages for k in s.node_ids)
    assert covered == list(range(n))


# --------------------------------------------------------------------- #
# Monitor: the reference's cases, on both monitors
# --------------------------------------------------------------------- #
def _queueing(M):
    mon = M.OnlineMonitor(M.MonitorConfig(window=1.0, beta=1.5))
    for i in range(5):
        mon.record_request(now=0.2 * i, request_latency=1.0,
                           exec_latency=0.1)
    mon.tick(1.1)
    assert mon.policy == "throughput" and mon.switches == 1
    return mon


def _light_load(M):
    mon = M.OnlineMonitor(M.MonitorConfig(window=1.0, beta=1.5),
                          initial_policy="throughput")
    for i in range(5):
        mon.record_request(now=0.2 * i, request_latency=0.105,
                           exec_latency=0.1)
    mon.tick(1.1)
    assert mon.policy == "latency"
    return mon


def _window_boundary(M):
    mon = M.OnlineMonitor(M.MonitorConfig(window=1.0, beta=1.5))
    for i in range(8):
        mon.record_request(now=0.1 * (i + 1), request_latency=50.0,
                           exec_latency=0.1)
        assert mon.policy == "latency"
    mon.tick(1.2)
    assert mon.policy == "throughput"
    return mon


def _stall_accounting(M):
    mon = M.OnlineMonitor(M.MonitorConfig(window=1.0, beta=1.5,
                                          switch_stall=0.025))
    for k in range(6):
        ratio = 10.0 if k % 2 == 0 else 1.0
        mon.record_request(now=k + 0.1, request_latency=ratio * 0.1,
                           exec_latency=0.1)
        mon.tick(k + 1.2)
    assert mon.switches == 6
    assert mon.stall_time == pytest.approx(6 * 0.025)
    return mon


def _hysteresis(M):
    rng = random.Random(0)
    mon = M.OnlineMonitor(M.MonitorConfig(window=1.0, beta=1.5,
                                          hysteresis=0.05))
    for k in range(50):
        ratio = 1.5 * (1.0 + rng.uniform(-0.04, 0.04))
        mon.record_request(now=k + 0.5, request_latency=ratio,
                           exec_latency=1.0)
        mon.tick(k + 1.0)
    assert mon.switches == 0
    mon.record_request(now=51.5, request_latency=1.6, exec_latency=1.0)
    mon.tick(52.6)
    assert mon.policy == "throughput"
    return mon


def _idle_gap(M):
    mon = M.OnlineMonitor(M.MonitorConfig(window=0.5, beta=1.5))
    mon.tick(0.0)
    mon.record_request(now=0.1, request_latency=10.0, exec_latency=0.1)
    mon.record_kernel_group(0.004)
    mon.record_kernel_group(0.008)
    mon.tick(100.0)
    assert mon.switches == 1 and len(mon.history) == 1
    assert mon.history[-1][3] == pytest.approx(0.006)
    return mon


def _alternating(M):
    rng = random.Random(0)
    mon = M.OnlineMonitor(M.MonitorConfig(window=0.5, beta=1.1))
    for i in range(200):
        q = (2.5 if (i // 40) % 2 == 0 else 1.01) * rng.uniform(0.9, 1.1)
        mon.record_request(i * 0.05, request_latency=q * 0.1,
                           exec_latency=0.1)
    return mon


@pytest.mark.parametrize("scenario", [
    _queueing, _light_load, _window_boundary, _stall_accounting,
    _hysteresis, _idle_gap, _alternating], ids=lambda f: f.__name__[1:])
def test_monitor_matches_reference(scenario):
    t, j = scenario(TMON), scenario(JMON)
    assert (t.policy, t.switches, t.stall_time, t.history) == \
        (j.policy, j.switches, j.stall_time, j.history)
