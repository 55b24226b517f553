"""The port's cluster DES (``repro_torch.core.simulator`` under
``repro_torch.serving.spec``) against the reference's, on the CPU.

Both packages compile the same ``DeploymentSpec`` on the same kernel
graph (built once with ``conftest.random_dag`` and carried into the
port by ``to_port``), replay the same trace, and must give results that
are ``==`` field by field: event logs, latencies, TTFTs, assignments,
busy times, shed and SLO counts, transfers.  The grid is
``tests/test_des_fast.py``'s — routers, pd on/off, kv_chunks on/off,
controller on/off, failure injection, the ``agg``/``full``/``None``
event modes and the long-program vector walk — on both replica walks
(``reference=True`` and the fast walk).  ``simulate_offline`` /
``simulate_online`` are held to the reference as in
``tests/test_monitor_sim.py``.
"""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.core import planner as JP  # noqa: E402
from repro.core import simulator as JS  # noqa: E402
from repro.core.costmodel import CATALOG as JCAT  # noqa: E402
from repro.core.monitor import MonitorConfig as JMonCfg  # noqa: E402
from repro.core.monitor import OnlineMonitor as JMon  # noqa: E402
from repro.serving import controller as JCTL  # noqa: E402
from repro.serving import sizing as JSZ  # noqa: E402
from repro.serving import spec as JSPEC  # noqa: E402
from repro.serving import workload as JW  # noqa: E402
from repro_torch.core import planner as TP  # noqa: E402
from repro_torch.core import simulator as TS  # noqa: E402
from repro_torch.core.costmodel import CATALOG as TCAT  # noqa: E402
from repro_torch.core.monitor import MonitorConfig as TMonCfg  # noqa: E402
from repro_torch.core.monitor import OnlineMonitor as TMon  # noqa: E402
from repro_torch.serving import controller as TCTL  # noqa: E402
from repro_torch.serving import sizing as TSZ  # noqa: E402
from repro_torch.serving import spec as TSPEC  # noqa: E402
from repro_torch.serving import workload as TW  # noqa: E402

from _torch_parity import assert_same_result, to_port  # noqa: E402
from conftest import random_dag  # noqa: E402

GROUPS = [["a100", "l40s"], ["h100", "h100"], ["a100", "l40s"]]
SLOS = {"base": 2.0, "per_output_token": 0.05, "ttft": 1.5}
ANNEAL = 150
DEVS = ("a100", "l40s")


def _phased(g, pin_alternating=False):
    nodes = [dataclasses.replace(
        node, phase="prefill" if node.idx < len(g.nodes) // 2 else "decode",
        pinned=(node.idx % 2 if pin_alternating else node.pinned))
        for node in g.nodes]
    g2 = type(g)(nodes, dict(g.edges), name=g.name + ".des")
    g2.validate()
    return g2


def _both(g):
    """(the reference's graph, the port's copy of it)."""
    return g, to_port(g)


@pytest.fixture(scope="module")
def graph():
    return _both(_phased(random_dag(24, seed=2)))


@pytest.fixture(scope="module")
def deep_graph():
    return _both(_phased(random_dag(80, seed=2), pin_alternating=True))


def _trace(W, n=400, rate=40.0, seed=0):
    return W.diurnal_trace(rate, n, seed=seed)


def _simulate(SPEC, W, g, spec_kwargs, reference, **sim_kwargs):
    kw = dict(anneal_iters=ANNEAL, **spec_kwargs)
    return SPEC.DeploymentSpec(**kw).compile(g).simulate(
        _trace(W), reference=reference, **sim_kwargs)


def _pair(graph, spec_kwargs, reference, **sim_kwargs):
    jg, tg = graph
    ref = _simulate(JSPEC, JW, jg, spec_kwargs, reference, **sim_kwargs)
    port = _simulate(TSPEC, TW, tg, spec_kwargs, reference, **sim_kwargs)
    return ref, port


WALKS = pytest.mark.parametrize("reference", [True, False],
                                ids=["ref_walk", "fast_walk"])


@WALKS
@pytest.mark.parametrize("router", ["jsed", "round_robin",
                                    "least_loaded"])
def test_colocated_routers_match_reference(graph, router, reference):
    ref, port = _pair(graph, dict(groups=GROUPS, router=router,
                                  slos=SLOS), reference)
    assert ref.events and ref.completed > 0
    assert_same_result(ref, port)


@WALKS
@pytest.mark.parametrize("kv_chunks", [1, 4])
def test_pd_split_matches_reference(graph, kv_chunks, reference):
    ref, port = _pair(graph, dict(groups=GROUPS, router="pd_split",
                                  slos=SLOS, pd=True,
                                  kv_chunks=kv_chunks), reference)
    assert ref.transfers > 0
    assert_same_result(ref, port)


def _controller(CTL):
    return CTL.AutoscalePolicy(
        CTL.AutoscaleConfig(interval=0.05, window=0.2, cooldown=0.1,
                            warmup=0.05, queue_hi=0.5, queue_lo=0.15,
                            util_lo=0.6),
        inventory=[["l40s"], ["a100"]])


@WALKS
@pytest.mark.parametrize("failures", [None, [(5.0, 1)]],
                         ids=["no_fail", "fail"])
def test_controller_and_failures_match_reference(graph, failures,
                                                 reference):
    out = []
    for SPEC, W, CTL, g in ((JSPEC, JW, JCTL, graph[0]),
                            (TSPEC, TW, TCTL, graph[1])):
        dep = SPEC.DeploymentSpec(groups=GROUPS, router="jsed", slos=SLOS,
                                  budget=60.0,
                                  anneal_iters=ANNEAL).compile(g)
        out.append(dep.simulate(_trace(W), controller=_controller(CTL),
                                failures=failures, reference=reference))
    assert_same_result(*out)


@pytest.mark.parametrize("events", ["full", "agg", None])
def test_event_modes_match_reference(graph, events):
    ref, port = _pair(graph, dict(groups=GROUPS, router="jsed",
                                  slos=SLOS), False, events=events)
    if events == "agg":
        assert ref.event_agg is not None and ref.events == []
    assert_same_result(ref, port)


def test_agg_equals_full_reduction_in_the_port(graph):
    _, tg = graph
    dep = TSPEC.DeploymentSpec(groups=GROUPS, router="jsed", slos=SLOS,
                               anneal_iters=ANNEAL).compile(tg)
    full = dep.simulate(_trace(TW))
    agg = dep.simulate(_trace(TW), events="agg")
    reduced = TS.EventAggregate.from_events(full.events)
    assert agg.event_agg.counts == reduced.counts
    assert agg.event_agg.seconds == reduced.seconds
    assert agg.latencies == full.latencies


def test_events_mode_validated(graph):
    dep = TSPEC.DeploymentSpec(groups=GROUPS,
                               anneal_iters=ANNEAL).compile(graph[1])
    with pytest.raises(ValueError, match="events"):
        dep.simulate(_trace(TW, n=5), events="everything")


@WALKS
def test_vector_walk_long_programs_match_reference(deep_graph, reference):
    kw = dict(groups=[["a100", "l40s"], ["h100", "h100"]],
              router="jsed", slos=SLOS, anneal_iters=50)
    out = []
    for SPEC, W, g in ((JSPEC, JW, deep_graph[0]),
                       (TSPEC, TW, deep_graph[1])):
        dep = SPEC.DeploymentSpec(**kw).compile(g)
        units = dep.cluster().build_replicas()[0].unit_sets
        assert all(len(us) >= 48 for us in units.values()), \
            "fixture no longer exercises the vector walk"
        out.append(dep.simulate(_trace(W, n=300, rate=60.0),
                                reference=reference))
    assert_same_result(*out)


def test_same_seed_same_event_log_across_runs(graph):
    a = _simulate(TSPEC, TW, graph[1], dict(groups=GROUPS, slos=SLOS),
                  False)
    b = _simulate(TSPEC, TW, graph[1], dict(groups=GROUPS, slos=SLOS),
                  False)
    assert a.events and a.events == b.events


def test_program_cache_keys_by_content():
    us1 = [TS.ReplicaUnit(1, 0, 0.5, 0.3), TS.ReplicaUnit(0, 1, 0.1, 1.0)]
    us2 = [TS.ReplicaUnit(1, 0, 0.5, 0.3), TS.ReplicaUnit(0, 1, 0.1, 1.0)]
    assert TS.compile_units(us1) is TS.compile_units(us2)
    assert TS.compile_units(us1).service(2.0, 3.0) == sum(
        u.scaled(2.0, 3.0) for u in us1)


@pytest.mark.parametrize("subsample", [None, 80])
def test_sizing_search_matches_reference(graph, subsample):
    out = []
    for SZ, W, g in ((JSZ, JW, graph[0]), (TSZ, TW, graph[1])):
        out.append(SZ.search_composition(
            {"a100": 2, "l40s": 2}, 30.0, _trace(W, n=240, rate=30.0,
                                                 seed=4),
            g, iters=10, seed=0, subsample=subsample,
            spec_kwargs={"slos": SLOS, "anneal_iters": ANNEAL}))
    ref, port = out
    assert port.composition == ref.composition
    assert port.spec.to_json() == ref.spec.to_json()
    assert (port.score, port.seed_score, port.evals, port.confirmed) == \
        (ref.score, ref.seed_score, ref.evals, ref.confirmed)
    assert port.history == ref.history
    assert_same_result(ref.result, port.result)


# --------------------------------------------------------------------- #
# simulate_offline / simulate_online (the single-replica DES)
# --------------------------------------------------------------------- #
def _toy_plans(seed, n=24):
    g = random_dag(n, seed=seed)
    out = []
    for P, CAT, gg in ((JP, JCAT, g), (TP, TCAT, to_port(g))):
        devs = [CAT[d] for d in DEVS]
        out.append((gg, devs, {
            pol: P.plan(gg, devs, policy=pol, cache=False,
                        anneal_iters=500)
            for pol in ("latency", "throughput")}))
    return out


@pytest.mark.parametrize("pipelined,scheduling", [
    (True, "priority"), (True, "fifo"), (False, "priority")])
@pytest.mark.parametrize("seed", [3, 7])
def test_simulate_offline_matches_reference(seed, pipelined, scheduling):
    (jg, jd, jp), (tg, td, tp) = _toy_plans(seed)
    ref = JS.simulate_offline(jg, jp["throughput"], jd, num_requests=32,
                              pipelined=pipelined, scheduling=scheduling)
    port = TS.simulate_offline(tg, tp["throughput"], td, num_requests=32,
                               pipelined=pipelined, scheduling=scheduling)
    assert ref.events and ref.completed == 32
    assert_same_result(ref, port)


@pytest.mark.parametrize("with_monitor", [False, True],
                         ids=["static", "monitor"])
def test_simulate_online_matches_reference(with_monitor):
    (jg, jd, jp), (tg, td, tp) = _toy_plans(11, n=30)
    exec_lat = jp["latency"].unpipelined_latency
    rate = 2.0 / exec_lat
    out = []
    for S, g, d, plans, Mon, Cfg in ((JS, jg, jd, jp, JMon, JMonCfg),
                                     (TS, tg, td, tp, TMon, TMonCfg)):
        mon = Mon(Cfg(window=exec_lat * 20, beta=1.5)) \
            if with_monitor else None
        out.append(S.simulate_online(
            g, plans if with_monitor else {"latency": plans["latency"]},
            d, rate=rate, num_requests=120, monitor=mon, seed=3))
    ref, port = out
    if with_monitor:
        assert ref.switches >= 1
    assert_same_result(ref, port)
