"""The port's contended fabric (``repro_torch.serving.fabric``), fault
layer (``repro_torch.serving.faults``) and elastic executor
(``repro_torch.runtime.fault``) against the reference's, on the CPU.

  * ``Topology`` / ``FaultPlan`` JSON text identical to the reference's;
  * the cluster DES with a contended fabric, and under crash, straggle
    and flaky-link plans with and without checkpoint recovery, ``==``
    to the reference's DES on both replica walks;
  * ``LiveFabric`` / ``LiveChannel`` accounting of the port's shards
    equal to the reference's of its own;
  * ``corrupt_slice`` flips a byte of a clone that ``KvSlice.verify``
    catches, and a ``CheckpointStore`` round trip of CPU tensors
    restores a session that decodes on bit-identically;
  * ``ElasticExecutor`` re-plans and rebuilds on device loss and keeps
    the eager decode step's logits.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import fabric as JF  # noqa: E402
from repro.serving import faults as JX  # noqa: E402
from repro.serving import kvpool as JK  # noqa: E402
from repro.serving import spec as JSPEC  # noqa: E402
from repro.serving import workload as JW  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch.core import analyzer  # noqa: E402
from repro_torch.core.costmodel import CATALOG  # noqa: E402
from repro_torch.core.executor import logical_devices  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.runtime.fault import ElasticExecutor  # noqa: E402
from repro_torch.serving import fabric as TF  # noqa: E402
from repro_torch.serving import faults as TX  # noqa: E402
from repro_torch.serving import kvpool as TK  # noqa: E402
from repro_torch.serving import spec as TSPEC  # noqa: E402
from repro_torch.serving import workload as TW  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402

from _torch_parity import assert_same_result, to_port  # noqa: E402
from conftest import random_dag  # noqa: E402

GROUPS = [["a100", "l40s"], ["h100", "h100"], ["a100", "l40s"]]
SLOS = {"base": 2.0, "per_output_token": 0.05, "ttft": 1.5}
ANNEAL = 150
SIDES = ((JSPEC, JW, JF, JX), (TSPEC, TW, TF, TX))


def _phased(g):
    nodes = [dataclasses.replace(
        node, phase="prefill" if node.idx < len(g.nodes) // 2 else "decode")
        for node in g.nodes]
    g2 = type(g)(nodes, dict(g.edges), name=g.name + ".des")
    g2.validate()
    return g2


@pytest.fixture(scope="module")
def graphs():
    g = _phased(random_dag(24, seed=2))
    return g, to_port(g)


def two_island(F, scheduler="priority", bw=2e8, host="pre"):
    return F.Topology(
        islands=(F.Island("pre", groups=(0,), bw=600e9),
                 F.Island("dec", groups=(1, 2), bw=600e9)),
        crossings=(F.Crossing("pre", "dec", bw=bw, latency=50e-6,
                              duplex="half"),),
        host_island=host, scheduler=scheduler)


def _chaos_plan(X, mid):
    return (X.FaultPlan(seed=11)
            .crash(mid, group=1, recover_at=mid + 1.0)
            .straggle(mid * 0.2, mid * 0.9, group=0, factor=3.0)
            .flaky_link(0, 1, p=0.05, seed=2, max_retries=4,
                        backoff=2e-3, deadline=0.5))


# ===================================================================== #
# JSON text
# ===================================================================== #
@pytest.mark.parametrize("scheduler", ["priority", "fifo"])
def test_topology_json_text_matches_reference(scheduler):
    ref, port = (two_island(F, scheduler) for F in (JF, TF))
    assert json.dumps(port.to_dict()) == json.dumps(ref.to_dict())
    assert TF.Topology.from_dict(json.loads(json.dumps(
        ref.to_dict()))) == port
    kw = dict(groups=GROUPS, fabric=ref.to_dict())
    assert TSPEC.DeploymentSpec(**kw).to_json() == \
        JSPEC.DeploymentSpec(**kw).to_json()
    assert port.planner_bw(1) == ref.planner_bw(1) == 300e9
    for s, d in ((0, 1), (1, 2), (1, TF.HOST), (0, 0)):
        assert port.channel_key(s, d) == ref.channel_key(s, d)


def test_fault_plan_json_text_matches_reference(tmp_path):
    ref, port = (_chaos_plan(X, 4.0) for X in (JX, TX))
    assert port.to_json() == ref.to_json()
    assert TX.FaultPlan.from_json(ref.to_json()) == port
    port.save(tmp_path / "plan.json")
    assert JX.FaultPlan.load(tmp_path / "plan.json") == ref
    with pytest.raises(ValueError, match="unknown FaultPlan fields"):
        TX.FaultPlan.from_json('{"seed": 0, "mystery": []}')
    assert [dataclasses.astuple(e) for e in port.control_events()] == \
        [dataclasses.astuple(e) for e in ref.control_events()]


def test_bound_link_draws_match_reference():
    draws = []
    for X in (JX, TX):
        plan = X.FaultPlan(seed=9).flaky_link(0, 1, p=0.5)
        st = plan.bind(2)
        draws.append(([st.link(0, 1).rng.random() for _ in range(8)],
                      [st.live_link(0, 1).rng.random() for _ in range(8)]))
    assert draws[0] == draws[1]


# ===================================================================== #
# Cluster DES with a fabric and under fault plans
# ===================================================================== #
WALKS = pytest.mark.parametrize("reference", [True, False],
                                ids=["ref_walk", "fast_walk"])


@WALKS
@pytest.mark.parametrize("router,pd,kv_chunks", [
    ("jsed", False, 1), ("round_robin", False, 1),
    ("least_loaded", False, 1),
    ("pd_split", True, 1), ("pd_split", True, 4),
])
def test_contended_fabric_des_matches_reference(graphs, router, pd,
                                                kv_chunks, reference):
    out = []
    for (SPEC, W, F, _), g in zip(SIDES, graphs):
        out.append(SPEC.DeploymentSpec(
            groups=GROUPS, router=router, slos=SLOS, pd=pd,
            kv_chunks=kv_chunks, anneal_iters=ANNEAL,
            fabric=two_island(F, bw=2e7).to_dict()).compile(g).simulate(
                W.diurnal_trace(40.0, 300, seed=0), reference=reference))
    assert_same_result(*out)
    if pd:
        assert out[0].fabric_wait_seconds > 0.0


def _colocated(SPEC, W, g):
    dep = SPEC.DeploymentSpec(groups=GROUPS, anneal_iters=ANNEAL) \
        .compile(g)
    trace = W.poisson_trace(rate=1.5 * dep.cluster().capacity,
                            num_requests=150, seed=5)
    return dep, trace


@WALKS
@pytest.mark.parametrize("recovery", [None, 1e-3], ids=["naive", "ckpt"])
def test_crash_and_straggle_des_matches_reference(graphs, recovery,
                                                  reference):
    out = []
    for (SPEC, W, _, X), g in zip(SIDES, graphs):
        dep, trace = _colocated(SPEC, W, g)
        mid = trace[len(trace) // 2].arrival
        kw = dict(faults=_chaos_plan(X, mid), reference=reference)
        if recovery is not None:
            kw.update(recovery=X.RecoveryConfig(interval=recovery),
                      health=X.GroupHealth(len(GROUPS)))
        out.append(dep.simulate(trace, **kw))
    assert_same_result(*out)


def test_full_outage_blip_des_matches_reference(graphs):
    out = []
    for (SPEC, W, _, X), g in zip(SIDES, graphs):
        dep, trace = _colocated(SPEC, W, g)
        mid = trace[len(trace) // 2].arrival
        plan = X.FaultPlan(seed=1)
        for grp in range(len(GROUPS)):
            plan.crash(mid, group=grp, recover_at=mid + 0.01)
        out.append(dep.simulate(trace, faults=plan,
                                recovery=X.RecoveryConfig(interval=1e-5),
                                health=X.GroupHealth()))
    assert out[0].recovered > 0 and out[0].dropped == 0
    assert_same_result(*out)


def _all_links(X, seed, **kw):
    plan = X.FaultPlan(seed=seed)
    for s in range(len(GROUPS)):
        for d in range(len(GROUPS)):
            if s != d:
                plan.flaky_link(s, d, **kw)
    return plan


@WALKS
@pytest.mark.parametrize("link", [
    dict(p=0.2, max_retries=8, deadline=10.0),
    dict(p=0.9, max_retries=1, deadline=1e-6),
], ids=["retries", "refills"])
def test_flaky_link_des_matches_reference(graphs, link, reference):
    out = []
    for (SPEC, W, _, X), g in zip(SIDES, graphs):
        dep = SPEC.DeploymentSpec(groups=GROUPS, router="pd_split",
                                  pd=True, kv_chunks=4,
                                  anneal_iters=ANNEAL).compile(g)
        trace = W.poisson_trace(rate=1.5 * dep.cluster().capacity,
                                num_requests=150, seed=5)
        out.append(dep.simulate(trace, faults=_all_links(X, 5, **link),
                                reference=reference))
    assert out[0].kv_retries > 0
    assert_same_result(*out)


def test_checkpoint_ships_on_fabric_match_reference(graphs):
    out = []
    for (SPEC, W, F, X), g in zip(SIDES, graphs):
        dep = SPEC.DeploymentSpec(
            groups=GROUPS, router="pd_split", slos=SLOS, pd=True,
            kv_chunks=4, anneal_iters=ANNEAL,
            fabric=two_island(F, bw=2e7).to_dict()).compile(g)
        out.append(dep.simulate(
            W.diurnal_trace(40.0, 300, seed=0), faults=X.FaultPlan(seed=3),
            recovery=X.RecoveryConfig(interval=2e-3),
            health=X.GroupHealth(len(GROUPS))))
    assert out[0].ckpt_shipped > 0 and out[0].fabric_bulk_bytes > 0.0
    assert_same_result(*out)


def test_straggle_detector_matches_reference(graphs):
    out, dets = [], []
    for (SPEC, W, _, X), g in zip(SIDES, graphs):
        dep = SPEC.DeploymentSpec(groups=GROUPS, router="jsed", slos=SLOS,
                                  anneal_iters=ANNEAL).compile(g)
        h = X.GroupHealth(len(GROUPS))
        det = X.StraggleDetector(h, interval=0.5)
        out.append(dep.simulate(
            W.diurnal_trace(40.0, 400, seed=0),
            faults=X.FaultPlan(seed=0).straggle(2.0, 6.0, group=0,
                                                factor=5.0),
            health=h, controller=det))
        dets.append(det.detections)
    assert dets[0] and dets[0][0][1] == 0
    assert dets[1] == dets[0]
    assert_same_result(*out)


def test_breaker_sequences_match_reference():
    seq = [("record_error", 0, 0.1), ("record_error", 0, 0.2),
           ("record_ok", 1, 0.3), ("record_error", 0, 0.4),
           ("suspect", 1, 0.5), ("trip", 2, 0.6), ("record_ok", 1, 0.9),
           ("reset", 2, 1.5), ("record_error", 0, 3.0)]
    trails = []
    for X in (JX, TX):
        h = X.GroupHealth(3)
        trail = []
        for op, g, t in seq:
            getattr(h, op)(g, t)
            trail.append(tuple((h.state(i, t), h.allow(i, t),
                                h.penalty(i, t), h.error_rate(i))
                               for i in range(3)) + (h.degraded(t),))
        trails.append(trail)
    assert trails[0] == trails[1]
    dh = TX.DeviceHealth([True, True, True])
    dh.fail(1)
    assert dh.lost() == {1} and dh.alive == [True, False, True]


# ===================================================================== #
# Live accounting, corruption, checkpoints
# ===================================================================== #
def test_live_fabric_accounting_matches_reference():
    stats = []
    for F, K in ((JF, JK), (TF, TK)):
        fab = F.LiveFabric(two_island(F), 3)
        ch = fab.channel(0, 1)
        shards = [K.KvSlice(rid=1, component="kv", layer=0, nbytes=100),
                  K.KvSlice(rid=1, component="kv", layer=1, nbytes=200,
                            klass=F.BULK)]
        assert list(ch.wrap(iter(shards + ["cursor"]))) == \
            shards + ["cursor"]
        ch.account(4096, F.URGENT)
        fab.account_ckpt(1, 1000)
        fab.account_ckpt(2, 500)
        assert fab.channel(0, 0) is None
        stats.append((fab.stats(), ch.modeled_seconds(F.URGENT),
                      ch.modeled_seconds(F.BULK)))
    assert stats[0] == stats[1]
    assert stats[1][0]["bulk_bytes"] == 1700


def _state(dtype):
    g = torch.Generator().manual_seed(0)
    return {"kv": {"k": torch.randn(1, 1, 4, 2, 8, generator=g)
                   .to(dtype)[:, :, :3],
                   "v": torch.randn(1, 1, 3, 2, 8, generator=g).to(dtype)}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_corrupt_slice_is_caught_by_verify(dtype):
    state = _state(dtype)
    before = {k: t.clone() for k, t in state["kv"].items()}
    sl = TK.KvSlice(rid=3, component="kv", layer=0, state=state,
                    nbytes=TM.kv_state_bytes(state),
                    checksum=TK.kv_checksum(state))
    assert sl.verify()
    bad = TX.corrupt_slice(sl)
    assert bad.checksum == sl.checksum and not bad.verify()
    # the first leaf in checksum order ("k") lost its first byte; the
    # shard it came from is untouched (the flip is on a clone)
    flipped = bad.state["kv"]["k"].reshape(-1).view(torch.uint8)
    orig = before["k"].contiguous().reshape(-1).view(torch.uint8)
    assert int(flipped[0]) == int(orig[0]) ^ 0xFF
    assert torch.equal(flipped[1:], orig[1:])
    assert bad.state["kv"]["v"] is state["kv"]["v"]
    for k in before:
        assert torch.equal(state["kv"][k], before[k])


def test_chaos_link_counts_match_reference():
    """``ChaosLink`` draws once per shard from the plan's string seed:
    on the same shard sequence its retries and corrupted shards equal
    the reference link's."""
    counts = []
    for X, K in ((JX, JK), (TX, TK)):
        fl = X.FlakyLink(0, 1, p=0.6, max_retries=1)
        link = X.ChaosLink(5, fl)
        shards = [K.KvSlice(rid=i, component="kv", layer=0,
                            state={"k": np.zeros(4, np.float32)}
                            if K is JK else {"k": torch.zeros(4)})
                  for i in range(24)]
        out = list(link.wrap(iter(shards)))
        counts.append((link.retries, link.corrupted, len(out)))
    assert counts[0] == counts[1]
    assert counts[1][0] > 0 and counts[1][1] > 0


def _smoke_llama():
    cfg = dataclasses.replace(TC.get_smoke("llama3_8b"), dtype="float32")
    params = TM.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    return cfg, params


def _reqs(cfg, n_new=10):
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=n)
                    .astype(np.int32), max_new_tokens=n_new)
            for i, n in enumerate((7, 5))]


def test_checkpoint_store_round_trip_on_cpu():
    cfg, params = _smoke_llama()
    want = _reqs(cfg)
    ServingEngine(cfg, params, slots=2, max_len=32, sync_every=1,
                  device="cpu").run(want)

    reqs = _reqs(cfg)
    eng = ServingEngine(cfg, params, slots=2, max_len=32, sync_every=1,
                        device="cpu")
    assert eng.admit_batch(reqs, 0.0) == 2
    for _ in range(3):
        eng.step(0.0)
    store = TX.CheckpointStore(TX.RecoveryConfig(interval=1.0,
                                                 min_dirty_tokens=1))
    seen = []
    assert store.poll([eng], 0.0,
                      on_store=lambda g, n: seen.append((g, n))) == 2
    assert store.poll([eng], 0.5) == 0          # inside the interval
    assert store.checkpoints == 2 and len(seen) == 2
    assert store.stored_bytes == sum(n for _, n in seen)
    # the stored copies own their memory: later decode steps (which
    # write the engine's cache in place) do not reach them
    saved = {rid: TK._state_to(store._data[rid]["state"], "cpu", copy=True)
             for rid in (0, 1)}
    for _ in range(2):
        eng.step(0.0)
    for rid in (0, 1):
        for a, b in zip(TM.state_leaves(saved[rid]),
                        TM.state_leaves(store._data[rid]["state"])):
            assert torch.equal(a, b)
            assert a.data_ptr() != eng.cache["kv"]["k"].data_ptr()
    lost = eng.sessions.crash(0.0)
    assert sorted(r.rid for r in lost) == [0, 1]
    survivor = ServingEngine(cfg, params, slots=2, max_len=32,
                             sync_every=1, device="cpu")
    for req in sorted(lost, key=lambda r: r.rid):
        assert store.restore(req, survivor, 0.0)
    while survivor._any_active():
        survivor.step(0.0)
    survivor.sync(0.0)
    assert [r.output for r in reqs] == [r.output for r in want]
    assert all(len(r.output) == r.max_new_tokens for r in reqs)


# ===================================================================== #
# Elastic executor
# ===================================================================== #
def test_elastic_executor_replans_and_keeps_logits():
    cfg, params = _smoke_llama()
    slots, max_len = 2, 16
    cache = TM.init_cache(cfg, slots, max_len, device="cpu")
    toks = torch.tensor([[3], [5]], dtype=torch.int32)
    pos = torch.tensor([2, 4], dtype=torch.int32)

    def step(p, c, t, q):
        return TM.decode_step(p, cfg, t, c, q, tagged=True)

    traced = analyzer.analyze(step, params, cache, toks, pos,
                              state_argnums=(1,))
    traced = traced.with_graph(analyzer.pin_nodes(
        traced.graph, traced.state_readers | traced.state_writers, 0))
    specs = [CATALOG[n] for n in ("h100", "a100", "l40s")]
    ex = ElasticExecutor(traced, specs, logical_devices(3, "cpu"))

    def run(fn):
        c = TM.init_cache(cfg, slots, max_len, device="cpu")
        return fn(params, c, toks, pos)

    want = run(step)[0]
    assert torch.equal(run(ex)[0], want)
    for lost in (2, 1):
        ex.mark_failed(lost)
        alive = tuple(s.name for i, s in enumerate(specs)
                      if ex.health.alive[i])
        assert ex.plan.devices == alive
        assert max(ex.plan.labels) < len(alive)
        assert torch.equal(run(ex)[0], want)
    assert ex.replans == 2 and ex.health.lost() == {1, 2}
