"""The port's declarative deployment API (``repro_torch.serving.spec``,
``controller``, ``sizing``) against the reference's, on the CPU.

  * spec validation errors and the JSON round trip, text identical to
    the reference's;
  * ``search_composition`` and the autoscaling controller's decisions
    and billing identical to the reference's;
  * every launch backend at smoke width in fp32 — single engine, a pool
    with ``scale``, a crash with and without checkpoint recovery, the
    serial and streamed prefill -> decode pairs, and the streamed pair
    under ``flaky_link`` — gives the reference ``LaunchedDeployment``'s
    greedy tokens; the pairs also its wire bytes and shards, and its
    retry, corruption and re-prefill counts.

Parameters are initialised in JAX and carried across by
``repro_torch.convert``.  A pool run reads the host's wall clock (its
crash catches whatever is resident then), so pool runs are held to
tokens and "no request lost", never to migration counts; the port's
pool runs here read a clock that ticks per read, so the crash lands at
the same point of the run on any host.
"""
import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.configs as JC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import controller as JCTL  # noqa: E402
from repro.serving import engine as JE  # noqa: E402
from repro.serving import faults as JX  # noqa: E402
from repro.serving import sizing as JSZ  # noqa: E402
from repro.serving import spec as JSPEC  # noqa: E402
from repro.serving import workload as JW  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.serving import controller as TCTL  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402
from repro_torch.serving import faults as TX  # noqa: E402
from repro_torch.serving import sizing as TSZ  # noqa: E402
from repro_torch.serving import spec as TSPEC  # noqa: E402
from repro_torch.serving import workload as TW  # noqa: E402

from _torch_parity import assert_same_result, to_port  # noqa: E402
from conftest import random_dag  # noqa: E402

GROUPS = [["h100", "rtxpro6000"], ["a100", "l40s"], ["a100", "l40s"]]
SLOS = {"base": 2.0, "per_output_token": 0.02, "ttft": 0.3}
ANNEAL = 150


# ===================================================================== #
# Spec validation + serialization
# ===================================================================== #
@pytest.mark.parametrize("kwargs,err", [
    (dict(groups=[["v100"]]), "unknown device"),
    (dict(groups=[]), "non-empty"),
    (dict(groups=[[]]), "non-empty"),
    (dict(groups=[["h100"]], router="oracle"), "unknown router"),
    (dict(groups=[["h100"]], kv_chunks=4), "requires pd"),
    (dict(groups=[["h100"]], slos={"p99": 1.0}), "unknown slo keys"),
    (dict(groups=[["h100"]], slos={"base": 0.0}), "positive deadline"),
    (dict(groups=[["h100"]], interconnect={"bw_gbps": 1}),
     "unknown interconnect keys"),
    (dict(groups=[["h100"]], interconnect={"bw": {"a-b": 1e9}}), "src-dst"),
    (dict(groups=[["h100"]], initial_policy="balanced"), "initial_policy"),
    (dict(groups=[["b200", "b200"]], budget=5.0), "over the"),
    (dict(groups=[["h100"]], engine={"max_length": 256}),
     "unknown engine keys"),
])
def test_spec_validation_errors_match_reference(kwargs, err):
    msgs = []
    for SPEC in (JSPEC, TSPEC):
        with pytest.raises(ValueError, match=err) as exc:
            SPEC.DeploymentSpec(**kwargs)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def _full_spec(SPEC):
    return SPEC.DeploymentSpec(
        groups=GROUPS, arch="llama3_8b", base_prompt=512, base_output=64,
        router="pd_split",
        router_kwargs={"prefill_pool": [0], "decode_pool": [1, 2],
                       "session_affinity": True, "affinity_break": 0.1},
        pd=True, kv_chunks=8,
        interconnect={"default_bw": 50e9, "bw": {"0-1": 200e9}},
        slos={"base": 2.0, "per_output_token": 0.02, "ttft": 0.3},
        budget=20.0,
        calibration={"ttft_wall_over_model": 3.0,
                     "tpot_wall_over_model": 2.0},
        monitor={"window": 0.05}, anneal_iters=300,
        engine={"slots": 2, "max_len": 32, "kv_block_tokens": 8})


def test_spec_json_text_matches_reference(tmp_path):
    ref, port = _full_spec(JSPEC), _full_spec(TSPEC)
    assert port.to_json() == ref.to_json()
    assert TSPEC.DeploymentSpec.from_json(ref.to_json()) == port
    port.save(tmp_path / "spec.json")
    assert JSPEC.DeploymentSpec.load(tmp_path / "spec.json") == ref
    assert TSPEC.DeploymentSpec.load(tmp_path / "spec.json") == port
    with pytest.raises(ValueError, match="unknown DeploymentSpec"):
        TSPEC.DeploymentSpec.from_json(json.dumps(
            {"groups": [["h100"]], "routr": "jsed"}))
    assert port.price_rate == ref.price_rate
    assert port.kv_config() == ref.kv_config()
    ic, jic = port.make_interconnect(), ref.make_interconnect()
    assert ic.bandwidth(0, 1) == jic.bandwidth(0, 1) == 200e9
    assert ic.bandwidth(1, 2) == jic.bandwidth(1, 2) == 50e9


# ===================================================================== #
# Sizing and the autoscaling controller
# ===================================================================== #
def _pd_graph(n=24, seed=2):
    g = random_dag(n, seed=seed)
    nodes = [dataclasses.replace(
        node, phase="prefill" if node.idx < n // 2 else "decode")
        for node in g.nodes]
    g2 = type(g)(nodes, dict(g.edges), name=g.name + ".dep")
    g2.validate()
    return g2


@pytest.fixture(scope="module")
def graphs():
    g = _pd_graph()
    return g, to_port(g)


INVENTORY = {"h100": 2, "rtxpro6000": 2, "a100": 3, "l40s": 4}


def test_search_composition_matches_reference(graphs):
    out = []
    for SZ, W, g in ((JSZ, JW, graphs[0]), (TSZ, TW, graphs[1])):
        out.append(SZ.search_composition(
            INVENTORY, 9.0, W.poisson_trace(rate=2000.0, num_requests=80,
                                            seed=9),
            g, iters=10, seed=0,
            spec_kwargs={"slos": SLOS, "anneal_iters": ANNEAL}))
    ref, port = out
    assert port.spec.to_json() == ref.spec.to_json()
    assert (port.score, port.seed_score, port.evals) == \
        (ref.score, ref.seed_score, ref.evals)
    assert port.history == ref.history
    assert_same_result(ref.result, port.result)
    assert TSZ.group_templates({"h100": 1, "l40s": 2}) == \
        JSZ.group_templates({"h100": 1, "l40s": 2})
    assert TSZ.uniform_composition(INVENTORY, 9.0, graphs[1],
                                   anneal_iters=ANNEAL) == \
        JSZ.uniform_composition(INVENTORY, 9.0, graphs[0],
                                anneal_iters=ANNEAL)


def _ctl(CTL):
    return CTL.AutoscalePolicy(
        CTL.AutoscaleConfig(interval=0.05, window=0.2, cooldown=0.1,
                            warmup=0.05, queue_hi=0.5, queue_lo=0.15,
                            util_lo=0.6),
        inventory=[["a100", "l40s"], ["l40s"]])


def test_controller_decisions_and_billing_match_reference(graphs):
    out = []
    for SPEC, W, CTL, g in ((JSPEC, JW, JCTL, graphs[0]),
                            (TSPEC, TW, TCTL, graphs[1])):
        dep = SPEC.DeploymentSpec(
            groups=[["a100", "l40s"]], router="jsed",
            router_kwargs={"slo_shed": True}, slos=SLOS, budget=20.0,
            anneal_iters=ANNEAL).compile(g)
        rate = 2.0 * dep.cluster().capacity
        n = 3000
        trace = W.diurnal_trace(rate, n, seed=7, amplitude=0.7,
                                period=n / rate)
        ctl = _ctl(CTL)
        res = dep.simulate(trace, controller=ctl)
        out.append((res, [dataclasses.astuple(d) for d in ctl.decisions],
                    ctl.billed_dollars(), CTL.goodput_per_dollar(res)))
    (jres, jdec, jbill, jgpd), (tres, tdec, tbill, tgpd) = out
    assert {d[1] for d in jdec} >= {"up", "down"}
    assert tdec == jdec
    assert (tbill, tgpd) == (jbill, jgpd)
    assert_same_result(jres, tres)


def test_scale_schedules_match_reference(graphs):
    out = []
    for SPEC, W, g in ((JSPEC, JW, graphs[0]), (TSPEC, TW, graphs[1])):
        dep = SPEC.DeploymentSpec(groups=GROUPS, anneal_iters=ANNEAL) \
            .compile(g)
        trace = W.poisson_trace(rate=1.5 * dep.cluster().capacity,
                                num_requests=150, seed=5)
        t_mid = trace[70].arrival
        dep.scale(remove=[2], at=t_mid)
        dep.scale(add=[["h100", "rtxpro6000"]], at=t_mid, warmup=0.01)
        out.append((dep.simulate(trace), dep.price_rate))
    assert out[0][0].completed == 150 and out[0][1] == out[1][1]
    assert_same_result(out[0][0], out[1][0])


# ===================================================================== #
# Launch backends against the reference's
# ===================================================================== #
@functools.lru_cache(maxsize=None)
def _model(arch):
    jcfg = dataclasses.replace(JC.get_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(TC.get_smoke(arch), dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


class _TickClock:
    """Stands in for the ``time`` module of ``serving.spec``: each read
    of ``perf_counter`` advances the clock by ``dt`` seconds and
    ``sleep`` by its argument, so a pool run's scheduled crash lands at
    the same point of the run on any host."""

    def __init__(self, dt: float = 1e-3):
        self.t, self.dt = 0.0, dt

    def perf_counter(self) -> float:
        self.t += self.dt
        return self.t

    def sleep(self, s: float) -> None:
        self.t += max(s, 0.0)


def _requests(E, cfg, sizes, max_new):
    rng = np.random.default_rng(0)
    return [E.Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=n)
                      .astype(np.int32), max_new_tokens=max_new, arrival=0.0)
            for i, n in enumerate(sizes)]


PAIR = dict(groups=[["h100"], ["a100"]], pd=True,
            engine={"slots": 2, "max_len": 64})
POOL = dict(groups=[["h100"], ["a100"]], engine={"slots": 4, "max_len": 64,
                                                 "sync_every": 2})

# backend -> (spec kwargs, max_new, how to arm the launched deployment)
BACKENDS = {
    "single": (dict(groups=[["h100"]],
                    engine={"slots": 2, "max_len": 64, "sync_every": 2}),
               6, None),
    "pool_scale": (POOL, 8, lambda X, ld: (
        ld.scale(add=[["l40s"]], at=0.0), ld.scale(remove=[0], at=0.0))),
    "crash": (POOL, 12, lambda X, ld: ld.inject(
        X.FaultPlan(seed=4).crash(0.02, group=0, recover_at=0.06))),
    "crash_recovery": (POOL, 12, lambda X, ld: ld.inject(
        X.FaultPlan(seed=4).crash(0.02, group=0, recover_at=0.06),
        recovery=X.RecoveryConfig(interval=1e-3, min_dirty_tokens=1))),
    "serial_pair": (PAIR, 6, None),
    "streamed_pair": (dict(PAIR, kv_chunks=4), 6, None),
    "flaky_pair": (dict(PAIR, kv_chunks=4), 6, lambda X, ld: ld.inject(
        X.FaultPlan(seed=1).flaky_link(0, 1, p=0.5, max_retries=1))),
}


@functools.lru_cache(maxsize=None)
def _reference_run(arch, backend):
    kw, max_new, arm = BACKENDS[backend]
    jcfg, jparams, _, _ = _model(arch)
    ld = JSPEC.DeploymentSpec(arch=arch, **kw).compile().launch(jcfg,
                                                                jparams)
    if arm is not None:
        arm(JX, ld)
    reqs = _requests(JE, jcfg, (12, 9, 17), max_new)
    out = ld.run(reqs)
    return [list(r.output) for r in reqs], out


@pytest.mark.parametrize("arch,backend", [
    ("llama3_8b", b) for b in BACKENDS] + [("zamba2_7b", "flaky_pair")])
def test_launch_backend_matches_reference(arch, backend, monkeypatch):
    kw, max_new, arm = BACKENDS[backend]
    want, jout = _reference_run(arch, backend)
    assert all(len(o) == max_new for o in want)
    _, _, cfg, params = _model(arch)
    monkeypatch.setattr(TSPEC, "time", _TickClock())
    ld = TSPEC.DeploymentSpec(arch=arch, **kw).compile().launch(
        cfg, params, device="cpu")
    assert all(e.params is params for e in ld.engines)   # no weight copy
    if arm is not None:
        arm(TX, ld)
    reqs = _requests(TE, cfg, (12, 9, 17), max_new)
    out = ld.run(reqs)
    assert [list(r.output) for r in reqs] == want
    assert out["engine"]["completed"] == len(reqs)
    assert all(r.finished >= 0 for r in reqs), "dropped request"
    if kw.get("pd"):
        assert (out["wire_bytes"], out["shards"]) == \
            (jout["wire_bytes"], jout["shards"])
        assert out["wire_bytes"] > 0
        assert (out["shards"] > 0) == (kw.get("kv_chunks", 1) > 1)
        assert out["engine"]["prefill_batches"] == \
            jout["engine"]["prefill_batches"]
    if backend == "flaky_pair":
        counts = ("kv_retries", "kv_corrupted", "reprefills")
        assert tuple(out[k] for k in counts) == \
            tuple(jout[k] for k in counts)
        assert out["kv_retries"] > 0 and out["kv_corrupted"] > 0
        assert out["reprefills"] == out["kv_corrupted"]
    if backend == "pool_scale":
        assert out["migrations"] >= 1 and out["wire_bytes"] > 0
        assert out["routable"] == [False, True, True]
    if backend.startswith("crash"):
        assert out["lost_sessions"] > 0
        assert out["recovered_sessions"] == (
            out["lost_sessions"] if backend == "crash_recovery" else 0)
        assert (out["checkpoints"] > 0) == (backend == "crash_recovery")


def test_launch_defaults_to_the_card_and_never_falls_back(monkeypatch):
    dep = TSPEC.DeploymentSpec(groups=[["h100"]], arch="llama3_8b") \
        .compile()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dep.launch()
    _, _, cfg, params = _model("llama3_8b")
    with pytest.raises(RuntimeError, match="CUDA"):
        dep.launch(cfg, params)


def test_launch_makes_seeded_params_on_the_device():
    spec = TSPEC.DeploymentSpec(groups=[["h100"]], arch="llama3_8b",
                                engine={"seed": 3, "max_len": 16})
    a = spec.compile().launch(device="cpu")
    b = spec.compile().launch(device="cpu")
    c = dataclasses.replace(spec, engine={"seed": 4, "max_len": 16}) \
        .compile().launch(device="cpu")
    wa, wb, wc = (x.params["embed"]["tok"] for x in (a, b, c))
    assert wa.device.type == "cpu" and torch.equal(wa, wb)
    assert not torch.equal(wa, wc)
    assert a.cfg == TC.get_smoke("llama3_8b")


def test_live_scale_and_inject_validation():
    _, _, cfg, params = _model("llama3_8b")
    ekw = {"slots": 2, "max_len": 32, "sync_every": 2}
    ld = TSPEC.DeploymentSpec(groups=[["h100"]], arch="llama3_8b",
                              engine=ekw).compile().launch(cfg, params,
                                                           device="cpu")
    with pytest.raises(ValueError, match="last routable"):
        ld.scale(remove=[0])
    with pytest.raises(ValueError, match="cannot remove"):
        ld.scale(remove=[3])
    with pytest.raises(ValueError, match="unknown device"):
        ld.scale(add=[["v100"]])
    pd = TSPEC.DeploymentSpec(groups=[["h100"], ["l40s"]], pd=True,
                              arch="llama3_8b", engine=ekw) \
        .compile().launch(cfg, params, device="cpu")
    with pytest.raises(ValueError, match="pd"):
        pd.scale(add=[["a100"]])
    with pytest.raises(ValueError, match="fixed topology"):
        pd.inject(TX.FaultPlan().crash(1.0, group=0))
