"""Elasticity at both granularities on the PyTorch port: device loss and
replica-group loss.

  PYTHONPATH=src python examples/elastic_recovery_torch.py [--device cpu]

Part 1 (kernel granularity): PD/AF disaggregation must re-provision a
whole phase/block pool on node loss; Tessera just re-solves kernel
placement over the survivors.  ``ElasticExecutor`` runs a model's
decode step planned for three GPUs of the catalog, mapped onto three
logical devices of ``--device`` (on CUDA, a stream each), and loses two
of them; the logits stay those of the eager step.

Part 2 (cluster granularity): a whole replica GROUP dies mid-trace on
the deployment DES — the router masks it and its in-flight requests
re-route across the survivors — then autoscaling drains a group
gracefully while a warm replacement spins up, with zero accepted
requests dropped.  The simulated times are the cost model's for the
catalog's GPUs, not measurements.
"""
import argparse
import dataclasses

import torch

import repro_torch.configs as configs
from repro_torch import resolve_device
from repro_torch.core import analyzer
from repro_torch.core.costmodel import GPU_A100, GPU_H100, GPU_L40S
from repro_torch.core.executor import logical_devices
from repro_torch.models import model as M
from repro_torch.runtime.fault import ElasticExecutor
from repro_torch.serving.spec import DeploymentSpec
from repro_torch.serving.workload import poisson_trace

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = resolve_device(ap.parse_args().device)

cfg = dataclasses.replace(configs.get_smoke("qwen3_1_7b"),
                          dtype="float32")
g = torch.Generator(device=dev)
g.manual_seed(0)
params = M.init_params(cfg, generator=g, device=dev)
SLOTS, MAX_LEN = 2, 16
toks = torch.tensor([[3], [11]], dtype=torch.int32, device=dev)
pos = torch.tensor([4, 9], dtype=torch.int32, device=dev)


def step(p, c, t, q):
    return M.decode_step(p, cfg, t, c, q, tagged=True)


def fresh_cache():
    return M.init_cache(cfg, SLOTS, MAX_LEN, device=dev)


traced = analyzer.analyze(step, params, fresh_cache(), toks, pos,
                          state_argnums=(1,))
# the cache's readers and writers stay with the cache (plan device 0)
traced = traced.with_graph(analyzer.pin_nodes(
    traced.graph, traced.state_readers | traced.state_writers, 0))
exe = ElasticExecutor(traced, [GPU_A100, GPU_L40S, GPU_H100],
                      logical_devices(3, dev))
want = step(params, fresh_cache(), toks, pos)[0]


def check(label):
    print(f"{label}:", exe.plan.summary())
    got = exe(params, fresh_cache(), toks, pos)[0]
    assert torch.equal(got, want), "logits changed after re-planning"


check("3 devices")
exe.mark_failed(2)          # lose the H100
check("2 devices")
exe.mark_failed(1)          # lose the L40s too
check("1 device ")
print(f"elastic re-plans: {exe.replans}; logits identical throughout")

# --- cluster granularity: replica-group failure + autoscaling -------- #
print("\n--- replica-group failure on the deployment DES ---")
spec = DeploymentSpec(groups=[["h100", "rtxpro6000"], ["a100", "l40s"],
                              ["a100", "l40s"]],
                      router="jsed", anneal_iters=300)
dep = spec.compile(traced.graph)
trace = poisson_trace(rate=1.5 * dep.cluster().capacity,
                      num_requests=200, seed=5)
t_fail = trace[len(trace) // 2].arrival
base = dep.simulate(trace)
hit = dep.simulate(trace, failures=[(t_fail, 0)])
after = [a for r, a in zip(sorted(trace, key=lambda r: r.arrival),
                           hit.assignments) if r.arrival > t_fail]
print(f"baseline: completed={base.completed} "
      f"per-replica={base.per_replica_completed}")
print(f"group 0 dies at t={t_fail:.3f}s: completed={hit.completed} "
      f"rerouted={hit.rerouted} dropped={hit.dropped} "
      f"per-replica={hit.per_replica_completed}")
assert hit.completed == len(trace) and hit.dropped == 0
assert 0 not in after, "router kept sending work to a dead group"
print(f"recovery cost: mean latency {base.mean_latency * 1e3:.1f}ms -> "
      f"{hit.mean_latency * 1e3:.1f}ms on 2/3 capacity (modeled)")

print("\n--- autoscaling: drain one group, warm up a replacement ---")
dep2 = spec.compile(traced.graph)
t_mid = trace[len(trace) // 2].arrival
# warm-up sized to the trace (this smoke graph serves in milliseconds)
warm = 0.25 * (trace[-1].arrival - t_mid)
dep2.scale(add=[["h100", "rtxpro6000"]], at=t_mid, warmup=warm)
dep2.scale(remove=[1], at=t_mid)
scaled = dep2.simulate(trace)
ordered = sorted(trace, key=lambda r: r.arrival)
drained = [a for r, a in zip(ordered, scaled.assignments)
           if r.arrival > t_mid]
early = [a for r, a in zip(ordered, scaled.assignments)
         if r.arrival < t_mid]
print(f"scaled: completed={scaled.completed} dropped={scaled.dropped} "
      f"per-replica={scaled.per_replica_completed}")
assert scaled.dropped == 0 and scaled.completed == len(trace), \
    "graceful drain must be loss-free"
assert 1 not in drained, "drained group must take no new requests"
assert 3 not in early, "warming group must not serve before warm-up"
assert 3 in scaled.assignments, "replacement group never became eligible"
print("drain loss-free; replacement eligible after warm-up; "
      f"post-scale price ${dep2.price_rate:.1f}/hr")
