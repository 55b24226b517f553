"""Cluster-scale heterogeneous serving on the PyTorch port.

  PYTHONPATH=src python examples/serve_cluster_torch.py [--device cpu]

Traces one model's decode step with the port's analyzer, plans it onto
four heterogeneous GPU replica groups from the cost model's catalog,
then replays a bursty open-loop trace through the cluster simulator
under round-robin, least-loaded and workload-aware (JSED) routing.
Each replica runs its own online monitor and flips between latency-
and throughput-oriented plans as its queueing ratio crosses beta.  The
simulated times are the cost model's for those GPUs, not measurements.

Last, the same deployment shape is launched on ``--device`` as a pool
of real engines (one per replica group, sharing one set of weights),
and one group is drained mid-run: its sessions migrate to the others
with no request lost.
"""
import argparse
import dataclasses

import numpy as np
import torch

import repro_torch.configs as configs
from repro_torch import resolve_device
from repro_torch.core import analyzer
from repro_torch.core.monitor import MonitorConfig
from repro_torch.models import model as M
from repro_torch.serving.cluster import TesseraCluster
from repro_torch.serving.engine import Request
from repro_torch.serving.router import (JSEDRouter, LeastLoadedRouter,
                                        RoundRobinRouter)
from repro_torch.serving.spec import DeploymentSpec
from repro_torch.serving.workload import bursty_trace, trace_stats

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = resolve_device(ap.parse_args().device)

# --- trace the decode step of a small model -------------------------- #
cfg = dataclasses.replace(configs.get_smoke("llama3_8b"), dtype="float32")
g = torch.Generator(device=dev)
g.manual_seed(0)
params = M.init_params(cfg, generator=g, device=dev)
SLOTS, MAX_LEN = 4, 64
traced = analyzer.analyze(
    lambda p, c, t, q: M.decode_step(p, cfg, t, c, q, tagged=True),
    params, M.init_cache(cfg, SLOTS, MAX_LEN, device=dev),
    torch.zeros((SLOTS, 1), dtype=torch.int32, device=dev),
    torch.zeros((SLOTS,), dtype=torch.int32, device=dev),
    state_argnums=(1,))
graph = traced.graph

# --- a 4-replica, 8-GPU heterogeneous cluster ------------------------ #
GROUPS = [["h100", "rtxpro6000"], ["b200", "h100"],
          ["a100", "l40s"], ["h100", "rtxpro6000"]]
cluster = TesseraCluster(graph, GROUPS, base_prompt=256, base_output=128,
                         monitor_cfg=MonitorConfig(window=0.010),
                         anneal_iters=500)
print(cluster.describe())

trace = bursty_trace(rate=1.1 * cluster.capacity, num_requests=300,
                     seed=7)
print("trace:", {k: round(v, 2) for k, v in trace_stats(trace).items()})

for router in (RoundRobinRouter(), LeastLoadedRouter(), JSEDRouter()):
    r = cluster.simulate(trace, router)
    print(f"{router.name:>12}: thr={r.throughput:7.1f} req/s  "
          f"mean_lat={r.mean_latency * 1e3:8.2f} ms  "
          f"p95={r.p(0.95) * 1e3:8.2f} ms  "
          f"cost_eff={r.cost_efficiency:8.1f} req/$  "
          f"switches={r.switches}  per_replica={r.per_replica_completed}"
          "  (modeled)")

# --- the same shape on real engines: drain group 0 mid-run ----------- #
spec = DeploymentSpec(groups=GROUPS[:2], arch="llama3_8b",
                      engine={"slots": 2, "max_len": MAX_LEN,
                              "sync_every": 2})
live = spec.compile(graph).launch(cfg, params, device=dev)
live.scale(remove=[0], at=0.0)
rng = np.random.default_rng(0)
reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=n)
                .astype(np.int32), max_new_tokens=8)
        for i, n in enumerate((9, 5, 12, 7))]
out = live.run(reqs)
assert all(len(r.output) == r.max_new_tokens for r in reqs), \
    "a drained session lost tokens"
print(f"live pool: completed={out['engine']['completed']} "
      f"migrations={out['migrations']} wire_bytes={out['wire_bytes']} "
      f"routable={out['routable']}")
