"""End-to-end serving driver on the PyTorch port (the paper's kind of
workload).

  PYTHONPATH=src python examples/serve_pipeline_torch.py [--device cpu]

A Poisson open-loop trace (serving/workload.py) drives the REAL
continuous-batching engine; the decode step runs DISAGGREGATED through
Tessera's executable on two logical devices, and the online monitor
switches between latency- and throughput-oriented plans as queueing
pressure changes.

The cost model's predictions for the same plan are printed next to the
engine's wall-clock SLO stats: modeled TPOT is the decode plan's
pipelined bottleneck, modeled TTFT the serial prefill time on the
faster device (the prefill graph traced on meta tensors, through the
attention and SSD kernels' fake implementations).  Modeled numbers are
for the H100 + RTX Pro 6000 pair the plans were solved for
(``costmodel.PAPER_PAIRS``); wall clock is whatever device runs this
script.  The reference's phase-split handoff (its part after the
monitor) needs the paged KV pool and the deployment spec, not ported
yet.
"""
import argparse
import dataclasses
import json
import time

import torch

import repro_torch.configs as configs
from repro_torch import resolve_device
from repro_torch.core import analyzer, planner
from repro_torch.core.costmodel import CATALOG, PAPER_PAIRS, graph_time_on
from repro_torch.core.executor import build_executable, logical_devices
from repro_torch.core.monitor import MonitorConfig, OnlineMonitor
from repro_torch.models import model as M
from repro_torch.serving.engine import ServingEngine, requests_from_trace
from repro_torch.serving.workload import poisson_trace, trace_stats

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = resolve_device(ap.parse_args().device)

SLOTS, MAX_LEN = 4, 48
# the smoke config at head_dim 64, a width the attention kernels take
cfg = dataclasses.replace(configs.get_smoke("gpt_oss_20b"),
                          dtype="float32", head_dim=64)
g = torch.Generator(device=dev)
g.manual_seed(0)
params = M.init_params(cfg, generator=g, device=dev)

# --- Tessera: plan the decode step for both policies ----------------- #
cache0 = M.init_cache(cfg, SLOTS, MAX_LEN, device=dev)
toks0 = torch.zeros((SLOTS, 1), dtype=torch.int32, device=dev)
pos0 = torch.zeros((SLOTS,), dtype=torch.int32, device=dev)


def step(p, c, t, q):
    return M.decode_step(p, cfg, t, c, q, tagged=True)


traced = analyzer.analyze(step, params, cache0, toks0, pos0,
                          state_argnums=(1,))
gp = analyzer.pin_nodes(traced.graph,
                        traced.state_readers | traced.state_writers, 0)
traced = traced.with_graph(gp)
devs = [CATALOG[n] for n in PAPER_PAIRS[1]]
plans = {pol: planner.plan(gp, devs, policy=pol) for pol in
         ("latency", "throughput")}
for pol, p in plans.items():
    print(f"{pol:>10}: {p.summary()}")
lds = logical_devices(2, dev)
executables = {pol: build_executable(traced, p, lds)
               for pol, p in plans.items()}

monitor = OnlineMonitor(MonitorConfig(window=0.5, beta=1.5))


def decode_fn(p, c, t, q):
    return executables[monitor.policy](p, c, t, q)


# --- workload: an open-loop Poisson trace ----------------------------- #
PROMPT_CAP, NEW_CAP = 8, 6
trace = poisson_trace(rate=40.0, num_requests=12, seed=0)
print("trace:", {k: round(v, 3) for k, v in trace_stats(trace).items()})
reqs = requests_from_trace(trace, cfg.vocab_size, max_prompt=PROMPT_CAP,
                           max_new=NEW_CAP, time_scale=0.5)
engine = ServingEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                       decode_fn=decode_fn, sync_every=4, device=dev)
t0 = time.perf_counter()
stats = engine.run(reqs)
for r in reqs:
    lat = r.finished - r.arrival
    monitor.record_request(r.finished, lat, lat * 0.5)
monitor.tick(time.perf_counter() - t0 + 1.0)

# --- modeled vs wall-clock SLOs --------------------------------------- #
# modeled TTFT: serial prefill on the faster device (no queueing term),
# traced on meta tensors; modeled TPOT: pipelined steady-state
# bottleneck of the decode plan.
meta = torch.device("meta")
tg_pre = analyzer.analyze(
    lambda p, c, t: M.prefill(p, cfg, t, c, tagged=True),
    M.init_params(cfg, device=meta), M.init_cache(cfg, 1, MAX_LEN,
                                                  device=meta),
    torch.zeros((1, PROMPT_CAP), dtype=torch.int32, device=meta),
    state_argnums=(1,))
modeled_ttft = min(graph_time_on(tg_pre.graph, d) for d in devs)
s = stats.summary()
print("engine:", s)
print(f"{'':14}{'modeled':>12}{'wall-clock':>12}")
for name, model_v, wall_v in (
        ("TTFT", modeled_ttft, s["mean_ttft"]),
        ("TPOT", plans[monitor.policy].bottleneck, s["mean_tpot"])):
    ratio = wall_v / max(model_v, 1e-12)
    print(f"  {name:<12}{model_v * 1e3:>10.3f}ms{wall_v * 1e3:>10.3f}ms"
          f"   (wall/model {ratio:,.0f}x)")
# machine-readable modeled-vs-wall gap (one JSON object per line,
# greppable by CALIBRATION; costmodel.calibrate reads it)
modeled_tpot = plans[monitor.policy].bottleneck
print("CALIBRATION " + json.dumps({
    "modeled_ttft_s": modeled_ttft, "wall_ttft_s": s["mean_ttft"],
    "ttft_wall_over_model": s["mean_ttft"] / max(modeled_ttft, 1e-12),
    "modeled_tpot_s": modeled_tpot, "wall_tpot_s": s["mean_tpot"],
    "tpot_wall_over_model": s["mean_tpot"] / max(modeled_tpot, 1e-12),
}))
print(f"monitor: policy={monitor.policy} switches={monitor.switches}")
print("sample output tokens:", reqs[0].output)
