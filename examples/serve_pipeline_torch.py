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
script.

The last part is the phase-split handoff: a prefill engine exports each
request's state and a decode engine continues from it, serially (the
whole state after the prefill) and streamed ((layer, chunk) shards while
later chunks still run), driven through the engines' own API as the
reference deployment spec drives its prefill/decode pair; greedy decode
must equal a single engine's.  The spec itself (and its DES backend) is
not ported yet.
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
from repro_torch.serving.engine import (ServingEngine, requests_from_trace,
                                        serve_pd)
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

# --- phase-split: two-engine prefill -> transfer -> decode handoff ---- #
# Engine P runs only prefills and exports each request's KV/recurrent
# state; engine D starts decode-only sessions from the imported state.
# Serial: the whole state after the prefill.  Streamed: the prefill
# engine runs 4-token chunks and yields each (layer, chunk) shard as it
# is computed; D installs shards as they arrive and starts decoding when
# the last one lands (a ring-buffer model ships each layer's ring whole).
print("\n--- phase-split handoff (prefill engine -> decode engine) ---")
ENGINE_KW = {"slots": SLOTS, "max_len": MAX_LEN, "device": dev}
pd_trace = poisson_trace(rate=40.0, num_requests=6, seed=3)


def pd_requests():
    return requests_from_trace(pd_trace, cfg.vocab_size,
                               max_prompt=PROMPT_CAP, max_new=NEW_CAP,
                               time_scale=0.0)


single = pd_requests()
ServingEngine(cfg, params, **ENGINE_KW).run(single)


def run_pd(requests, streamed):
    """One prefill engine and one decode engine through the reference
    spec's loop (``serve_pd``); returns the decode engine's stats, the
    wire bytes and the shards."""
    pre = ServingEngine(cfg, params, prefill_chunk=4 if streamed else None,
                        **ENGINE_KW)
    dec = ServingEngine(cfg, params, sync_every=4, **ENGINE_KW)
    wire, shards, _ = serve_pd(pre, dec, requests, streamed)
    return dec.stats.summary(), wire, shards


for streamed in (False, True):
    split = pd_requests()
    t0 = time.perf_counter()
    summary, wire_bytes, n_shards = run_pd(split, streamed)
    wall = time.perf_counter() - t0
    match = all(a.output == b.output for a, b in zip(single, split))
    kind = "streamed" if streamed else "serial"
    print(f"{kind}: requests={len(split)}  KV wire bytes={wire_bytes}  "
          f"shards={n_shards}  wall={wall * 1e3:.1f}ms")
    print(f"{kind}: decode-only engine: {summary}")
    print(f"{kind} handoff bit-identical to single engine: {match}")
    assert match, f"{kind} handoff diverged from the single-engine run"
