"""Serving launcher of the port: the continuous-batching engine on one
CUDA device (or the CPU with ``--device cpu``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b \
      --max-len 1024 --max-new 32 --trace poisson
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt_oss_20b \
      --max-len 1024 --max-new 32 --trace poisson
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6_3b \
      --max-len 1024 --max-new 32 --trace poisson      # or zamba2_7b
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --arch zamba2_7b

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt_oss_20b \
      --max-len 1024 --max-new 32 --trace poisson \
      --disaggregate --policy throughput

Dense, MoE, ssm (rwkv6) and hybrid (zamba2) architectures are served;
the encdec and vlm ones raise ``NotImplementedError``.

``--disaggregate`` traces the decode step (``core.analyzer``), plans it
for the GPU pair ``PLAN_PAIR`` under ``--policy`` (``core.planner``,
with the cache's readers and writers pinned to the first device) and
serves through the disaggregated executable, both logical devices on
the one ``--device`` (each with its own stream on CUDA).

``--deployment SPEC_JSON`` launches a serialized ``DeploymentSpec``
instead (``serving.spec``): a pool of colocated engines, one per replica
group, or the prefill -> decode pair when the spec says ``pd`` (streamed
when ``kv_chunks > 1``), every engine on ``--device`` and sharing one
set of weights; engine knobs come from ``spec.engine``:

  PYTHONPATH=src python -m repro_torch.launch.serve --deployment spec.json \
      --device cpu --smoke --requests 8

Same flags as ``repro.launch.serve``; ``--device`` is new.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

import repro_torch.configs as configs
from repro_torch import resolve_device
from repro_torch.core import analyzer, planner
from repro_torch.core.costmodel import CATALOG, PAPER_PAIRS
from repro_torch.core.executor import build_executable, logical_devices
from repro_torch.models import model as M
from repro_torch.serving.engine import (Request, ServingEngine,
                                        requests_from_trace)
from repro_torch.serving.spec import DeploymentSpec
from repro_torch.serving.workload import make_trace


# the paper's H100 + RTX Pro 6000 pair, from costmodel.PAPER_PAIRS
PLAN_PAIR = PAPER_PAIRS[1]


def plan_decode(cfg, params, slots: int, max_len: int,
                device: torch.device,
                policies: Sequence[str] = ("latency", "throughput")
                ) -> Dict[str, Any]:
    """Trace the engine's decode step (``slots`` rows, a cache of
    ``max_len``), pin the cache's readers and writers to plan device 0
    and plan it for ``PLAN_PAIR`` under each policy.  Returns {"traced",
    "plans"}."""
    cache = M.init_cache(cfg, slots, max_len, device=device)
    toks = torch.zeros((slots, 1), dtype=torch.int32, device=device)
    pos = torch.zeros((slots,), dtype=torch.int32, device=device)

    def step(p, c, t, q):
        return M.decode_step(p, cfg, t, c, q, tagged=True)

    traced = analyzer.analyze(step, params, cache, toks, pos,
                              state_argnums=(1,))
    g = analyzer.pin_nodes(traced.graph,
                           traced.state_readers | traced.state_writers, 0)
    traced = traced.with_graph(g)
    devs = [CATALOG[n] for n in PLAN_PAIR]
    return {"traced": traced,
            "plans": {pol: planner.plan(g, devs, policy=pol)
                      for pol in policies}}


def disaggregated_decode(cfg, params, slots: int, max_len: int,
                         device: torch.device,
                         policies: Sequence[str] = ("latency", "throughput")
                         ) -> Dict[str, Any]:
    """``plan_decode``, then one executable per policy on two logical
    devices of ``device`` (on CUDA, a stream each).  Returns {"traced",
    "plans", "executables"}."""
    core = plan_decode(cfg, params, slots, max_len, device, policies)
    lds = logical_devices(len(PLAN_PAIR), device)
    core["executables"] = {
        pol: build_executable(core["traced"], p, lds)
        for pol, p in core["plans"].items()}
    return core


def build_requests(args, cfg, max_len: int,
                   rng_seed: int = 0) -> List[Request]:
    if args.trace:
        trace = make_trace(args.trace, args.rate, args.requests, seed=0)
        return requests_from_trace(
            trace, cfg.vocab_size, max_prompt=max_len // 2,
            max_new=args.max_new)
    rng = np.random.default_rng(rng_seed)
    return [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size, size=8)
                    .astype(np.int32),
                    max_new_tokens=args.max_new,
                    arrival=0.01 * i)
            for i in range(args.requests)]


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--sync-every", type=int, default=8,
                    help="decode steps between host syncs (1 = per-token "
                         "accounting)")
    ap.add_argument("--trace", default=None,
                    choices=["poisson", "bursty", "diurnal"],
                    help="drive the engine from an open-loop workload "
                         "trace instead of fixed arrivals")
    ap.add_argument("--rate", type=float, default=20.0,
                    help="trace arrival rate (req/s)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    ap.add_argument("--disaggregate", action="store_true",
                    help="serve the decode step through a Tessera plan "
                         "for the pair " + "+".join(PLAN_PAIR))
    ap.add_argument("--policy", default="throughput",
                    choices=["throughput", "latency"])
    ap.add_argument("--deployment", default=None, metavar="SPEC_JSON",
                    help="load a serialized DeploymentSpec and launch "
                         "its engine topology instead of the ad-hoc "
                         "flags (--arch/--slots/... are ignored except "
                         "--smoke/--requests/--max-new/--trace/--rate/"
                         "--device)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.deployment:
        spec = DeploymentSpec.load(args.deployment)
        arch = spec.arch or args.arch
        cfg = (configs.get_smoke(arch) if args.smoke
               else configs.get(arch))
        launched = spec.compile().launch(cfg, device=device)
        max_len = int(spec.engine.get("max_len", 64))
        reqs = build_requests(args, cfg, max_len)
        out = launched.run(reqs)
        print(f"deployment: pd={spec.pd} kv_chunks={spec.kv_chunks} "
              f"engines={len(launched.engines)} "
              f"wire_bytes={out['wire_bytes']} shards={out['shards']}")
        print(out["engine"])
        return out
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    params = M.init_params(cfg, device=device)

    decode_fn = None
    if args.disaggregate:
        core = disaggregated_decode(cfg, params, args.slots, args.max_len,
                                    device, policies=(args.policy,))
        plan = core["plans"][args.policy]
        print(plan.summary())
        decode_fn = core["executables"][args.policy]

    reqs = build_requests(args, cfg, args.max_len)
    engine = ServingEngine(cfg, params, slots=args.slots,
                           max_len=args.max_len, sync_every=args.sync_every,
                           decode_fn=decode_fn, device=device)
    summary = engine.run(reqs).summary()
    print(summary)
    return summary


if __name__ == "__main__":
    main()
