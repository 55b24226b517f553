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

Dense, MoE, ssm (rwkv6) and hybrid (zamba2) architectures are served;
the encdec and vlm ones raise ``NotImplementedError``.

Same flags as ``repro.launch.serve`` apart from the Tessera paths
(``--disaggregate``, ``--policy``, ``--deployment``), which are not
ported yet; ``--device`` is new.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

import repro_torch.configs as configs
from repro_torch import resolve_device
from repro_torch.models import model as M
from repro_torch.serving.engine import (Request, ServingEngine,
                                        requests_from_trace)
from repro_torch.serving.workload import make_trace


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
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    params = M.init_params(cfg, device=device)
    reqs = build_requests(args, cfg, args.max_len)
    engine = ServingEngine(cfg, params, slots=args.slots,
                           max_len=args.max_len, sync_every=args.sync_every,
                           device=device)
    summary = engine.run(reqs).summary()
    print(summary)
    return summary


if __name__ == "__main__":
    main()
