"""Quickstart: Tessera's full pipeline on the PyTorch port.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

1. trace a model's decode step into a kernel graph (torch.export; value
   edges plus the read/write sets of the in-place cache writes),
2. inspect kernel heterogeneity across a heterogeneous GPU pair,
3. plan placement (throughput + latency policies),
4. execute disaggregated on two logical devices and verify against
   single-device execution, for both policies.

The plans are made for the paper's H100 + RTX Pro 6000 pair
(``costmodel.PAPER_PAIRS``); the modeled times are the cost model's, not
a measurement.  Both logical devices sit on ``--device`` (on CUDA each
with its own stream).
"""
import argparse
import dataclasses

import torch

import repro_torch.configs as configs
from repro_torch import resolve_device
from repro_torch.core import analyzer, planner
from repro_torch.core.costmodel import CATALOG, PAPER_PAIRS
from repro_torch.core.executor import build_executable, logical_devices
from repro_torch.models import model as M

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = resolve_device(ap.parse_args().device)

# the smoke config at head_dim 64, a width the attention kernels take
cfg = dataclasses.replace(configs.get_smoke("llama3_8b"), dtype="float32",
                          head_dim=64)
g = torch.Generator(device=dev)
g.manual_seed(0)
params = M.init_params(cfg, generator=g, device=dev)
cache = M.init_cache(cfg, 2, 32, device=dev)
toks = torch.tensor([[5], [9]], dtype=torch.int32, device=dev)
pos = torch.tensor([3, 7], dtype=torch.int32, device=dev)


def step(p, c, t, q):
    return M.decode_step(p, cfg, t, c, q, tagged=True)


# 1. analyze ---------------------------------------------------------- #
traced = analyzer.analyze(step, params, cache, toks, pos,
                          state_argnums=(1,))
print("kernel graph:", traced.graph.stats())

# 2. heterogeneity ---------------------------------------------------- #
devs = [CATALOG[n] for n in PAPER_PAIRS[1]]
faster_on_b = sum(devs[1].kernel_time(n) < devs[0].kernel_time(n)
                  for n in traced.graph.nodes)
print(f"{faster_on_b}/{len(traced.graph)} kernels faster on "
      f"{devs[1].name} (paper Fig. 2; modeled)")

# 3. plan (pin KV-touching kernels to the cache's home device) -------- #
gp = analyzer.pin_nodes(traced.graph,
                        traced.state_readers | traced.state_writers, 0)
traced = traced.with_graph(gp)
plans = {pol: planner.plan(gp, devs, policy=pol, cache=False)
         for pol in ("throughput", "latency")}
for p in plans.values():
    print(p.summary())

# 4. execute disaggregated and verify, both policies ------------------ #
for pol, p in plans.items():
    exe = build_executable(traced, p, logical_devices(2, dev))
    c_exe = M.init_cache(cfg, 2, 32, device=dev)
    c_ref = M.init_cache(cfg, 2, 32, device=dev)
    for i in range(3):
        logits, c_exe = exe(params, c_exe, toks, pos + i)
        ref_logits, c_ref = M.decode_step(params, cfg, toks, c_ref, pos + i)
        torch.testing.assert_close(logits, ref_logits, rtol=1e-5, atol=1e-5)
    print(f"{pol}: {exe.num_units} dispatch units; "
          "disaggregated == single-device: OK")
