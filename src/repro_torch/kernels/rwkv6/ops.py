"""The WKV recurrence as a custom op, ``repro_torch::wkv`` (K4), which
replaces its ``state`` in place (``Tensor(a!)``): a CPU tensor takes the
plain PyTorch version (``ref``), any other tensor the hand-written
kernel (``kernel``), which raises on what it does not take.  There is no
fallback from the kernel to the plain version."""
from __future__ import annotations

import torch
from torch.distributed.tensor import Shard
from torch.utils.flop_counter import register_flop_formula

from repro_torch.distributed import local as LD
from repro_torch.kernels import cost, library
from repro_torch.kernels.rwkv6 import kernel, ref


def _fake(r, k, v, w, u, state):
    return r.new_empty(r.shape, dtype=torch.float32)


WKV = library.define(
    "wkv(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, "
    "Tensor(a!) state) -> Tensor", kernel.wkv, ref.wkv, _fake)


@register_flop_formula(torch.ops.repro_torch.wkv)
def _flops(r, k, v, w, u, state, *, out_shape=None, **kw) -> float:
    return cost.wkv(*r, 4)[0]


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """r, k, v, w: (B, S, H, P); u: (H, P); state: (B, H, P, P) fp32,
    replaced in place by the final state.  -> y (B, S, H, P) fp32.

    On DTensors each rank runs the op on its shards, every input moved to
    the state's batch and head placements (DTensor's own strategies
    would move the state, a copy, and lose the write)."""
    if LD.is_dtensor(r, k, v, w, u, state):
        return _sharded(r, k, v, w, u, state)
    return WKV(r, k, v, w, u, state)


def _sharded(r, k, v, w, u, state):
    mesh = LD.mesh_of(state, r, k, v, w, u)
    spl = LD.placements_of(state, mesh)
    if any(isinstance(p, Shard) and p.dim > 1 for p in spl):
        # a state sharded over its key or value channels (the cache
        # rules' "kv_heads" where the heads do not split): run on the
        # state gathered over them, then write back each rank's slice
        whole = state.redistribute(mesh, LD.mapped(spl, {0: 0, 1: 1}))
        y = _sharded(r, k, v, w, u, whole)
        state.to_local().copy_(whole.redistribute(mesh, spl).to_local())
        return y
    seq = LD.mapped(spl, {0: 0, 1: 2})
    return LD.local_call(
        WKV, mesh,
        [(r, seq), (k, seq), (v, seq), (w, seq),
         (u, LD.mapped(spl, {1: 0})), (state, spl)],
        [(seq, r.shape)])
