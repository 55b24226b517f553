"""The grouped matmul as a custom op, ``repro_torch::gmm`` (K3): a CPU
tensor takes the plain PyTorch version (``ref``), any other tensor the
hand-written kernel (``kernel``), which raises on what it does not take.
There is no fallback from the kernel to the plain version.

The op is one node in a trace: the plain version's host read of the
group sizes (``.tolist()``) stays inside it, so a trace on fake tensors
does not need their values."""
from __future__ import annotations

import torch
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import cost, library
from repro_torch.kernels.moe_gmm import kernel, ref


def _fake(x, w, group_sizes):
    return x.new_empty((x.shape[0], w.shape[2]))


def _sharding(x, w, group_sizes):
    """K3 on one mesh dimension: replicated; the output columns sharded
    with the weights' (the FFN width of a tensor-parallel expert); or
    the contraction sharded, a partial sum.  The rows stay whole: the
    group sizes count every row."""
    R = Replicate()
    return [([R], [R, R, R]), ([Shard(1)], [R, Shard(2), R]),
            ([Partial()], [Shard(1), Shard(1), R])]


GMM = library.define(
    "gmm(Tensor x, Tensor w, Tensor group_sizes) -> Tensor",
    kernel.gmm, ref.gmm, _fake, _sharding)


@register_flop_formula(torch.ops.repro_torch.gmm)
def _flops(x, w, group_sizes, *, out_shape=None, **kw) -> float:
    return cost.gmm(x[0], x[1], w[2], w[0], 2)[0]


def gmm(x: torch.Tensor, w: torch.Tensor,
        group_sizes: torch.Tensor) -> torch.Tensor:
    """x: (M, K) expert-sorted rows; w: (E, K, N); group_sizes: (E,)
    int32.  -> (M, N)."""
    return GMM(x, w, group_sizes)
