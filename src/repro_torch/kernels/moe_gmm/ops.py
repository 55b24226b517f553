"""The grouped matmul as a custom op, ``repro_torch::gmm`` (K3): a CPU
tensor takes the plain PyTorch version (``ref``), any other tensor the
hand-written kernel (``kernel``), which raises on what it does not take.
There is no fallback from the kernel to the plain version.

The op is one node in a trace: the plain version's host read of the
group sizes (``.tolist()``) stays inside it, so a trace on fake tensors
does not need their values."""
from __future__ import annotations

import torch

from repro_torch.kernels import library
from repro_torch.kernels.moe_gmm import kernel, ref


def _fake(x, w, group_sizes):
    return x.new_empty((x.shape[0], w.shape[2]))


GMM = library.define(
    "gmm(Tensor x, Tensor w, Tensor group_sizes) -> Tensor",
    kernel.gmm, ref.gmm, _fake)


def gmm(x: torch.Tensor, w: torch.Tensor,
        group_sizes: torch.Tensor) -> torch.Tensor:
    """x: (M, K) expert-sorted rows; w: (E, K, N); group_sizes: (E,)
    int32.  -> (M, N)."""
    return GMM(x, w, group_sizes)
