"""Dispatch for the grouped matmul: a CPU tensor takes the plain PyTorch
version (``ref``), any other tensor the hand-written kernel
(``kernel``), which raises on what it does not take.  There is no
fallback from the kernel to the plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels.moe_gmm import kernel, ref


def gmm(x: torch.Tensor, w: torch.Tensor,
        group_sizes: torch.Tensor) -> torch.Tensor:
    """x: (M, K) expert-sorted rows; w: (E, K, N); group_sizes: (E,)
    int32.  -> (M, N)."""
    if x.device.type == "cpu":
        return ref.gmm(x, w, group_sizes)
    return kernel.gmm(x, w, group_sizes)
