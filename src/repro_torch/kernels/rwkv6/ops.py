"""Dispatch for the WKV recurrence: a CPU tensor takes the plain PyTorch
version (``ref``), any other tensor the hand-written kernel
(``kernel``), which raises on what it does not take.  There is no
fallback from the kernel to the plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels.rwkv6 import kernel, ref


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """r, k, v, w: (B, S, H, P); u: (H, P); state: (B, H, P, P) fp32,
    replaced in place by the final state.  -> y (B, S, H, P) fp32."""
    if r.device.type == "cpu":
        return ref.wkv(r, k, v, w, u, state)
    return kernel.wkv(r, k, v, w, u, state)
