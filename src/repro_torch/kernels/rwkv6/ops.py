"""The WKV recurrence as a custom op, ``repro_torch::wkv`` (K4), which
replaces its ``state`` in place (``Tensor(a!)``): a CPU tensor takes the
plain PyTorch version (``ref``), any other tensor the hand-written
kernel (``kernel``), which raises on what it does not take.  There is no
fallback from the kernel to the plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels import library
from repro_torch.kernels.rwkv6 import kernel, ref


def _fake(r, k, v, w, u, state):
    return r.new_empty(r.shape, dtype=torch.float32)


WKV = library.define(
    "wkv(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, "
    "Tensor(a!) state) -> Tensor", kernel.wkv, ref.wkv, _fake)


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """r, k, v, w: (B, S, H, P); u: (H, P); state: (B, H, P, P) fp32,
    replaced in place by the final state.  -> y (B, S, H, P) fp32."""
    return WKV(r, k, v, w, u, state)
