"""Dispatch for the SSD chunked scan: a CPU tensor takes the plain
PyTorch version (``ref``), any other tensor the hand-written kernel
(``kernel``), which raises on what it does not take.  There is no
fallback from the kernel to the plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels.mamba2_ssd import kernel, ref


def ssd(xh: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor,
        a_log: torch.Tensor, h: torch.Tensor, *,
        chunk: int = 128) -> torch.Tensor:
    """xh: (B, S, H, P) fp32; B_/C_: (B, S, N); a_log: (B, S, H) fp32;
    h: (B, H, N, P) fp32, replaced in place by the final state.
    -> y (B, S, H, P) fp32."""
    if xh.device.type == "cpu":
        return ref.ssd(xh, B_, C_, a_log, h, chunk=chunk)
    return kernel.ssd(xh, B_, C_, a_log, h, chunk=chunk)
