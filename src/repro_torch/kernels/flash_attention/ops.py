"""Dispatch for flash attention: a CPU tensor takes the plain PyTorch
version (``ref``), any other tensor the hand-written kernel
(``kernel``), which raises on what it does not take.  There is no
fallback from the kernel to the plain version."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import kernel, ref


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, q_offset: int = 0,
                      window: Optional[int] = None) -> torch.Tensor:
    """Causal GQA prefill, optionally over a sliding ``window``.
    q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D)."""
    if q.device.type == "cpu":
        return ref.prefill_attention(q, k, v, q_offset=q_offset,
                                     window=window)
    return kernel.flash_prefill(q, k, v, q_offset=q_offset, window=window)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """One-token GQA decode.  q: (B, H, D); k/v: (B, T, Hkv, D);
    lengths: (B,) int32."""
    if q.device.type == "cpu":
        return ref.decode_attention(q, k, v, lengths)
    return kernel.flash_decode(q, k, v, lengths)
