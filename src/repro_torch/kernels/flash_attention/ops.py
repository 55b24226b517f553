"""Flash attention as two custom ops, ``repro_torch::flash_decode`` (K1)
and ``repro_torch::flash_prefill`` (K2): a CPU tensor takes the plain
PyTorch version (``ref``), any other tensor the hand-written kernel
(``kernel``), which raises on what it does not take.  There is no
fallback from the kernel to the plain version."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import library
from repro_torch.kernels.flash_attention import kernel, ref


# ``causal`` has its schema default in each implementation: the
# dispatcher drops an argument equal to the default before the call
def _prefill_kernel(q, k, v, q_offset, window, causal=True):
    return kernel.flash_prefill(q, k, v, q_offset=q_offset, window=window,
                                causal=causal)


# the plain versions' outputs are made contiguous, as the kernels' are
# (and as the fake implementation says)
def _prefill_plain(q, k, v, q_offset, window, causal=True):
    return ref.prefill_attention(q, k, v, q_offset=q_offset, window=window,
                                 causal=causal).contiguous()


def _decode_plain(q, k, v, lengths):
    return ref.decode_attention(q, k, v, lengths).contiguous()


def _like_q(q, *_):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


FLASH_DECODE = library.define(
    "flash_decode(Tensor q, Tensor k, Tensor v, Tensor lengths) -> Tensor",
    kernel.flash_decode, _decode_plain, _like_q)
FLASH_PREFILL = library.define(
    "flash_prefill(Tensor q, Tensor k, Tensor v, int q_offset, int? window,"
    " bool causal=True) -> Tensor", _prefill_kernel, _prefill_plain, _like_q)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, q_offset: int = 0,
                      window: Optional[int] = None,
                      causal: bool = True) -> torch.Tensor:
    """GQA prefill: causal, optionally over a sliding ``window``, or not
    causal (every query sees every key: an encoder, cross-attention).
    q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D)."""
    return FLASH_PREFILL(q, k, v, q_offset, window, causal)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """One-token GQA decode.  q: (B, H, D); k/v: (B, T, Hkv, D);
    lengths: (B,) int32."""
    return FLASH_DECODE(q, k, v, lengths)
