"""Flash attention as two custom ops, ``repro_torch::flash_decode`` (K1)
and ``repro_torch::flash_prefill`` (K2): a CPU tensor takes the plain
PyTorch version (``ref``), any other tensor the hand-written kernel
(``kernel``), which raises on what it does not take.  There is no
fallback from the kernel to the plain version."""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import cost, library
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


def _kv_heads_split(q, k) -> bool:
    """Heads may shard: every shard of the query heads then reads the KV
    heads of its own shard (the KV heads split evenly over the whole
    mesh, so over any of its dimensions)."""
    return k.shape[2] % k.mesh.size() == 0


def _decode_sharding(q, k, v, lengths):
    """K1 on one mesh dimension: replicated, batch-sharded, or
    head-sharded where the KV heads follow the query heads."""
    R, S0 = Replicate(), Shard(0)
    out = [([R], [R, R, R, R]), ([S0], [S0, S0, S0, S0])]
    if _kv_heads_split(q, k):
        out.append(([Shard(1)], [Shard(1), Shard(2), Shard(2), R]))
    return out


def _prefill_sharding(q, k, v, *rest):
    """K2 on one mesh dimension: as K1's (the query and key positions
    stay whole: causality and windows are absolute positions)."""
    R, S0, none = Replicate(), Shard(0), [None] * len(rest)
    out = [([R], [R, R, R] + none), ([S0], [S0, S0, S0] + none)]
    if _kv_heads_split(q, k):
        out.append(([Shard(2)], [Shard(2), Shard(2), Shard(2)] + none))
    return out


FLASH_DECODE = library.define(
    "flash_decode(Tensor q, Tensor k, Tensor v, Tensor lengths) -> Tensor",
    kernel.flash_decode, _decode_plain, _like_q, _decode_sharding)
FLASH_PREFILL = library.define(
    "flash_prefill(Tensor q, Tensor k, Tensor v, int q_offset, int? window,"
    " bool causal=True) -> Tensor", _prefill_kernel, _prefill_plain, _like_q,
    _prefill_sharding)


@register_flop_formula(torch.ops.repro_torch.flash_decode)
def _decode_flops(q, k, v, lengths, *, out_shape=None, **kw) -> float:
    # a trace sees shapes only: every row's whole cache
    B, H, D = q
    return cost.decode(B, H, k[2], D, B * k[1], 2)[0]


@register_flop_formula(torch.ops.repro_torch.flash_prefill)
def _prefill_flops(q, k, v, q_offset, window, causal=True, *,
                   out_shape=None, **kw) -> float:
    B, Sq, H, D = q
    pairs = cost.prefill_pairs(Sq, k[1], q_offset, window, causal)
    return cost.prefill(B, Sq, k[1], H, k[2], D, pairs, 2)[0]


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
