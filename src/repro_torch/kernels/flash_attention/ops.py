"""Flash attention as custom ops, ``repro_torch::flash_decode`` (K1),
its log-sum-exp form ``repro_torch::flash_decode_lse`` and
``repro_torch::flash_prefill`` (K2): a CPU tensor takes the plain
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


# ``causal`` and ``softcap`` have their schema defaults in each
# implementation: the dispatcher drops an argument equal to its default
# before the call
def _decode_kernel(q, k, v, lengths, softcap=0.0):
    return kernel.flash_decode(q, k, v, lengths, softcap=softcap)


def _decode_lse_kernel(q, k, v, lengths, softcap=0.0):
    return kernel.flash_decode_lse(q, k, v, lengths, softcap=softcap)


def _prefill_kernel(q, k, v, q_offset, window, causal=True, softcap=0.0):
    return kernel.flash_prefill(q, k, v, q_offset=q_offset, window=window,
                                causal=causal, softcap=softcap)


# the plain versions' outputs are made contiguous, as the kernels' are
# (and as the fake implementation says)
def _prefill_plain(q, k, v, q_offset, window, causal=True, softcap=0.0):
    return ref.prefill_attention(q, k, v, q_offset=q_offset, window=window,
                                 causal=causal, softcap=softcap).contiguous()


def _decode_plain(q, k, v, lengths, softcap=0.0):
    return ref.decode_attention(q, k, v, lengths, softcap).contiguous()


def _decode_lse_plain(q, k, v, lengths, softcap=0.0):
    o, lse = ref.decode_attention_lse(q, k, v, lengths, softcap)
    return o.contiguous(), lse.contiguous()


def _like_q(q, *_):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


def _lse_like(q, *_):
    """The log-sum-exp form's outputs: o (B, H, D) and lse (B, H),
    float32."""
    return (q.new_empty(q.shape, dtype=torch.float32),
            q.new_empty(q.shape[:2], dtype=torch.float32))


def _kv_heads_split(q, k) -> bool:
    """Heads may shard: every shard of the query heads then reads the KV
    heads of its own shard (the KV heads split evenly over the whole
    mesh, so over any of its dimensions)."""
    return k.shape[2] % k.mesh.size() == 0


def _decode_sharding(q, k, v, lengths, *rest):
    """K1 on one mesh dimension: replicated, batch-sharded, or
    head-sharded where the KV heads follow the query heads (``rest``:
    the softcap, where the call passed one)."""
    R, S0, none = Replicate(), Shard(0), [None] * len(rest)
    out = [([R], [R, R, R, R] + none), ([S0], [S0, S0, S0, S0] + none)]
    if _kv_heads_split(q, k):
        out.append(([Shard(1)], [Shard(1), Shard(2), Shard(2), R] + none))
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
    "flash_decode(Tensor q, Tensor k, Tensor v, Tensor lengths,"
    " float softcap=0.0) -> Tensor",
    _decode_kernel, _decode_plain, _like_q, _decode_sharding)
# the log-sum-exp form runs on each rank's shards of a cache sharded over
# T (``distributed.local.attend``), never on DTensors: no strategy
FLASH_DECODE_LSE = library.define(
    "flash_decode_lse(Tensor q, Tensor k, Tensor v, Tensor lengths,"
    " float softcap=0.0) -> (Tensor, Tensor)",
    _decode_lse_kernel, _decode_lse_plain, _lse_like)
FLASH_PREFILL = library.define(
    "flash_prefill(Tensor q, Tensor k, Tensor v, int q_offset, int? window,"
    " bool causal=True, float softcap=0.0) -> Tensor", _prefill_kernel,
    _prefill_plain, _like_q, _prefill_sharding)


# the softcap's tanh is not counted, as no exp is (``kernels/cost.py``):
# the dry run and the roofline read the same work whatever implements it
@register_flop_formula(torch.ops.repro_torch.flash_decode)
def _decode_flops(q, k, v, lengths, softcap=0.0, *, out_shape=None,
                  **kw) -> float:
    # a trace sees shapes only: every row's whole cache
    B, H, D = q
    return cost.decode(B, H, k[2], D, B * k[1], 2)[0]


@register_flop_formula(torch.ops.repro_torch.flash_decode_lse)
def _decode_lse_flops(q, k, v, lengths, softcap=0.0, *, out_shape=None,
                      **kw) -> float:
    B, H, D = q
    return cost.decode_lse(B, H, k[2], D, B * k[1], 2)[0]


@register_flop_formula(torch.ops.repro_torch.flash_prefill)
def _prefill_flops(q, k, v, q_offset, window, causal=True, softcap=0.0, *,
                   out_shape=None, **kw) -> float:
    B, Sq, H, D = q
    pairs = cost.prefill_pairs(Sq, k[1], q_offset, window, causal)
    return cost.prefill(B, Sq, k[1], H, k[2], D, pairs, 2)[0]


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, q_offset: int = 0,
                      window: Optional[int] = None,
                      causal: bool = True,
                      softcap: float = 0.0) -> torch.Tensor:
    """GQA prefill: causal, optionally over a sliding ``window``, or not
    causal (every query sees every key: an encoder, cross-attention);
    with a logit ``softcap`` > 0.  q: (B, Sq, H, D); k/v: (B, Skv, Hkv,
    D)."""
    return FLASH_PREFILL(q, k, v, q_offset, window, causal, float(softcap))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor,
                     softcap: float = 0.0) -> torch.Tensor:
    """One-token GQA decode, with a logit ``softcap`` > 0.  q: (B, H, D);
    k/v: (B, T, Hkv, D); lengths: (B,) int32."""
    return FLASH_DECODE(q, k, v, lengths, float(softcap))


def decode_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor, softcap: float = 0.0):
    """``decode_attention`` over one shard of the cache, with its
    softmax's log-sum-exp: (o (B, H, D) float32, lse (B, H) float32); a
    row of length 0 gives o = 0 and lse = -1e30."""
    return FLASH_DECODE_LSE(q, k, v, lengths, float(softcap))
