"""Plain PyTorch prefill and decode attention — the semantics of the
model's ``_sdpa_chunked`` (``repro/models/layers.py``), in the model's
layouts.

* GQA: query head ``h`` reads KV head ``h // rep`` (``rep = H // Hkv``).
* q is scaled by ``1/sqrt(D)`` in its own dtype before the product.
* logits and softmax are fp32; with a ``softcap`` > 0 the scaled
  logits become ``tanh(logits / softcap) * softcap`` before the mask;
  masked logits are ``-1e30``.
* the softmax weights are cast to the value dtype for the PV product,
  which accumulates in fp32; the output is in the value dtype.

These run on whatever device their inputs are on; ``ops`` sends only
CPU tensors here.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _capped(logits: torch.Tensor, softcap: float) -> torch.Tensor:
    """The logit softcap, ``tanh(logits / softcap) * softcap`` (none at
    0), as the reference's ``_sdpa_chunked`` applies it."""
    return torch.tanh(logits / softcap) * softcap if softcap > 0.0 \
        else logits


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, q_offset: int = 0,
                      window: Optional[int] = None,
                      causal: bool = True,
                      softcap: float = 0.0) -> torch.Tensor:
    """GQA attention.  q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D).

    Causal: query row ``i`` sits at absolute position ``q_offset + i``
    and sees keys at positions ``<= q_offset + i`` (the model's
    alignment, not the Pallas kernel's top-left one) and, with a sliding
    ``window``, ``> q_offset + i - window``.  Not ``causal`` (an encoder,
    cross-attention): every query sees every key.  Returns (B, Sq, H,
    D)."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    qg = (q * (1.0 / math.sqrt(D))).reshape(B, Sq, Hkv, rep, D)
    logits = _capped(torch.einsum("bqhrd,bkhd->bhrqk", qg.float(),
                                  k.float()), softcap)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Skv, device=q.device)
    mask = kpos[None, :] <= qpos[:, None] if causal \
        else torch.ones(Sq, Skv, dtype=torch.bool, device=q.device)
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    logits = logits.masked_fill(~mask, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhrqk,bkhd->bqhrd", w.to(v.dtype).float(), v.float())
    return o.reshape(B, Sq, H, D).to(v.dtype)


def _decode_logits(q: torch.Tensor, k: torch.Tensor, lengths: torch.Tensor,
                   softcap: float) -> torch.Tensor:
    """The scaled, capped and masked fp32 logits (B, Hkv, rep, T) of a
    decode step."""
    B, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qg = (q * (1.0 / math.sqrt(D))).reshape(B, Hkv, H // Hkv, D)
    logits = _capped(torch.einsum("bhrd,bkhd->bhrk", qg.float(), k.float()),
                     softcap)
    valid = torch.arange(T, device=q.device)[None, :] \
        < lengths.to(q.device)[:, None]                      # (B, T)
    return logits.masked_fill(~valid[:, None, None, :], NEG_INF)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor,
                     softcap: float = 0.0) -> torch.Tensor:
    """One-token GQA attention over a KV cache.  q: (B, H, D); k/v: the
    cache of one layer, (B, T, Hkv, D); lengths: (B,) valid KV length
    per row (``pos + 1``).  Returns (B, H, D)."""
    w = torch.softmax(_decode_logits(q, k, lengths, softcap), dim=-1)
    o = torch.einsum("bhrk,bkhd->bhrd", w.to(v.dtype).float(), v.float())
    return o.reshape(q.shape).to(v.dtype)


def decode_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor, softcap: float = 0.0):
    """``decode_attention`` and its softmax's log-sum-exp, for a caller
    that merges several shards of the cache: (o (B, H, D) float32, never
    rounded to the value dtype; lse (B, H) float32).  A row of length 0
    (a shard holding none of its tokens) gives o = 0 and lse =
    ``NEG_INF``."""
    B, H, D = q.shape
    logits = _decode_logits(q, k, lengths, softcap)
    lse = torch.logsumexp(logits, dim=-1)                   # (B, Hkv, rep)
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhrk,bkhd->bhrd", w.to(v.dtype).float(), v.float())
    empty = (lengths.to(q.device) <= 0)[:, None, None]
    o = torch.where(empty[..., None], torch.zeros_like(o), o)
    lse = torch.where(empty, torch.full_like(lse, NEG_INF), lse)
    return o.reshape(B, H, D), lse.reshape(B, H)
