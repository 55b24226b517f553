"""Layers — the PyTorch counterpart of the attention (self, encoder and
cross), M-RoPE, MLP and MoE parts of ``repro/models/layers.py`` (the
recurrent blocks are in ``ssm.py``).

Plain functions over parameter dicts whose layouts are the JAX ones:
``wq`` (d, H, hd), ``wk``/``wv`` (d, Hkv, hd), ``wo`` (H, hd, d), MLP
weights (d, f) and (f, d), MoE ``router`` (d, E) fp32 and expert
weights (E, d, f) and (E, f, d).  The dense projections are
``torch.matmul``; attention goes through ``kernels.flash_attention.ops``
and the expert matmuls through ``kernels.moe_gmm.ops``, which run the
hand-written kernels on the card and their plain versions on the CPU.

The KV cache of one layer is (B, T, Hkv, D), as in JAX.  Unlike JAX,
which returns a new cache, ``attention`` writes this step's K/V into
the cache tensors IN PLACE (one row write per request at its
position), so serving keeps one cache allocation for its lifetime.  A
sliding-window model's cache is a ring buffer of ``min(max_len,
window)`` slots: position p lives in slot ``p % T``.

The training forms — ``attention_train`` over ``_sdpa_chunked`` and
``moe_train`` over ``ragged_dot`` — are the reference's own training
path in plain PyTorch, differentiated by autograd: the kernels' ops
define no backward, so training reaches none of them (the reference's
training forward calls no Pallas kernel either).

Ported: the dense, MoE (``ragged``, ``dense_einsum`` and the
expert-parallel ``ep``), ssm (rwkv6), hybrid (zamba2), encdec
(seamless) and vlm (qwen2-vl, M-RoPE) families, and the logit softcap
(``attn_logit_softcap``: ``tanh(logits / cap) * cap`` on the scaled
logits before the mask, in K1, K2 and the training form alike).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.distributed import local as LD
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.context import current_mesh
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.moe_gmm import ops as G
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]
FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the options the port does not serve yet."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported "
            f"({', '.join(FAMILIES)} only)")
    if cfg.family == "hybrid" and cfg.num_layers % cfg.hybrid_attn_every:
        # the JAX model groups the layers as (num_layers // k, k) too
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not "
                         f"split into groups of {cfg.hybrid_attn_every}")
    if cfg.attn_logit_softcap < 0.0:
        raise ValueError(f"{cfg.name}: logit softcap "
                         f"{cfg.attn_logit_softcap} < 0")


# --------------------------------------------------------------------- #
# Norms and RoPE
# --------------------------------------------------------------------- #
def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of the RoPE angles, (B, S, 1, D/2) fp32, for positions
    (B, S).  Computed once per forward and shared by every layer (eager
    PyTorch has no common-subexpression pass to do it, as XLA does)."""
    freqs = rope_frequencies(head_dim, theta, positions.device)
    ang = positions[..., None].float() * freqs                  # (B,S,D/2)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def mrope_tables(positions3: torch.Tensor, head_dim: int, theta: float,
                 sections: Tuple[int, ...]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multimodal RoPE (qwen2-vl): ``rope_tables`` for position ids
    (3, B, S) = (t, h, w), the D/2 frequency channels split into runs of
    ``sections`` channels, run i rotated by axis i's ids (``apply_mrope``
    of the JAX package).  (B, S, 1, D/2) fp32, for ``apply_rope``."""
    freqs = rope_frequencies(head_dim, theta, positions3.device)
    chan = torch.cat([positions3[i][..., None].expand(
        *positions3.shape[1:], n) for i, n in enumerate(sections)], dim=-1)
    ang = chan.float() * freqs                                  # (B,S,D/2)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def apply_rope(x: torch.Tensor, rope: Tuple[torch.Tensor, torch.Tensor]
               ) -> torch.Tensor:
    """Half-split RoPE.  x: (B, S, H, D); rope: ``rope_tables(...)``."""
    cos, sin = rope
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- #
# Attention with a KV cache (prefill fill / decode)
# --------------------------------------------------------------------- #
def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    if LD.is_dtensor(x, w):
        return LD.contract(x, w, 1, _project)
    B, S, d = x.shape
    return (x.reshape(B * S, d) @ w.reshape(d, -1)).view(
        B, S, w.shape[1], w.shape[2])


def attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              rope: Tuple[torch.Tensor, torch.Tensor],
              kv_cache: Optional[Dict[str, torch.Tensor]],
              decode_pos: Optional[DecodePos] = None,
              offset: Optional[int] = None) -> torch.Tensor:
    """GQA self-attention over one layer's cache ``{"k", "v"}`` (B, T,
    Hkv, D); ``rope`` holds the tables of this call's positions.

    * ``kv_cache`` None: an encoder, with no cache — every query attends
      over all of this call's keys (K2 not causal).
    * ``decode_pos`` and ``offset`` None: prefill fill — this prompt's
      K/V go to cache slots [0, S) (a ring buffer shorter than S keeps
      the last T tokens, each at slot ``position % T``) and the queries
      attend causally, within ``cfg.sliding_window``, over the prompt
      (K2).
    * ``offset`` given: one chunk of a chunked prefill at positions
      [offset, offset + S) — its K/V go to slots [offset, offset + S)
      and the queries attend causally over the filled prefix
      [0, offset + S) (K2 at ``q_offset=offset``).  The reference
      attends over the whole cache; every slot past the prefix is
      masked causally, so the prefix gives the same result.  A ring
      buffer raises: its slot layout wraps at the window.
    * ``decode_pos`` given: decode (S == 1) — a ``DecodePos`` of the
      step; this token's K/V are written at each row's slot and the
      query attends over the row's first ``lengths`` cache slots (K1).
    Returns the output projection (B, S, d)."""
    B, S, _ = x.shape
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_norm(p["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, rope)
    k = apply_rope(k, rope)

    cap = cfg.attn_logit_softcap
    if kv_cache is None:
        out = _prefill_attn(q, k, v, q_offset=0,
                            window=cfg.sliding_window, causal=False,
                            softcap=cap)
    elif decode_pos is not None:
        _dyn_update(kv_cache["k"], k, decode_pos)
        _dyn_update(kv_cache["v"], v, decode_pos)
        out = _decode_attn(q[:, 0].contiguous(), kv_cache["k"],
                           kv_cache["v"], decode_pos.lengths,
                           softcap=cap)[:, None]
    elif offset is not None:
        if cfg.sliding_window is not None:
            raise ValueError("chunked prefill is undefined for ring-buffer "
                             "SWA caches")
        end = offset + S
        kc, vc = kv_cache["k"], kv_cache["v"]
        _write_slots(kc, k, offset)
        _write_slots(vc, v, offset)
        # K2 reads dense (B, Skv, Hkv, D): a prefix of B > 1 rows is a
        # strided view, so it is copied
        out = _prefill_attn(q, kc[:, :end].contiguous(),
                            vc[:, :end].contiguous(), q_offset=offset,
                            window=None, softcap=cap)
    else:
        _fill(kv_cache["k"], k)
        _fill(kv_cache["v"], v)
        out = _prefill_attn(q, k.to(kv_cache["k"].dtype),
                            v.to(kv_cache["v"].dtype), q_offset=0,
                            window=cfg.sliding_window, softcap=cap)
    return _out_project(out, p["wo"])


def _prefill_attn(q, k, v, *, q_offset: int, window: Optional[int],
                  causal: bool = True, softcap: float = 0.0) -> torch.Tensor:
    """K2; on DTensors each rank's call on its shards
    (``distributed.local.attend``)."""
    def kernel(a, b, c):
        return FA.prefill_attention(a, b, c, q_offset=q_offset,
                                    window=window, causal=causal,
                                    softcap=softcap)
    if LD.is_dtensor(q, k, v):
        return LD.attend(kernel, q, k, v)
    return kernel(q, k, v)


def _decode_attn(q, k, v, lengths, *, softcap: float = 0.0) -> torch.Tensor:
    """K1; on DTensors each rank's call on its shards, a cache sharded
    over T attended shard by shard through K1's log-sum-exp form and
    merged (``distributed.local.attend``)."""
    def kernel(a, b, c, n):
        return FA.decode_attention(a, b, c, n, softcap=softcap)

    def partial(a, b, c, n):
        return FA.decode_attention_lse(a, b, c, n, softcap=softcap)
    if LD.is_dtensor(q, k, v, lengths):
        return LD.attend(kernel, q, k, v, lengths, partial=partial)
    return kernel(q, k, v, lengths)


def _out_project(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul.  On DTensors the partial
    sums over sharded heads are added at once (the residual stream stays
    whole over ``model``)."""
    if LD.is_dtensor(out, wo):
        return LD.reduced(LD.contract(out, wo, 2, _out_project))
    B, S, H, hd = out.shape
    return (out.reshape(B * S, H * hd) @ wo.reshape(H * hd, -1)).view(
        B, S, -1)


def cross_kv(p: Params, enc_out: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder's keys and values for one cross-attention layer,
    (B, Se, Hkv, D) each: projections only, as the reference's (no
    bias, no norm, no RoPE)."""
    return _project(enc_out, p["wk"]), _project(enc_out, p["wv"])


def cross_attention(p: Params, x: torch.Tensor, cfg: ModelConfig,
                    k: torch.Tensor, v: torch.Tensor,
                    lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of the decoder's ``x`` (B, S, d) over an encoder's keys
    and values ``k``/``v`` (B, Se, Hkv, D), not causal: q gets ``bq`` and
    ``q_norm`` where the configuration has them and no RoPE.  A prefill
    runs K2 non-causal; a decode step (``lengths`` (B,) int32 = Se for
    every row, built once per step) runs K1 over the whole cross cache.
    Returns the output projection (B, S, d)."""
    q = _project(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
    cap = cfg.attn_logit_softcap
    if lengths is not None:
        out = _decode_attn(q[:, 0].contiguous(), k, v, lengths,
                           softcap=cap)[:, None]
    else:
        out = _prefill_attn(q, k, v, q_offset=0, window=cfg.sliding_window,
                            causal=False, softcap=cap)
    return _out_project(out, p["wo"])


# --------------------------------------------------------------------- #
# Attention without a cache: the training (and training encoder) form
# --------------------------------------------------------------------- #
def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, q_offset: Union[int, torch.Tensor],
                  window: Optional[int], chunk: int,
                  softcap: float = 0.0) -> torch.Tensor:
    """Scaled dot-product attention, chunked over the query axis (the
    reference's ``_sdpa_chunked``).

    q: (B, Sq, H, D);  k/v: (B, Skv, Hkv, D).  ``q_offset`` (an int or
    (B,)) is the absolute position of q[0] relative to k[0].  With a
    sliding ``window`` and Skv > window + chunk only the last ``window +
    chunk`` keys are sliced per chunk, keeping FLOPs O(Sq * window).
    With a ``softcap`` > 0 the logits become ``tanh(logits / softcap) *
    softcap`` before the mask.  Masked logits are -1e30; QK^T and PV
    accumulate in fp32 from the inputs' values (the reference's
    ``preferred_element_type``), the softmax weights rounded to v's dtype
    first."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    q = q * (1.0 / math.sqrt(D))
    q_off = torch.as_tensor(q_offset, device=q.device)
    if q_off.ndim == 0:
        q_off = q_off.expand(B)

    def attend(qc, kc, vc, qpos, kpos):
        # qc: (B, C, H, D); kc/vc: (B, Kc, Hkv, D); qpos: (B, C); kpos (Kc,)
        C = qc.shape[1]
        qg = qc.reshape(B, C, Hkv, rep, D)
        logits = torch.einsum("bqhrd,bkhd->bhrqk", qg.float(), kc.float())
        if softcap > 0.0:
            logits = torch.tanh(logits / softcap) * softcap
        kp = kpos[None, None, :]
        qp = qpos[:, :, None]
        mask = kp >= 0                              # padded window slots
        if causal:
            mask = mask & (kp <= qp)
        if window is not None:
            mask = mask & (kp > qp - window)
        logits = torch.where(mask[:, None, None], logits, -1e30)
        w = torch.softmax(logits, dim=-1)
        o = torch.einsum("bhrqk,bkhd->bqhrd", w.to(v.dtype).float(),
                         vc.float())
        return o.reshape(B, C, H, D).to(v.dtype)

    ar = torch.arange(max(Sq, Skv), device=q.device)
    if Sq <= chunk:
        return attend(q, k, v, q_off[:, None] + ar[None, :Sq], ar[:Skv])
    if Sq % chunk:
        raise ValueError(f"{Sq} queries do not split into chunks of {chunk}")
    outs = []
    for i in range(Sq // chunk):
        qc = q[:, i * chunk:(i + 1) * chunk]
        qpos = q_off[:, None] + i * chunk + ar[None, :chunk]
        if window is not None and Skv > window + chunk:
            span = window + chunk
            start = min(max(i * chunk + chunk - span, 0), Skv - span)
            outs.append(attend(qc, k[:, start:start + span],
                               v[:, start:start + span], qpos,
                               start + ar[:span]))
        else:
            outs.append(attend(qc, k, v, qpos, ar[:Skv]))
    return torch.cat(outs, dim=1)


def attention_train(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    cross_kv: Optional[Tuple[torch.Tensor,
                                             torch.Tensor]] = None,
                    causal: bool = True, q_chunk: int = 512
                    ) -> torch.Tensor:
    """The reference's ``attention`` without a cache: full
    self-attention over ``x`` (B, S, d) rotated by ``rope`` (causal for a
    decoder, not for an encoder), or with ``cross_kv`` (the encoder's
    K/V, (B, Se, Hkv, D)) cross-attention: q with ``bq`` / ``q_norm`` and
    no RoPE.  Within ``cfg.sliding_window`` either way.  Plain PyTorch
    (``_sdpa_chunked``), differentiable.  Returns the output projection
    (B, S, d)."""
    q = _project(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    if cross_kv is None:
        k = _project(x, p["wk"])
        v = _project(x, p["wv"])
        if "bk" in p:
            k = k + p["bk"]
            v = v + p["bv"]
    else:
        k, v = cross_kv
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
        if cross_kv is None:
            k = rms_norm(p["k_norm"], k, cfg.norm_eps)
    if cross_kv is None:
        q = apply_rope(q, rope)
        k = apply_rope(k, rope)

    def sdpa(q, k, v):
        return _sdpa_chunked(q, k, v, causal=causal, q_offset=0,
                             window=cfg.sliding_window, chunk=q_chunk,
                             softcap=cfg.attn_logit_softcap)
    # on DTensors each rank attends with its own query heads
    out = LD.attend(sdpa, q, k, v) if LD.is_dtensor(q, k, v) \
        else sdpa(q, k, v)
    return _out_project(out, p["wo"])


class DecodePos(NamedTuple):
    """Per-step decode indices, built once and shared by every layer."""
    rows: torch.Tensor          # (B,) int64: 0 .. B-1
    slot: torch.Tensor          # (B,) int64: the cache slot each row writes
    lengths: torch.Tensor       # (B,) int32: the valid KV length

    @classmethod
    def of(cls, pos: torch.Tensor,
           cap: Optional[int] = None) -> "DecodePos":
        """Indices for absolute positions ``pos`` (B,).  With ``cap`` (a
        ring buffer of ``cap`` slots) row b writes slot ``pos % cap`` and
        reads ``min(pos + 1, cap)`` slots; without, slot ``pos`` and
        ``pos + 1`` slots."""
        p = pos.long()
        if cap is None:
            slot, n = p, p + 1
        else:
            slot, n = p % cap, torch.clamp(p + 1, max=cap)
        return cls(torch.arange(p.shape[0], device=p.device), slot,
                   n.to(torch.int32))


def _dyn_update(cache: torch.Tensor, val: torch.Tensor,
                at: DecodePos) -> None:
    """cache (B, T, H, D)[b, slot[b]] <- val (B, 1, H, D)[b, 0], in
    place: one row write per request at its own slot.  A DTensor cache:
    each rank writes the rows and slots its shard holds."""
    if LD.is_dtensor(cache):
        def write(c, v, idx, t0):
            rel = idx[0] - t0
            ok = (rel >= 0) & (rel < c.shape[1])
            rel = rel.clamp(0, c.shape[1] - 1)
            rows = torch.arange(c.shape[0], device=c.device)
            c[rows, rel] = torch.where(ok[:, None, None], v[:, 0].to(c.dtype),
                                       c[rows, rel])
        LD.write_cache(cache, val, [at.slot], write)
        return
    cache[at.rows, at.slot] = val[:, 0].to(cache.dtype)


def _write_slots(cache: torch.Tensor, val: torch.Tensor, start: int) -> None:
    """cache (B, T, H, D)[:, start:start + S] <- val (B, S, H, D), in
    place (a DTensor cache: each rank its own slots)."""
    if not LD.is_dtensor(cache):
        cache[:, start:start + val.shape[1]] = val.to(cache.dtype)
        return

    def write(c, v, idx, t0):
        lo = max(start, t0)
        hi = min(start + v.shape[1], t0 + c.shape[1])
        if hi > lo:
            c[:, lo - t0:hi - t0] = v[:, lo - start:hi - start].to(c.dtype)
    LD.write_cache(cache, val, [], write)


def _fill(cache: torch.Tensor, val: torch.Tensor) -> None:
    """Write a prefill's K/V (B, S, H, D) into a cache of T slots, in
    place: slots [0, S) when S <= T; otherwise (a sliding-window ring
    buffer shorter than the prompt) the last T tokens, each at slot
    ``position % T``, as the JAX ``_fill`` does."""
    T, S = cache.shape[1], val.shape[1]
    if S <= T:
        _write_slots(cache, val, 0)
        return
    if LD.is_dtensor(cache):
        def write(c, v, idx, t0):
            # slot g holds the token t of [S - T, S) with t % T == g
            g = torch.arange(t0, t0 + c.shape[1], device=c.device)
            c[:] = v[:, S - T + (g - (S - T)) % T].to(c.dtype)
        LD.write_cache(cache, val, [], write)
        return
    slots = torch.arange(S - T, S, device=cache.device) % T
    cache[:, slots] = val[:, S - T:].to(cache.dtype)


def make_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device: torch.device,
                  layers: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Zero-initialized stacked KV cache (L, B, T, Hkv, D), L = ``layers``
    (default: every layer); a sliding window model allocates only the
    window (ring buffer): T = min(max_len, window)."""
    check_supported(cfg)
    T = max_len if cfg.sliding_window is None \
        else min(max_len, cfg.sliding_window)
    L = cfg.num_layers if layers is None else layers
    shape = (L, batch, T, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}


def make_kv_block_pool(cfg: ModelConfig, pool_blocks: int,
                       block_tokens: int, device: torch.device,
                       layers: Optional[int] = None
                       ) -> Dict[str, torch.Tensor]:
    """Zero-initialized paged KV pool (L, P, bt, Hkv, D): the per-slot
    batch axis becomes a flat block axis, so a session's KV lives in
    ``ceil(tokens / block_tokens)`` pool blocks named by its block
    table."""
    L = cfg.num_layers if layers is None else layers
    shape = (L, pool_blocks, block_tokens, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}


# --------------------------------------------------------------------- #
# MLP, embedding
# --------------------------------------------------------------------- #
def mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    g = LD.matmul(x, p["w_gate"])
    u = LD.matmul(x, p["w_up"])
    # jax.nn.gelu defaults to the tanh approximation
    act = F.gelu(g, approximate="tanh") if cfg.activation == "geglu" \
        else F.silu(g)
    # on DTensors the partial sums over a sharded d_ff are added at once
    return LD.reduced(LD.matmul(act * u, p["w_down"]))


# --------------------------------------------------------------------- #
# Mixture of Experts: top-k router + sort-based ragged dispatch
# --------------------------------------------------------------------- #
def route(p: Params, xt: torch.Tensor,
          cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing of tokens ``xt`` (T, d): fp32 router logits, the k
    largest per token, a softmax over their values.  Returns (gates
    (T, k) fp32, expert_ids (T, k) int64)."""
    logits = xt.float() @ p["router"]
    gate_vals, expert_ids = torch.topk(logits, cfg.experts_per_token, dim=-1)
    return torch.softmax(gate_vals, dim=-1), expert_ids


def moe(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Dropless MoE, as the JAX ``layers.moe``.  ``ragged``: tokens
    sorted by expert through three grouped matmuls (K3), exact active
    FLOPs.  ``dense_einsum``: every expert on every token, masked
    combine.

    Nothing here reads a device value on the host: the group sizes are
    counted with ``scatter_add_`` (``bincount`` on CUDA reads the
    input's max on the host) and K3 finds each tile's expert from them
    on the device, so a decode step stays free of host syncs.

    ``ep``: the capacity-based expert-parallel path (``_moe_ep``), under
    ``mesh_context(mesh)``; it launches no K3."""
    if cfg.moe_impl == "ep":
        return _moe_ep(p, x, cfg)
    return _moe(p, x, cfg, G.gmm)


def ragged_dot(x: torch.Tensor, w: torch.Tensor,
               group_sizes: torch.Tensor) -> torch.Tensor:
    """``jax.lax.ragged_dot`` in plain PyTorch, differentiable: rows
    (M, d) sorted by group, each group's rows times its ``w`` (E, d, f).
    Reads the group sizes on the host."""
    parts = torch.split(x, group_sizes.tolist())
    return torch.cat([xs @ w[e] for e, xs in enumerate(parts)])


def moe_train(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``moe`` for training: the expert matmuls are ``ragged_dot``, not
    K3, so autograd differentiates the whole layer (``ep`` is
    differentiable as it stands)."""
    if cfg.moe_impl == "ep":
        return _moe_ep(p, x, cfg)
    return _moe(p, x, cfg, ragged_dot)


def _moe(p: Params, x: torch.Tensor, cfg: ModelConfig,
         grouped: Callable) -> torch.Tensor:
    """The MoE layer with ``grouped(rows, w, group_sizes)`` as the
    ragged path's expert matmul."""
    B, S, d = x.shape
    T, k, E = B * S, cfg.experts_per_token, cfg.num_experts
    xt = x.reshape(T, d)
    gates, expert_ids = route(p, xt, cfg)                         # (T, k)

    if cfg.moe_impl == "dense_einsum":
        # combine weights (T, E): the gate of each chosen expert
        combine = torch.zeros(T, E, dtype=torch.float32,
                              device=x.device).scatter_add_(1, expert_ids,
                                                            gates)
        g = torch.einsum("td,edf->tef", xt, p["w_gate"])
        u = torch.einsum("td,edf->tef", xt, p["w_up"])
        h = F.silu(g) * u
        y = torch.einsum("tef,efd->ted", h, p["w_down"])
        out = torch.einsum("ted,te->td", y, combine.to(y.dtype))
        return out.reshape(B, S, d)

    # ragged (sort-based, dropless); the stable sort matches jnp.argsort
    flat_expert = expert_ids.reshape(-1)                          # (T*k,)
    sort_idx = torch.argsort(flat_expert, stable=True)
    xs = xt[sort_idx // k]                                        # (T*k, d)
    group_sizes = torch.zeros(E, dtype=torch.int32, device=x.device) \
        .scatter_add_(0, flat_expert,
                      torch.ones_like(flat_expert, dtype=torch.int32))
    g = grouped(xs, p["w_gate"], group_sizes)
    u = grouped(xs, p["w_up"], group_sizes)
    h = (F.silu(g.float()) * u.float()).to(xs.dtype)
    y = grouped(h, p["w_down"], group_sizes)                      # (T*k, d)
    # unsort (inverse permutation) and combine with the gates in fp32
    inv = torch.empty_like(sort_idx).scatter_(
        0, sort_idx, torch.arange(T * k, device=x.device))
    y = y[inv].reshape(T, k, d)
    out = (y.float() * gates[..., None]).sum(dim=1)
    return out.to(x.dtype).reshape(B, S, d)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum(..., preferred_element_type=float32)`` of a batched
    product: fp32 products and sums of 16-bit inputs (``out_dtype`` on
    the card; the CPU's bmm takes no ``out_dtype`` for them, and there
    the inputs are widened, which gives the same exact products)."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def ep_route(xt: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """``_moe_ep``'s routing of local tokens ``xt`` (T, d): ``route``
    (fp32 router logits, the sorted top-k, a softmax over them); each
    assignment's slot in its expert (earlier assignments to it,
    token-major); the capacity C = ceil(T*k/E * moe_capacity_factor)
    (Python numbers).  Returns (gates (T, k) fp32, experts (T*k,), slots
    clamped to C - 1 (T*k,), kept (T*k,) bool, C)."""
    T, k, E = xt.shape[0], cfg.experts_per_token, cfg.num_experts
    gates, eid = route({"router": router}, xt, cfg)             # (T, k)
    flat_e = eid.reshape(-1)                                    # (T*k,)
    onehot = torch.zeros(T * k, E, dtype=torch.int32, device=xt.device) \
        .scatter_(1, flat_e[:, None], 1)
    pos = (onehot.cumsum(0) - onehot).gather(1, flat_e[:, None])[:, 0]
    C = max(int(-(-T * k // E) * cfg.moe_capacity_factor), 1)
    keep = pos < C
    return gates, flat_e, pos.clamp(max=C - 1).long(), keep, C


class _ModelSum(torch.autograd.Function):
    """The sum over a process group of each rank's partial output, left
    on every rank.  Its gradient is the output's own on every rank (the
    transpose of a sum into a replicated value), not a second all-reduce,
    which would multiply it by the group's size."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        import torch.distributed as dist
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


def _moe_ep(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Capacity-based expert-parallel MoE under ``local_map``.

    Tokens stay inside their (pod, data) shard:

      local top-k -> slot position by masked cumsum -> scatter into a
      fixed (E, C, d) dispatch buffer -> batched expert GEMMs with the
      FFN width sharded over ``model`` -> gather+gate combine -> one
      all-reduce over ``model`` of the (T_loc, d) output.

    Capacity C = ceil(T_loc*k/E * capacity_factor); overflow tokens are
    dropped (GShard semantics); with factor >= E/k the path is exactly
    dropless.  ``local_map`` is ``shard_map``'s counterpart: it hands
    each rank the local blocks of DTensor arguments and wraps the output
    as a DTensor; plain tensors (the one-device mesh of serving) pass
    straight through.  On a mesh of more than one device x must be a
    DTensor.  The batched products are ``torch.bmm`` with fp32 results,
    as the reference's einsums (no K3), and nothing reads a device value
    on the host.

    Gradients: each rank's are partial sums where its work was a share
    of the whole, and ``local_map`` is told so: over the data axes that
    shard the tokens, the router's and the experts' weights'; over
    ``model``, x's and the router's (each rank's FFN shard and its part
    of the combine).  The output's all-reduce passes its gradient through
    unchanged (``_ModelSum``)."""
    from torch.distributed.tensor import DTensor, Partial
    from torch.distributed.tensor.experimental import local_map
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError("moe_impl='ep' requires mesh_context(mesh)")
    sizes = SH.mesh_shape(mesh)
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    model_axis = "model" if "model" in sizes else None
    if mesh.size() > 1 and not isinstance(x, DTensor):
        raise ValueError(f"moe_impl='ep' on a mesh of {mesh.size()} devices "
                         "takes x as a DTensor")

    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    # shard tokens over the largest data-axis prefix dividing the batch
    # (long-context decode has batch 1: tokens replicate across data)
    chosen = ()
    n_data = 1
    for a in data_axes:
        if B % (n_data * sizes[a]) == 0:
            chosen += (a,)
            n_data *= sizes[a]
    # a model axis of one device sums nothing
    group = mesh.get_group(model_axis) \
        if model_axis is not None and sizes[model_axis] > 1 else None

    def local_fn(xl, router, wg, wu, wd):
        Bl, Sl, _ = xl.shape
        Tl = Bl * Sl
        dev = xl.device
        xt = xl.reshape(Tl, d)
        gates, flat_e, pos_c, keep, C = ep_route(xt, router, cfg)
        token_idx = torch.arange(Tl * k, device=dev) // k
        xrep = xt[token_idx]                                    # (Tl*k, d)
        upd = torch.where(keep[:, None], xrep, torch.zeros_like(xrep))
        # dropped rows add zeros to slot C-1: accumulate, never overwrite
        disp = torch.zeros(E, C, d, dtype=xl.dtype, device=dev) \
            .index_put_((flat_e, pos_c), upd, accumulate=True)
        g = _bmm_f32(disp, wg)
        u = _bmm_f32(disp, wu)
        h = (F.silu(g) * u).to(xl.dtype)
        y = _bmm_f32(h, wd)                                     # f-partial
        rows = y[flat_e, pos_c] * keep[:, None]
        out = (rows.reshape(Tl, k, d) * gates[..., None]).sum(dim=1)
        if group is not None:
            out = _ModelSum.apply(out, group)
        return out.to(xl.dtype).reshape(Bl, Sl, d)

    def place(*entries):
        return SH.placements_for(SH.P(*entries), mesh)

    def summed(pl, axes):
        """``pl`` with the mesh dimensions of ``axes`` partial sums."""
        return tuple(Partial() if a in axes else q
                     for a, q in zip(sizes, pl))
    dspec = chosen if chosen else None
    x_pl = place(dspec, None, None)
    w_in = place(None, None, model_axis)     # (E, d, f/n): FFN width
    w_out = place(None, model_axis, None)    # (E, f/n, d)
    in_pl = (x_pl, place(None, None), w_in, w_in, w_out)
    model = (model_axis,) if model_axis is not None else ()
    grad_pl = (summed(x_pl, model), summed(in_pl[1], chosen + model),
               summed(w_in, chosen), summed(w_in, chosen),
               summed(w_out, chosen))
    # one output: its placements as a list (a tuple would be read as one
    # placement list per output)
    return local_map(
        local_fn, out_placements=list(x_pl), in_placements=in_pl,
        in_grad_placements=grad_pl, device_mesh=mesh,
        redistribute_inputs=True,
    )(x, p["router"], p["w_gate"], p["w_up"], p["w_down"])


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    if LD.is_dtensor(p["tok"], tokens):
        # a vocab-sharded table: each rank looks up its rows, one sum
        return LD.embedding(tokens, p["tok"])
    return p["tok"].index_select(0, tokens.reshape(-1)).view(
        *tokens.shape, -1)


def unembed(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Project to (padded) vocab logits; padding columns are -1e30, so
    argmax and softmax equal the unpadded computation."""
    w = p["unembed"] if "unembed" in p else p["tok"].t().to(x.dtype)
    logits = LD.matmul(x, w)
    if cfg.padded_vocab != cfg.vocab_size:
        if LD.is_dtensor(logits):
            # out of place: a vocab-sharded slice cannot be assigned
            pad = torch.arange(logits.shape[-1], device=logits.device) \
                >= cfg.vocab_size
            return logits.masked_fill(pad, -1e30)
        logits[..., cfg.vocab_size:] = -1e30
    return logits


# --------------------------------------------------------------------- #
# Parameter construction (same distributions as the JAX init_*)
# --------------------------------------------------------------------- #
def _normal(shape, std: float, g: torch.Generator, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    w = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
    return w.mul_(std).to(dtype)


def init_rmsnorm(d: int, dtype: torch.dtype,
                 device: torch.device) -> Params:
    return {"scale": torch.ones(d, dtype=dtype, device=device)}


def init_attention(cfg: ModelConfig, g: torch.Generator,
                   device: torch.device) -> Params:
    d, hd, H, Hkv = cfg.d_model, cfg.head_dim, cfg.padded_heads, \
        cfg.num_kv_heads
    dt = cfg.torch_dtype
    s = 1.0 / math.sqrt(d)
    wq = _normal((d, H, hd), s, g, dt, device)
    wk = _normal((d, Hkv, hd), s, g, dt, device)
    wv = _normal((d, Hkv, hd), s, g, dt, device)
    wo = _normal((H, hd, d), s, g, dt, device)
    if H != cfg.num_heads:
        # zero-padded heads (Megatron-style): the output is exactly the
        # unpadded model's because the padded wo rows are zero
        wq[:, cfg.num_heads:] = 0
        wo[cfg.num_heads:] = 0
    p = {"wq": wq, "wk": wk, "wv": wv, "wo": wo}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(H, hd, dtype=dt, device=device)
        p["bk"] = torch.zeros(Hkv, hd, dtype=dt, device=device)
        p["bv"] = torch.zeros(Hkv, hd, dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, dt, device)
        p["k_norm"] = init_rmsnorm(hd, dt, device)
    return p


def init_mlp(cfg: ModelConfig, g: torch.Generator,
             device: torch.device) -> Params:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.torch_dtype
    return {"w_gate": _normal((d, f), 1.0 / math.sqrt(d), g, dt, device),
            "w_up": _normal((d, f), 1.0 / math.sqrt(d), g, dt, device),
            "w_down": _normal((f, d), 1.0 / math.sqrt(f), g, dt, device)}


def init_moe(cfg: ModelConfig, g: torch.Generator,
             device: torch.device) -> Params:
    d, f, E, dt = cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.torch_dtype
    s = 1.0 / math.sqrt(d)
    return {"router": _normal((d, E), s, g, torch.float32, device),
            "w_gate": _normal((E, d, f), s, g, dt, device),
            "w_up": _normal((E, d, f), s, g, dt, device),
            "w_down": _normal((E, f, d), 1.0 / math.sqrt(f), g, dt, device)}


def init_embed(cfg: ModelConfig, g: torch.Generator,
               device: torch.device) -> Params:
    V, d, dt = cfg.padded_vocab, cfg.d_model, cfg.torch_dtype
    p = {"tok": _normal((V, d), 0.02, g, dt, device)}
    if not cfg.tie_embeddings:
        p["unembed"] = _normal((d, V), 0.02, g, dt, device)
    return p
