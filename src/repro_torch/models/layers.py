"""Dense decoder layers — the PyTorch counterpart of the dense parts of
``repro/models/layers.py``.

Plain functions over parameter dicts whose layouts are the JAX ones:
``wq`` (d, H, hd), ``wk``/``wv`` (d, Hkv, hd), ``wo`` (H, hd, d), MLP
weights (d, f) and (f, d).  The large projections are ``torch.matmul``;
attention goes through ``kernels.flash_attention.ops``, which runs the
hand-written kernels on the card and their plain versions on the CPU.

The KV cache of one layer is (B, T, Hkv, D), as in JAX.  Unlike JAX,
which returns a new cache, ``attention`` writes this step's K/V into
the cache tensors IN PLACE (one row write per request at its
position), so serving keeps one cache allocation for its lifetime.

Out of this slice: the sliding window and its ring buffer, M-RoPE,
logit softcap and non-dense families (``check_supported`` raises
``NotImplementedError``); chunked prefill at a cache offset (absent).
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the options this slice of the port does not serve."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            "(dense only)")
    for flag, what in ((cfg.sliding_window is not None, "sliding window"),
                       (cfg.mrope, "M-RoPE"),
                       (cfg.attn_logit_softcap > 0.0, "logit softcap")):
        if flag:
            raise NotImplementedError(f"{cfg.name}: {what} is not ported")


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
    B, S, d = x.shape
    return (x.reshape(B * S, d) @ w.reshape(d, -1)).view(
        B, S, w.shape[1], w.shape[2])


def attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              rope: Tuple[torch.Tensor, torch.Tensor],
              kv_cache: Dict[str, torch.Tensor],
              decode_pos: Optional[DecodePos] = None) -> torch.Tensor:
    """GQA attention over one layer's cache ``{"k", "v"}`` (B, T, Hkv, D);
    ``rope`` holds the tables of this call's positions.

    * ``decode_pos`` None: prefill fill — this prompt's K/V go to cache
      slots [0, S) and the queries attend causally over them (K2).
    * ``decode_pos`` given: decode (S == 1) — a ``DecodePos`` of the
      step; this token's K/V are written at each row's position and the
      query attends over the first ``position + 1`` cache slots (K1).
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

    if decode_pos is not None:
        _dyn_update(kv_cache["k"], k, decode_pos)
        _dyn_update(kv_cache["v"], v, decode_pos)
        out = FA.decode_attention(q[:, 0].contiguous(), kv_cache["k"],
                                  kv_cache["v"], decode_pos.lengths)[:, None]
    else:
        _fill(kv_cache["k"], k)
        _fill(kv_cache["v"], v)
        out = FA.prefill_attention(q, k.to(kv_cache["k"].dtype),
                                   v.to(kv_cache["v"].dtype), q_offset=0)
    H, hd = out.shape[2], out.shape[3]
    return (out.reshape(B * S, H * hd)
            @ p["wo"].reshape(H * hd, -1)).view(B, S, -1)


class DecodePos(NamedTuple):
    """Per-step decode indices, built once and shared by every layer."""
    rows: torch.Tensor          # (B,) int64: 0 .. B-1
    pos: torch.Tensor           # (B,) int64: the slot each row writes
    lengths: torch.Tensor       # (B,) int32: pos + 1, the valid KV length

    @classmethod
    def of(cls, pos: torch.Tensor) -> "DecodePos":
        p = pos.long()
        return cls(torch.arange(p.shape[0], device=p.device), p,
                   (p + 1).to(torch.int32))


def _dyn_update(cache: torch.Tensor, val: torch.Tensor,
                at: DecodePos) -> None:
    """cache (B, T, H, D)[b, pos[b]] <- val (B, 1, H, D)[b, 0], in place:
    one row write per request at its own position."""
    cache[at.rows, at.pos] = val[:, 0].to(cache.dtype)


def _fill(cache: torch.Tensor, val: torch.Tensor) -> None:
    """cache[:, 0:S] <- val (B, S, H, D), in place."""
    S = val.shape[1]
    if S > cache.shape[1]:
        raise ValueError(f"prefill of {S} tokens exceeds the cache's "
                         f"{cache.shape[1]} slots")
    cache[:, :S] = val.to(cache.dtype)


def make_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device: torch.device) -> Dict[str, torch.Tensor]:
    """Zero-initialized stacked KV cache (L, B, T, Hkv, D)."""
    check_supported(cfg)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}


# --------------------------------------------------------------------- #
# MLP, embedding
# --------------------------------------------------------------------- #
def mlp(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    # jax.nn.gelu defaults to the tanh approximation
    act = F.gelu(g, approximate="tanh") if cfg.activation == "geglu" \
        else F.silu(g)
    return (act * u) @ p["w_down"]


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"].index_select(0, tokens.reshape(-1)).view(
        *tokens.shape, -1)


def unembed(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Project to (padded) vocab logits; padding columns are -1e30, so
    argmax and softmax equal the unpadded computation."""
    if "unembed" in p:
        logits = x @ p["unembed"]
    else:
        logits = x @ p["tok"].t().to(x.dtype)
    if cfg.padded_vocab != cfg.vocab_size:
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


def init_embed(cfg: ModelConfig, g: torch.Generator,
               device: torch.device) -> Params:
    V, d, dt = cfg.padded_vocab, cfg.d_model, cfg.torch_dtype
    p = {"tok": _normal((V, d), 0.02, g, dt, device)}
    if not cfg.tie_embeddings:
        p["unembed"] = _normal((d, V), 0.02, g, dt, device)
    return p
