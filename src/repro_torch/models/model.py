"""Decoder assembly — the PyTorch counterpart of the dense and MoE
branch of ``repro/models/model.py``.

Entry points:
  init_params(cfg, generator=, device=)      parameters on the device
  init_cache(cfg, batch, max_len, device=)    zero KV cache
  prefill(params, cfg, tokens, cache, last_pos=)   fill cache, logits
  decode_step(params, cfg, tokens, cache, pos)     one token per row

Parameters are the JAX pytree with the stacked ``layers`` leaves split
into a Python list of per-layer dicts; the layer stack is a Python loop
over it.  The cache keeps the JAX structure ``{"kv": {"k", "v"}}`` with
leaves (L, B, T, Hkv, D) (T = min(max_len, window) for a sliding-window
model, a ring buffer), and ``prefill``/``decode_step`` update it in
place (returning the same object).  Entry points run on the card unless
``device`` names another; with no CUDA present the default raises.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import DeviceLike, default_generator, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]


def init_params(cfg: ModelConfig, *,
                generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Params:
    """Random parameters from the JAX package's distributions (normal
    weights scaled by 1/sqrt(fan_in), 0.02 embeddings, unit norms, zero
    biases, zero padded heads), drawn from ``generator`` (default: seed
    0 on the device).  The draws differ from ``jax.random``'s: parity
    tests convert JAX parameters with ``repro_torch.convert``."""
    L.check_supported(cfg)
    dev = resolve_device(device)
    g = generator if generator is not None else default_generator(dev)
    dt = cfg.torch_dtype
    p: Params = {"embed": L.init_embed(cfg, g, dev),
                 "final_norm": L.init_rmsnorm(cfg.d_model, dt, dev)}
    ffn, init_ffn = ("moe", L.init_moe) if cfg.family == "moe" \
        else ("mlp", L.init_mlp)
    p["layers"] = [{"ln1": L.init_rmsnorm(cfg.d_model, dt, dev),
                    "attn": L.init_attention(cfg, g, dev),
                    "ln2": L.init_rmsnorm(cfg.d_model, dt, dev),
                    ffn: init_ffn(cfg, g, dev)}
                   for _ in range(cfg.num_layers)]
    return p


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: DeviceLike = None) -> Params:
    return {"kv": L.make_kv_cache(cfg, batch, max_len,
                                  resolve_device(device))}


def _dense_block(lp: Params, x: torch.Tensor, cfg: ModelConfig, *,
                 rope, cache: Dict[str, torch.Tensor],
                 decode_pos: Optional[L.DecodePos] = None) -> torch.Tensor:
    h = L.attention(lp["attn"], L.rms_norm(lp["ln1"], x, cfg.norm_eps), cfg,
                    rope=rope, kv_cache=cache, decode_pos=decode_pos)
    x = x + h
    y_in = L.rms_norm(lp["ln2"], x, cfg.norm_eps)
    if cfg.family == "moe":
        y = L.moe(lp["moe"], y_in, cfg)
    else:
        y = L.mlp(lp["mlp"], y_in, cfg)
    return x + y


def _run_layers(params: Params, cfg: ModelConfig, x: torch.Tensor,
                cache: Params, positions: torch.Tensor,
                decode_pos: Optional[L.DecodePos] = None) -> torch.Tensor:
    rope = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    kv = cache["kv"]
    for i, lp in enumerate(params["layers"]):
        x = _dense_block(lp, x, cfg, rope=rope,
                         cache={"k": kv["k"][i], "v": kv["v"][i]},
                         decode_pos=decode_pos)
    return x


def _embed(params: Params, cfg: ModelConfig,
           tokens: torch.Tensor) -> torch.Tensor:
    return L.embed(params["embed"], tokens).to(cfg.torch_dtype)


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Params, *, last_pos: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Params]:
    """Process right-padded prompts ``tokens`` (B, S), fill cache slots
    [0, S) of every layer, and return the logits (B, V) at each row's
    ``last_pos`` (default: the final column) with the cache."""
    B, S = tokens.shape
    T = cache["kv"]["k"].shape[2]
    if S > T and cfg.sliding_window is None:
        raise ValueError(f"prefill of {S} tokens exceeds the cache's "
                         f"{T} slots")
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    x = _run_layers(params, cfg, _embed(params, cfg, tokens), cache,
                    positions)
    if last_pos is None:
        xl = x[:, -1:]
    else:
        rows = torch.arange(B, device=x.device)
        xl = x[rows, last_pos.long()][:, None]
    xl = L.rms_norm(params["final_norm"], xl, cfg.norm_eps)
    return L.unembed(params["embed"], xl, cfg)[:, 0], cache


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Params, pos: torch.Tensor
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step.  tokens: (B, 1) int; pos: (B,) absolute positions
    (each row writes cache slot ``pos``, or ``pos % T`` in a
    sliding-window ring buffer of T slots).  Returns (logits (B, V),
    cache)."""
    cap = cache["kv"]["k"].shape[2] if cfg.sliding_window is not None \
        else None
    x = _run_layers(params, cfg, _embed(params, cfg, tokens), cache,
                    pos[:, None], L.DecodePos.of(pos, cap))
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params["embed"], x, cfg)[:, 0], cache
