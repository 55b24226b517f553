"""Decoder assembly — the PyTorch counterpart of the dense, MoE, ssm
(rwkv6) and hybrid (zamba2) branches of ``repro/models/model.py``.

Entry points:
  init_params(cfg, generator=, device=)      parameters on the device
  init_cache(cfg, batch, max_len, device=)    zero cache
  prefill(params, cfg, tokens, cache, last_pos=)   fill cache, logits
  decode_step(params, cfg, tokens, cache, pos)     one token per row

Parameters are the JAX pytree with the stacked ``layers`` leaves split
into a Python list of per-layer dicts (the hybrid's one ``shared_attn``
block stays a single dict); the layer stack is a Python loop over it.
The cache keeps the JAX structure and layouts: ``{"kv": {"k", "v"}}``
with leaves (L, B, T, Hkv, D) (T = min(max_len, window) for a
sliding-window model, a ring buffer); ``{"rwkv": {"tm_x", "wkv",
"cm_x"}}`` for ssm; ``{"mamba": {"ssm", "conv"}, "kv": ...}`` for
hybrid, whose KV cache has one layer per shared-attention application.
``prefill``/``decode_step`` update the cache in place (returning the
same object).  A recurrent state integrates every token it is given, so
ssm/hybrid prompts in one ``prefill`` must have equal lengths (the
engine groups them so).  Entry points run on the card unless ``device``
names another; with no CUDA present the default raises.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils._pytree as pytree
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import DeviceLike, default_generator, resolve_device
from repro_torch.core import marker
from repro_torch.models import layers as L
from repro_torch.models import ssm as SM
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]


def init_params(cfg: ModelConfig, *,
                generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> Params:
    """Random parameters from the JAX package's distributions (normal
    weights scaled by 1/sqrt(fan_in), 0.02 embeddings, unit norms, zero
    biases, zero padded heads), drawn from ``generator`` (default: seed
    0 on the device).  The draws differ from ``jax.random``'s: parity
    tests convert JAX parameters with ``repro_torch.convert``.  On the
    ``meta`` device only shapes and dtypes are made (no memory, no
    draws): what the Tessera analyzer needs to trace a full-width step."""
    L.check_supported(cfg)
    dev = resolve_device(device)
    if dev.type == "meta":
        with FakeTensorMode():
            fake = init_params(cfg, generator=torch.Generator(),
                               device="cpu")
        return pytree.tree_map(lambda t: torch.empty(
            t.shape, dtype=t.dtype, device=dev), fake)
    g = generator if generator is not None else default_generator(dev)
    dt = cfg.torch_dtype
    p: Params = {"embed": L.init_embed(cfg, g, dev),
                 "final_norm": L.init_rmsnorm(cfg.d_model, dt, dev)}
    d = cfg.d_model
    if cfg.family == "ssm":             # rwkv6
        p["layers"] = [{"ln1": L.init_rmsnorm(d, dt, dev),
                        "tm": SM.init_rwkv6(cfg, g, dev),
                        "ln2": L.init_rmsnorm(d, dt, dev)}
                       for _ in range(cfg.num_layers)]
    elif cfg.family == "hybrid":        # zamba2
        p["layers"] = [{"ln": L.init_rmsnorm(d, dt, dev),
                        "mamba": SM.init_mamba2(cfg, g, dev)}
                       for _ in range(cfg.num_layers)]
        p["shared_attn"] = {"ln1": L.init_rmsnorm(d, dt, dev),
                            "attn": L.init_attention(cfg, g, dev),
                            "ln2": L.init_rmsnorm(d, dt, dev),
                            "mlp": L.init_mlp(cfg, g, dev)}
    else:
        ffn, init_ffn = ("moe", L.init_moe) if cfg.family == "moe" \
            else ("mlp", L.init_mlp)
        p["layers"] = [{"ln1": L.init_rmsnorm(d, dt, dev),
                        "attn": L.init_attention(cfg, g, dev),
                        "ln2": L.init_rmsnorm(d, dt, dev),
                        ffn: init_ffn(cfg, g, dev)}
                       for _ in range(cfg.num_layers)]
    return p


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: DeviceLike = None) -> Params:
    L.check_supported(cfg)
    dev = resolve_device(device)
    if cfg.family == "ssm":
        return {"rwkv": SM.make_rwkv6_state(cfg, batch, dev)}
    if cfg.family == "hybrid":
        n_attn = -(-cfg.num_layers // cfg.hybrid_attn_every)
        return {"mamba": SM.make_mamba2_state(cfg, batch, dev),
                "kv": L.make_kv_cache(cfg, batch, max_len, dev,
                                      layers=n_attn)}
    return {"kv": L.make_kv_cache(cfg, batch, max_len, dev)}


def _region(tagged: bool, block: str, layer: int):
    """The Tessera analyzer's region of ``block`` in ``layer`` when
    ``tagged`` (a trace), else nothing: the eager path runs unchanged."""
    if not tagged:
        return contextlib.nullcontext()
    return marker.region(block=block, layer=layer)


def _dense_block(lp: Params, x: torch.Tensor, cfg: ModelConfig, *,
                 rope, cache: Dict[str, torch.Tensor],
                 decode_pos: Optional[L.DecodePos] = None,
                 layer_idx: int = -1, tagged: bool = False) -> torch.Tensor:
    """A decoder block (attention + MLP or MoE); also the hybrid's shared
    attention block, whose parameters have the same structure.  With
    ``tagged``, its kernels carry the blocks "attention" and "moe" or
    "ffn" and the layer ``layer_idx``."""
    xin = L.rms_norm(lp["ln1"], x, cfg.norm_eps)
    with _region(tagged, "attention", layer_idx):
        h = L.attention(lp["attn"], xin, cfg, rope=rope, kv_cache=cache,
                        decode_pos=decode_pos)
    x = x + h
    y_in = L.rms_norm(lp["ln2"], x, cfg.norm_eps)
    if cfg.family == "moe":
        with _region(tagged, "moe", layer_idx):
            y = L.moe(lp["moe"], y_in, cfg)
    else:
        with _region(tagged, "ffn", layer_idx):
            y = L.mlp(lp["mlp"], y_in, cfg)
    return x + y


def _rwkv_block(lp: Params, x: torch.Tensor, cfg: ModelConfig,
                state: Dict[str, torch.Tensor], *, layer_idx: int = -1,
                tagged: bool = False) -> torch.Tensor:
    """Time mix and channel mix (whose parameters live in the same "tm"
    dict, as in JAX); ``state`` holds this layer's views, updated in
    place.  With ``tagged``: the blocks "ssm" and "ffn"."""
    xin = L.rms_norm(lp["ln1"], x, cfg.norm_eps)
    with _region(tagged, "ssm", layer_idx):
        h, _ = SM.rwkv6_time_mix(lp["tm"], xin, cfg,
                                 state={"tm_x": state["tm_x"],
                                        "wkv": state["wkv"]})
    x = x + h
    yin = L.rms_norm(lp["ln2"], x, cfg.norm_eps)
    with _region(tagged, "ffn", layer_idx):
        y, _ = SM.rwkv6_channel_mix(lp["tm"], yin, cfg, state=state["cm_x"])
    return x + y


def _mamba_block(lp: Params, x: torch.Tensor, cfg: ModelConfig,
                 state: Dict[str, torch.Tensor], *, layer_idx: int = -1,
                 tagged: bool = False) -> torch.Tensor:
    """With ``tagged``: the block "ssm"."""
    xin = L.rms_norm(lp["ln"], x, cfg.norm_eps)
    with _region(tagged, "ssm", layer_idx):
        h, _ = SM.mamba2(lp["mamba"], xin, cfg, state=state)
    return x + h


def _layer_state(tree: Dict[str, torch.Tensor], i: int
                 ) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s views of a stacked state dict."""
    return {k: v[i] for k, v in tree.items()}


def _run_layers(params: Params, cfg: ModelConfig, x: torch.Tensor,
                cache: Params, positions: torch.Tensor,
                decode_pos: Optional[L.DecodePos] = None,
                tagged: bool = False) -> torch.Tensor:
    """The layer stack; with ``tagged`` each block's kernels carry its
    block and layer (the hybrid's shared block: the index of its use)."""
    if cfg.family == "ssm":
        for i, lp in enumerate(params["layers"]):
            x = _rwkv_block(lp, x, cfg, _layer_state(cache["rwkv"], i),
                            layer_idx=i, tagged=tagged)
        return x
    rope = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    kv = cache["kv"]
    if cfg.family == "hybrid":
        # one shared attention + MLP block (its own KV layer per use)
        # before each group of hybrid_attn_every mamba layers
        k = cfg.hybrid_attn_every
        for gi in range(cfg.num_layers // k):
            x = _dense_block(params["shared_attn"], x, cfg, rope=rope,
                             cache=_layer_state(kv, gi),
                             decode_pos=decode_pos, layer_idx=gi,
                             tagged=tagged)
            for i in range(gi * k, (gi + 1) * k):
                x = _mamba_block(params["layers"][i], x, cfg,
                                 _layer_state(cache["mamba"], i),
                                 layer_idx=i, tagged=tagged)
        return x
    for i, lp in enumerate(params["layers"]):
        x = _dense_block(lp, x, cfg, rope=rope, cache=_layer_state(kv, i),
                         decode_pos=decode_pos, layer_idx=i, tagged=tagged)
    return x


def _embed(params: Params, cfg: ModelConfig,
           tokens: torch.Tensor) -> torch.Tensor:
    return L.embed(params["embed"], tokens).to(cfg.torch_dtype)


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Params, *, last_pos: Optional[torch.Tensor] = None,
            tagged: bool = False) -> Tuple[torch.Tensor, Params]:
    """Process prompts ``tokens`` (B, S) from a fresh cache: fill KV
    slots [0, S) of every attention layer and carry every recurrent
    state over the S tokens.  Returns the logits (B, V) at each row's
    ``last_pos`` (default: the final column) with the cache.  Attention
    families take right-padded rows; recurrent ones need equal-length
    rows, since a pad token would enter the state.  ``tagged`` marks each
    block's kernels for the Tessera analyzer (``core.marker``)."""
    B, S = tokens.shape
    if "kv" in cache:
        T = cache["kv"]["k"].shape[2]
        if S > T and cfg.sliding_window is None:
            raise ValueError(f"prefill of {S} tokens exceeds the cache's "
                             f"{T} slots")
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    x = _run_layers(params, cfg, _embed(params, cfg, tokens), cache,
                    positions, tagged=tagged)
    if last_pos is None:
        xl = x[:, -1:]
    else:
        rows = torch.arange(B, device=x.device)
        xl = x[rows, last_pos.long()][:, None]
    xl = L.rms_norm(params["final_norm"], xl, cfg.norm_eps)
    return L.unembed(params["embed"], xl, cfg)[:, 0], cache


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Params, pos: torch.Tensor, *, tagged: bool = False
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step.  tokens: (B, 1) int; pos: (B,) absolute positions
    (each row writes KV slot ``pos``, or ``pos % T`` in a sliding-window
    ring buffer of T slots, and advances its recurrent state by one
    token).  Returns (logits (B, V), cache).  ``tagged`` marks each
    block's kernels for the Tessera analyzer (``core.marker``)."""
    decode_pos = None
    if "kv" in cache:
        cap = cache["kv"]["k"].shape[2] if cfg.sliding_window is not None \
            else None
        decode_pos = L.DecodePos.of(pos, cap)
    x = _run_layers(params, cfg, _embed(params, cfg, tokens), cache,
                    pos[:, None], decode_pos, tagged=tagged)
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params["embed"], x, cfg)[:, 0], cache
