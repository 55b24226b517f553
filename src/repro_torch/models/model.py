"""Model assembly — the PyTorch counterpart of the dense, MoE, ssm
(rwkv6), hybrid (zamba2), encdec (seamless) and vlm (qwen2-vl) branches
of ``repro/models/model.py``.

Entry points:
  init_params(cfg, generator=, device=)      parameters on the device
  init_cache(cfg, batch, max_len, device=, enc_len=)    zero cache
  forward_logits(params, cfg, tokens, patch_embeds=, positions3=,
                 enc_embeds=, remat=)        full-sequence logits (training)
  loss_fn(params, cfg, tokens, targets, **kw)           training loss
  prefill(params, cfg, tokens, cache, last_pos=, offset=, patch_embeds=,
          positions3=, enc_embeds=)          fill cache (or one chunk), logits
  iter_prefill_chunks / prefill_chunked      a prefill as fixed-size chunks
  decode_step(params, cfg, tokens, cache, pos, positions3=)
                                             one token per row
  export_kv / import_kv and their per-layer shards, pack_kv_blocks /
  gather_kv_blocks                           move one session's state

Parameters are the JAX pytree with the stacked ``layers`` (and an
encdec's ``encoder``) leaves split into a Python list of per-layer dicts
(the hybrid's one ``shared_attn`` block stays a single dict); the layer
stack is a Python loop over it.
The cache keeps the JAX structure and layouts: ``{"kv": {"k", "v"}}``
with leaves (L, B, T, Hkv, D) (T = min(max_len, window) for a
sliding-window model, a ring buffer); ``{"rwkv": {"tm_x", "wkv",
"cm_x"}}`` for ssm; ``{"mamba": {"ssm", "conv"}, "kv": ...}`` for
hybrid, whose KV cache has one layer per shared-attention application;
``{"kv": ..., "cross_k", "cross_v"}`` for encdec, the cross caches
top-level tensors (L, B, enc_len, Hkv, D) that a prefill fills from the
encoder's output.
``prefill``/``decode_step`` update the cache in place (returning the
same object).  A recurrent state integrates every token it is given, so
ssm/hybrid prompts in one ``prefill`` must have equal lengths (the
engine groups them so).  Entry points run on the card unless ``device``
names another; with no CUDA present the default raises.

The state movers write the cache in place (``copy_`` into the existing
tensors), so a cache object keeps its storage for its lifetime; every
exporter returns copies (a torch slice is a view, and the slot it came
from is written again by its next occupant).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.utils._pytree as pytree
import torch.utils.checkpoint
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import DeviceLike, default_generator, resolve_device
from repro_torch.core import marker
from repro_torch.distributed import local as LD
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
    elif cfg.family == "encdec":        # seamless backbone
        p["encoder"] = [{"ln1": L.init_rmsnorm(d, dt, dev),
                         "attn": L.init_attention(cfg, g, dev),
                         "ln2": L.init_rmsnorm(d, dt, dev),
                         "mlp": L.init_mlp(cfg, g, dev)}
                        for _ in range(cfg.encoder_layers)]
        p["layers"] = [{"ln1": L.init_rmsnorm(d, dt, dev),
                        "attn": L.init_attention(cfg, g, dev),
                        "ln_x": L.init_rmsnorm(d, dt, dev),
                        "xattn": L.init_attention(cfg, g, dev),
                        "ln2": L.init_rmsnorm(d, dt, dev),
                        "mlp": L.init_mlp(cfg, g, dev)}
                       for _ in range(cfg.num_layers)]
        p["enc_norm"] = L.init_rmsnorm(d, dt, dev)
    elif cfg.family == "hybrid":        # zamba2
        p["layers"] = [{"ln": L.init_rmsnorm(d, dt, dev),
                        "mamba": SM.init_mamba2(cfg, g, dev)}
                       for _ in range(cfg.num_layers)]
        p["shared_attn"] = {"ln1": L.init_rmsnorm(d, dt, dev),
                            "attn": L.init_attention(cfg, g, dev),
                            "ln2": L.init_rmsnorm(d, dt, dev),
                            "mlp": L.init_mlp(cfg, g, dev)}
    else:                               # dense, moe, vlm
        ffn, init_ffn = ("moe", L.init_moe) if cfg.family == "moe" \
            else ("mlp", L.init_mlp)
        p["layers"] = [{"ln1": L.init_rmsnorm(d, dt, dev),
                        "attn": L.init_attention(cfg, g, dev),
                        "ln2": L.init_rmsnorm(d, dt, dev),
                        ffn: init_ffn(cfg, g, dev)}
                       for _ in range(cfg.num_layers)]
    return p


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: DeviceLike = None,
               enc_len: Optional[int] = None) -> Params:
    """A zero cache of ``batch`` rows and ``max_len`` positions; an
    encdec model's cross caches hold ``enc_len`` (default ``max_len``)
    encoder positions, the length its prefill's encoder input must
    have."""
    L.check_supported(cfg)
    dev = resolve_device(device)
    if cfg.family == "ssm":
        return {"rwkv": SM.make_rwkv6_state(cfg, batch, dev)}
    if cfg.family == "hybrid":
        n_attn = -(-cfg.num_layers // cfg.hybrid_attn_every)
        return {"mamba": SM.make_mamba2_state(cfg, batch, dev),
                "kv": L.make_kv_cache(cfg, batch, max_len, dev,
                                      layers=n_attn)}
    cache = {"kv": L.make_kv_cache(cfg, batch, max_len, dev)}
    if cfg.family == "encdec":
        shape = (cfg.num_layers, batch, enc_len or max_len,
                 cfg.num_kv_heads, cfg.head_dim)
        for name in ("cross_k", "cross_v"):
            cache[name] = torch.zeros(shape, dtype=cfg.torch_dtype,
                                      device=dev)
    return cache


def _on_dtensors(fn: Callable) -> Callable:
    """An entry point that also runs with every parameter, cache and
    batch leaf a DTensor: inside it plain tensors count as replicated and
    the parameters' mesh is the ambient one (``distributed.local``)."""
    @functools.wraps(fn)
    def entry(params, *a, **kw):
        with LD.sharded(params["embed"]):
            return fn(params, *a, **kw)
    return entry


def _region(tagged: bool, block: str, layer: int):
    """The Tessera analyzer's region of ``block`` in ``layer`` when
    ``tagged`` (a trace), else nothing: the eager path runs unchanged."""
    if not tagged:
        return contextlib.nullcontext()
    return marker.region(block=block, layer=layer)


def _dense_block(lp: Params, x: torch.Tensor, cfg: ModelConfig, *,
                 rope, cache: Dict[str, torch.Tensor],
                 decode_pos: Optional[L.DecodePos] = None,
                 offset: Optional[int] = None,
                 layer_idx: int = -1, tagged: bool = False) -> torch.Tensor:
    """A decoder block (attention + MLP or MoE); also the hybrid's shared
    attention block, whose parameters have the same structure.  With
    ``tagged``, its kernels carry the blocks "attention" and "moe" or
    "ffn" and the layer ``layer_idx``."""
    xin = L.rms_norm(lp["ln1"], x, cfg.norm_eps)
    with _region(tagged, "attention", layer_idx):
        h = L.attention(lp["attn"], xin, cfg, rope=rope, kv_cache=cache,
                        decode_pos=decode_pos, offset=offset)
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


def _encdec_block(lp: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  rope, cache: Dict[str, torch.Tensor],
                  cross: Tuple[torch.Tensor, torch.Tensor],
                  decode_pos: Optional[L.DecodePos] = None,
                  cross_lengths: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """An encdec decoder block: causal self-attention over the KV cache,
    cross-attention over this layer's encoder K/V ``cross`` and the MLP.
    Like the reference's encdec bodies it carries no analyzer regions."""
    h = L.attention(lp["attn"], L.rms_norm(lp["ln1"], x, cfg.norm_eps), cfg,
                    rope=rope, kv_cache=cache, decode_pos=decode_pos)
    x = x + h
    h = L.cross_attention(lp["xattn"], L.rms_norm(lp["ln_x"], x,
                                                  cfg.norm_eps), cfg,
                          *cross, lengths=cross_lengths)
    x = x + h
    return x + L.mlp(lp["mlp"], L.rms_norm(lp["ln2"], x, cfg.norm_eps), cfg)


def _layer_state(tree: Dict[str, torch.Tensor], i: int
                 ) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s views of a stacked state dict."""
    return {k: v[i] for k, v in tree.items()}


def _run_layers(params: Params, cfg: ModelConfig, x: torch.Tensor,
                cache: Params, positions: torch.Tensor,
                decode_pos: Optional[L.DecodePos] = None,
                offset: Optional[int] = None,
                tagged: bool = False,
                positions3: Optional[torch.Tensor] = None,
                enc_out: Optional[torch.Tensor] = None,
                cross_lengths: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """The layer stack; with ``tagged`` each block's kernels carry its
    block and layer (the hybrid's shared block: the index of its use).
    ``offset``: a prefill chunk's first position (attention's chunk
    mode); recurrent states carry over through the cache by
    construction.  RoPE rotates by ``positions`` (B, S), or with M-RoPE
    by ``positions3`` (3, B, S) when given; the cache slots come from
    ``positions`` / ``decode_pos`` either way.  encdec: a prefill
    (``enc_out``, the encoder's output) first writes each layer's
    encoder K/V into the cross caches in place; a decode step reads them
    over ``cross_lengths``."""
    if cfg.family == "ssm":
        for i, lp in enumerate(params["layers"]):
            x = _rwkv_block(lp, x, cfg, _layer_state(cache["rwkv"], i),
                            layer_idx=i, tagged=tagged)
        return x
    if cfg.mrope and positions3 is not None:
        rope = L.mrope_tables(positions3, cfg.head_dim, cfg.rope_theta,
                              cfg.mrope_sections)
    else:
        rope = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    kv = cache["kv"]
    if cfg.family == "encdec":
        for i, lp in enumerate(params["layers"]):
            ck, cv = cache["cross_k"][i], cache["cross_v"][i]
            if enc_out is not None:
                k, v = L.cross_kv(lp["xattn"], enc_out)
                ck.copy_(k)
                cv.copy_(v)
            x = _encdec_block(lp, x, cfg, rope=rope,
                              cache=_layer_state(kv, i), cross=(ck, cv),
                              decode_pos=decode_pos,
                              cross_lengths=cross_lengths)
        return x
    if cfg.family == "hybrid":
        # one shared attention + MLP block (its own KV layer per use)
        # before each group of hybrid_attn_every mamba layers
        k = cfg.hybrid_attn_every
        for gi in range(cfg.num_layers // k):
            x = _dense_block(params["shared_attn"], x, cfg, rope=rope,
                             cache=_layer_state(kv, gi),
                             decode_pos=decode_pos, offset=offset,
                             layer_idx=gi,
                             tagged=tagged)
            for i in range(gi * k, (gi + 1) * k):
                x = _mamba_block(params["layers"][i], x, cfg,
                                 _layer_state(cache["mamba"], i),
                                 layer_idx=i, tagged=tagged)
        return x
    for i, lp in enumerate(params["layers"]):
        x = _dense_block(lp, x, cfg, rope=rope, cache=_layer_state(kv, i),
                         decode_pos=decode_pos, offset=offset, layer_idx=i,
                         tagged=tagged)
    return x


def _embed(params: Params, cfg: ModelConfig,
           tokens: torch.Tensor) -> torch.Tensor:
    return L.embed(params["embed"], tokens).to(cfg.torch_dtype)


def _embed_inputs(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  patch_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """Token embeddings; a vlm model's ``patch_embeds`` (B, npat, d)
    replace positions [0, npat) (the stubbed vision frontend's output)."""
    x = _embed(params, cfg, tokens)
    if cfg.family == "vlm" and patch_embeds is not None:
        npat = patch_embeds.shape[1]
        if npat > tokens.shape[1]:
            raise ValueError(f"{npat} patch embeddings exceed the prompt's "
                             f"{tokens.shape[1]} positions")
        if LD.is_dtensor(x):        # out of place: DTensor's autograd
            return torch.cat([patch_embeds.to(x.dtype), x[:, npat:]], dim=1)
        x[:, :npat] = patch_embeds.to(x.dtype)
    return x


def _encoder_forward(params: Params, cfg: ModelConfig,
                     enc_embeds: torch.Tensor) -> torch.Tensor:
    """The bidirectional encoder over precomputed frame embeddings (B, Se,
    d): RoPE at positions [0, Se), attention not causal (K2), no cache.
    Returns the normed output (B, Se, d)."""
    x = enc_embeds.to(cfg.torch_dtype)
    B, Se, _ = x.shape
    positions = torch.arange(Se, dtype=torch.int32,
                             device=x.device).expand(B, Se)
    rope = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    for lp in params["encoder"]:
        h = L.attention(lp["attn"], L.rms_norm(lp["ln1"], x, cfg.norm_eps),
                        cfg, rope=rope, kv_cache=None)
        x = x + h
        x = x + L.mlp(lp["mlp"], L.rms_norm(lp["ln2"], x, cfg.norm_eps),
                      cfg)
    return L.rms_norm(params["enc_norm"], x, cfg.norm_eps)


# --------------------------------------------------------------------- #
# Training forward: the reference's forward_logits / loss_fn in plain
# PyTorch, differentiated by autograd.  No cache, and no kernel op: the
# layers' training forms (``attention_train``, ``moe_train``, the ssm
# blocks' ``train=True`` scans) replace K1-K5, whose ops define no
# backward, as the reference's training forward replaces its Pallas
# kernels with ``_sdpa_chunked``, the jnp scans and ``ragged_dot``.
# --------------------------------------------------------------------- #
def _maybe_remat(fn: Callable, remat: bool) -> Callable:
    """``fn`` recomputed in the backward pass (``jax.checkpoint``) when
    ``remat``."""
    if not remat:
        return fn
    return lambda *a: torch.utils.checkpoint.checkpoint(
        fn, *a, use_reentrant=False)


def _train_block(lp: Params, x: torch.Tensor, cfg: ModelConfig, rope,
                 q_chunk: int) -> torch.Tensor:
    """A decoder block (attention + MLP or MoE), and the hybrid's shared
    block, without a cache."""
    x = x + L.attention_train(lp["attn"], L.rms_norm(lp["ln1"], x,
                                                     cfg.norm_eps), cfg,
                              rope=rope, q_chunk=q_chunk)
    y_in = L.rms_norm(lp["ln2"], x, cfg.norm_eps)
    if cfg.family == "moe":
        return x + L.moe_train(lp["moe"], y_in, cfg)
    return x + L.mlp(lp["mlp"], y_in, cfg)


def _encoder_train(params: Params, cfg: ModelConfig,
                   enc_embeds: torch.Tensor, remat: bool,
                   q_chunk: int) -> torch.Tensor:
    """The bidirectional encoder over frame embeddings (B, Se, d), as
    ``_encoder_forward`` but differentiable; returns the normed output."""
    x = enc_embeds.to(cfg.torch_dtype)
    B, Se, _ = x.shape
    positions = torch.arange(Se, device=x.device).expand(B, Se)
    rope = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)

    def body(x, lp):
        x = x + L.attention_train(lp["attn"], L.rms_norm(
            lp["ln1"], x, cfg.norm_eps), cfg, rope=rope, causal=False,
            q_chunk=q_chunk)
        return x + L.mlp(lp["mlp"], L.rms_norm(lp["ln2"], x, cfg.norm_eps),
                         cfg)
    body = _maybe_remat(body, remat)
    for lp in params["encoder"]:
        x = body(x, lp)
    return L.rms_norm(params["enc_norm"], x, cfg.norm_eps)


@_on_dtensors
def forward_logits(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   *, patch_embeds: Optional[torch.Tensor] = None,
                   positions3: Optional[torch.Tensor] = None,
                   enc_embeds: Optional[torch.Tensor] = None,
                   scan_layers: bool = True, remat: bool = False,
                   q_chunk: int = 512) -> torch.Tensor:
    """Full-sequence logits (B, S, V) of ``tokens`` (B, S), teacher
    forced: the training forward.  vlm: ``patch_embeds`` take positions
    [0, npat) and ``positions3`` (3, B, S) are the M-RoPE ids; encdec:
    ``enc_embeds`` (B, Se, d) go through the encoder.  ``remat``
    recomputes each layer (each hybrid super-block, each encoder layer)
    in the backward pass.  ``scan_layers`` is accepted and has no effect
    (the layers are a list).  ``q_chunk`` is attention's query chunk
    (the reference's layers keep their default, 512; the result does not
    depend on it)."""
    del scan_layers
    L.check_supported(cfg)
    B, S = tokens.shape
    x = _embed_inputs(params, cfg, tokens, patch_embeds)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    if cfg.mrope and positions3 is not None:
        rope = L.mrope_tables(positions3, cfg.head_dim, cfg.rope_theta,
                              cfg.mrope_sections)
    else:
        rope = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)

    if cfg.family in ("dense", "moe", "vlm"):
        def body(x, lp):
            return _train_block(lp, x, cfg, rope, q_chunk)
        groups = params["layers"]
    elif cfg.family == "ssm":
        def body(x, lp):
            h, _ = SM.rwkv6_time_mix(lp["tm"], L.rms_norm(
                lp["ln1"], x, cfg.norm_eps), cfg, train=True)
            x = x + h
            y, _ = SM.rwkv6_channel_mix(lp["tm"], L.rms_norm(
                lp["ln2"], x, cfg.norm_eps), cfg)
            return x + y
        groups = params["layers"]
    elif cfg.family == "hybrid":
        # super-block i: the shared attention block, then mamba layers
        # [i k, (i + 1) k)
        k = cfg.hybrid_attn_every

        def body(x, group):
            x = _train_block(params["shared_attn"], x, cfg, rope, q_chunk)
            for lp in group:
                h, _ = SM.mamba2(lp["mamba"], L.rms_norm(
                    lp["ln"], x, cfg.norm_eps), cfg, train=True)
                x = x + h
            return x
        groups = [params["layers"][i:i + k]
                  for i in range(0, cfg.num_layers, k)]
    elif cfg.family == "encdec":
        if enc_embeds is None:
            raise ValueError(f"{cfg.name}: encdec requires enc_embeds")
        enc_out = _encoder_train(params, cfg, enc_embeds, remat, q_chunk)

        def body(x, lp):
            x = x + L.attention_train(lp["attn"], L.rms_norm(
                lp["ln1"], x, cfg.norm_eps), cfg, rope=rope,
                q_chunk=q_chunk)
            x = x + L.attention_train(
                lp["xattn"], L.rms_norm(lp["ln_x"], x, cfg.norm_eps), cfg,
                cross_kv=L.cross_kv(lp["xattn"], enc_out), causal=False,
                q_chunk=q_chunk)
            return x + L.mlp(lp["mlp"], L.rms_norm(lp["ln2"], x,
                                                   cfg.norm_eps), cfg)
        groups = params["layers"]
    else:
        raise ValueError(cfg.family)

    body = _maybe_remat(body, remat)
    for group in groups:
        x = body(x, group)
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params["embed"], x, cfg)


@_on_dtensors
def loss_fn(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            targets: torch.Tensor, **kw) -> torch.Tensor:
    """Mean next-token cross entropy: logsumexp minus the gold logit, in
    fp32.  ``kw`` go to :func:`forward_logits`."""
    logits = forward_logits(params, cfg, tokens, **kw).float()
    if LD.is_dtensor(logits):
        # the same sums over a vocab-sharded row: a max, a sum of
        # exponentials and the gold logit, each a per-shard partial
        m = logits.detach().amax(dim=-1, keepdim=True)
        logz = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
        hit = torch.arange(logits.shape[-1], device=logits.device) \
            == targets.long()[..., None]
        gold = torch.where(hit, logits, 0.0).sum(dim=-1)
        return torch.mean(logz - gold)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


@_on_dtensors
def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Params, *, last_pos: Optional[torch.Tensor] = None,
            offset: Optional[int] = None,
            patch_embeds: Optional[torch.Tensor] = None,
            positions3: Optional[torch.Tensor] = None,
            enc_embeds: Optional[torch.Tensor] = None,
            tagged: bool = False) -> Tuple[torch.Tensor, Params]:
    """Process prompts ``tokens`` (B, S) from a fresh cache: fill KV
    slots [0, S) of every attention layer and carry every recurrent
    state over the S tokens.  Returns the logits (B, V) at each row's
    ``last_pos`` (default: the final column) with the cache.  Attention
    families take right-padded rows; recurrent ones need equal-length
    rows, since a pad token would enter the state.  ``tagged`` marks each
    block's kernels for the Tessera analyzer (``core.marker``).

    ``offset`` (a Python int) switches to chunk mode: ``tokens`` are the
    prompt slice at positions [offset, offset + S) and the cache holds
    the state of the preceding chunks; ``last_pos`` is chunk-relative.
    Ring-buffer (sliding-window) caches are not chunkable, nor are the
    encdec and vlm families (the reference's chunked prefill serves the
    decoder-only families without M-RoPE).

    vlm: ``patch_embeds`` (B, npat, d) take positions [0, npat) and
    ``positions3`` (3, B, S) are the M-RoPE ids (without them RoPE is
    1-D over the positions, as in the reference).  encdec:
    ``enc_embeds`` (B, enc_len, d) go through the encoder, whose output
    each decoder layer projects into the cross caches."""
    B, S = tokens.shape
    if offset is not None and cfg.family in ("encdec", "vlm"):
        raise ValueError(f"{cfg.name}: chunked prefill serves the "
                         "decoder-only families without M-RoPE")
    off = 0 if offset is None else int(offset)
    if offset is not None and cfg.sliding_window is not None:
        raise ValueError("chunked prefill is undefined for ring-buffer SWA "
                         "caches")
    if "kv" in cache:
        T = cache["kv"]["k"].shape[2]
        if off + S > T and cfg.sliding_window is None:
            raise ValueError(f"prefill of tokens [{off}, {off + S}) exceeds "
                             f"the cache's {T} slots")
    enc_out = None
    if cfg.family == "encdec":
        enc_len = cache["cross_k"].shape[2]
        if enc_embeds is None or enc_embeds.shape[1] != enc_len:
            raise ValueError(f"{cfg.name}: prefill needs enc_embeds of the "
                             f"cross caches' {enc_len} positions")
        enc_out = _encoder_forward(params, cfg, enc_embeds)
    positions = torch.arange(off, off + S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    x = _run_layers(params, cfg, _embed_inputs(params, cfg, tokens,
                                               patch_embeds),
                    cache, positions, offset=offset, tagged=tagged,
                    positions3=positions3, enc_out=enc_out)
    if last_pos is None:
        xl = x[:, -1:]
    else:
        rows = torch.arange(B, device=x.device)
        xl = x[rows, last_pos.long()][:, None]
    xl = L.rms_norm(params["final_norm"], xl, cfg.norm_eps)
    return L.unembed(params["embed"], xl, cfg)[:, 0], cache


@_on_dtensors
def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Params, pos: torch.Tensor, *,
                positions3: Optional[torch.Tensor] = None,
                tagged: bool = False) -> Tuple[torch.Tensor, Params]:
    """One decode step.  tokens: (B, 1) int; pos: (B,) absolute positions
    (each row writes KV slot ``pos``, or ``pos % T`` in a sliding-window
    ring buffer of T slots, and advances its recurrent state by one
    token).  vlm: ``positions3`` (3, B, 1) are this token's M-RoPE ids,
    which differ from ``pos`` once an image has gone by: the angle comes
    from them, the cache slot from ``pos``.  encdec: cross-attention over
    the whole cross caches.  Returns (logits (B, V), cache).  ``tagged``
    marks each block's kernels for the Tessera analyzer
    (``core.marker``)."""
    decode_pos = cross_lengths = None
    if "kv" in cache:
        cap = cache["kv"]["k"].shape[2] if cfg.sliding_window is not None \
            else None
        decode_pos = L.DecodePos.of(pos, cap)
    if cfg.family == "encdec":
        ck = cache["cross_k"]
        cross_lengths = torch.full((ck.shape[1],), ck.shape[2],
                                   dtype=torch.int32, device=ck.device)
    x = _run_layers(params, cfg, _embed(params, cfg, tokens), cache,
                    pos[:, None], decode_pos, tagged=tagged,
                    positions3=positions3, cross_lengths=cross_lengths)
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(params["embed"], x, cfg)[:, 0], cache


# --------------------------------------------------------------------- #
# Chunked prefill
# --------------------------------------------------------------------- #
def iter_prefill_chunks(params: Params, cfg: ModelConfig,
                        tokens: torch.Tensor, cache: Params, *,
                        chunk_size: int,
                        last_pos: Optional[torch.Tensor] = None,
                        prefill_call: Optional[Callable] = None
                        ) -> Iterator[Tuple[int, int, torch.Tensor, Params]]:
    """Drive ``prefill(offset=)`` over ``chunk_size`` slices of
    ``tokens`` (B, S), yielding ``(t0, t1, logits, cache)`` after each:
    ``logits`` is each row's last-position selection over the chunks so
    far, so the final yield carries :func:`prefill`'s result.  The engine
    steps its decode slots between yields and the streamed handoff ships
    each chunk's (layer, chunk) K/V at a yield.  ``prefill_call(cache,
    tokens_chunk, offset, rel_last) -> (logits, cache)`` replaces the
    plain chunk call.  Nothing here reads the device on the host."""
    B, S = tokens.shape
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    if cfg.sliding_window is not None:
        raise ValueError("chunked prefill is undefined for ring-buffer SWA "
                         "caches")
    if prefill_call is None:
        def prefill_call(c, t, off, lp):
            return prefill(params, cfg, t, c, offset=off, last_pos=lp)
    last = torch.full((B,), S - 1, dtype=torch.int32, device=tokens.device) \
        if last_pos is None else last_pos.to(torch.int32)
    logits = None
    for t0 in range(0, S, chunk_size):
        t1 = min(t0 + chunk_size, S)
        rel = torch.clamp(last - t0, 0, t1 - t0 - 1)
        lg, cache = prefill_call(cache, tokens[:, t0:t1], t0, rel)
        # keep each row's logits from the chunk that holds its last
        # position (a row whose prompt ended earlier ignores later ones)
        sel = (last >= t0) & (last < t1)
        logits = lg if logits is None else torch.where(sel[:, None], lg,
                                                       logits)
        yield t0, t1, logits, cache


def prefill_chunked(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                    cache: Params, *, chunk_size: int,
                    last_pos: Optional[torch.Tensor] = None,
                    prefill_call: Optional[Callable] = None
                    ) -> Tuple[torch.Tensor, Params]:
    """A whole-prompt prefill as fixed-size chunks: the same logits and
    cache as :func:`prefill` (exact for the recurrent families, causal
    masking for attention).  A ring-buffer cache, or a prompt of one
    chunk, takes one whole prefill."""
    if cfg.sliding_window is not None or chunk_size >= tokens.shape[1]:
        return prefill(params, cfg, tokens, cache, last_pos=last_pos)
    logits = None
    for _, _, logits, cache in iter_prefill_chunks(
            params, cfg, tokens, cache, chunk_size=chunk_size,
            last_pos=last_pos, prefill_call=prefill_call):
        pass
    return logits, cache


# --------------------------------------------------------------------- #
# Per-request state movers (handoff, park/activate, migration).  A cache
# is {component: {leaf: (L, B, ...)} or (L, B, ...)} (an encdec model's
# cross caches are top-level tensors); attention KV leaves are (L, B, T,
# Hkv, D).  Exporters return copies; importers write in place.  Only the
# self-attention KV is ever trimmed to a length: the cross caches, like
# recurrent state, move whole.
# --------------------------------------------------------------------- #
def _each(fn: Callable, part: Any) -> Any:
    """``fn`` on each tensor of a cache component (a dict of leaves, or
    one tensor)."""
    if isinstance(part, dict):
        return {name: fn(a) for name, a in part.items()}
    return fn(part)


def _pairs(full: Any, val: Any) -> Iterator[Tuple[torch.Tensor,
                                                  torch.Tensor]]:
    """(cache tensor, exported tensor) of each leaf of a component."""
    if isinstance(val, dict):
        for name, v in val.items():
            yield full[name], v
    else:
        yield full, val


def export_kv(cfg: ModelConfig, cache: Params, slot: int,
              length: Optional[int] = None) -> Params:
    """Row ``slot`` of a batched cache as a batch-1 state of the same
    structure, copied.  Attention KV is trimmed to its first ``length``
    tokens (what a handoff ships); a ring buffer (sliding window),
    recurrent state and cross caches ship whole."""
    trim = length is not None and cfg.sliding_window is None
    out: Params = {}
    for key, part in cache.items():
        cut = key == "kv" and trim
        out[key] = _each(lambda a: (a[:, slot:slot + 1, :length] if cut
                                    else a[:, slot:slot + 1]).clone(), part)
    return out


def import_kv(cfg: ModelConfig, cache: Params, slot: int,
              state: Params) -> Params:
    """Write an exported batch-1 state into row ``slot`` of ``cache`` in
    place (the inverse of :func:`export_kv`; attention KV fills the first
    T slots of the row).  Returns ``cache``."""
    for key, part in state.items():
        for full, val in _pairs(cache[key], part):
            if key == "kv":
                full[:, slot:slot + 1, :val.shape[2]].copy_(val)
            else:
                full[:, slot:slot + 1].copy_(val)
    return cache


def state_leaves(tree: Any) -> Iterator[torch.Tensor]:
    """The tensors of a nested dict in sorted key order (the order in
    which a JAX pytree flattens a dict)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from state_leaves(tree[key])
    else:
        yield tree


def kv_state_bytes(state: Params) -> int:
    """Wire size of an exported state (or of one shard)."""
    return sum(t.numel() * t.element_size() for t in state_leaves(state))


def cache_layer_counts(cache: Params) -> Dict[str, int]:
    """Leading (layer) dimension of each cache component (a hybrid's
    shared-attention KV has fewer layers than its mamba state)."""
    return {key: next(state_leaves(part)).shape[0]
            for key, part in cache.items()}


def export_kv_shard(cfg: ModelConfig, cache: Params, slot: int, key: str,
                    layer: int, t0: Optional[int] = None,
                    t1: Optional[int] = None) -> Params:
    """One layer of one row's component ``key``, copied; for attention
    KV without a window, only the tokens [t0, t1) when ``t0`` is given
    (a ring buffer and recurrent state ship the whole layer)."""
    window = key == "kv" and t0 is not None and cfg.sliding_window is None

    def shard(a):
        sub = a[layer:layer + 1, slot:slot + 1]
        return (sub[:, :, t0:t1] if window else sub).clone()
    return _each(shard, cache[key])


def import_kv_window(cfg: ModelConfig, cache: Params, slot: int,
                     layer0: int, shards, t0: int = 0) -> Params:
    """Install attention-KV shards of the layers ``layer0, layer0 + 1,
    ...``, all over the token window starting at ``t0``, with one copy
    per leaf.  In place; returns ``cache``."""
    for name in ("k", "v"):
        vals = torch.cat([s[name] for s in shards], dim=0)
        n, T = vals.shape[0], vals.shape[2]
        cache["kv"][name][layer0:layer0 + n, slot:slot + 1,
                          t0:t0 + T].copy_(vals)
    return cache


def import_kv_shard(cfg: ModelConfig, cache: Params, slot: int, key: str,
                    layer: int, shard: Params, t0: int = 0) -> Params:
    """Install one exported layer shard into row ``slot``, in place (the
    inverse of :func:`export_kv_shard`).  Returns ``cache``."""
    for full, val in _pairs(cache[key], shard):
        if key == "kv" and cfg.sliding_window is None:
            T = val.shape[2]
            full[layer:layer + 1, slot:slot + 1, t0:t0 + T].copy_(val)
        else:
            full[layer:layer + 1, slot:slot + 1].copy_(val)
    return cache


# --------------------------------------------------------------------- #
# Paged KV blocks over a shared (layer, block) pool: one block id spans
# every layer.  pack -> gather is exact (same dtype, no arithmetic).
# --------------------------------------------------------------------- #
def kv_block_bytes(cfg: ModelConfig, block_tokens: int,
                   layers: Optional[int] = None) -> int:
    """Bytes one pool block holds across all layers (K and V)."""
    n = cfg.num_layers if layers is None else layers
    itemsize = torch.empty((), dtype=cfg.torch_dtype).element_size()
    return 2 * n * block_tokens * cfg.num_kv_heads * cfg.head_dim * itemsize


def pack_kv_blocks(pool: Params, state: Params,
                   block_ids: List[int]) -> Params:
    """Copy a batch-1 attention-KV state (L, 1, T, Hkv, D) into pool
    blocks ``block_ids``, in place; T is zero-padded to the blocks'
    capacity.  Returns ``pool``."""
    ids = torch.tensor(block_ids, dtype=torch.long, device=pool["k"].device)
    nb, bt = len(block_ids), pool["k"].shape[2]
    for c in ("k", "v"):
        val = state[c][:, 0]                               # (L, T, Hkv, D)
        n, T = val.shape[0], val.shape[1]
        blocks = torch.zeros((n, nb * bt) + tuple(val.shape[2:]),
                             dtype=pool[c].dtype, device=pool[c].device)
        blocks[:, :T] = val[:, :nb * bt]
        pool[c][:, ids] = blocks.view(n, nb, bt, *val.shape[2:])
    return pool


def gather_kv_blocks(pool: Params, block_ids: List[int],
                     length: int) -> Params:
    """The inverse of :func:`pack_kv_blocks`: blocks ``block_ids`` as a
    batch-1 state (L, 1, length, Hkv, D), a new tensor per leaf."""
    ids = torch.tensor(block_ids, dtype=torch.long, device=pool["k"].device)
    out = {}
    for c in ("k", "v"):
        blocks = pool[c][:, ids]                           # (L, nb, bt, ...)
        n, nb, bt = blocks.shape[:3]
        out[c] = blocks.reshape(n, nb * bt, *blocks.shape[3:])[:, :length] \
            .unsqueeze(1)
    return out
