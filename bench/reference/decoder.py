"""The plain reference: a float32 decoder, dense or MoE, in plain PyTorch.

It imports nothing of the program and takes nothing the program made: the
weights are the benchmark's own tensors (``harness.weights``), read in the
layouts the benchmark drew them in, and everything is computed again from
them in float32 with TF32 off.  There is no cache and no batching: each
sequence runs its whole causal forward pass, layer by layer (all sequences
through one layer before the next, so that only one layer's weights are
ever widened to float32 at a time), and attention runs in blocks of query
rows.

The architecture, as the configuration files state it (Llama-style GQA
decoder; Mixtral-style top-k MoE):

* ``x = embed[tok]``; per layer ``x += attn(norm1(x))``,
  ``x += ffn(norm2(x))``; ``logits = norm_f(x) @ unembed``.
* RMSNorm: ``x * rsqrt(mean(x^2) + eps) * scale``.
* Attention: q, k, v projections, half-split RoPE at base ``rope_theta``
  on q and k, query head h reads KV head ``h // (H / Hkv)``, softmax of
  ``q.k / sqrt(D)`` over keys at positions ``<= p`` (and, with a sliding
  window W, ``> p - W``), then the output projection.
* Dense FFN: ``(silu(x Wg) * (x Wu)) Wd``.
* MoE FFN: router logits ``x R``, the ``k`` largest per token, a softmax
  over those ``k`` values as the gates, ``sum_j gate_j * ffn_{e_j}(x)``.

``quant="fp8"`` is the control of the correctness check: every linear
layer's weights (per output channel) and inputs (per token) are rounded to
float8 e4m3 before the product, which is what an fp8 path of the program
would compute; the router, norms, RoPE and softmax stay float32.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Sequence

import torch
import torch.nn.functional as F

FP8_MAX = 448.0          # largest finite float8 e4m3fn


@contextlib.contextmanager
def full_fp32() -> Iterator[None]:
    """float32 products in float32 (TF32 off) inside the block."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd
        torch.set_float32_matmul_precision(prec)


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the slice's largest magnitude maps to 448), back in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    s = amax / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class _Linear:
    """``x @ w`` (w: (K, N) float32), optionally in simulated fp8."""

    def __init__(self, quant: Optional[str]):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown quant {quant!r}")
        self.quant = quant

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        return _fp8(w, 0) if self.quant else w

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.quant:
            x = _fp8(x, -1)
        return x @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split RoPE of x (S, heads, D) at positions 0..S-1."""
    S, _, D = x.shape
    freqs = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                          device=x.device) / D))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: Optional[int], block: int = 512) -> torch.Tensor:
    """Causal GQA attention of one sequence: q (S, H, D), k/v (S, Hkv, D)
    -> (S, H, D), in blocks of ``block`` query rows."""
    S, H, D = q.shape
    rep = H // k.shape[1]
    kh = k.repeat_interleave(rep, dim=1).transpose(0, 1)      # (H, S, D)
    vh = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    kpos = torch.arange(S, device=q.device)
    for a in range(0, S, block):
        b = min(a + block, S)
        qb = q[a:b].transpose(0, 1) / math.sqrt(D)            # (H, n, D)
        logits = qb @ kh[:, :b].transpose(1, 2)               # (H, n, b)
        qpos = torch.arange(a, b, device=q.device)[:, None]
        mask = kpos[None, :b] <= qpos
        if window is not None:
            mask &= kpos[None, :b] > qpos - window
        logits = logits.masked_fill(~mask, float("-inf"))
        out[a:b] = (torch.softmax(logits, dim=-1) @ vh[:, :b]).transpose(0, 1)
    return out


def _attn_block(w: Dict[str, torch.Tensor], l: int, x: torch.Tensor,
                cfg: Dict, lin: _Linear) -> torch.Tensor:
    S = x.shape[0]
    H, Hkv, D = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    q = lin(x, lin.weight(w["wq"][l].reshape(x.shape[1], -1)))
    k = lin(x, lin.weight(w["wk"][l].reshape(x.shape[1], -1)))
    v = lin(x, lin.weight(w["wv"][l].reshape(x.shape[1], -1)))
    q = rope(q.view(S, H, D), cfg["rope_theta"])
    k = rope(k.view(S, Hkv, D), cfg["rope_theta"])
    o = attention(q, k, v.view(S, Hkv, D), cfg.get("sliding_window"))
    return lin(o.reshape(S, H * D), lin.weight(w["wo"][l].reshape(H * D, -1)))


def _ffn(x: torch.Tensor, wg, wu, wd, lin: _Linear) -> torch.Tensor:
    h = F.silu(lin(x, lin.weight(wg))) * lin(x, lin.weight(wu))
    return lin(h, lin.weight(wd))


def _moe_block(w: Dict[str, torch.Tensor], l: int, x: torch.Tensor,
               cfg: Dict, lin: _Linear) -> torch.Tensor:
    k = cfg["experts_per_token"]
    router = x @ w["router"][l].float()
    vals, ids = torch.topk(router, k, dim=-1)
    gates = torch.softmax(vals, dim=-1)
    out = torch.zeros_like(x)
    for e in range(cfg["num_experts"]):
        tok, slot = (ids == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        y = _ffn(x[tok], w["w_gate"][l, e], w["w_up"][l, e],
                 w["w_down"][l, e], lin)
        out.index_add_(0, tok, y * gates[tok, slot][:, None])
    return out


def forward(weights: Dict[str, torch.Tensor], cfg: Dict,
            seqs: Sequence[torch.Tensor], read: Sequence[torch.Tensor],
            quant: Optional[str] = None) -> List[torch.Tensor]:
    """Logits (n_i, V) float32 of sequence ``seqs[i]`` (token ids, (S_i,))
    at its positions ``read[i]`` (n_i,), each from the causal forward pass
    over the whole sequence.  ``cfg`` is the configuration file's dict;
    ``weights`` the benchmark's tensors (``harness.weights.layout``)."""
    lin = _Linear(quant)
    eps = cfg["norm_eps"]
    moe = cfg["family"] == "moe"
    with full_fp32(), torch.no_grad():
        xs = [weights["tok"][s.long()].float() for s in seqs]
        for l in range(cfg["num_layers"]):
            for i, x in enumerate(xs):
                x = x + _attn_block(weights, l, rms_norm(
                    x, weights["ln1"][l], eps), cfg, lin)
                h = rms_norm(x, weights["ln2"][l], eps)
                if moe:
                    x = x + _moe_block(weights, l, h, cfg, lin)
                else:
                    x = x + _ffn(h, weights["w_gate"][l], weights["w_up"][l],
                                 weights["w_down"][l], lin)
                xs[i] = x
        unembed = lin.weight(weights["unembed"])
        return [lin(rms_norm(x[r.long()], weights["final_norm"], eps), unembed)
                for x, r in zip(xs, read)]
