"""The yardstick's counts: model FLOPs of a step, kernel bounds of a launch,
and the H100's peaks.

Model FLOPs: 2 x the weights a token multiplies by (attention's four
projections, the dense FFN or the ``experts_per_token`` experts it is
routed to, the router, the unembedding; the embedding is a lookup), plus
attention's 4 x (keys it attends to) x H x D in each layer.

Kernel bounds come from ``vendor.cost`` (the program's formulas, frozen):
the larger of operations / peak FLOP/s and bytes / peak bytes/s, from the
launch's actual arguments (batch, padded lengths, slots) and, where the
work depends on the data, the data (K1's cache lengths of every row, idle
rows included, since the kernel reads them).
"""
from __future__ import annotations

from typing import Dict, Optional

from vendor import cost

# One H100 SXM (NVIDIA's data sheet, dense bf16, HBM3), at 700 W.
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
ES = 2                          # bytes of a bf16 element


def weights_per_token(cfg: Dict) -> float:
    d, H, Hkv, D, f = (cfg["d_model"], cfg["num_heads"],
                       cfg["num_kv_heads"], cfg["head_dim"], cfg["d_ff"])
    attn = d * D * (2 * H + 2 * Hkv)
    ffn = 3 * d * f
    if cfg["family"] == "moe":
        ffn = ffn * cfg["experts_per_token"] + d * cfg["num_experts"]
    return cfg["num_layers"] * (attn + ffn) + d * cfg["vocab_size"]


def model_flops(cfg: Dict, tokens: int, attended: int) -> float:
    """Model FLOPs of ``tokens`` tokens that attend to ``attended``
    (query, key) pairs in all, per layer."""
    H, D = cfg["num_heads"], cfg["head_dim"]
    return 2.0 * weights_per_token(cfg) * tokens \
        + 4.0 * attended * H * D * cfg["num_layers"]


def bound_s(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def k1_bound(cfg: Dict, rows: int, n_tok: int) -> float:
    """One K1 launch: ``rows`` rows reading ``n_tok`` cache positions."""
    return bound_s(*cost.decode(rows, cfg["num_heads"], cfg["num_kv_heads"],
                                cfg["head_dim"], n_tok, ES))


def k2_bound(cfg: Dict, rows: int, S: int) -> float:
    """One K2 launch of an admission: ``rows`` x ``S`` causal."""
    window: Optional[int] = cfg.get("sliding_window")
    pairs = cost.prefill_pairs(S, S, 0, window)
    return bound_s(*cost.prefill(rows, S, S, cfg["num_heads"],
                                 cfg["num_kv_heads"], cfg["head_dim"],
                                 pairs, ES))


def k3_bound(cfg: Dict, tokens: int) -> float:
    """The three K3 launches of one MoE layer over ``tokens`` tokens (each
    routed to ``experts_per_token`` experts; every expert is taken to hold
    rows)."""
    M = tokens * cfg["experts_per_token"]
    d, f, E = cfg["d_model"], cfg["d_ff"], cfg["num_experts"]
    busy = min(E, M)
    return 2 * bound_s(*cost.gmm(M, d, f, busy, ES)) \
        + bound_s(*cost.gmm(M, f, d, busy, ES))
