"""The work of K1-K5, in one place: the operations each kernel does and
the bytes it must move (each input read once, each output written once),
from its arithmetic.  ``FlopCounterMode`` counts each op by these
formulas (each ``ops`` module registers its own), so the dry run's
FLOPs and ``chip_smoke.py``'s roofline bounds are the same numbers.

``n_tok`` (K1) and ``pairs`` (K2) are the work the data asks for: the
cache positions read, and the (query, key) pairs that the mask leaves.
A trace sees shapes only, so its K1 formula reads the whole cache T of
every row.
"""
from __future__ import annotations

from typing import Optional, Tuple

Cost = Tuple[float, float]            # (operations, bytes)


def decode(B: int, H: int, Hkv: int, D: int, n_tok: int, es: int) -> Cost:
    """K1: QK^T and PV over ``n_tok`` cache positions in all (2 x 2 x
    n_tok x H x D); q and the output, the K/V read, the lengths."""
    return (4.0 * n_tok * H * D,
            float(es * (2 * B * H * D + 2 * n_tok * Hkv * D) + 4 * B))


def decode_lse(B: int, H: int, Hkv: int, D: int, n_tok: int,
               es: int) -> Cost:
    """K1's log-sum-exp form: K1's work; its output is float32, and it
    writes a float32 log-sum-exp per (row, query head)."""
    return (4.0 * n_tok * H * D,
            float(es * (B * H * D + 2 * n_tok * Hkv * D)
                  + 4 * B * H * D + 4 * B * H + 4 * B))


def prefill_pairs(Sq: int, Skv: int, q_offset: int = 0,
                  window: Optional[int] = None, causal: bool = True) -> int:
    """The (query, key) pairs K2's mask leaves, per row and head: query i
    at position q_offset + i sees keys j < Skv with j <= its position
    (causal) and j > its position - window (a window)."""
    n = 0
    for p in range(q_offset, q_offset + Sq):
        hi = min(p, Skv - 1) if causal else Skv - 1
        lo = max(0, p - window + 1) if window is not None else 0
        n += max(0, hi - lo + 1)
    return n


def prefill(B: int, Sq: int, Skv: int, H: int, Hkv: int, D: int,
            pairs: int, es: int) -> Cost:
    """K2: QK^T and PV over the unmasked pairs; q and the output, K/V."""
    return (4.0 * D * H * B * pairs,
            float(es * (2 * B * Sq * H * D + 2 * B * Skv * Hkv * D)))


def gmm(M: int, K: int, N: int, busy: int, es: int) -> Cost:
    """K3: rows x (K, N) per row; the weights of the ``busy`` experts that
    have rows, the rows in and out."""
    return 2.0 * M * K * N, float(busy * K * N * es + M * (K + N) * es)


def wkv(B: int, S: int, H: int, P: int, es: int) -> Cost:
    """K4: 4 P per channel and token (the read-out and the update); r, k,
    v (es each), w and y (fp32) per channel and token, the state in and
    out, u."""
    tok = B * S * H * P
    return (4.0 * tok * P,
            float(tok * (3 * es + 8) + 2 * B * H * P * P * 4 + H * P * 4))


def ssd(B: int, S: int, H: int, P: int, N: int, es: int) -> Cost:
    """K5: the recurrence's 4 N P per token and head (the chunked form
    does about twice as many); x and y (fp32), B and C (es), a_log, the
    state in and out."""
    tok = B * S * H
    return (4.0 * tok * N * P,
            float(tok * P * 8 + B * S * N * 2 * es + tok * 4
                  + 2 * B * H * N * P * 4))
