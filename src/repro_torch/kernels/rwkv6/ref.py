"""Plain PyTorch WKV recurrence — the semantics of the model's
``_wkv_scan`` (``repro/models/ssm.py``) and of the Pallas ``wkv``.

A Python loop over tokens: per token one (B, H, P, P) outer product,
the read-out and the decayed state update, all in fp32.  It runs on
whatever device its inputs are on; ``ops`` sends only CPU tensors here.
"""
from __future__ import annotations

import torch


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """r, k, v: (B, S, H, P); w: (B, S, H, P) per-channel decay in (0, 1);
    u: (H, P) bonus; state: (B, H, P, P) fp32 [key x value], replaced IN
    PLACE by the final state.

    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T);
    S_t = diag(w_t) S_{t-1} + k_t v_t^T.   Returns y (B, S, H, P) fp32."""
    s = state.float()
    uu = u.float()[None, :, :, None]
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt = r[:, t].float(), k[:, t].float(), v[:, t].float()
        kv = kt[..., :, None] * vt[..., None, :]            # (B, H, P, P)
        ys.append(torch.einsum("bhp,bhpq->bhq", rt, s + uu * kv))
        s = w[:, t].float()[..., :, None] * s + kv
    state.copy_(s)
    return torch.stack(ys, dim=1)
