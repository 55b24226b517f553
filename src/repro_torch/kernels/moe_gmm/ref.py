"""Plain PyTorch grouped matmul — the semantics of ``jax.lax.ragged_dot``
at the model's call sites (``repro/models/layers.py``) and of the Pallas
``gmm`` after ``pad_groups``.

A loop over experts: each group's rows times that expert's weight,
``torch.matmul`` at fp32, cast back to x's dtype.  It reads the group
sizes on the host, so it synchronises with the device; ``ops`` sends
only CPU tensors here.
"""
from __future__ import annotations

import torch


def gmm(x: torch.Tensor, w: torch.Tensor,
        group_sizes: torch.Tensor) -> torch.Tensor:
    """x: (M, K) rows sorted by expert; w: (E, K, N); group_sizes: (E,)
    summing to M.  Returns (M, N) in x's dtype."""
    sizes = [int(n) for n in group_sizes.tolist()]
    if sum(sizes) != x.shape[0] or min(sizes, default=0) < 0:
        raise ValueError(f"gmm: group sizes {sizes} do not cover "
                         f"{x.shape[0]} rows")
    out = torch.empty((x.shape[0], w.shape[2]), dtype=x.dtype,
                      device=x.device)
    start = 0
    for e, n in enumerate(sizes):
        if n:
            rows = slice(start, start + n)
            out[rows] = (x[rows].float() @ w[e].float()).to(x.dtype)
        start += n
    return out
