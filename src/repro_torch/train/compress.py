"""Gradient compression with error feedback — the port of
``repro/train/compress.py``.

Two schemes with error feedback (EF: the residual of each step's
compression is added back the next step, which keeps SGD convergent):

  * int8 quantization: per-tensor absmax scale, ~4x traffic reduction
    vs fp32 (2x vs bf16).
  * top-k sparsification: keep the k largest-magnitude entries
    (k = ratio * size), send values + indices.

On one device these are pure functions with the signature the
cross-node all-reduce would wrap; the EF invariant (compressed +
residual == input) is property-tested.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch
import torch.utils._pytree as pytree

from repro_torch.tree import leaves_as


# --------------------------------------------------------------------- #
def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def topk_sparsify(x: torch.Tensor, ratio: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = x.reshape(-1)
    k = max(1, int(flat.numel() * ratio))
    _, idx = torch.topk(torch.abs(flat), k)
    return flat[idx], idx


def topk_densify(values: torch.Tensor, idx: torch.Tensor,
                 shape) -> torch.Tensor:
    out = torch.zeros(int(torch.Size(shape).numel()), dtype=values.dtype,
                      device=values.device)
    return out.index_put_((idx,), values).reshape(shape)


# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    scheme: str = "int8"         # "int8" | "topk" | "none"
    topk_ratio: float = 0.05


def init_residual(grads: Any) -> Any:
    return pytree.tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32,
                              device=g.device), grads)


@torch.no_grad()
def compress_decompress(cfg: CompressionConfig, grads: Any,
                        residual: Any) -> Tuple[Any, Any]:
    """Apply EF compression leaf-wise.  Returns (decompressed grads that
    would survive the wire, new residual).  The wire format (int8 / value
    +index pairs) is what the cross-node all-reduce would carry."""
    if cfg.scheme == "none":
        return grads, residual

    def one(g, r):
        x = g.float() + r
        if cfg.scheme == "int8":
            q, s = quantize_int8(x)
            y = dequantize_int8(q, s)
        elif cfg.scheme == "topk":
            vals, idx = topk_sparsify(x, cfg.topk_ratio)
            y = topk_densify(vals, idx, x.shape)
        else:
            raise ValueError(cfg.scheme)
        return y.to(g.dtype), x - y

    flat_g, spec = pytree.tree_flatten(grads)
    flat_r = leaves_as(grads, residual)
    outs = [one(g, r) for g, r in zip(flat_g, flat_r)]
    return (pytree.tree_unflatten([o[0] for o in outs], spec),
            pytree.tree_unflatten([o[1] for o in outs], spec))


def wire_bytes(cfg: CompressionConfig, grads: Any) -> float:
    """Bytes the compressed gradients occupy on the interconnect."""
    leaves = pytree.tree_leaves(grads)
    if cfg.scheme == "int8":
        return sum(l.numel() * 1 + 4 for l in leaves)
    if cfg.scheme == "topk":
        return sum(int(l.numel() * cfg.topk_ratio) * 8 for l in leaves)
    return sum(l.numel() * l.element_size() for l in leaves)
