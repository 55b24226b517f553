"""Carry JAX parameter and cache pytrees into the port's structures.

Input is the JAX pytree with every leaf converted to numpy (for example
``jax.tree_util.tree_map(np.asarray, params)``): nested dicts of
arrays.  JAX bf16 arrays reach numpy as ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` rejects, so they cross as their uint16 bit
patterns and are viewed back as ``torch.bfloat16`` — an exact copy.
This module imports neither JAX nor ``ml_dtypes``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device


def array_to_torch(a: np.ndarray, device: DeviceLike = None) -> torch.Tensor:
    a = np.array(a, order="C")          # a writable copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(resolve_device(device))


def tree_to_torch(tree: Any, device: DeviceLike = None) -> Any:
    """Nested dicts of arrays -> the same of tensors."""
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    return array_to_torch(np.asarray(tree), device)


def _unstack(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return tree[i]


# the stacked layer groups of a JAX parameter tree (an encdec model has
# both)
STACKED = ("layers", "encoder")


def params_from_jax(params: Dict[str, Any],
                    device: DeviceLike = None) -> Dict[str, Any]:
    """JAX model parameters (stacked ``layers`` and ``encoder`` leaves
    with a leading layer axis, e.g. MoE experts (L, E, d, f)) -> the
    port's parameters (a list of per-layer dicts for each).  Dtypes are
    kept: the fp32 MoE router stays fp32 in a bf16 model."""
    out = {k: tree_to_torch(v, device) for k, v in params.items()
           if k not in STACKED}
    for k in STACKED:
        if k not in params:
            continue
        first = params[k]
        while isinstance(first, dict):
            first = next(iter(first.values()))
        out[k] = [tree_to_torch(_unstack(params[k], i), device)
                  for i in range(np.asarray(first).shape[0])]
    return out


def cache_from_jax(cache: Dict[str, Any],
                   device: DeviceLike = None) -> Dict[str, Any]:
    """JAX cache pytree (``{"kv": {"k", "v"}}`` (L, B, T, Hkv, D), with
    top-level ``cross_k`` / ``cross_v`` for encdec) -> the port's, same
    structure and layout."""
    return tree_to_torch(cache, device)
