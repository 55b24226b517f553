"""AdamW with mixed precision — the port of ``repro/train/optim.py``.

Moments are fp32; parameters may be bf16, with an fp32 master copy in
the optimizer state as the source of truth.  The arithmetic is the
reference's, in its order: the global-norm clip scale ``min(1, clip /
(gnorm + 1e-9))``, bias correction ``1 - b ** step`` with ``step`` an
fp32 tensor, weight decay on every leaf (norms and embeddings
included), and the new parameters cast back to each leaf's own dtype
(the fp32 MoE router stays fp32).

Trees are the port's parameter trees: nested dicts whose ``layers``
(and an encdec model's ``encoder``) are lists of per-layer dicts.

Unlike the reference, which returns new arrays, ``apply`` updates the
state's moments and master weights and the parameters IN PLACE (and
returns them): a full-width model's state then exists once on the
card.  It runs over groups of leaves with ``torch._foreach_*`` ops, so
its temporaries stay within ``GROUP_ELEMENTS`` elements.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, List, NamedTuple, Tuple, Union

import torch
import torch.utils._pytree as pytree

from repro_torch.tree import leaves_as

# the elements one group of leaves may hold: each fp32 temporary of
# ``apply`` is at most this large (1 GiB)
GROUP_ELEMENTS = 2 ** 28


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    master_fp32: bool = True


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    mu: Any
    nu: Any
    master: Any          # fp32 master weights (None when disabled)


def schedule(cfg: AdamWConfig,
             step: Union[torch.Tensor, float]) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio (fp32)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio +
                            (1 - cfg.min_lr_ratio) * cos)


def init(cfg: AdamWConfig, params: Any) -> AdamWState:
    """Zero moments and (with ``master_fp32``) an fp32 copy of every
    parameter, on the parameters' devices."""
    leaves = pytree.tree_leaves(params)
    zeros = pytree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32,
                              device=p.device), params)
    master = pytree.tree_map(
        lambda p: p.detach().to(torch.float32, copy=True), params) \
        if cfg.master_fp32 else None
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
        mu=zeros, nu=pytree.tree_map(torch.clone, zeros), master=master)


def global_norm(tree: Any) -> torch.Tensor:
    leaves = pytree.tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in leaves))


def _groups(leaves: List[torch.Tensor]) -> Iterator[slice]:
    """Consecutive runs of leaves of at most GROUP_ELEMENTS elements (a
    larger leaf is a run of its own)."""
    start, n = 0, 0
    for i, leaf in enumerate(leaves):
        if n and n + leaf.numel() > GROUP_ELEMENTS:
            yield slice(start, i)
            start, n = i, 0
        n += leaf.numel()
    if start < len(leaves):
        yield slice(start, len(leaves))


@torch.no_grad()
def apply(cfg: AdamWConfig, grads: Any, state: AdamWState,
          params: Any) -> Tuple[Any, AdamWState]:
    """One AdamW update, in place.  Returns (params, new_state): the
    same parameter tree and moment trees, updated, and a new step."""
    step = state.step + 1
    stepf = step.float()
    lr = schedule(cfg, stepf)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) \
        if cfg.grad_clip > 0 else 1.0
    b1c = 1 - torch.pow(cfg.b1, stepf)
    b2c = 1 - torch.pow(cfg.b2, stepf)

    flat_g = pytree.tree_leaves(grads)
    flat_p = leaves_as(grads, params)
    flat_m = leaves_as(grads, state.mu)
    flat_v = leaves_as(grads, state.nu)
    flat_src = leaves_as(grads, state.master) if cfg.master_fp32 \
        else flat_p
    for sl in _groups(flat_g):
        g = torch._foreach_mul([t.float() for t in flat_g[sl]], scale)
        m, v = flat_m[sl], flat_v[sl]
        torch._foreach_mul_(m, cfg.b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - cfg.b1))
        torch._foreach_mul_(v, cfg.b2)
        torch._foreach_add_(v, torch._foreach_mul(
            torch._foreach_mul(g, g), 1 - cfg.b2))
        del g
        mhat = torch._foreach_div(m, b1c)
        vhat = torch._foreach_div(v, b2c)
        # p32 is the master leaf itself, or the parameter as fp32 (the
        # parameter itself when it is fp32)
        p32 = [t.float() for t in flat_src[sl]]
        upd = torch._foreach_div(
            mhat, torch._foreach_add(torch._foreach_sqrt(vhat), cfg.eps))
        del mhat, vhat
        torch._foreach_add_(upd, torch._foreach_mul(p32, cfg.weight_decay))
        torch._foreach_sub_(p32, torch._foreach_mul(upd, lr))
        del upd
        for p, new in zip(flat_p[sl], p32):
            if p is not new:
                p.copy_(new)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu,
                              master=state.master)
