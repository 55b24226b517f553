"""The ``repro_torch`` operator namespace: each hand-written kernel is one
custom op, so that a trace (``torch.export``, fake tensors) records one
node per kernel call and the dispatcher, not Python, chooses by device.

Each op has three registrations:
  * ``CPU``: the plain PyTorch version (``ref.py``);
  * ``CompositeExplicitAutograd``: the kernel's wrapper (``kernel.py``),
    which every other device reaches, a CUDA tensor included; it launches
    the kernel or raises, and never falls back to the plain version;
  * a fake implementation, which gives the output's shape, dtype and
    strides without running anything.

Ops that replace a state in place declare it in their schema
(``Tensor(a!)``).

An op that writes nothing in place may also take DTensors: ``sharding``
lists the placements it takes on one mesh dimension (DTensor's
``register_sharding``), and DTensor moves any other input to one of
them.  The in-place ops (K4, K5) take none: a strategy would move their
state, a copy, and lose the write; their ``ops`` wrappers run each
rank's shards instead (``distributed.local.local_call``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

NAMESPACE = "repro_torch"
LIB = torch.library.Library(NAMESPACE, "DEF")


def define(schema: str, kernel_fn: Callable, plain_fn: Callable,
           fake_fn: Callable, sharding: Optional[Callable] = None):
    """Register the op of ``schema`` and return its default overload;
    with ``sharding``, its DTensor strategies."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, kernel_fn, "CompositeExplicitAutograd")
    LIB.impl(name, plain_fn, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake_fn, lib=LIB)
    op = getattr(getattr(torch.ops, NAMESPACE), name).default
    if sharding is not None:
        from torch.distributed.tensor.experimental import register_sharding
        register_sharding(op)(sharding)
    return op
