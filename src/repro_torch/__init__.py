"""PyTorch/CUDA port of the ``repro`` package.

The JAX package ``repro`` is the reference; this package mirrors its
layout (``models/``, ``configs/``, ``kernels/``, ``serving/``,
``launch/``) and imports neither JAX nor anything of ``repro``.

Entry points run on the card unless the caller asks for the CPU:
``resolve_device(None)`` is ``cuda`` and raises when no CUDA device is
present — it never falls back to the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device``
    names another.  Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def default_generator(device: torch.device,
                      seed: int = 0) -> torch.Generator:
    """A seeded generator on ``device`` (never the global RNG)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


__all__ = ["resolve_device", "default_generator", "DeviceLike"]
