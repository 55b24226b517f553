"""Region markers: phase/block/layer tags on the kernels of a region.

The paper's analyzer knows each kernel's phase/block from the CUDA launch
site.  Here a region is a ``torch.fx.traceback.annotate`` scope: every
node that ``torch.export`` traces inside it carries the region's tags in
``node.meta["custom"]`` (the analyzer reads them with ``tags_of``).  A
marker adds no op to the graph and no work at run time; an inner region
inherits the outer one's tags it does not set, and the outer tags come
back when it closes.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterator, Tuple

import torch.fx.traceback as fx_traceback

_PREFIX = "tessera."


def _annotation(phase: str, block: str, layer: int) -> Dict[str, Any]:
    """The tags a region sets: only those given (an empty phase or block
    and a negative layer inherit the enclosing region's)."""
    given = {"phase": phase, "block": block,
             "layer": layer if layer >= 0 else None}
    return {_PREFIX + k: v for k, v in given.items() if v not in ("", None)}


@contextlib.contextmanager
def region(*, phase: str = "", block: str = "",
           layer: int = -1) -> Iterator[None]:
    """``with region(block="attention", layer=3): ...`` tags every kernel
    traced inside the block."""
    with fx_traceback.annotate(_annotation(phase, block, layer)):
        yield


def tag(x, *, phase: str = "", block: str = "", layer: int = -1
        ) -> Tuple[Any, Callable[[Any], Any]]:
    """Functional form: opens a region and returns (``x``, closer); the
    closer ends the region and returns its argument."""
    scope = region(phase=phase, block=block, layer=layer)
    scope.__enter__()

    def close(z):
        scope.__exit__(None, None, None)
        return z

    return x, close


def wrap(fn: Callable, *, phase: str = "", block: str = "",
         layer: int = -1) -> Callable:
    """Wrap ``fn`` so the kernels it traces carry the given tags."""
    def wrapped(*args, **kw):
        with region(phase=phase, block=block, layer=layer):
            return fn(*args, **kw)
    return wrapped


def tags_of(meta: Dict[str, Any]) -> Tuple[str, str, int]:
    """(phase, block, layer) of a traced node's ``meta`` ("", "", -1 where
    no region set them)."""
    custom = meta.get("custom") or {}
    phase = custom.get(_PREFIX + "phase", "")
    block = custom.get(_PREFIX + "block", "")
    layer = custom.get(_PREFIX + "layer", -1)
    return phase, block, layer
