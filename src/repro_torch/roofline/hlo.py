"""Collective accounting for the roofline, from the dispatch trace.

The port of ``repro/roofline/hlo.py``.  The port has no HLO: the dry
run (``launch/dryrun.py``) traces a cell's step on DTensors under a
dispatch mode, and every functional collective that DTensor or the
model issues passes through it as one op on this rank's local tensors.
Each is recorded with its result bytes and its group size
(``record``), and costed by the reference's per-chip ring formulas:

  all-gather          result_bytes            (each chip receives ~full)
  all-reduce          2 x result_bytes x (n-1)/n
  reduce-scatter      result_bytes x n        (operand is consumed)
  all-to-all          result_bytes
  collective-permute  result_bytes

The numbers are PER-CHIP traffic; the roofline collective term is
per_chip_bytes / link_bw.  The ops that map onto them are
``_c10d_functional``'s ``all_gather_into_tensor``, ``all_reduce``,
``reduce_scatter_tensor`` and ``all_to_all_single`` (and their
coalesced forms), and ``c10d``'s in-place ``allreduce_``, which
``torch.distributed.nn.functional.all_reduce`` issues.  Nothing in the
port issues a collective-permute; its formula is kept for the
reference's five.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, Iterable, NamedTuple, Optional, Tuple

import torch

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter",
               "all-to-all", "collective-permute")

# dispatched op name -> (collective, the index of its group-size
# argument, or None where the group is named and its size is looked up)
_TORCH_OPS = {
    "_c10d_functional::all_gather_into_tensor": ("all-gather", 1),
    "_c10d_functional::all_gather_into_tensor_coalesced": ("all-gather", 1),
    "_c10d_functional::all_reduce": ("all-reduce", None),
    "_c10d_functional::all_reduce_": ("all-reduce", None),
    "_c10d_functional::all_reduce_coalesced": ("all-reduce", None),
    "_c10d_functional::reduce_scatter_tensor": ("reduce-scatter", 2),
    "_c10d_functional::reduce_scatter_tensor_coalesced":
        ("reduce-scatter", 2),
    "_c10d_functional::all_to_all_single": ("all-to-all", None),
    "c10d::allreduce_": ("all-reduce", None),
}


class Collective(NamedTuple):
    """One collective of a trace: its op, the bytes of its result on this
    rank, the size of its group, and where it came from."""
    op: str
    result_bytes: float
    group_size: int
    origin: str = ""


def traffic(op: str, result_bytes: float, n: int) -> float:
    """Per-chip bytes moved by one collective (the ring formulas)."""
    if op == "all-reduce":
        return 2.0 * result_bytes * (n - 1) / max(n, 1)
    if op == "reduce-scatter":
        return result_bytes * n
    return result_bytes


def _nbytes(x: Any) -> float:
    return float(sum(t.numel() * t.element_size()
                     for t in torch.utils._pytree.tree_leaves(x)
                     if isinstance(t, torch.Tensor)))


def _group_size(args: Tuple, kwargs: Dict, idx: Optional[int]) -> int:
    if idx is not None:
        return int(args[idx])
    for a in reversed(list(args) + list(kwargs.values())):
        if isinstance(a, str):              # a functional op's group name
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            return _resolve_process_group(a).size()
    raise ValueError("a collective without a group")


def record(func, args: Tuple, kwargs: Dict, out: Any,
           origin: str = "") -> Optional[Collective]:
    """The collective of one dispatched op, or None for any other op."""
    name = getattr(func, "name", lambda: "")()
    entry = _TORCH_OPS.get(name.split(".")[0])
    if entry is None:
        return None
    op, idx = entry
    if name.startswith("c10d::"):           # (tensors, process group, ...)
        import torch.distributed as dist
        return Collective(op, _nbytes(out[0]),
                          dist.ProcessGroup.unbox(args[1]).size(), origin)
    return Collective(op, _nbytes(out), _group_size(args, kwargs, idx),
                      origin)


def collective_bytes(records: Iterable[Collective]
                     ) -> Tuple[float, Dict[str, float], Dict[str, int]]:
    """(total per-chip traffic bytes, bytes-by-op, count-by-op)."""
    by_op: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    for c in records:
        if c.result_bytes == 0.0:
            continue
        by_op[c.op] += traffic(c.op, c.result_bytes, c.group_size)
        counts[c.op] += 1
    return sum(by_op.values()), dict(by_op), dict(counts)


def count_op(records: Iterable[Collective], opname: str) -> int:
    return sum(1 for c in records if c.op == opname)
