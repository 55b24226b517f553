"""The SSD chunked scan as a custom op, ``repro_torch::ssd`` (K5), which
replaces its state ``h`` in place (``Tensor(a!)``): a CPU tensor takes
the plain PyTorch version (``ref``), any other tensor the hand-written
kernel (``kernel``), which raises on what it does not take.  There is no
fallback from the kernel to the plain version."""
from __future__ import annotations

import torch
from torch.distributed.tensor import Shard
from torch.utils.flop_counter import register_flop_formula

from repro_torch.distributed import local as LD
from repro_torch.kernels import cost, library
from repro_torch.kernels.mamba2_ssd import kernel, ref


# the dispatcher leaves out an argument equal to its schema default
def _kernel(xh, B_, C_, a_log, h, chunk=128):
    return kernel.ssd(xh, B_, C_, a_log, h, chunk=chunk)


def _plain(xh, B_, C_, a_log, h, chunk=128):
    # a ragged tail leaves the plain version's output a slice of the
    # padded chunks; the op's output is contiguous, as the kernel's is
    return ref.ssd(xh, B_, C_, a_log, h, chunk=chunk).contiguous()


def _fake(xh, B_, C_, a_log, h, chunk=128):
    return xh.new_empty(xh.shape, dtype=torch.float32)


SSD = library.define(
    "ssd(Tensor xh, Tensor B, Tensor C, Tensor a_log, Tensor(a!) h, "
    "int chunk=128) -> Tensor", _kernel, _plain, _fake)


@register_flop_formula(torch.ops.repro_torch.ssd)
def _flops(xh, B_, C_, a_log, h, chunk=128, *, out_shape=None,
           **kw) -> float:
    return cost.ssd(*xh, B_[2], 4)[0]


def ssd(xh: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor,
        a_log: torch.Tensor, h: torch.Tensor, *,
        chunk: int = 128) -> torch.Tensor:
    """xh: (B, S, H, P) fp32; B_/C_: (B, S, N); a_log: (B, S, H) fp32;
    h: (B, H, N, P) fp32, replaced in place by the final state.
    -> y (B, S, H, P) fp32.

    On DTensors each rank runs the op on its shards, every input moved to
    the state's batch and head placements (DTensor's own strategies
    would move the state, a copy, and lose the write)."""
    if LD.is_dtensor(xh, B_, C_, a_log, h):
        return _sharded(xh, B_, C_, a_log, h, chunk)
    return SSD(xh, B_, C_, a_log, h, chunk)


def _sharded(xh, B_, C_, a_log, h, chunk):
    mesh = LD.mesh_of(h, xh, B_, C_, a_log)
    hpl = LD.placements_of(h, mesh)
    if any(isinstance(p, Shard) and p.dim > 1 for p in hpl):
        raise ValueError(f"ssd: a state sharded as {hpl}")
    seq = LD.mapped(hpl, {0: 0, 1: 2})
    rows = LD.mapped(hpl, {0: 0})
    return LD.local_call(
        lambda *a: SSD(*a, chunk), mesh,
        [(xh, seq), (B_, rows), (C_, rows), (a_log, seq), (h, hpl)],
        [(seq, xh.shape)])
