"""The SSD chunked scan as a custom op, ``repro_torch::ssd`` (K5), which
replaces its state ``h`` in place (``Tensor(a!)``): a CPU tensor takes
the plain PyTorch version (``ref``), any other tensor the hand-written
kernel (``kernel``), which raises on what it does not take.  There is no
fallback from the kernel to the plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels import library
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


def ssd(xh: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor,
        a_log: torch.Tensor, h: torch.Tensor, *,
        chunk: int = 128) -> torch.Tensor:
    """xh: (B, S, H, P) fp32; B_/C_: (B, S, N); a_log: (B, S, H) fp32;
    h: (B, H, N, P) fp32, replaced in place by the final state.
    -> y (B, S, H, P) fp32."""
    return SSD(xh, B_, C_, a_log, h, chunk)
