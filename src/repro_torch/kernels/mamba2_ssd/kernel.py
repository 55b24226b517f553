"""Build, bind and launch the Mamba2 SSD chunked-scan kernel K5, written
in CUDA C++ for Hopper (``csrc/ssd.cu``), at state size and head dim 64
with the model's chunk of 128 (zamba2-7b).

The source is built at first use by ``repro_torch.kernels.nvcc`` into
``_build/`` beside it (never at import).

The wrapper checks device, dtype, shape, strides and contiguity,
allocates the output with ``torch.empty``, launches on PyTorch's current
stream without synchronising, raises if the launch returned an error,
and adds one to ``LAUNCHES["ssd"]`` for each launch.  B and C are read
by stride, so the model passes its views of the conv output without a
copy; the state is read and replaced in place.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels import nvcc

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
SOURCES = {"ssd": "ssd.cu"}
CHUNK = 128
STATE = 64                       # N
HEAD_DIM = 64                    # P
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build_jobs() -> nvcc.Jobs:
    return nvcc.jobs(CSRC, BUILD_DIR, SOURCES)


def build() -> Dict[str, Path]:
    """Compile the source if it has no library yet and load it.  Raises
    with the compiler's output on failure."""
    todo = build_jobs()
    nvcc.compile_all(todo)
    _, path = todo["ssd"]
    if "ssd" not in _LIBS:
        lib = ctypes.CDLL(str(path))
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd.argtypes = [I, P, P, P, P, P, P, I, I, I, LL, LL, P]
        lib.ssd.restype = I
        lib.ssd_error_string.argtypes = [I]
        lib.ssd_error_string.restype = ctypes.c_char_p
        _LIBS["ssd"] = lib
    return {"ssd": path}


def ssd(xh: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor,
        a_log: torch.Tensor, h: torch.Tensor, *,
        chunk: int = CHUNK) -> torch.Tensor:
    """K5.  xh: (B, S, H, 64) float32, contiguous; B_/C_: (B, S, 64)
    float32 or bfloat16 with one set of strides and unit stride along the
    last axis (views of a wider row are read in place; in bfloat16 the
    rows start 16-byte aligned); a_log: (B, S, H) float32; h: (B, H, 64,
    64) float32, replaced in place by the final state.
    -> y (B, S, H, 64) float32."""
    if xh.device.type != "cuda":
        raise ValueError(f"ssd: expects CUDA tensors, got {xh.device}")
    if chunk != CHUNK:
        raise ValueError(f"ssd: chunk {chunk} (the kernel's is {CHUNK})")
    for name, t in (("xh", xh), ("a_log", a_log), ("h", h)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd: {name} must be float32, got {t.dtype}")
    if B_.dtype not in _DTYPES or C_.dtype != B_.dtype:
        raise TypeError(f"ssd: B and C must share one dtype of float32/"
                        f"bfloat16, got {B_.dtype}, {C_.dtype}")
    if xh.dim() != 4 or xh.shape[1] < 1 or xh.shape[3] != HEAD_DIM:
        raise ValueError(f"ssd: xh (B, S>=1, H, {HEAD_DIM}), got "
                         f"{tuple(xh.shape)}")
    Bb, S, H, P = xh.shape
    if B_.shape != (Bb, S, STATE) or C_.shape != B_.shape \
            or a_log.shape != (Bb, S, H) or h.shape != (Bb, H, STATE, P):
        raise ValueError(
            f"ssd: xh {tuple(xh.shape)}, B {tuple(B_.shape)}, C "
            f"{tuple(C_.shape)}, a_log {tuple(a_log.shape)}, h "
            f"{tuple(h.shape)} (N = {STATE})")
    for t in (B_, C_, a_log, h):
        if t.device != xh.device:
            raise ValueError("ssd: tensors must be on one device")
    if B_.stride() != C_.stride() or B_.stride(2) != 1:
        raise ValueError(f"ssd: B and C need equal strides with a unit "
                         f"last stride, got {B_.stride()}, {C_.stride()}")
    for t in (xh, a_log, h):
        if not t.is_contiguous():
            raise ValueError("ssd: xh, a_log and h must be contiguous")
    if xh.data_ptr() % 16 or h.data_ptr() % 16:
        raise ValueError("ssd: xh and h must be 16-byte aligned")
    if B_.dtype == torch.bfloat16 and (
            B_.data_ptr() % 16 or C_.data_ptr() % 16 or B_.stride(0) % 8
            or B_.stride(1) % 8):
        raise ValueError("ssd: bf16 B and C rows must start 16-byte "
                         "aligned (base and strides)")
    y = torch.empty((Bb, S, H, P), dtype=torch.float32, device=xh.device)
    if "ssd" not in _LIBS:
        build()
    lib = _LIBS["ssd"]
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream(xh.device).cuda_stream
        err = lib.ssd(_DTYPES[B_.dtype], xh.data_ptr(), B_.data_ptr(),
                      C_.data_ptr(), a_log.data_ptr(), h.data_ptr(),
                      y.data_ptr(), Bb, S, H, B_.stride(0), B_.stride(1),
                      stream)
    nvcc.raise_on("ssd", lib.ssd_error_string, err)
    LAUNCHES["ssd"] += 1
    return y
