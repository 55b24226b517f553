"""Build, bind and launch the RWKV6 WKV kernel K4, written in CUDA C++
for Hopper (``csrc/wkv.cu``), at head size 64 (rwkv6-3b).

The source is built at first use by ``repro_torch.kernels.nvcc`` into
``_build/`` beside it (never at import).

The wrapper checks device, dtype, shape and contiguity, allocates the
output with ``torch.empty``, launches on PyTorch's current stream
without synchronising, raises if the launch returned an error, and adds
one to ``LAUNCHES["wkv"]`` for each launch.  The state is read and
replaced in place, so a decode step needs no copy and no host sync.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels import nvcc

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
SOURCES = {"wkv": "wkv.cu"}
HEAD_SIZE = 64                   # P: one thread per value column
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
    _, path = todo["wkv"]
    if "wkv" not in _LIBS:
        lib = ctypes.CDLL(str(path))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.wkv.argtypes = [I, P, P, P, P, P, P, P, I, I, I, P]
        lib.wkv.restype = I
        lib.wkv_error_string.argtypes = [I]
        lib.wkv_error_string.restype = ctypes.c_char_p
        _LIBS["wkv"] = lib
    return {"wkv": path}


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
        u: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """K4.  r, k, v: (B, S, H, 64) float32 or bfloat16; w: (B, S, H, 64)
    float32 decay; u: (H, 64) float32; state: (B, H, 64, 64) float32,
    replaced in place by the final state.  -> y (B, S, H, 64) float32."""
    if r.device.type != "cuda":
        raise ValueError(f"wkv: expects CUDA tensors, got {r.device}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"wkv: r, k, v must share one dtype of float32/"
                        f"bfloat16, got {r.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("w", w), ("u", u), ("state", state)):
        if t.dtype != torch.float32:
            raise TypeError(f"wkv: {name} must be float32, got {t.dtype}")
    if r.dim() != 4 or r.shape[-1] != HEAD_SIZE or r.shape[1] < 1:
        raise ValueError(f"wkv: r (B, S>=1, H, {HEAD_SIZE}), got "
                         f"{tuple(r.shape)}")
    B, S, H, P = r.shape
    if k.shape != r.shape or v.shape != r.shape or w.shape != r.shape \
            or u.shape != (H, P) or state.shape != (B, H, P, P):
        raise ValueError(
            f"wkv: r {tuple(r.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, w {tuple(w.shape)}, u {tuple(u.shape)}, "
            f"state {tuple(state.shape)}")
    for t in (r, k, v, w, u, state):
        if t.device != r.device or not t.is_contiguous():
            raise ValueError("wkv: tensors must be contiguous on one device")
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=r.device)
    if "wkv" not in _LIBS:
        build()
    lib = _LIBS["wkv"]
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.wkv(_DTYPES[r.dtype], r.data_ptr(), k.data_ptr(),
                      v.data_ptr(), w.data_ptr(), u.data_ptr(),
                      state.data_ptr(), y.data_ptr(), B, S, H, stream)
    nvcc.raise_on("wkv", lib.wkv_error_string, err)
    LAUNCHES["wkv"] += 1
    return y
