"""Build, bind and launch the MoE grouped-matmul kernel K3, written in
CUDA C++ for Hopper (``csrc/gmm.cu``).

The source is built at first use by ``repro_torch.kernels.nvcc`` into
``_build/`` beside it (never at import).

The wrapper checks device, dtype, shape, alignment and contiguity,
allocates the output with ``torch.empty``, launches on PyTorch's
current stream without synchronising, raises if the launch returned an
error, and adds one to ``LAUNCHES["gmm"]`` for each launch.  It never
reads the group sizes on the host: the kernel finds each tile's expert
from them on the device, so the MoE layer makes no host sync.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels import nvcc

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
SOURCES = {"gmm": "gmm.cu"}
MAX_EXPERTS = 256
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
    _, path = todo["gmm"]
    if "gmm" not in _LIBS:
        lib = ctypes.CDLL(str(path))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.gmm.argtypes = [I, P, P, P, P, I, I, I, I, P]
        lib.gmm.restype = I
        lib.gmm_error_string.argtypes = [I]
        lib.gmm_error_string.restype = ctypes.c_char_p
        _LIBS["gmm"] = lib
    return {"gmm": path}


def gmm(x: torch.Tensor, w: torch.Tensor,
        group_sizes: torch.Tensor) -> torch.Tensor:
    """K3.  x: (M, K) rows sorted by expert; w: (E, K, N); group_sizes:
    (E,) int32 on x's device, summing to M (rows past the sum are left
    unwritten).  -> (M, N) in x's dtype, accumulated in fp32."""
    if x.device.type != "cuda":
        raise ValueError(f"gmm: expects CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"gmm: x {x.dtype} and w {w.dtype} must both be "
                        "float32 or bfloat16")
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"gmm: x (M,K) {tuple(x.shape)} vs w (E,K,N) "
                         f"{tuple(w.shape)}")
    M, K = x.shape
    E, _, N = w.shape
    if not 1 <= E <= MAX_EXPERTS or K % 8 or N % 8:
        raise ValueError(f"gmm: E={E} (1..{MAX_EXPERTS}), K={K} and N={N} "
                         "(multiples of 8)")
    if group_sizes.dtype != torch.int32 or group_sizes.shape != (E,) \
            or group_sizes.device != x.device:
        raise ValueError("gmm: group_sizes must be an (E,) int32 tensor on "
                         "x's device")
    for t in (x, w, group_sizes):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("gmm: tensors must be contiguous on one device")
    for t in (x, w):
        if t.data_ptr() % 16:
            raise ValueError("gmm: x and w must be 16-byte aligned")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    if "gmm" not in _LIBS:
        build()
    lib = _LIBS["gmm"]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gmm(_DTYPES[x.dtype], x.data_ptr(), w.data_ptr(),
                      group_sizes.data_ptr(), out.data_ptr(), M, K, N, E,
                      stream)
    nvcc.raise_on("gmm", lib.gmm_error_string, err)
    LAUNCHES["gmm"] += 1
    return out
