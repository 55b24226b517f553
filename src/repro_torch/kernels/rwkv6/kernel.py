"""Build, bind and launch the RWKV6 WKV kernel K4, written in CUDA C++
for Hopper (``csrc/wkv.cu``), at head size 64 (rwkv6-3b).

The source is built at first use by ``repro_torch.kernels.nvcc`` into
``_build/`` beside it (never at import).

K4 has two paths, chosen by the sequence length, as K3 has its Small and
Large paths:
  * S < ``CHUNKED_MIN_S`` (decode, short prompts): the parallel
    recurrence, four blocks of 64 threads per (row, head), each thread a
    4 x 4 slice of the state in registers;
  * S >= ``CHUNKED_MIN_S`` (prefill): the chunked form, steps of
    ``CHUNK`` tokens on TF32 tensor cores with fp32 accuracy.  Where the
    rows and heads alone would leave the card idle (B 1, the serve
    shape), the sequence is also cut into ``segments``: in one
    cooperative launch (every block resident), each block first writes
    its segment's own contribution to the state and its decay into
    scratch (``torch.empty``), the blocks meet at a grid barrier (a
    pair of counters per (device, stream) that each launch leaves ready
    for the next, ``_barrier``, so launches in flight on two streams never
    share one), and each then computes its segment's outputs from the
    state carried over the segments before it.
Both paths give the recurrence to fp32 rounding; neither falls back to
the other, and each raises on what it does not take.

The wrapper checks device, dtype, shape, alignment and contiguity,
allocates the output and any scratch with ``torch.empty`` on the current
stream, launches one kernel without synchronising, raises if the launch
returned an error, and adds one to ``LAUNCHES["wkv"]`` for each call.
The state is read and replaced in place, so a decode step needs no copy
and no host sync.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.kernels import nvcc

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
SOURCES = {"wkv": "wkv.cu"}
HEAD_SIZE = 64                   # P
CHUNK = 16                       # tokens per step of the chunked path
CHUNKED_MIN_S = 16               # shortest S that takes the chunked path
                                 # (measured: the two cross between 12 and 16)
MIN_SEGMENT = 4 * CHUNK          # shortest segment worth a carry
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}
_LIBS: Dict[str, ctypes.CDLL] = {}
_BARRIERS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


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
        lib.wkv.argtypes = [I, I, I, I, P, P, P, P, P, P, P, P, P, P, I, I,
                            I, P]
        lib.wkv.restype = I
        lib.wkv_chunk_blocks_per_sm.argtypes = [I]
        lib.wkv_chunk_blocks_per_sm.restype = I
        lib.wkv_error_string.argtypes = [I]
        lib.wkv_error_string.restype = ctypes.c_char_p
        _LIBS["wkv"] = lib
    return {"wkv": path}


@functools.lru_cache(maxsize=None)
def _resident_blocks(index: int, dtype: int) -> int:
    """Blocks of the chunked kernel the card holds at once: its SMs times
    the blocks an SM holds (with the device ``index`` current)."""
    with torch.cuda.device(index):
        per_sm = _LIBS["wkv"].wkv_chunk_blocks_per_sm(dtype)
    if per_sm < 1:
        raise RuntimeError("wkv: the chunked kernel fits no SM")
    return per_sm * torch.cuda.get_device_properties(
        index).multi_processor_count


def _barrier(device: torch.device, stream: torch.cuda.Stream
             ) -> torch.Tensor:
    """The chunked path's grid barrier for launches on ``stream`` of
    ``device``: two uint32 (as int32), zero between calls, kept from call
    to call.  One stream's launches run one after another and may share
    it; two streams' launches may overlap, so each stream has its own."""
    key = (device, stream.stream_id)
    t = _BARRIERS.get(key)
    if t is None:
        t = torch.zeros(2, dtype=torch.int32, device=device)
        _BARRIERS[key] = t
    return t


def segments(B: int, H: int, S: int, resident: int) -> Tuple[int, int]:
    """(number of segments, tokens a segment) of the chunked path: as many
    segments as keep B x H x segments blocks resident at once (``resident``
    blocks: one wave, as the grid barrier needs), none shorter than
    ``MIN_SEGMENT`` tokens; a segment is a whole number of ``CHUNK``-token
    steps and the last one ends at S."""
    want = resident // (B * H)
    n = max(1, min(want, S // MIN_SEGMENT))
    seglen = -(-S // (n * CHUNK)) * CHUNK
    return -(-S // seglen), seglen


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
        if t.device != r.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("wkv: tensors must be contiguous and 16-byte "
                             "aligned on one device")
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=r.device)
    if "wkv" not in _LIBS:
        build()
    lib = _LIBS["wkv"]
    path, nseg, seglen = 0, 1, CHUNK
    scr = ascr = gbar = None
    if S >= CHUNKED_MIN_S:
        path = 1
        index = r.device.index
        if index is None:
            index = torch.cuda.current_device()
        nseg, seglen = segments(B, H, S,
                                _resident_blocks(index, _DTYPES[r.dtype]))
        if nseg > 1:
            scr = torch.empty((nseg, B, H, P, P), dtype=torch.float32,
                              device=r.device)
            ascr = torch.empty((nseg, B, H, P), dtype=torch.float32,
                               device=r.device)
    with torch.cuda.device(r.device):
        current = torch.cuda.current_stream(r.device)
        if nseg > 1:
            gbar = _barrier(r.device, current)
        stream = current.cuda_stream
        err = lib.wkv(_DTYPES[r.dtype], path, nseg, seglen, r.data_ptr(),
                      k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                      state.data_ptr(), y.data_ptr(),
                      None if scr is None else scr.data_ptr(),
                      None if ascr is None else ascr.data_ptr(),
                      None if gbar is None else gbar.data_ptr(),
                      B, S, H, stream)
    nvcc.raise_on("wkv", lib.wkv_error_string, err)
    LAUNCHES["wkv"] += 1
    return y
