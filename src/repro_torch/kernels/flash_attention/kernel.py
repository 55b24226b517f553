"""Build, bind and launch the flash-attention kernels K1 (decode) and K2
(prefill, causal or not), written in CUDA C++ for Hopper
(``csrc/*.cu``), at head_dim 64, 112, 128 or 256, each with or without
a logit softcap (a second instantiation of each kernel).

The sources are built at first use by ``repro_torch.kernels.nvcc`` into
``_build/`` beside them (never at import).

The wrappers check device, dtype, shape and contiguity, allocate the
output (and K1's split partials) with ``torch.empty``, launch on
PyTorch's current stream without synchronising, raise if the launch
returned an error, and add one to ``LAUNCHES[name]`` for each launch.
K1's log-sum-exp form (``flash_decode_lse``, counted under its own name)
returns the float32 output and each query head's log-sum-exp, for a
caller that merges the softmaxes of several shards of the cache.
K1 merges its splits in the same launch by a per-(row, KV head) ticket:
its counters are kept zeroed between calls, one buffer per (device,
stream), so a call makes no allocation that needs initialising and no
host sync, and two launches in flight on two streams never share one.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import nvcc

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
SOURCES = {"flash_decode": "flash_decode.cu",
           "flash_prefill": "flash_prefill.cu"}
HEAD_DIMS = (64, 112, 128, 256)
MAX_REP = 16                     # query heads per KV head (K1)
MAX_SPLIT = 64                   # KV splits per (row, KV head) (K1)
DECODE_TILE = 64                 # tokens per K1 tile
BLOCKS_PER_SM = 1                # K1's split planning target (timed
                                 # best of 0.5-2 on the H100, PERF.md)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: Dict[str, int] = {name: 0 for name in
                             (*SOURCES, "flash_decode_lse")}
_LIBS: Dict[str, ctypes.CDLL] = {}
_TICKETS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build_jobs() -> nvcc.Jobs:
    return nvcc.jobs(CSRC, BUILD_DIR, SOURCES)


def build() -> Dict[str, Path]:
    """Compile the sources that have no library yet (in parallel) and
    load them.  Raises with the compiler's output on failure."""
    todo = build_jobs()
    nvcc.compile_all(todo)
    for name, (_, path) in todo.items():
        if name not in _LIBS:
            _LIBS[name] = _bind(name, ctypes.CDLL(str(path)))
    return {name: path for name, (_, path) in todo.items()}


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "flash_decode":
        lib.fa_decode.argtypes = [I, I, P, P, P, P, P, P, P, P, P, I, I,
                                  I, I, I, F, F, P]
        lib.fa_decode.restype = I
        lib.fa_decode_error_string.argtypes = [I]
        lib.fa_decode_error_string.restype = ctypes.c_char_p
    else:
        lib.fa_prefill.argtypes = [I, I, P, P, P, P, I, I, I, I, I, I, I, I,
                                   F, F, P]
        lib.fa_prefill.restype = I
        lib.fa_prefill_error_string.argtypes = [I]
        lib.fa_prefill_error_string.restype = ctypes.c_char_p
    return lib


def _lib(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        build()
    return _LIBS[name]


def _check_common(name: str, q: torch.Tensor, *others: torch.Tensor):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: expects CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {q.dtype} is not float32/bfloat16")
    for t in (q,) + others:
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name}: all tensors must share device and "
                             f"dtype ({q.device}, {q.dtype})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {q.shape[-1]} is not one of "
                         f"{HEAD_DIMS}")


def _check_softcap(name: str, softcap: float) -> float:
    """The logit softcap: 0 for none, else positive and finite."""
    softcap = float(softcap)
    if not (softcap == 0.0 or 0.0 < softcap < math.inf):
        raise ValueError(f"{name}: softcap {softcap} is neither 0 (none) "
                         "nor a positive finite number")
    return softcap


def _check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """K1 copies K/V rows with 16-byte cp.async; K2's TMA tensor maps need a
    16-byte-aligned base (their strides, D x 2 bytes and up, are multiples
    of 16 at every supported head_dim)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor not 16-byte aligned")


def decode_splits(B: int, Hkv: int, T: int, sms: int) -> int:
    """KV splits per (row, KV head) for K1, from the shapes and the SM
    count alone (never from the lengths, so a decode step stays free of
    host syncs): enough blocks for about ``BLOCKS_PER_SM`` per SM, no more
    splits than the cache has tiles, and at most ``MAX_SPLIT``."""
    tiles = -(-T // DECODE_TILE)
    want = math.ceil(BLOCKS_PER_SM * sms / (B * Hkv))
    return max(1, min(tiles, MAX_SPLIT, want))


def split_bounds(length: int, nsplit: int):
    """The token range ``[begin, end)`` of each of the ``nsplit`` splits
    of a row with ``length`` valid tokens, as the kernel deals them out:
    runs of ``ceil(tiles / nsplit)`` whole tiles (``split_range`` in
    ``flash_decode.cu``); a split past the end is empty."""
    tiles = -(-length // DECODE_TILE)
    per = -(-tiles // nsplit) * DECODE_TILE
    return [(sp * per, min(length, sp * per + per)) for sp in range(nsplit)]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _tickets(device: torch.device, stream: torch.cuda.Stream,
             n: int) -> torch.Tensor:
    """K1's split counters for launches on ``stream`` of ``device``:
    int32, zero between calls (the last block of each (row, KV head) sets
    its counter back to 0), kept from call to call and grown when a call
    needs more.  Launches on one stream run one after another, so they
    may share a buffer; launches on two streams may overlap, so each
    stream has its own."""
    key = (device, stream.stream_id)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


def _decode(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            lengths: torch.Tensor, softcap: float, lse: bool):
    """K1's checks and launch; with ``lse``, the log-sum-exp form."""
    softcap = _check_softcap(name, softcap)
    _check_common(name, q, k, v)
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: q (B,H,D), k/v (B,T,Hkv,D)")
    B, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{name}: q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)}")
    if H % Hkv or H // Hkv > MAX_REP:
        raise ValueError(f"{name}: H={H}, Hkv={Hkv} (rep <= {MAX_REP})")
    if lengths.dtype != torch.int32 or lengths.shape != (B,) \
            or lengths.device != q.device or not lengths.is_contiguous():
        raise ValueError(f"{name}: lengths must be a contiguous (B,) "
                         "int32 tensor on q's device")
    _check_aligned(name, q, k, v)
    lib = _lib("flash_decode")
    nsplit = decode_splits(B, Hkv, T, _sm_count(q.device.index))
    if lse:
        o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        m = torch.empty((B, H), dtype=torch.float32, device=q.device)
    else:
        o, m = torch.empty_like(q), None
    part_acc = torch.empty((B, H, nsplit, D), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((B, H, nsplit, 2), dtype=torch.float32,
                          device=q.device)
    with torch.cuda.device(q.device):
        current = torch.cuda.current_stream(q.device)
        tickets = _tickets(q.device, current, B * Hkv)
        stream = current.cuda_stream
        err = lib.fa_decode(_DTYPES[q.dtype], D, q.data_ptr(), k.data_ptr(),
                            v.data_ptr(), lengths.data_ptr(), o.data_ptr(),
                            None if m is None else m.data_ptr(),
                            part_acc.data_ptr(), part_ml.data_ptr(),
                            tickets.data_ptr(), B, T, H, Hkv, nsplit,
                            1.0 / math.sqrt(D), softcap, stream)
    nvcc.raise_on(name, lib.fa_decode_error_string, err)
    LAUNCHES[name] += 1
    return o if m is None else (o, m)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, *,
                 softcap: float = 0.0) -> torch.Tensor:
    """K1.  q: (B, H, D); k/v: one layer of the KV cache, (B, T, Hkv, D);
    lengths: (B,) int32, the valid KV length of each row (0 gives a zero
    output); ``softcap`` > 0 caps the scaled logits at +-softcap (tanh).
    -> (B, H, D)."""
    return _decode("flash_decode", q, k, v, lengths, softcap, False)


def flash_decode_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, softcap: float = 0.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's log-sum-exp form, as ``flash_decode`` takes its arguments.
    -> (o (B, H, D) float32, lse (B, H) float32): the softmax's
    log-sum-exp of each (row, query head) over its valid keys, -1e30 for
    a row of length 0 (whose o is 0)."""
    return _decode("flash_decode_lse", q, k, v, lengths, softcap, True)


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  q_offset: int = 0, window: Optional[int] = None,
                  causal: bool = True,
                  softcap: float = 0.0) -> torch.Tensor:
    """K2.  q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D); causal with query
    row i at absolute position ``q_offset + i``, and with a sliding
    ``window`` it sees only keys at positions > its own - window.  Not
    ``causal``, every query sees all Skv keys; no model sets an offset or
    a window there, and the kernel takes neither.  ``softcap`` > 0 caps
    the scaled logits at +-softcap (tanh), in every mode.
    -> (B, Sq, H, D)."""
    softcap = _check_softcap("flash_prefill", softcap)
    if not causal and (q_offset or window is not None):
        raise ValueError("flash_prefill: a non-causal call takes no "
                         f"q_offset ({q_offset}) and no window ({window})")
    _check_common("flash_prefill", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_prefill: q (B,Sq,H,D), k/v (B,Skv,Hkv,D)")
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % Hkv:
        raise ValueError(f"flash_prefill: q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)}")
    if q_offset < 0:
        raise ValueError(f"flash_prefill: q_offset {q_offset} < 0")
    if window is not None and window < 1:
        raise ValueError(f"flash_prefill: window {window} < 1")
    # no window: one wide enough that it masks nothing
    win = q_offset + Sq if window is None else min(window, q_offset + Sq)
    _check_aligned("flash_prefill", q, k, v)
    lib = _lib("flash_prefill")
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fa_prefill(_DTYPES[q.dtype], D, q.data_ptr(), k.data_ptr(),
                             v.data_ptr(), o.data_ptr(), B, Sq, Skv, H, Hkv,
                             int(q_offset), int(win), int(causal),
                             1.0 / math.sqrt(D), softcap, stream)
    nvcc.raise_on("flash_prefill", lib.fa_prefill_error_string, err)
    LAUNCHES["flash_prefill"] += 1
    return o
