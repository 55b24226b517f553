#!/usr/bin/env python3
"""Time the two paths of K4 (the RWKV6 WKV kernel of the PyTorch port,
``src/repro_torch/kernels/rwkv6``) side by side on one CUDA card.

  python3 benchmarks/wkv_paths_torch.py

For rwkv6-3b's heads (H 40, head size 64), bf16 r/k/v, at B 1 and B 4
over a range of sequence lengths, it times
  * ``rec``: the parallel recurrence (the wrapper's path below
    ``CHUNKED_MIN_S``),
  * ``chunk``: the chunked form as the wrapper runs it (segments where
    the rows and heads leave the card idle),
  * ``chunk1``: the chunked form in one segment (no grid barrier),
each forced by setting the wrapper's switch, and holds each against the
plain recurrence on the same inputs at ``WKV_TOL`` first.  Times are
CUDA events over 30 launches queued behind a device sleep, rotating over
input sets larger than the L2 cache (``chip_smoke.time_ms``); the bound
is ``chip_smoke.wkv_bound``.  The last line is the card's name and power
limit from nvidia-smi.  Without a CUDA device it exits non-zero.
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as CS  # noqa: E402

SHAPES = [(S, B) for S in (1, 8, 12, 16, 24, 32, 64, 128, 512)
          for B in (1, 4)]


@contextlib.contextmanager
def forced(WK, path: str):
    """Make ``WK.wkv`` take ``path`` (rec, chunk or chunk1) for the
    block."""
    min_s, segments = WK.CHUNKED_MIN_S, WK.segments
    WK.CHUNKED_MIN_S = 1 << 30 if path == "rec" else 1
    if path == "chunk1":
        WK.segments = lambda B, H, S, resident: (
            1, -(-S // WK.CHUNK) * WK.CHUNK)
    try:
        yield
    finally:
        WK.CHUNKED_MIN_S, WK.segments = min_s, segments


def main() -> int:
    if not torch.cuda.is_available():
        print("wkv_paths_torch: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.rwkv6 import kernel as WK
    from repro_torch.kernels.rwkv6 import ref as WR
    torch.backends.cuda.matmul.allow_tf32 = False
    WK.build()
    g = torch.Generator(device=CS.DEV)
    g.manual_seed(0)
    dt = torch.bfloat16
    print("S,B,bound_ms,rec_ms,chunk_ms,chunk1_ms,segments", flush=True)
    for S, B in SHAPES:
        # enough input sets that the launches do not reuse L2
        per_set = B * S * 40 * 64 * 14 + 2 * B * 40 * 64 * 64 * 4
        sets = [CS.wkv_inputs(g, dt, S, B)
                for _ in range(max(3, min(24, -(-120_000_000 // per_set))))]
        # (timing replaces the states of ``sets`` in place: keep this one)
        r, k, v, w, u, s0 = (x.clone() for x in sets[0])
        sp = s0.clone()
        want = WR.wkv(r, k, v, w, u, sp)
        times = {}
        for path in ("rec", "chunk", "chunk1"):
            with forced(WK, path):
                sk = s0.clone()
                CS.check(f"K4 {path} B={B} S={S}", WK.wkv(r, k, v, w, u, sk),
                         want, CS.WKV_TOL[dt])
                CS.check(f"K4 {path} B={B} S={S} state", sk, sp,
                         CS.WKV_TOL[dt])
                times[path] = CS.time_ms(WK.wkv, sets)
        nseg = WK.segments(B, 40, S, WK._resident_blocks(
            torch.cuda.current_device(), 1))[0]
        print(f"{S},{B},{CS.wkv_bound(S, 2, B)['bound_ms']:.4f},"
              f"{times['rec']:.4f},{times['chunk']:.4f},"
              f"{times['chunk1']:.4f},{nseg}", flush=True)
        del sets
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
