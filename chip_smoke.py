#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:
  1. build    compile K1 (decode attention), K2 (prefill attention), K3
              (MoE grouped matmul), K4 (RWKV6 WKV) and K5 (Mamba2 SSD)
              from the repo's CUDA sources with nvcc for sm_90a, all five
              sources in parallel; count the wgmma (HGMMA) and TMA load
              (UTMALDG) instructions in the machine code of K2 and K3,
              and the mma.sync (HMMA) and cp.async (LDGSTS) instructions
              in that of K1, K4 and K5 (cuobjdump -sass), and fail if any
              is missing;
  2. kernels  hold each kernel against its plain PyTorch version on the
              card in fp32 (tight) and bf16 (stated tolerance) at the
              main paths' shapes (K1/K2 at llama3-8b's head_dim 128,
              gpt-oss-20b's 64 and zamba2-7b's 112, K2 also with a
              sliding window; K3 at the decode and the prefill shape, on
              one expert, on ragged tails and on ragged groups at the
              Large path with a depth of 1000; K4
              at rwkv6-3b's prefill, decode and a ragged length, and at
              B 1 with a wide spread of decays, from a nonzero state; K5
              at zamba2-7b's prefill and a ragged length, from a nonzero
              state), and time kernel, plain version and, where there is
              one, one PyTorch call of the same function (K4 and K5 also
              at B 1, the shape of every recurrent serve admission; K2
              also at one chunk of a chunked llama3-8b admission, Sq 128
              at q_offset 384 over Skv 512, against SDPA with a
              bottom-right causal mask);
  3. llama    full-width llama3-8b in bf16 (random weights from a seeded
              generator): one right-padded prefill and 8 decode steps
              through the kernels, each step under
              torch.cuda.set_sync_debug_mode("error") (it makes no host
              sync), and again through the plain versions, logits held
              within a stated relative tolerance; then the
              ServingEngine (4 slots, max_len 1024) serves 8 Poisson-trace
              requests (prompts <= 512, 32 new tokens), every request must
              complete with its token count, and the launch counters,
              zeroed just before, must equal 32 per step or admission;
  4. window   gpt-oss-20b at full width, 2 layers, fp32, sliding window
              128: prompts up to 512 overfill the ring buffer and 8 decode
              steps wrap it; kernels against plain versions, tight;
  5. gpt-oss  full-width gpt-oss-20b in bf16: the prefill and decode
              check of phase 3 (so the MoE routing, too, makes no host
              sync), with the routing differences between the two runs
              counted; then the same serving run, with
              K1 = 24 per decode step, K2 = 24 per admission and
              K3 = 72 per decode step and per admission;
  6. rwkv6    rwkv6-3b at full width and depth: in fp32, a prefill of
              equal-length rows (a pad token would enter the state) and
              8 decode steps (no host sync) through the kernels and the
              plain versions, logits held tight; then in bf16 the same,
              where the free-running logit difference is held against
              that of a plain run moved off its rounding points and each
              kernel call against its plain version on the same inputs
              (see phase_model); then
              the serving run, with K4 = 32 per decode step and per
              admission (admissions grouped by exact prompt length);
  7. zamba2   zamba2-7b at full width and depth, as phase 6 (the fp32
              prompt of 300 ends in a ragged chunk); then the serving
              run, with K1 = 27 per decode step, K2 = 27 per admission and
              K5 = 81 per admission of a prompt longer than one token;
  paged       after the serving run of each model, with its parameters
              still loaded, paged KV, chunked admission and the prefill ->
              decode handoff (``serving/kvpool.py``), every decode step
              under set_sync_debug_mode("error"): llama3-8b (bf16) served
              by a paged engine (48 blocks of 64 tokens) that must
              preempt, spill and prefetch, one session's park -> spill ->
              prefetch -> activate round trip bitwise on every cache leaf;
              by a chunked-admission engine (128-token chunks, K2 32 per
              chunk, at q_offset > 0 inside the model); by a serial and a
              streamed prefill -> decode pair of engines; a 4 x 512
              chunked prefill held against the whole one at MODEL_RTOL;
              the same four runs in fp32 at 4 layers give the fixed
              engine's greedy tokens; gpt-oss-20b's serial pair ships
              each session's whole ring and lands it bit for bit;
              rwkv6-3b and zamba2-7b prefill 4 x 512 in 128-token chunks
              from the carried state, logits and every final state leaf
              held against one whole prefill at the model's phase-6/7
              tolerance, with K4 / K5 (and K2) launched once per chunk;
  cluster     after llama3-8b's "paged" checks, with its bf16 weights
              still loaded, the cluster layer (``serving/spec.py`` and
              what it stands on): llama3-8b's decode step traced on the
              card; the deployment DES of two catalog GPU groups on its
              graph, one Poisson trace simulated twice with identical
              event logs (its throughput and TTFT are the cost model's);
              ``spec.compile().launch()`` as a pool of two engines on one
              set of weights (memory grows by their caches only), group 0
              drained at t 0 (sessions migrate); the pool again with group
              0 crashed mid-run and sessions checkpointed to the host
              (every lost session restored); a serial pair, a streamed
              pair in 128-token chunks (the "paged" pairs' wire bytes and
              shards) and a streamed pair under a flaky link (retransmits,
              corrupted shards caught by checksums, each re-prefilled);
              ``launch.serve --deployment`` once; ``ElasticExecutor`` on
              three streams of the card, logits bit-identical to the eager
              step after each of two device losses; in fp32 at 4 layers
              the drain, crash and flaky runs give one plain engine's
              greedy tokens; K1 and K2 launch counts of the phase;
  8. tessera  the Tessera core on the decode step at full width (bf16, B
              4, max_len 1024): the step of all four models traced with
              torch.export (kernel op nodes = launches per step: 32 K1;
              24 K1 + 72 K3; 32 K4; 27 K1); llama3-8b and gpt-oss-20b
              planned for the H100 + RTX Pro 6000 pair under both
              policies and executed on two logical devices of this card
              (a stream each) and fused on one: 8 decode steps from one
              prefilled cache, no host sync, logits bit-identical to the
              eager step and the same launches, less than 1 GiB allocated
              by building the executables; gpt-oss-20b served through
              the online monitor's executable with the eager engine's
              greedy tokens; the pipelined runner on two streams of the
              card with straggler deadlines, which must fire on a unit's
              completion (not its issue) and rerun it on a fallback
              stream with the eager result.  Phase 2 also runs K1 and K4
              (B 1) twice at once on two unordered streams;
  9. card     the card's name and power limit from nvidia-smi.

The last lines are the kernels' JSON record, the nvidia-smi line and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside it, the script fails and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

DEV = "cuda"                          # every phase runs on the card
B = 4                                 # engine slots, batch of the checks
MAX_LEN = 1024                        # engine cache length
PROMPT = 512                          # longest prompt (max_len // 2)
DECODE_STEPS = 8
N_REQUESTS, MAX_NEW, RATE = 8, 32, 20.0
# the "paged" phase: a pool of 48 blocks of 64 tokens (llama3-8b: 128 KiB
# a token, so 384 MiB, against 512 MiB for the 4 x 1024 dense cache),
# prefill chunks of 128 tokens, and llama3-8b in fp32 at 4 layers for the
# greedy identity of the engines
KV_BLOCK, KV_POOL, PREFILL_CHUNK = 64, 48, 128
IDENTITY_LAYERS = 4
# K2 at one chunk of a chunked llama3-8b admission: the last 128-token
# chunk of a 512-token prompt
CHUNK_SQ, CHUNK_OFFSET = 128, 384
# attention shapes (H, Hkv, D) of the three attention models
LLAMA_ATTN = (32, 8, 128)
GPTOSS_ATTN = (64, 8, 64)
ZAMBA_ATTN = (32, 32, 112)
RWKV_SHAPE = (40, 64)                 # rwkv6-3b: heads, head size (K4)
SSD_SHAPE = (112, 64, 64)             # zamba2-7b: heads, head dim, state (K5)
GPTOSS_WINDOW = 4096                  # gpt-oss-20b's sliding window
SMALL_WINDOW = 128                    # phase 4: the ring wraps

# H100 SXM published peaks (dense), against which bounds are computed
PEAK_BYTES_S = 3.35e12
# (fp32 outside the tensor cores; TF32 on them)
PEAK_FLOPS_S = {torch.bfloat16: 989e12, torch.float32: 67e12,
                "tf32": 495e12}

# Kernel vs plain version: |kernel - plain| <= ATOL + RTOL * |plain|.
# Attention in fp32 differs only by summation order and expf.  K3 in
# fp32 sums 2880 products per element in another order than cuBLAS: the
# rounding error of such a sum is about sqrt(2880) x 6e-8 = 3.2e-6 of an
# O(1) output, and its maximum over 23 M elements is near 6 sigma, so
# K3's fp32 bound is 1e-4.  In bf16 the plain attention rounds q*scale
# and the softmax weights to bf16 before the products and the kernels do
# not, and every version rounds its output to bf16, so one or two bf16
# ulps (2^-7 relative) of disagreement are expected.
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 2e-2)}
GMM_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 2e-2)}
# Full-width model, kernels vs plain versions: max|a - b| / max|b| of the
# logits.  Per-layer bf16 differences of the size above propagate through
# the layers; in fp32 they are summation-order differences.
MODEL_RTOL = {torch.bfloat16: 5e-2, torch.float32: 1e-4}
# K4 vs plain: both convert the same r, k, v (fp32, or bf16 read exactly
# into fp32).  The recurrence path sums 64 products per output in another
# order than the plain einsum and rounds the state update once (fma); the
# chunked path forms the same sums as products on TF32 tensor cores with
# each fp32 operand split into hi + lo (3xTF32, about 2^-22 of each
# operand), in steps of 16 tokens, with the decays as products of w: fp32
# summation-order error, a few 1e-6 of outputs of size ~10, in either
# input dtype.
WKV_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-5, 1e-5)}
# K5 vs plain: the in-chunk prefix sums of a_log reach ~100 at the
# model's decays (~0.8 a token over 128 tokens), where an fp32 ulp is
# 7.6e-6; the two versions sum them in different orders, so
# cum_t - cum_s differs by up to ~3e-5, which is the relative error of
# its exponential.  Hence 1e-4, the bound the JAX kernel tests hold the
# chunked scan to; B and C in bf16 are read exactly into fp32 by both.
SSD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-4, 1e-4)}
# The shadow run (phase_model) holds each scan call element by element
# against an error bound: |kernel - plain| <= tol x (the sum of the
# absolute values of the terms of that output or state element), which
# is the plain version run on |r|, |k|, |v|, |u|, |state| (|x|, |B|, |C|,
# |h0| for SSD; every decay is positive).  The rounding error of an fp32
# sum grows with that sum, not with the result, which may cancel to near
# 0.  WKV: 2 n u with n ~ 80 terms (64 products, a state that remembers
# ~8 tokens) and u = 6e-8, so 1e-5; SSD: the exponentials' relative error
# of up to 3e-5 (SSD_TOL), twice, so 1e-4.
SHADOW_BOUND = {"wkv": (1e-5, (0, 1, 2, 4, 5)), "ssd": (1e-4, (0, 1, 2, 4))}
# bf16 recurrent models, free-running: the random full-width models
# amplify a one-ulp bf16 difference anywhere into logit differences of
# several per cent, so there kernels vs plain is held at MODEL_RTOL or,
# where it is larger, at FREE_RUN_K times the difference between the
# plain run and a plain run moved off its rounding points as the kernels
# are (perturbed_plain).
FREE_RUN_K = 3.0

REPLACES = {"flash_decode": "src/repro/kernels/flash_attention/kernel.py:188",
            "flash_prefill": "src/repro/kernels/flash_attention/kernel.py:93",
            "gmm": "src/repro/kernels/moe_gmm/kernel.py:32",
            "wkv": "src/repro/kernels/rwkv6/kernel.py:53",
            "ssd": "src/repro/kernels/mamba2_ssd/kernel.py:76"}
# libraries whose kernels must run on wgmma fed by TMA, and those whose
# bf16 paths must run on mma.sync fed by cp.async (phase 1)
WGMMA_TMA_LIBS = ("flash_prefill", "gmm")
MMA_CPASYNC_LIBS = ("flash_decode", "wkv", "ssd")
FA_SRC = "src/repro_torch/kernels/flash_attention/csrc/"
GMM_SRC = "src/repro_torch/kernels/moe_gmm/csrc/gmm.cu"
WKV_SRC = "src/repro_torch/kernels/rwkv6/csrc/wkv.cu"
SSD_SRC = "src/repro_torch/kernels/mamba2_ssd/csrc/ssd.cu"
T0 = time.perf_counter()


def log(*a) -> None:
    print(*a, flush=True)


def log_phase(name: str) -> None:
    log(f"[time] {name} done at {time.perf_counter() - T0:.1f} s")


def time_ms(fn, arg_sets, iters: int = 30) -> float:
    """Device time of one call, from CUDA events around ``iters`` calls
    queued behind a device-side sleep (so host overhead between launches
    does not show), rotating over ``arg_sets`` so that the inputs do not
    all sit in the 50 MB L2 cache."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)         # ~50 ms of queue head-room
    e0.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def check(name, got, want, tol) -> float:
    torch.cuda.synchronize()
    atol, rtol = tol
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if got.shape != want.shape or not torch.isfinite(got.float()).all() \
            or bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside atol={atol} "
            f"rtol={rtol}; max abs err {float(err.max()):.3e}")
    return float(err.max())


def bound(nbytes: float, flops: float, dtype) -> dict:
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS_S[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# --------------------------------------------------------------------- #
# 1. build
# --------------------------------------------------------------------- #
def phase_build(nvcc, kernels) -> None:
    t = time.perf_counter()
    jobs = {}
    for km in kernels:
        jobs.update(km.build_jobs())
    nvcc.compile_all(jobs)
    libs = {}
    for km in kernels:
        libs.update(km.build())
    log(f"[build] K1-K5 ({len(jobs)} sources) built in "
        f"{time.perf_counter() - t:.2f} s (nvcc, sm_90a, one process per "
        "source)")
    for name, out in nvcc.BUILD_LOG.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "C75" in line:
                log(f"[build] {name}: {line.strip()}")
    # K2 and K3's Large path run on wgmma (SASS HGMMA) fed by TMA
    # (UTMALDG); K1's and K5's bf16 paths and K4's chunked path on
    # mma.sync (HMMA) fed by cp.async (LDGSTS)
    for names, ops in ((WGMMA_TMA_LIBS, ("HGMMA", "UTMALDG")),
                       (MMA_CPASYNC_LIBS, ("HMMA", "LDGSTS"))):
        for name in names:
            found = nvcc.sass_counts(libs[name], ops)
            log(f"[build] {name}: SASS holds "
                + " and ".join(f"{n} {op}" for op, n in found.items())
                + " instructions")
            if not all(found.values()):
                raise AssertionError(f"{name}: a tensor-core or async-copy "
                                     f"instruction is missing from its "
                                     f"machine code ({found})")


# --------------------------------------------------------------------- #
# 2. kernels
# --------------------------------------------------------------------- #
def randn(g, *shape, dtype):
    return torch.randn(*shape, generator=g, device=DEV).to(dtype)


def decode_inputs(g, dtype, lengths, attn, T=MAX_LEN):
    H, Hkv, D = attn
    return (randn(g, B, H, D, dtype=dtype), randn(g, B, T, Hkv, D, dtype=dtype),
            randn(g, B, T, Hkv, D, dtype=dtype),
            torch.tensor(lengths, dtype=torch.int32, device=DEV))


def prefill_inputs(g, dtype, S, attn, Skv=None):
    H, Hkv, D = attn
    Skv = S if Skv is None else Skv
    return (randn(g, B, S, H, D, dtype=dtype),
            randn(g, B, Skv, Hkv, D, dtype=dtype),
            randn(g, B, Skv, Hkv, D, dtype=dtype))


def sdpa_decode(q, k, v, lengths):
    T = k.shape[1]
    mask = torch.arange(T, device=q.device)[None, :] < lengths[:, None]
    return F.scaled_dot_product_attention(
        q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask[:, None, None, :], enable_gqa=True)


def sdpa_prefill(q, k, v):
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True)


def check_attention(g, FK, FR) -> dict:
    """K1 and K2 against their plain versions; returns the largest bf16
    error per (kernel, head_dim)."""
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        for attn in (LLAMA_ATTN, GPTOSS_ATTN, ZAMBA_ATTN):
            D = attn[2]
            for T, lengths in ((MAX_LEN, [1, 77, 512, MAX_LEN]),
                               (MAX_LEN, [PROMPT] * B),
                               (1000, [1000, 999, 64, 65])):
                q, k, v, lens = decode_inputs(g, dtype, lengths, attn, T)
                e = check(f"K1 {tag} D={D} T={T} lengths={lengths}",
                          FK.flash_decode(q, k, v, lens),
                          FR.decode_attention(q, k, v, lens), TOL[dtype])
                log(f"[kernels] K1 {tag} D={D} rep={attn[0] // attn[1]} "
                    f"T={T} lengths={lengths}: max abs err {e:.3e}")
                if dtype == torch.bfloat16:
                    key = ("flash_decode", D)
                    errs[key] = max(errs.get(key, 0.0), e)
            for S, Skv, off, win in ((PROMPT, PROMPT, 0, None),
                                     (PROMPT, PROMPT, 0, SMALL_WINDOW),
                                     (300, 300, 0, 64), (37, 37, 0, None),
                                     (200, 456, 256, None),
                                     (200, 456, 256, 100)):
                q, k, v = prefill_inputs(g, dtype, S, attn, Skv)
                what = (f"K2 {tag} D={D} S={S} Skv={Skv} q_offset={off} "
                        f"window={win}")
                e = check(what,
                          FK.flash_prefill(q, k, v, q_offset=off, window=win),
                          FR.prefill_attention(q, k, v, q_offset=off,
                                               window=win), TOL[dtype])
                log(f"[kernels] {what}: max abs err {e:.3e}")
                if dtype == torch.bfloat16:
                    key = ("flash_prefill", D)
                    errs[key] = max(errs.get(key, 0.0), e)
    return errs


def time_attention(g, FK, FR, errs) -> list:
    dt, es = torch.bfloat16, 2
    rows = []
    for suffix, attn, window in (("", LLAMA_ATTN, None),
                                 ("_d64", GPTOSS_ATTN, GPTOSS_WINDOW),
                                 ("_d112", ZAMBA_ATTN, None)):
        H, Hkv, D = attn
        lengths = [PROMPT] * B
        dec_sets = [decode_inputs(g, dt, lengths, attn) for _ in range(6)]
        n_tok = sum(lengths)
        dec = bound(es * (2 * B * H * D + 2 * n_tok * Hkv * D) + 4 * B,
                    4 * n_tok * H * D, dt)
        pre_sets = [prefill_inputs(g, dt, PROMPT, attn) for _ in range(3)]
        # no window, or one (4096) wider than the prompt: the causal pairs
        pre = bound(es * (2 * B * PROMPT * H * D + 2 * B * PROMPT * Hkv * D),
                    4 * D * H * B * PROMPT * (PROMPT + 1) // 2, dt)

        def prefill(q, k, v):
            return FK.flash_prefill(q, k, v, window=window)

        def plain_prefill(q, k, v):
            return FR.prefill_attention(q, k, v, window=window)

        for name, src, sets, kern, plain, lib, bnd in (
                ("flash_decode", "flash_decode.cu", dec_sets, FK.flash_decode,
                 FR.decode_attention, sdpa_decode, dec),
                ("flash_prefill", "flash_prefill.cu", pre_sets, prefill,
                 plain_prefill, sdpa_prefill, pre)):
            row = {"name": name + suffix, "route": "cuda",
                   "source": FA_SRC + src, "replaces": REPLACES[name],
                   "launches": 0, "max_abs_err": errs[(name, D)],
                   "ms": time_ms(kern, sets),
                   "plain_ms": time_ms(plain, sets, iters=10), **bnd,
                   "library_ms": time_ms(lib, sets)}
            log(f"[kernels] {row['name']} bf16 H={H} Hkv={Hkv} D={D} timing: "
                f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                f"sdpa {row['library_ms']:.4f} ms, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
            rows.append(row)
    rows.append(time_prefill_chunk(g, FK, FR))
    return rows


def sdpa_prefill_lower_right(q, k, v):
    """SDPA with the causal mask aligned bottom-right (query i at position
    Skv - Sq + i), the chunk's alignment; ``is_causal`` aligns top-left."""
    from torch.nn.attention.bias import causal_lower_right
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=causal_lower_right(q.shape[1], k.shape[1]),
        enable_gqa=True)


def time_prefill_chunk(g, FK, FR) -> dict:
    """K2 at one chunk of a chunked llama3-8b admission: B 4, Sq 128 at
    q_offset 384 over the filled prefix Skv 512 (bf16, held at TOL)."""
    dt, es = torch.bfloat16, 2
    H, Hkv, D = LLAMA_ATTN
    Skv = CHUNK_OFFSET + CHUNK_SQ
    sets = [prefill_inputs(g, dt, CHUNK_SQ, LLAMA_ATTN, Skv)
            for _ in range(3)]

    def kern(q, k, v):
        return FK.flash_prefill(q, k, v, q_offset=CHUNK_OFFSET)

    def plain(q, k, v):
        return FR.prefill_attention(q, k, v, q_offset=CHUNK_OFFSET)

    err = check(f"K2 bf16 D={D} S={CHUNK_SQ} Skv={Skv} q_offset="
                f"{CHUNK_OFFSET}", kern(*sets[0]), plain(*sets[0]), TOL[dt])
    lib_err = check("SDPA lower-right vs plain", sdpa_prefill_lower_right(
        *sets[0]).transpose(1, 2), plain(*sets[0]), TOL[dt])
    # each query of the chunk sees the prefix and the chunk's causal part
    pairs = CHUNK_SQ * CHUNK_OFFSET + CHUNK_SQ * (CHUNK_SQ + 1) // 2
    bnd = bound(es * (2 * B * CHUNK_SQ * H * D + 2 * B * Skv * Hkv * D),
                4 * D * H * B * pairs, dt)
    row = {"name": "flash_prefill_chunk", "route": "cuda",
           "source": FA_SRC + "flash_prefill.cu",
           "replaces": REPLACES["flash_prefill"], "launches": 0,
           "max_abs_err": err, "ms": time_ms(kern, sets),
           "plain_ms": time_ms(plain, sets, iters=10), **bnd,
           "library_ms": time_ms(sdpa_prefill_lower_right, sets)}
    log(f"[kernels] flash_prefill_chunk bf16 H={H} Hkv={Hkv} D={D} Sq="
        f"{CHUNK_SQ} q_offset={CHUNK_OFFSET} Skv={Skv}: max abs err "
        f"{err:.3e} (SDPA lower-right vs plain {lib_err:.3e}); kernel "
        f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, sdpa "
        f"(causal_lower_right) {row['library_ms']:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    return row


def gmm_inputs(g, dtype, sizes, w):
    x = randn(g, sum(sizes), w.shape[1], dtype=dtype)
    return x, w, torch.tensor(sizes, dtype=torch.int32, device=DEV)


# Group sizes of the two main-path shapes at gpt-oss-20b (32 experts,
# top-4, 4 slots): a decode step's 16 rows over 13 experts (some empty),
# and a 4 x 512 prefill's 8192 rows, uneven, one expert empty.
GMM_DECODE = [1, 0, 2, 1, 0, 1, 1, 0, 2, 0, 1, 1, 0, 0, 1, 2,
              0, 0, 1, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0]
GMM_PREFILL = [256 + 8 * ((7 * e) % 9) - 32 for e in range(31)] + [0]
GMM_PREFILL[0] += 8192 - sum(GMM_PREFILL)
# The Large (prefill) path on ragged groups: empty groups, groups of one
# row and at the edges of 64-, 128- and 256-row tiles, 2,057 rows in all
# (at least 64 per expert on average, so the Large path), at a depth K
# that is not a multiple of the kernel's 64-deep stages.
GMM_RAGGED_LARGE = [0, 1, 63, 64, 65, 127, 129, 300, 2, 255, 256, 257, 0,
                    33, 97, 200] + [13] * 16
GMM_RAGGED_K = 1000


def grouped_mm_library():
    """The PyTorch call used as K3's yardstick: ``torch._grouped_mm``
    where this PyTorch has it and takes these inputs, else a per-expert
    ``torch.matmul`` loop.  The port never calls either."""
    def grouped(x, w, gs):
        return torch._grouped_mm(x, w, offs=torch.cumsum(gs, 0,
                                                         dtype=torch.int32))

    def loop(x, w, gs):
        out, start = torch.empty(x.shape[0], w.shape[2], dtype=x.dtype,
                                 device=x.device), 0
        for e, n in enumerate(gs.tolist()):
            if n:
                out[start:start + n] = x[start:start + n] @ w[e]
            start += n
        return out
    return grouped, loop


def check_and_time_gmm(g, GK, GR, d=2880, f=2880, E=32) -> list:
    rows, errs = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        w = (torch.randn(E, d, f, generator=g, device=DEV)
             / d ** 0.5).to(dtype)
        for shape, sizes in (("decode", GMM_DECODE), ("prefill", GMM_PREFILL),
                             ("one expert", [0] * 31 + [8192]),
                             ("ragged tails", [300, 0, 17, 1, 63, 64, 65,
                                               129] + [0] * 24)):
            x, w, gs = gmm_inputs(g, dtype, sizes, w)
            e = check(f"K3 {tag} {shape} M={x.shape[0]}", GK.gmm(x, w, gs),
                      GR.gmm(x, w, gs), GMM_TOL[dtype])
            log(f"[kernels] K3 {tag} {shape} M={x.shape[0]} E={E} "
                f"nonempty={sum(1 for n in sizes if n)}: max abs err {e:.3e}")
            if dtype == torch.bfloat16:
                errs[shape] = e
        del w
        w = (torch.randn(E, GMM_RAGGED_K, f, generator=g, device=DEV)
             / GMM_RAGGED_K ** 0.5).to(dtype)
        x, w, gs = gmm_inputs(g, dtype, GMM_RAGGED_LARGE, w)
        e = check(f"K3 {tag} ragged Large M={x.shape[0]} K={GMM_RAGGED_K}",
                  GK.gmm(x, w, gs), GR.gmm(x, w, gs), GMM_TOL[dtype])
        log(f"[kernels] K3 {tag} ragged Large M={x.shape[0]} "
            f"K={GMM_RAGGED_K} E={E} groups {GMM_RAGGED_LARGE}: max abs err "
            f"{e:.3e}")
        del w
    dt = torch.bfloat16
    grouped, loop = grouped_mm_library()
    for shape, sizes in (("decode", GMM_DECODE), ("prefill", GMM_PREFILL)):
        # four weight sets (4 x 531 MB), so launches do not reuse L2
        sets = [gmm_inputs(g, dt, sizes, (torch.randn(
            E, d, f, generator=g, device=DEV) / d ** 0.5).to(dt))
            for _ in range(4)]
        M = sum(sizes)
        busy = sum(1 for n in sizes if n)
        bnd = bound(busy * d * f * 2 + M * (d + f) * 2, 2 * M * d * f, dt)
        lib, lib_name = loop, "per-expert torch.matmul loop"
        if hasattr(torch, "_grouped_mm"):
            try:
                check("torch._grouped_mm yardstick", grouped(*sets[0]),
                      GR.gmm(*sets[0]), GMM_TOL[dt])
                lib, lib_name = grouped, "torch._grouped_mm"
            except (RuntimeError, TypeError, ValueError,
                    AssertionError) as exc:
                log(f"[kernels] torch._grouped_mm not usable as the "
                    f"yardstick here ({str(exc).splitlines()[0]})")
        row = {"name": f"gmm_{shape}", "route": "cuda", "source": GMM_SRC,
               "replaces": REPLACES["gmm"], "launches": 0,
               "max_abs_err": errs[shape], "ms": time_ms(GK.gmm, sets),
               "plain_ms": time_ms(GR.gmm, sets, iters=10), **bnd,
               "library_ms": time_ms(lib, sets, iters=10)}
        log(f"[kernels] gmm_{shape} bf16 M={M} experts={busy} timing: kernel "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library "
            f"({lib_name}) {row['library_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
        rows.append(row)
        del sets
    return rows


def wkv_inputs(g, dtype, S, Bn=B, wide=False):
    """r, k, v (x 0.5) in ``dtype``; the model's decays w = exp(-exp(ww))
    with ww near its w0 of -2, or (``wide``) ww uniform in [-6, 2], so w
    from about 6e-4 to 0.9975, where a decay over a few dozen tokens
    underflows; a bonus u and a nonzero state, fp32."""
    H, P, f32 = *RWKV_SHAPE, torch.float32
    r, k, v = ((randn(g, Bn, S, H, P, dtype=f32) * 0.5).to(dtype)
               for _ in range(3))
    if wide:
        ww = torch.rand(Bn, S, H, P, generator=g, device=DEV) * 8.0 - 6.0
    else:
        ww = randn(g, Bn, S, H, P, dtype=f32) * 0.5 - 2.0
    return (r, k, v, torch.exp(-torch.exp(ww)),
            randn(g, H, P, dtype=f32) * 0.1,
            randn(g, Bn, H, P, P, dtype=f32) * 0.1)


def wkv_bound(S: int, es: int, Bn: int = B) -> dict:
    """Bytes: r, k, v (es each), w and y (fp32) per channel and token, the
    state in and out, u.  Operations: 4 P per channel and token (the
    read-out and the update), at the fp32 rate."""
    H, P = RWKV_SHAPE
    tok = Bn * S * H * P
    return bound(tok * (3 * es + 8) + 2 * Bn * H * P * P * 4 + H * P * 4,
                 4 * tok * P, torch.float32)


def check_and_time_wkv(g, WK, WR) -> list:
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        # S 1: the recurrence path; the rest the chunked path, at B 1 in
        # segments with a grid barrier between their two passes
        for S, Bn, wide in ((PROMPT, B, False), (1, B, False),
                            (37, B, False), (200, 1, False),
                            (PROMPT, 1, True)):
            r, k, v, w, u, s0 = wkv_inputs(g, dtype, S, Bn, wide)
            sk, sp = s0.clone(), s0.clone()
            what = (f"K4 {tag} B={Bn} S={S} H={RWKV_SHAPE[0]}"
                    + (" decays 6e-4..0.9975" if wide else ""))
            e = max(check(what + " y", WK.wkv(r, k, v, w, u, sk),
                          WR.wkv(r, k, v, w, u, sp), WKV_TOL[dtype]),
                    check(what + " state", sk, sp, WKV_TOL[dtype]))
            log(f"[kernels] {what} (nonzero state): max abs err {e:.3e}")
            if dtype == torch.bfloat16:
                errs[S, Bn] = max(errs.get((S, Bn), 0.0), e)
    rows, dt = [], torch.bfloat16
    # B 4: the model check's prefill and decode; B 1: every rwkv6 serve
    # admission (exact-length groups).  3, 8 or 24 input sets of 76, 20
    # or 2.7 MB, so that launches do not reuse L2
    for name, S, Bn, n_sets in (("wkv_prefill", PROMPT, B, 3),
                                ("wkv_prefill_b1", PROMPT, 1, 8),
                                ("wkv_decode", 1, B, 24)):
        sets = [wkv_inputs(g, dt, S, Bn) for _ in range(n_sets)]
        row = {"name": name, "route": "cuda", "source": WKV_SRC,
               "replaces": REPLACES["wkv"], "launches": 0,
               "max_abs_err": errs[S, Bn], "ms": time_ms(WK.wkv, sets),
               "plain_ms": time_ms(WR.wkv, sets, iters=3 if S > 1 else 10),
               **wkv_bound(S, 2, Bn), "library_ms": None}
        log(f"[kernels] {name} bf16 B={Bn} S={S} H={RWKV_SHAPE[0]} P=64 "
            f"timing: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f}"
            f" ms, no library call, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})")
        rows.append(row)
        del sets
    return rows


def ssd_inputs(g, dtype, S, Bn=B):
    """xh (x 0.5), a nonzero h0 and the model's log decays
    a_log = -softplus(dt_raw) (A = -1), fp32; B and C (x 0.5) in
    ``dtype`` as views of one wider row, as the model's conv output."""
    H, P, N = SSD_SHAPE
    f32 = torch.float32
    bc = (randn(g, Bn, S, 2 * N + 16, dtype=f32) * 0.5).to(dtype)
    return (randn(g, Bn, S, H, P, dtype=f32) * 0.5, bc[..., :N],
            bc[..., N:2 * N], -F.softplus(randn(g, Bn, S, H, dtype=f32)),
            randn(g, Bn, H, N, P, dtype=f32) * 0.5)


def ssd_bound(S: int, es: int, Bn: int = B) -> dict:
    """Bytes: x and y (fp32), B and C (es), a_log, the state in and out.
    Operations: the recurrence's 4 N P per token and head (the chunked
    form does about twice as many), at the TF32 tensor-core rate:
    the work is matrix products, which the card can run on its tensor
    cores (3xTF32 keeps fp32 accuracy at a third of that rate, and is
    still under the bytes)."""
    H, P, N = SSD_SHAPE
    tok = Bn * S * H
    return bound(tok * P * 8 + Bn * S * N * 2 * es + tok * 4
                 + 2 * Bn * H * N * P * 4, 4 * tok * N * P, "tf32")


def check_and_time_ssd(g, SK, SR) -> list:
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        for S, Bn in ((PROMPT, B), (300, B), (77, 1)):
            xh, Bm, Cm, a_log, h0 = ssd_inputs(g, dtype, S, Bn)
            hk, hp = h0.clone(), h0.clone()
            what = f"K5 {tag} B={Bn} S={S} H={SSD_SHAPE[0]}"
            e = max(check(what + " y", SK.ssd(xh, Bm, Cm, a_log, hk),
                          SR.ssd(xh, Bm, Cm, a_log, hp), SSD_TOL[dtype]),
                    check(what + " state", hk, hp, SSD_TOL[dtype]))
            log(f"[kernels] {what} (nonzero h0, chunk 128): max abs err "
                f"{e:.3e}")
            if dtype == torch.bfloat16:
                err = max(err, e)
    dt, rows = torch.bfloat16, []
    # B 4: the model check's prefill; B 1: every zamba2 serve admission
    # (exact-length groups); 3 or 8 input sets of 134 or 34 MB, so that
    # launches do not reuse L2
    for name, Bn, n_sets in (("ssd_prefill", B, 3), ("ssd_prefill_b1", 1, 8)):
        sets = [ssd_inputs(g, dt, PROMPT, Bn) for _ in range(n_sets)]
        row = {"name": name, "route": "cuda", "source": SSD_SRC,
               "replaces": REPLACES["ssd"], "launches": 0,
               "max_abs_err": err, "ms": time_ms(SK.ssd, sets),
               "plain_ms": time_ms(SR.ssd, sets, iters=10),
               **ssd_bound(PROMPT, 2, Bn), "library_ms": None}
        log(f"[kernels] {name} bf16 B={Bn} S={PROMPT} H={SSD_SHAPE[0]} "
            f"P=64 N=64 timing: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, no library call, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
        rows.append(row)
        del sets
    return rows


# --------------------------------------------------------------------- #
# 2b. K1 and K4 on two streams at once
# --------------------------------------------------------------------- #
TWO_STREAM_ROUNDS = 20


def check_two_streams(g, FK, FR, WK, WR) -> None:
    """Two calls of K1 (different inputs) on two streams with no ordering
    between them, and the same for K4 at B 1 (its segmented path, whose
    grid barrier counts the blocks of its own launch), each held against
    its plain version: K1's split tickets and K4's barrier counters are
    kept per (device, stream), so launches in flight at once never share
    them.  ``TWO_STREAM_ROUNDS`` rounds, queued behind a device sleep on
    each stream so the two launches can overlap."""
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    current = torch.cuda.current_stream()
    for what, tol, make, kern, plain, state in (
            ("K1 bf16 llama3-8b decode", TOL[torch.bfloat16],
             lambda: decode_inputs(g, torch.bfloat16, [PROMPT, 300, 77, 5],
                                   LLAMA_ATTN),
             FK.flash_decode, FR.decode_attention, None),
            ("K4 bf16 B=1 S=512 (segments)", WKV_TOL[torch.bfloat16],
             lambda: wkv_inputs(g, torch.bfloat16, PROMPT, 1),
             WK.wkv, WR.wkv, 5)):
        worst = 0.0
        for _ in range(TWO_STREAM_ROUNDS):
            ins = [make(), make()]
            plain_ins = [[x.clone() if i == state else x
                          for i, x in enumerate(a)] for a in ins]
            outs = [None, None]
            for j, st in enumerate(streams):
                st.wait_stream(current)
            for j, st in enumerate(streams):
                with torch.cuda.stream(st):
                    torch.cuda._sleep(2_000_000)
                    outs[j] = kern(*ins[j])
            for st in streams:
                current.wait_stream(st)
            for j in range(2):
                want = plain(*plain_ins[j])
                worst = max(worst, check(f"{what} stream {j}", outs[j],
                                         want, tol))
                if state is not None:
                    worst = max(worst, check(f"{what} stream {j} state",
                                             ins[j][state],
                                             plain_ins[j][state], tol))
        log(f"[kernels] {what}: {TWO_STREAM_ROUNDS} rounds of two calls on "
            f"two unordered streams, each against its plain version: max "
            f"abs err {worst:.3e}")


# --------------------------------------------------------------------- #
# 3-7. models
# --------------------------------------------------------------------- #
KERNEL_NAMES = ("flash_decode", "flash_prefill", "gmm", "wkv", "ssd")


@contextlib.contextmanager
def swapped(swaps):
    """Set each (module, name, function) of ``swaps`` for the block."""
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


def plain_versions(k):
    """Route the model's kernels (attention, expert matmuls, WKV, SSD) to
    their plain versions (on the card)."""
    return swapped(((k.FA, "prefill_attention", k.FR.prefill_attention),
                    (k.FA, "decode_attention", k.FR.decode_attention),
                    (k.G, "gmm", k.GR.gmm), (k.W, "wkv", k.WR.wkv),
                    (k.S, "ssd", k.SR.ssd)))


@contextlib.contextmanager
def routing(L, *, record: list = None, replay: list = None):
    """Append each MoE call's expert choices (T, k) to ``record``, or
    make the MoE calls take the choices of ``replay``, in order, with
    the gates from their own router logits at those experts."""
    route = L.route
    calls = iter(replay) if replay is not None else None

    def patched(p, xt, cfg):
        if calls is None:
            gates, ids = route(p, xt, cfg)
            record.append(ids)
            return gates, ids
        ids = next(calls)
        logits = xt.float() @ p["router"]
        return torch.softmax(logits.gather(1, ids), dim=-1), ids
    L.route = patched
    try:
        yield
    finally:
        L.route = route


def shadowed(k, found: list):
    """Every call of an attention, WKV or SSD kernel also runs its plain
    version on the same inputs (a copy of the state it replaces in
    place).  The two are compared on the device, attention elementwise at
    phase 2's TOL and the scans elementwise at SHADOW_BOUND, and
    ``found`` collects (kernel, elements outside, max abs err, largest
    error relative to |plain| for attention or to the bound's sum of
    |terms| for the scans) for the output and the state as device
    tensors, so a decode step stays free of host syncs.  The model goes
    on with the kernel's output."""
    def shadow(name, kern, plain, state_arg):
        def f(*a, **kw):
            pa = list(a)
            if state_arg is not None:
                pa[state_arg] = a[state_arg].clone()
            if name in SHADOW_BOUND:      # before the kernel moves the state
                tol, absolute = SHADOW_BOUND[name]
                ma = [x.abs() if i in absolute else x
                      for i, x in enumerate(a)]
                scales = [plain(*ma, **kw), ma[state_arg]]
            want = plain(*pa, **kw)
            got = kern(*a, **kw)
            pairs = [(got, want)]
            if state_arg is not None:
                pairs.append((a[state_arg], pa[state_arg]))
            for n, (x, y) in enumerate(pairs):
                err = (x.float() - y.float()).abs()
                if name in SHADOW_BOUND:
                    bad = (err > tol * scales[n]).sum()
                    rel = (err / scales[n].clamp_min(1e-30)).max()
                else:
                    atol, rtol = TOL[x.dtype]
                    bad = (err > atol + rtol * y.float().abs()).sum()
                    rel = err.max() / y.float().abs().max().clamp_min(1e-30)
                found.append((name, bad, err.max(), rel))
            return got
        return f
    # (ops module, function, kernel, plain version, argument updated in
    # place)
    swaps = ((k.FA, "prefill_attention", "flash_prefill",
              k.FR.prefill_attention, None),
             (k.FA, "decode_attention", "flash_decode",
              k.FR.decode_attention, None),
             (k.W, "wkv", "wkv", k.WR.wkv, 5),
             (k.S, "ssd", "ssd", k.SR.ssd, 4))
    return swapped([(mod, fn, shadow(name, getattr(mod, fn), plain, st))
                    for mod, fn, name, plain, st in swaps])


def perturbed_plain(k, rel: float = 1e-6):
    """The plain versions, moved off their rounding points as far as the
    kernels are: attention evaluated in fp32 and rounded once, at its
    output (the plain version rounds q x scale and the softmax weights to
    bf16 first; K1 and K2 scale the fp32 logits, and K2 rounds its
    unnormalised weights), and the WKV and SSD outputs multiplied by
    1 + ``rel`` x N(0, 1), a perturbation of the size of an fp32
    summation-order difference."""
    g = torch.Generator(device=DEV)
    g.manual_seed(1)

    def in_fp32(fn):
        def f(q, k_, v, *a, **kw):
            return fn(q.float(), k_.float(), v.float(), *a, **kw).to(v.dtype)
        return f

    def noisy(fn):
        def f(*a, **kw):
            y = fn(*a, **kw)
            return y * (1 + rel * torch.randn(y.shape, generator=g,
                                              device=y.device))
        return f
    FR = k.FR
    return swapped(((k.FA, "prefill_attention", in_fp32(FR.prefill_attention)),
                    (k.FA, "decode_attention", in_fp32(FR.decode_attention)),
                    (k.W, "wkv", noisy(k.WR.wkv)),
                    (k.S, "ssd", noisy(k.SR.ssd))))


def counts(k) -> dict:
    return {n: v for m in k.kernels for n, v in m.LAUNCHES.items()}


def reset_counts(k) -> None:
    for m in k.kernels:
        m.reset_launch_counts()


def expected_launches(cfg, steps: int, admissions: int,
                      long_admissions: int) -> dict:
    """Launches of each kernel for ``steps`` decode steps and
    ``admissions`` prefills, ``long_admissions`` of them longer than one
    token (a one-token mamba prefill takes the recurrent step, not K5)."""
    n, fam = cfg.num_layers, cfg.family
    out = dict.fromkeys(KERNEL_NAMES, 0)
    if fam in ("dense", "moe"):
        out.update(flash_prefill=n * admissions, flash_decode=n * steps)
        if fam == "moe":
            out["gmm"] = 3 * n * (steps + admissions)
    elif fam == "ssm":
        out["wkv"] = n * (steps + admissions)
    elif fam == "hybrid":
        groups = n // cfg.hybrid_attn_every
        out.update(flash_prefill=groups * admissions,
                   flash_decode=groups * steps, ssd=n * long_admissions)
    return out


def phase_model(cfg, params, k, lens) -> float:
    """Prefill of ``lens`` (right-padded for attention families; equal
    lengths for recurrent ones, whose state a pad token would enter) and
    DECODE_STEPS decode steps, through the kernels and through the plain
    versions; logits held at MODEL_RTOL.  Through the kernels, every
    decode step runs under ``set_sync_debug_mode("error")``: it must make
    no host sync.  (The plain grouped matmul reads the group sizes on the
    host.)

    MoE: a router near-tie lets the two runs' rounding pick different
    experts for a token, and in bf16 such flips cascade through the
    layers, so the held comparison replays the kernel run's expert
    choices in the plain run (its gates still come from its own router
    logits).  A second, free-running plain run counts the flipped
    (token, layer) choices and its logit difference is reported, not
    held.

    Recurrent families in bf16: the random full-width models amplify a
    one-ulp bf16 difference anywhere into logit differences of several
    per cent, so the free-running logit difference is held at MODEL_RTOL
    or FREE_RUN_K times that of a plain run moved off its rounding points
    as the kernels are (perturbed_plain), whichever is larger, and a
    shadow run holds every kernel call of the model against its plain
    version on the same inputs (attention at phase 2's tolerances, the
    scans at their error bounds).  The tight logit comparison is the
    fp32 run at full depth.  Returns the relative logit difference it
    held the kernels to."""
    M, L = k.M, k.L
    rng = np.random.default_rng(0)
    lens = np.asarray(lens)
    recurrent = cfg.family in ("ssm", "hybrid")
    if recurrent and len(set(lens.tolist())) != 1:
        raise ValueError(f"{cfg.name}: recurrent prefill rows need equal "
                         f"lengths, got {lens.tolist()}")
    S = int(lens.max()) if recurrent else int(-(-lens.max() // 8) * 8)
    toks = np.zeros((B, S), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    dev = torch.device(DEV)
    steps = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, DECODE_STEPS))
                             .astype(np.int32)).to(dev)
    toks_d = torch.from_numpy(toks).to(dev)
    last = torch.from_numpy((lens - 1).astype(np.int32)).to(dev)

    def run(check_sync: bool):
        """Logits of the prefill and each decode step, the wall time (ms,
        host clock after a synchronise) of each, and the host time each
        decode step took to queue its work (before the synchronise)."""
        cache = M.init_cache(cfg, B, MAX_LEN, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = M.prefill(params, cfg, toks_d, cache, last_pos=last)
        outs = [logits.float()]
        torch.cuda.synchronize()
        wall = [(time.perf_counter() - t) * 1e3]
        pos = torch.from_numpy(lens.astype(np.int32)).to(dev)
        enq = []
        for i in range(DECODE_STEPS):
            tok = steps[:, i:i + 1]
            t = time.perf_counter()
            if check_sync:
                torch.cuda.set_sync_debug_mode("error")
            try:
                logits, cache = M.decode_step(params, cfg, tok, cache, pos)
                outs.append(logits.float())
                pos = pos + 1
            finally:
                torch.cuda.set_sync_debug_mode(0)
            enq.append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t) * 1e3)
        return outs, wall, enq

    run(True)                               # first calls: allocator, cuBLAS
    routes_k, routes_p = [], []
    reset_counts(k)
    with routing(L, record=routes_k):
        got, wall, enq = run(True)
    n_kern = counts(k)
    with plain_versions(k), routing(L, replay=routes_k):
        want, wall_plain, _ = run(False)
    n_layers, moe = cfg.num_layers, cfg.family == "moe"
    expect = expected_launches(cfg, DECODE_STEPS, 1, int(S > 1))
    if n_kern != expect or counts(k) != n_kern:
        raise AssertionError(f"model phase launches {n_kern} (expected "
                             f"{expect}) -> {counts(k)}")
    tag = "bf16" if cfg.torch_dtype == torch.bfloat16 else "fp32"
    rtol = MODEL_RTOL[cfg.torch_dtype]

    def compare(what, outs, ref_outs=None):
        worst = 0.0
        for i, (a, b) in enumerate(zip(ref_outs or got, outs)):
            a, b = a[:, :cfg.vocab_size], b[:, :cfg.vocab_size]
            if a.shape != (B, cfg.vocab_size) or not torch.isfinite(a).all():
                raise AssertionError(f"model: logits {i} bad shape/"
                                     "non-finite")
            rel = float((a - b).abs().max() / b.abs().max())
            worst = max(worst, rel)
            agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
            log(f"[{cfg.name}] {what} {'prefill' if i == 0 else f'decode {i}'}"
                f": rel err {rel:.3e}, greedy agreement {agree:.2f}")
        return worst

    worst = compare("kernels vs plain" + (", same routing" if moe else ""),
                    want)
    if moe:
        with plain_versions(k), routing(L, record=routes_p):
            free, _, _ = run(False)
        flips = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1)
                        .sum()) for a, b in zip(routes_k, routes_p))
        total = sum(a.shape[0] for a in routes_k)
        free_worst = compare("kernels vs plain, own routing", free)
        log(f"[{cfg.name}] routing: {flips} of {total} (token, layer) expert "
            "choices differ between the kernel run and a free-running "
            f"plain run, whose logits differ by rel err {free_worst:.3e} "
            "(reported, not held)")
    held = "logits"
    if recurrent and cfg.torch_dtype == torch.bfloat16:
        with perturbed_plain(k):
            moved, _, _ = run(False)
        base = compare("plain off its rounding points vs plain", want, moved)
        found = []
        with shadowed(k, found):
            run(True)
        torch.cuda.synchronize()
        per = {}
        for name, bad, err, rel in found:
            n, b, e, r = per.get(name, (0, 0, 0.0, 0.0))
            per[name] = (n + 1, b + int(bad), max(e, float(err)),
                         max(r, float(rel)))
        limit = max(rtol, FREE_RUN_K * base)
        log(f"[{cfg.name}] free-running kernels vs plain rel err "
            f"{worst:.3e}, plain off its rounding points vs plain "
            f"{base:.3e} (held at max({rtol}, {FREE_RUN_K} x that) = "
            f"{limit:.3e}); "
            "shadow run, each kernel call against its plain version on the "
            "same inputs: " + ", ".join(
                f"{name} {n} outputs, max abs err {e:.3e} (at most {r:.3e} "
                + ("of the sum of |terms|)" if name in SHADOW_BOUND
                   else "of the output's max |plain|)")
                for name, (n, b, e, r) in per.items()))
        bad = {name: b for name, (n, b, e, r) in per.items() if b}
        if bad or set(per) != {n for n, v in n_kern.items() if v}:
            raise AssertionError(f"{cfg.name}: shadow comparison: elements "
                                 f"outside tolerance {bad}, kernels "
                                 f"{sorted(per)} vs launched {n_kern}")
        if not worst <= limit:
            raise AssertionError(f"{cfg.name}: free-running rel err "
                                 f"{worst:.3e} > {limit:.3e}")
        held = f"at {limit:.3e}, and each kernel call (shadow)"
        rtol = limit
    elif worst > rtol:
        raise AssertionError(f"{cfg.name}: rel err {worst:.3e} > {rtol}")
    window = f", window {cfg.sliding_window} (ring of " \
        f"{min(MAX_LEN, cfg.sliding_window)} slots)" \
        if cfg.sliding_window else ""
    log(f"[{cfg.name}] {n_layers} layers {tag}{window}: prefill S={S} rows "
        f"{lens.tolist()} + {DECODE_STEPS} decode steps (no host sync "
        f"through the kernels), kernels vs plain "
        f"{'(same routing) ' if moe else ''}"
        f"versions max rel err {worst:.3e} ("
        + (f"held at {rtol}" if held == "logits" else f"held {held}")
        + f"), launches {n_kern}")
    for name, w in (("kernels", wall), ("plain versions", wall_plain)):
        log(f"[{cfg.name}] wall with {name}: prefill {w[0]:.2f} ms, decode "
            f"step mean {float(np.mean(w[1:])):.2f} ms "
            f"(min {min(w[1:]):.2f}, max {max(w[1:]):.2f})")
    log(f"[{cfg.name}] host time to queue a decode step (kernels): mean "
        f"{float(np.mean(enq)):.2f} ms of {float(np.mean(wall[1:])):.2f} ms "
        "wall")
    return rtol


# the kernels JSON rows that each family's serving run supplies launches
# to: (row, kernel counter, "prefill" or "decode" launches)
SERVE_ROWS = {
    "dense": [("flash_decode", "flash_decode", "decode"),
              ("flash_prefill", "flash_prefill", "prefill")],
    "moe": [("flash_decode_d64", "flash_decode", "decode"),
            ("flash_prefill_d64", "flash_prefill", "prefill"),
            ("gmm_prefill", "gmm", "prefill"),
            ("gmm_decode", "gmm", "decode")],
    "ssm": [("wkv_prefill", "wkv", "prefill"),
            ("wkv_prefill_b1", "wkv", "prefill"),
            ("wkv_decode", "wkv", "decode")],
    "hybrid": [("flash_decode_d112", "flash_decode", "decode"),
               ("flash_prefill_d112", "flash_prefill", "prefill"),
               ("ssd_prefill", "ssd", "prefill"),
               ("ssd_prefill_b1", "ssd", "prefill")],
}


def phase_serve(cfg, params, k) -> dict:
    """Serve N_REQUESTS Poisson requests; returns the launches of each
    kernel row (those inside admissions and the decode steps' apart)."""
    from repro_torch.serving.engine import requests_from_trace
    from repro_torch.serving.workload import make_trace
    trace = make_trace("poisson", RATE, N_REQUESTS, seed=0)
    reqs = requests_from_trace(trace, cfg.vocab_size,
                               max_prompt=MAX_LEN // 2, max_new=MAX_NEW)
    engine, reqs, wall, _, launches, calls = serve_colocated(
        cfg, params, k, "serve", reqs=reqs)
    stats = engine.stats
    if stats.completed != len(reqs):
        raise AssertionError(f"completed {stats.completed}/{len(reqs)}")
    in_prefill = {name: sum(c[2][name] for c in calls)
                  for name in KERNEL_NAMES}
    prefill_lens = [n for n, _, _ in calls]
    steps, adm = stats.decode_steps, stats.prefill_batches
    long_adm = sum(1 for n in prefill_lens if n > 1)
    expect = expected_launches(cfg, steps, adm, long_adm)
    expect_in_prefill = expected_launches(cfg, 0, adm, long_adm)
    rows = SERVE_ROWS[cfg.family]
    if launches != expect or in_prefill != expect_in_prefill \
            or len(prefill_lens) != adm \
            or min(launches[c] for _, c, _ in rows) == 0:
        raise AssertionError(f"serve launches {launches} ({in_prefill} in "
                             f"admissions of lengths {prefill_lens}) vs "
                             f"expected {expect} ({expect_in_prefill})")
    s = stats.summary()
    decode_tokens = sum(len(r.output) - 1 for r in reqs)
    log(f"[serve] {cfg.name} full width {cfg.dtype}, slots {B}, max_len "
        f"{MAX_LEN}: {len(reqs)} requests (prompts "
        f"{[len(r.prompt) for r in reqs]}, new "
        f"{[r.max_new_tokens for r in reqs]})")
    log(f"[serve] {cfg.name}: mean TTFT {s['mean_ttft']:.4f} s, mean TPOT "
        f"{s['mean_tpot']:.4f} s, decode tokens/s "
        f"{decode_tokens / wall:.1f} ({decode_tokens} decode tokens in "
        f"{wall:.3f} s wall), {steps} decode steps, {adm} prefill batches "
        f"of lengths {prefill_lens}, launches {launches} ({in_prefill} of "
        "them in admissions)")
    return {row: (in_prefill[c] if where == "prefill"
                  else launches[c] - in_prefill[c])
            for row, c, where in rows}


# --------------------------------------------------------------------- #
# paged: paged KV, chunked admission and the prefill -> decode handoff
# --------------------------------------------------------------------- #
def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip() \
        .splitlines()[0]


def paged_requests(cfg):
    """The serve phase's 8 trace requests (prompts cut to 512), all
    arriving at 0 with 32 new tokens, priorities 0 / 1 alternating."""
    from repro_torch.serving.engine import requests_from_trace
    from repro_torch.serving.workload import make_trace
    reqs = requests_from_trace(make_trace("poisson", RATE, N_REQUESTS, seed=0),
                               cfg.vocab_size, max_prompt=PROMPT,
                               max_new=MAX_NEW, time_scale=0.0)
    for i, r in enumerate(reqs):
        r.max_new_tokens, r.priority = MAX_NEW, i % 2
    return reqs


def no_sync_steps(engine) -> None:
    """Run each of ``engine``'s decode steps (decode, sampling and
    termination) under set_sync_debug_mode("error"): a host sync raises."""
    fused = engine._step_fused

    def guarded():
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fused()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    engine._step_fused = guarded


def check_completed(what, reqs, cfg) -> None:
    for r in reqs:
        if len(r.output) != r.max_new_tokens or r.finished < 0 \
                or not all(0 <= x < cfg.vocab_size for x in r.output):
            raise AssertionError(f"{what}: request {r.rid}: {len(r.output)} "
                                 f"tokens of {r.max_new_tokens}")


def engine_numbers(s, reqs, wall, adm_wall=None,
                   what="admission") -> str:
    """TTFT, TPOT and decode tokens/s of one run from its stats summary
    ``s`` (``EngineStats.summary()``); with ``adm_wall`` (the wall of
    each admission, or of each handoff of a prefill -> decode pair)
    their mean and the decode step's: the rest of the run's wall over
    its decode steps."""
    decode_tokens = sum(len(r.output) - 1 for r in reqs)
    out = (f"TTFT {s['mean_ttft']:.4f} s, TPOT {s['mean_tpot']:.4f} s, "
           f"{decode_tokens / wall:.1f} decode tok/s ({s['decode_steps']} "
           f"steps, {wall:.3f} s wall)")
    if adm_wall is not None:
        steps = max(s["decode_steps"], 1)
        adm = 1e3 * sum(adm_wall) / max(len(adm_wall), 1)
        out += (f", {what} {adm:.2f} ms x {len(adm_wall)}, decode step "
                f"{1e3 * (wall - sum(adm_wall)) / steps:.2f} ms")
    return out


def serve_colocated(cfg, params, k, label, hook=None, reqs=None, **knobs):
    """One engine (4 slots, max_len 1024, ``knobs``) serving ``reqs``
    (default: paged_requests), its decode steps under
    set_sync_debug_mode("error"), the launch counters zeroed just before
    the run; ``hook(engine)`` is called before it.  Every request must
    complete with its token count.  Returns (engine, requests, wall,
    admission walls, launches, prefill calls as (length, offset,
    launches in the call))."""
    from repro_torch.serving.engine import ServingEngine
    M = k.M
    reqs = paged_requests(cfg) if reqs is None else reqs
    engine = ServingEngine(cfg, params, slots=B, max_len=MAX_LEN, device=DEV,
                           **knobs)
    engine.warmup()
    no_sync_steps(engine)
    if hook is not None:
        hook(engine)
    calls, adm_wall = [], []
    prefill, admit_group = M.prefill, engine._admit_group

    def counted_prefill(params_, cfg_, tokens, *a, **kw):
        before = counts(k)
        out = prefill(params_, cfg_, tokens, *a, **kw)
        after = counts(k)
        calls.append((tokens.shape[1], kw.get("offset"),
                      {n: after[n] - before[n] for n in after}))
        return out

    def timed_admit(group, now):
        t = time.perf_counter()
        admit_group(group, now)
        adm_wall.append(time.perf_counter() - t)
    M.prefill, engine._admit_group = counted_prefill, timed_admit
    reset_counts(k)
    try:
        t = time.perf_counter()
        engine.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        M.prefill = prefill
    check_completed(f"{cfg.name} {label}", reqs, cfg)
    return engine, reqs, wall, adm_wall, counts(k), calls


def watch_round_trip(engine, M, cfg) -> list:
    """Check one session's park -> spill -> prefetch -> activate round
    trip: its slot's state at the park (exported) against the slot after
    the activation, every cache leaf with torch.equal.  Returns the list
    the rid of the checked session is appended to."""
    snap, done = {}, []
    park, activate = engine._park_slot, engine._activate_parked

    def park_hook(slot, t):
        if not snap and not done:
            p = int(engine.pos[slot])
            snap[engine.active[slot].rid] = (M.export_kv(cfg, engine.cache,
                                                         slot, p), p)
        park(slot, t)

    def activate_hook(rid, slot, t):
        spilled = engine._paged.resident[rid].tier == "host"
        activate(rid, slot, t)
        if rid in snap:
            state, p = snap.pop(rid)
            if not spilled:
                return          # parked in the pool only: watch the next
            back = M.export_kv(cfg, engine.cache, slot, p)
            leaves = list(zip(M.state_leaves(state), M.state_leaves(back)))
            if not leaves or not all(torch.equal(a, b) for a, b in leaves):
                raise AssertionError(f"rid {rid}: the park -> spill -> "
                                     "prefetch -> activate round trip "
                                     "changed the slot's state")
            done.append(rid)
    engine._park_slot, engine._activate_parked = park_hook, activate_hook
    return done


def serve_pd(cfg, params, reqs, streamed, check_state=False):
    """The reference spec's prefill -> decode loop (the port's
    ``serving.engine.serve_pd``) on a pair of engines on the card: serial
    or streamed in 128-token chunks.  With ``check_state`` every landed
    state is compared with its handoff, bit for bit.  Returns (decode
    engine, wall, the wall of each handoff, wire bytes, shards)."""
    from repro_torch.serving.engine import ServingEngine, serve_pd as loop
    from repro_torch.models import model as M
    pre = ServingEngine(cfg, params, slots=B, max_len=MAX_LEN, device=DEV,
                        prefill_chunk=PREFILL_CHUNK if streamed else None)
    dec = ServingEngine(cfg, params, slots=B, max_len=MAX_LEN, device=DEV)
    pre.warmup()
    dec.warmup()
    no_sync_steps(dec)

    def landed(req, h):
        slot = next(s for s, r in enumerate(dec.active) if r is req)
        got = M.export_kv(cfg, dec.cache, slot, h["pos"])
        pairs = list(zip(M.state_leaves(h["state"]), M.state_leaves(got)))
        if not pairs or not all(torch.equal(a, b) for a, b in pairs):
            raise AssertionError(f"rid {req.rid}: the handoff landed "
                                 "changed")

    t0 = time.perf_counter()
    wire, shards, walls = loop(pre, dec, reqs, streamed,
                               on_landed=landed if check_state else None)
    torch.cuda.synchronize()
    return dec, time.perf_counter() - t0, walls, wire, shards


def check_chunk_calls(cfg, calls, admissions, chunk) -> int:
    """Every admission of a chunked engine is ceil(S / chunk) prefill calls
    at offsets 0, chunk, 2 chunk, ..., each launching K2 once per layer.
    Returns the K2 launches of the calls at an offset > 0."""
    groups = []
    for n, off, launched in calls:
        if not off:
            groups.append([])
        groups[-1].append((n, off or 0, launched))
    if len(groups) != admissions:
        raise AssertionError(f"{admissions} admissions, prefill calls "
                             f"{[(n, o) for n, o, _ in calls]}")
    at_offset = 0
    for g_ in groups:
        S = g_[-1][1] + g_[-1][0]
        want = [(min(chunk, S - o), o) for o in range(0, S, chunk)] \
            if S > chunk else [(S, 0)]
        if [(n, o) for n, o, _ in g_] != want:
            raise AssertionError(f"admission of {S} tokens: chunks "
                                 f"{[(n, o) for n, o, _ in g_]} != {want}")
        for n, o, launched in g_:
            if launched["flash_prefill"] != cfg.num_layers:
                raise AssertionError(f"chunk ({n}, {o}): K2 launched "
                                     f"{launched['flash_prefill']} times")
            if o > 0:
                at_offset += launched["flash_prefill"]
    if not at_offset:
        raise AssertionError("no chunk ran at an offset > 0")
    return at_offset


def phase_paged_llama(cfg, params, k):
    """llama3-8b (bf16, full width): a paged engine that preempts, spills
    and prefetches, a chunked-admission engine and the two prefill ->
    decode pairs serve paged_requests; a 4 x 512 chunked prefill against
    the whole one.  Returns ({"flash_prefill_chunk": K2 launches at an
    offset > 0 in the chunked engine's run}, {"fixed": the fixed engine's
    greedy tokens, "serial pd" / "streamed pd": the pair's (wire bytes,
    shards)}), what the "cluster" phase holds its runs to."""
    M, name = k.M, card()
    fixed = serve_colocated(cfg, params, k, "fixed")
    ref = {"fixed": [r.output for r in fixed[1]]}
    lines = {"fixed": engine_numbers(fixed[0].stats.summary(), fixed[1], fixed[2],
                                     fixed[3])}

    # paged: 48 blocks of 64 tokens for sessions of up to 544 tokens
    watched = []
    eng, reqs, wall, adm, launched, _ = serve_colocated(
        cfg, params, k, "paged",
        hook=lambda e: watched.append(watch_round_trip(e, M, cfg)),
        kv_block_tokens=KV_BLOCK, kv_pool_blocks=KV_POOL)
    pk = eng._paged
    if min(pk.preemptions, pk.spills, pk.prefetches) < 1 or not watched[-1] \
            or pk.pool.free != pk.pool.n_blocks or not pk.pool.check():
        raise AssertionError(f"paged: preemptions {pk.preemptions}, spills "
                             f"{pk.spills}, prefetches {pk.prefetches}, "
                             f"round trips checked {watched}, free blocks "
                             f"{pk.pool.free} of {pk.pool.n_blocks}")
    expect = expected_launches(cfg, eng.stats.decode_steps,
                               eng.stats.prefill_batches, 0)
    if launched != expect:
        raise AssertionError(f"paged launches {launched} vs {expect}")
    lines["paged"] = engine_numbers(eng.stats.summary(), reqs, wall, adm) + (
        f", {pk.preemptions} preemptions, {pk.spills} spills, "
        f"{pk.prefetches} prefetches, round trip of rid {watched[-1][0]} "
        "bitwise")
    pool_mib = KV_POOL * M.kv_block_bytes(cfg, KV_BLOCK) / 2**20
    log(f"[paged] {cfg.name} on {name}, paged engine ({KV_POOL} blocks of "
        f"{KV_BLOCK} tokens = {pool_mib:.0f} MiB pool, {B} slots): "
        f"{lines['paged']}, launches {launched}")

    # chunked admission, 128-token chunks
    eng, reqs, wall, adm, launched, calls = serve_colocated(
        cfg, params, k, "chunked", prefill_chunk=PREFILL_CHUNK)
    at_offset = check_chunk_calls(cfg, calls, eng.stats.prefill_batches,
                                  PREFILL_CHUNK)
    expect = expected_launches(cfg, eng.stats.decode_steps, len(calls), 0)
    if launched != expect:
        raise AssertionError(f"chunked launches {launched} vs {expect}")
    lines["chunked"] = engine_numbers(eng.stats.summary(), reqs, wall, adm)
    log(f"[paged] {cfg.name} on {name}, chunked admission "
        f"({PREFILL_CHUNK}-token chunks): {lines['chunked']}; {len(calls)} "
        "prefill calls "
        f"(length, offset) {[(n, o) for n, o, _ in calls]}, K2 = "
        f"{cfg.num_layers} per chunk ({at_offset} at q_offset > 0)")

    # a 4 x 512 chunked prefill against the whole one
    rng = np.random.default_rng(0)
    lens = [PROMPT, 300, 77, 5]
    toks = np.zeros((B, PROMPT), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    toks_d = torch.from_numpy(toks).to(DEV)
    last = torch.tensor([n - 1 for n in lens], dtype=torch.int32, device=DEV)
    outs, walls = [], []
    for chunk in (None, PREFILL_CHUNK, None, PREFILL_CHUNK):
        cache = M.init_cache(cfg, B, MAX_LEN, device=DEV)
        torch.cuda.synchronize()
        t = time.perf_counter()
        if chunk is None:
            lg, _ = M.prefill(params, cfg, toks_d, cache, last_pos=last)
        else:
            lg, _ = M.prefill_chunked(params, cfg, toks_d, cache,
                                      chunk_size=chunk, last_pos=last)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t))
        outs.append(lg.float()[:, :cfg.vocab_size])
        del cache
    rel = float((outs[1] - outs[0]).abs().max() / outs[0].abs().max())
    if not torch.isfinite(outs[1]).all() or \
            rel > MODEL_RTOL[torch.bfloat16]:
        raise AssertionError(f"chunked prefill rel err {rel:.3e}")
    log(f"[paged] {cfg.name} on {name}, 4 x 512 prefill (rows {lens}), "
        f"chunks of {PREFILL_CHUNK} vs whole: logits rel err {rel:.3e} (held at "
        f"{MODEL_RTOL[torch.bfloat16]}), wall whole {walls[0]:.2f} / "
        f"{walls[2]:.2f} ms, chunked {walls[1]:.2f} / {walls[3]:.2f} ms")

    for streamed in (False, True):
        reqs = paged_requests(cfg)
        dec, wall, walls, wire, shards = serve_pd(cfg, params, reqs,
                                                  streamed)
        kind = "streamed pd" if streamed else "serial pd"
        check_completed(f"{cfg.name} {kind}", reqs, cfg)
        ref[kind] = (wire, shards)
        lines[kind] = engine_numbers(dec.stats.summary(), reqs, wall, walls,
                                     "handoff") + (
            f", {wire / 2**20:.1f} MiB on the wire"
            + (f" in {shards} shards" if streamed else ""))
    log(f"[paged] {cfg.name} on {name}: " + "; ".join(
        f"{kind}: {line}" for kind, line in lines.items()))
    return {"flash_prefill_chunk": at_offset}, ref


def phase_paged_identity(cfg, k) -> None:
    """llama3-8b at full width in fp32 with IDENTITY_LAYERS layers: the
    paged, chunked and both prefill -> decode runs give the fixed-slot
    engine's greedy tokens."""
    small = dataclasses.replace(cfg, num_layers=IDENTITY_LAYERS,
                                dtype="float32")
    params = init_params(k.M, small)
    outs = {}
    for label, knobs in (("fixed", {}),
                         ("paged", dict(kv_block_tokens=KV_BLOCK,
                                        kv_pool_blocks=KV_POOL)),
                         ("chunked", dict(prefill_chunk=PREFILL_CHUNK))):
        reqs = serve_colocated(small, params, k, label, **knobs)[1]
        outs[label] = [r.output for r in reqs]
    for streamed in (False, True):
        reqs = paged_requests(small)
        serve_pd(small, params, reqs, streamed)
        outs["streamed pd" if streamed else "serial pd"] = \
            [r.output for r in reqs]
    diff = {label: [i for i, (a, b) in enumerate(zip(o, outs["fixed"]))
                    if a != b] for label, o in outs.items()}
    if any(diff.values()):
        raise AssertionError(f"greedy tokens differ from the fixed engine's "
                             f"(request indices): {diff}")
    log(f"[paged] {small.name} fp32, {IDENTITY_LAYERS} layers: paged, "
        "chunked, serial and streamed prefill -> decode runs give the "
        f"fixed engine's greedy tokens ({len(outs['fixed'])} requests x "
        f"{MAX_NEW} tokens)")
    free(params)


def phase_paged_handoff(cfg, params) -> None:
    """gpt-oss-20b (bf16): the serial prefill -> decode pair; each session
    ships its whole ring, and lands bit for bit."""
    reqs = paged_requests(cfg)
    dec, wall, walls, wire, _ = serve_pd(cfg, params, reqs, False,
                                         check_state=True)
    check_completed(f"{cfg.name} serial pd", reqs, cfg)
    log(f"[paged] {cfg.name} on {card()}: serial pd: "
        f"{engine_numbers(dec.stats.summary(), reqs, wall, walls, 'handoff')}, "
        f"{wire / 2**20:.1f} MiB on "
        f"the wire ({wire // len(reqs)} bytes a session: the whole ring), "
        "every landed state bitwise equal to its handoff")


def phase_paged_recurrent(cfg, params, k, limit) -> None:
    """rwkv6-3b / zamba2-7b (bf16): a 4 x 512 prefill in 128-token chunks,
    each from the state the one before left, against one whole prefill:
    logits and every final state leaf held at ``limit`` (what phase_model
    held the model to), K4 / K5 (and K2) launched once per layer per
    chunk."""
    M = k.M
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, PROMPT))
                            .astype(np.int32)).to(DEV)
    runs = []
    for chunk in (None, PREFILL_CHUNK) * 2:     # the second pair is warm
        cache = M.init_cache(cfg, B, PROMPT, device=DEV)
        reset_counts(k)
        torch.cuda.synchronize()
        t = time.perf_counter()
        if chunk is None:
            lg, cache = M.prefill(params, cfg, toks, cache)
        else:
            lg, cache = M.prefill_chunked(params, cfg, toks, cache,
                                          chunk_size=chunk)
        torch.cuda.synchronize()
        runs.append((lg.float()[:, :cfg.vocab_size], cache, counts(k),
                     1e3 * (time.perf_counter() - t)))
    (lw, cw, nw, tw), (lc, cc, nc, tc) = runs[:2]
    n = PROMPT // PREFILL_CHUNK
    if nc != {name: v * n for name, v in nw.items()} or not any(nw.values()):
        raise AssertionError(f"chunked launches {nc}, whole {nw}")
    errs = {"logits": float((lc - lw).abs().max() / lw.abs().max())}
    for key, leaves in cw.items():
        for leaf, a in leaves.items():
            b = cc[key][leaf]
            errs[f"{key}.{leaf}"] = float((b.float() - a.float()).abs().max()
                                          / a.float().abs().max())
    bad = {w: e for w, e in errs.items() if not e <= limit}
    if bad or not torch.isfinite(lc).all():
        raise AssertionError(f"{cfg.name}: chunked vs whole {bad} > {limit}")
    log(f"[paged] {cfg.name} on {card()}, 4 x {PROMPT} prefill in {n} "
        f"chunks of {PREFILL_CHUNK} from the carried state vs whole: rel err "
        + ", ".join(f"{w} {e:.3e}" for w, e in errs.items())
        + f" (held at {limit:.3e}); launches {nc} = {n} x {nw}; wall whole "
        f"{tw:.2f} / {runs[2][3]:.2f} ms, chunked {tc:.2f} / {runs[3][3]:.2f}"
        " ms (first / second call)")


# --------------------------------------------------------------------- #
# cluster: the deployment spec's DES and its engines on the card
# --------------------------------------------------------------------- #
CLUSTER_ARCH = "llama3_8b"
CLUSTER_GROUPS = [["h100", "rtxpro6000"], ["a100", "l40s"]]
CLUSTER_ANNEAL = 300                  # planner effort per group (the DES)
DES_REQUESTS = 200
ELASTIC_SPECS = ("h100", "a100", "l40s")
# a launched engine may allocate its cache and this much besides (its
# decode cursors); a copy of llama3-8b's weights would be 15 GiB
ENGINE_SLACK = 16 * 2 ** 20
# the streamed pairs: 8 chunks of 128 tokens (the "paged" phase's pair,
# hence its wire bytes and shards), and 4 of 256 under a flaky link whose
# seeded draws, on these 8 requests, give 34 retransmits and 3 corrupted
# shards at 32 layers, 7 and 1 at IDENTITY_LAYERS
PLAIN_CHUNKS, FLAKY_CHUNKS = 8, 4
FLAKY_SEED, FLAKY = 10, dict(p=0.1, max_retries=1)
# the crash run's schedule, as fractions of the drain run's wall: a
# checkpoint poll every 0.15, group 0 lost at 0.4 and back at 0.6
CRASH_AT, RECOVER_AT, CKPT_EVERY = 0.4, 0.6, 0.15
CKPT_DIRTY = 8                        # tokens between a session's copies


def cluster_spec(**kw):
    from repro_torch.serving.spec import DeploymentSpec
    return DeploymentSpec(groups=CLUSTER_GROUPS, arch=CLUSTER_ARCH,
                          engine={"slots": B, "max_len": MAX_LEN}, **kw)


def launch(spec, cfg, params):
    """``spec.compile().launch(cfg, params)`` on the card, every engine's
    decode steps under set_sync_debug_mode("error")."""
    ld = spec.compile().launch(cfg, params, device=DEV)
    for eng in ld.engines:
        no_sync_steps(eng)
    return ld


def serve_launched(ld, cfg, k):
    """Serve paged_requests through the launched deployment ``ld``.
    Returns (requests, run stats, wall, the run's launches: the counters'
    growth over it, so that the phase's totals keep counting)."""
    reqs = paged_requests(cfg)
    before = counts(k)
    t = time.perf_counter()
    out = ld.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return reqs, out, wall, {n: v - before[n] for n, v in counts(k).items()}


def check_pool_launches(cfg, what, out, launched) -> None:
    """A pool run launches K1 once per layer per decode step and K2 once
    per layer per admission, summed over its engines."""
    e = out["engine"]
    expect = expected_launches(cfg, e["decode_steps"], e["prefill_batches"],
                               0)
    if launched != expect:
        raise AssertionError(f"cluster {what}: launches {launched} vs "
                             f"{expect}")


def check_pair_launches(cfg, what, out, launched) -> None:
    """A prefill -> decode pair launches K1 once per layer per decode
    step (the decode engine's), and K2 in its prefills."""
    steps = out["engine"]["decode_steps"]
    if launched["flash_decode"] != cfg.num_layers * steps or \
            not launched["flash_prefill"]:
        raise AssertionError(f"cluster {what}: launches {launched}, "
                             f"{steps} decode steps")


def cluster_pool(cfg, params, k):
    """The colocated pool of CLUSTER_GROUPS: launched (the second engine
    must cost its cache only, no weight), group 0 drained at t 0 while its
    sessions decode.  Returns (greedy tokens, wall, log line)."""
    M = k.M
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    ld = launch(cluster_spec(), cfg, params)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - mem0
    caches = sum(M.kv_state_bytes(e.cache) for e in ld.engines)
    if grown > caches + ENGINE_SLACK or \
            any(e.params is not params for e in ld.engines):
        raise AssertionError(f"cluster pool: launching {len(ld.engines)} "
                             f"engines allocated {grown} bytes, their "
                             f"caches {caches}")
    ld.scale(remove=[0], at=0.0)
    reqs, out, wall, launched = serve_launched(ld, cfg, k)
    check_completed(f"{cfg.name} cluster drain", reqs, cfg)
    check_pool_launches(cfg, "drain", out, launched)
    if out["migrations"] < 1 or out["routable"] != [False, True]:
        raise AssertionError(f"cluster drain: {out['migrations']} "
                             f"migrations, routable {out['routable']}")
    line = (f"pool of {len(ld.engines)} engines ({B} slots each) on one "
            f"set of weights (memory_allocated grew by {grown / 2**20:.1f} "
            f"MiB at launch, the caches {caches / 2**20:.1f} MiB), group 0 "
            f"drained at t 0: {out['migrations']} sessions migrated, "
            f"{out['wire_bytes'] / 2**20:.1f} MiB moved, "
            f"{engine_numbers(out['engine'], reqs, wall)}, launches "
            f"{launched}")
    return [r.output for r in reqs], wall, line


def cluster_crash(cfg, params, k, span):
    """The pool with group 0 crashed at CRASH_AT x ``span`` and back at
    RECOVER_AT x ``span``, sessions checkpointed to the host every
    CKPT_EVERY x ``span``: every lost session is restored from its
    checkpoint and every request completes.  Returns (greedy tokens, wall,
    log line)."""
    from repro_torch.serving.faults import FaultPlan, RecoveryConfig
    plan = FaultPlan(seed=0).crash(CRASH_AT * span, group=0,
                                   recover_at=RECOVER_AT * span)
    rec = RecoveryConfig(interval=CKPT_EVERY * span,
                         min_dirty_tokens=CKPT_DIRTY)
    ld = launch(cluster_spec(), cfg, params).inject(plan, rec)
    reqs, out, wall, launched = serve_launched(ld, cfg, k)
    check_completed(f"{cfg.name} cluster crash", reqs, cfg)
    check_pool_launches(cfg, "crash", out, launched)
    if out["lost_sessions"] < 1 or \
            out["recovered_sessions"] != out["lost_sessions"]:
        raise AssertionError(f"cluster crash: lost {out['lost_sessions']}, "
                             f"recovered {out['recovered_sessions']}")
    store = ld._store
    line = (f"crash of group 0 at {CRASH_AT * span:.3f} s (back at "
            f"{RECOVER_AT * span:.3f} s), checkpoints every "
            f"{CKPT_EVERY * span:.3f} s: {out['lost_sessions']} sessions "
            f"lost, {out['recovered_sessions']} restored, "
            f"{store.checkpoints} checkpoints, stored_bytes "
            f"{store.stored_bytes / 2**20:.1f} MiB, "
            f"{engine_numbers(out['engine'], reqs, wall)}, launches "
            f"{launched}")
    return [r.output for r in reqs], wall, line


def cluster_pairs(cfg, params, k, ref=None):
    """The serial pair, the streamed pair in PLAIN_CHUNKS chunks (their
    wire bytes and shards those of ``ref``, the "paged" phase's pairs)
    and the streamed pair in FLAKY_CHUNKS chunks under a flaky link that
    retransmits and corrupts shards (each corrupted handoff re-prefilled
    on the decode engine).  Returns ({kind: greedy tokens}, {kind: wall},
    log lines)."""
    from repro_torch.serving.faults import FaultPlan
    tokens, walls, lines = {}, {}, []
    for kind, chunks in (("serial pd", 1), ("streamed pd", PLAIN_CHUNKS),
                         ("flaky pd", FLAKY_CHUNKS)):
        ld = launch(cluster_spec(pd=True, kv_chunks=chunks), cfg, params)
        if kind == "flaky pd":
            ld.inject(FaultPlan(seed=FLAKY_SEED).flaky_link(0, 1, **FLAKY))
        reqs, out, wall, launched = serve_launched(ld, cfg, k)
        check_completed(f"{cfg.name} cluster {kind}", reqs, cfg)
        check_pair_launches(cfg, kind, out, launched)
        wire, shards = out["wire_bytes"], out["shards"]
        if ref is not None and kind in ref and (wire, shards) != ref[kind]:
            raise AssertionError(f"cluster {kind}: {wire} bytes in {shards}"
                                 f" shards, the paged phase's {ref[kind]}")
        line = (f"{kind}: {wire / 2**20:.1f} MiB on the wire in {shards} "
                f"shards, {engine_numbers(out['engine'], reqs, wall)}, "
                f"launches {launched}")
        if kind == "flaky pd":
            if not (out["kv_retries"] > 0 and out["kv_corrupted"] > 0
                    and out["reprefills"] == out["kv_corrupted"]):
                raise AssertionError(f"cluster flaky pd: {out}")
            line += (f", {out['kv_retries']} retransmits, "
                     f"{out['kv_corrupted']} corrupted shards, "
                     f"{out['reprefills']} re-prefills")
        tokens[kind], walls[kind] = [r.output for r in reqs], wall
        lines.append(line)
    return tokens, walls, lines


def decode_trace(cfg, params, M, dev):
    """The decode step (B slots, a cache of MAX_LEN) traced on ``dev``,
    the cache's readers and writers pinned to plan device 0."""
    from repro_torch.core import analyzer
    traced = analyzer.analyze(
        lambda p, c, t, q: M.decode_step(p, cfg, t, c, q, tagged=True),
        params, M.init_cache(cfg, B, MAX_LEN, device=dev),
        torch.zeros((B, 1), dtype=torch.int32, device=dev),
        torch.zeros(B, dtype=torch.int32, device=dev), state_argnums=(1,))
    return traced.with_graph(analyzer.pin_nodes(
        traced.graph, traced.state_readers | traced.state_writers, 0))


def cluster_des(graph) -> str:
    """The deployment DES of CLUSTER_GROUPS on the decode step's graph:
    one Poisson trace simulated twice must give identical event logs."""
    from repro_torch.serving.spec import DeploymentSpec
    from repro_torch.serving.workload import poisson_trace
    dep = DeploymentSpec(groups=CLUSTER_GROUPS, arch=CLUSTER_ARCH,
                         base_output=1, anneal_iters=CLUSTER_ANNEAL) \
        .compile(graph)
    trace = poisson_trace(rate=1.5 * dep.cluster().capacity,
                          num_requests=DES_REQUESTS, seed=5)
    a, b = dep.simulate(trace), dep.simulate(trace)
    if not a.events or (a.events, a.latencies, a.ttfts, a.assignments) != \
            (b.events, b.latencies, b.ttfts, b.assignments):
        raise AssertionError("cluster DES: two runs of one trace differ")
    return (f"DES of {CLUSTER_GROUPS} on the decode graph, {DES_REQUESTS} "
            f"Poisson requests at 1.5x capacity: modeled by the cost model "
            f"for those catalog GPUs, not measured: throughput "
            f"{a.throughput:.3f} req/s, mean TTFT {a.mean_ttft:.4f} s, mean "
            f"latency {a.mean_latency:.4f} s, p95 {a.p(0.95):.4f} s, "
            f"per replica {a.per_replica_completed}; {len(a.events)} events,"
            " identical in two runs")


def cluster_elastic(cfg, params, M, traced, dev) -> str:
    """ElasticExecutor on the decode step over ELASTIC_SPECS mapped onto
    three streams of the card, from one prefilled cache: the logits are
    bit-identical to the eager step's with three devices and after each
    of two mark_failed calls."""
    from repro_torch.core.costmodel import CATALOG
    from repro_torch.core.executor import logical_devices
    from repro_torch.runtime.fault import ElasticExecutor
    rng = np.random.default_rng(0)
    lens = np.asarray([PROMPT, 300, 77, 5])
    toks = np.zeros((B, PROMPT), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    cache0 = M.init_cache(cfg, B, MAX_LEN, device=dev)
    M.prefill(params, cfg, torch.from_numpy(toks).to(dev), cache0,
              last_pos=torch.from_numpy((lens - 1).astype(np.int32)).to(dev))
    step_toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1))
                                 .astype(np.int32)).to(dev)
    pos = torch.from_numpy(lens.astype(np.int32)).to(dev)

    def logits(fn):
        cache = {part: {n: v.clone() for n, v in leaves.items()}
                 for part, leaves in cache0.items()}
        out = fn(params, cache, step_toks, pos)[0]
        torch.cuda.synchronize()
        return out

    want = logits(lambda p, c, t, q: M.decode_step(p, cfg, t, c, q))
    t = time.perf_counter()
    ex = ElasticExecutor(traced, [CATALOG[n] for n in ELASTIC_SPECS],
                         logical_devices(len(ELASTIC_SPECS), dev))
    notes = [f"built in {time.perf_counter() - t:.1f} s"]
    for lost in (None, 2, 1):
        if lost is not None:
            t = time.perf_counter()
            ex.mark_failed(lost)
            notes.append(f"lost {ELASTIC_SPECS[lost]}, re-planned and "
                         f"rebuilt in {time.perf_counter() - t:.1f} s")
        same = torch.equal(logits(ex), want)
        notes.append(f"{ex.plan.summary()} ({ex.exe.num_units} dispatch "
                     f"units): logits bit-identical to the eager step: "
                     f"{same}")
        if not same:
            raise AssertionError(f"elastic executor: {notes[-1]}")
    return "elastic executor on 3 streams: " + "; ".join(notes)


def cluster_launcher() -> str:
    """``launch.serve --deployment`` once, on a streamed pair's spec file
    (the launcher makes its own weights from the spec's seed)."""
    import tempfile
    from repro_torch.launch import serve as launcher
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "spec.json")
        cluster_spec(pd=True, kv_chunks=PLAIN_CHUNKS).save(path)
        out = launcher.main(["--deployment", path, "--device", DEV,
                             "--requests", str(N_REQUESTS), "--max-new",
                             str(MAX_NEW), "--trace", "poisson", "--rate",
                             str(RATE)])
    torch.cuda.empty_cache()
    if out["engine"]["completed"] != N_REQUESTS or not out["shards"]:
        raise AssertionError(f"launch.serve --deployment: {out}")
    return (f"launch.serve --deployment (streamed pair): "
            f"{out['engine']['completed']} requests, "
            f"{out['wire_bytes'] / 2**20:.1f} MiB in {out['shards']} shards")


def cluster_identity(cfg, k):
    """llama3-8b at full width in fp32 with IDENTITY_LAYERS layers: the
    drain, crash-recovery and flaky-pair runs give the greedy tokens of
    one plain engine.  Returns the plain engine's tokens."""
    from repro_torch.serving.engine import ServingEngine
    small = dataclasses.replace(cfg, num_layers=IDENTITY_LAYERS,
                                dtype="float32")
    params = init_params(k.M, small)
    reqs = paged_requests(small)
    ServingEngine(small, params, slots=B, max_len=MAX_LEN,
                  device=DEV).run(reqs)
    want = [r.output for r in reqs]
    drain, span, _ = cluster_pool(small, params, k)
    runs = {"drain": drain,
            "crash": cluster_crash(small, params, k, span)[0],
            "flaky pd": cluster_pairs(small, params, k)[0]["flaky pd"]}
    diff = {label: [i for i, (a, b) in enumerate(zip(o, want)) if a != b]
            for label, o in runs.items()}
    if any(diff.values()):
        raise AssertionError(f"cluster: greedy tokens differ from the plain "
                             f"engine's (request indices): {diff}")
    free(params)
    return (f"{small.name} fp32, {IDENTITY_LAYERS} layers: drain migration, "
            "crash recovery and re-prefill give the plain engine's greedy "
            f"tokens ({len(want)} requests x {MAX_NEW} tokens)")


def phase_cluster(cfg, params, k, ref) -> None:
    """The cluster layer on llama3-8b (bf16, full width, its weights
    loaded): the deployment DES, the launched pool (drain, crash with
    checkpoint recovery), the serial, streamed and flaky prefill ->
    decode pairs, the launcher's --deployment, the elastic executor on
    three streams, and the greedy-token identity of the recovered runs in
    fp32 at IDENTITY_LAYERS layers.  ``ref`` is what phase_paged_llama
    returned: the fixed engine's tokens and the pairs' wire numbers.  The
    launch counters are zeroed at the start and read at the end (no step
    of the phase zeroes them)."""
    M, name = k.M, card()
    dev = torch.device(DEV, torch.cuda.current_device())
    reset_counts(k)
    lines, walls = [], {}

    def step(label, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        walls[label] = time.perf_counter() - t
        return out

    traced = step("trace", decode_trace, cfg, params, M, dev)
    lines.append(f"decode step traced: {traced.graph.stats()}")
    lines.append(step("des", cluster_des, traced.graph))
    drain, span, line = step("drain", cluster_pool, cfg, params, k)
    lines.append(line)
    crash, _, line = step("crash", cluster_crash, cfg, params, k, span)
    lines.append(line)
    pairs, _, pair_lines = step("pairs", cluster_pairs, cfg, params, k, ref)
    lines += pair_lines
    lines.append(step("launcher", cluster_launcher))
    lines.append(step("elastic", cluster_elastic, cfg, params, M, traced,
                      dev))
    del traced
    lines.append(step("identity", cluster_identity, cfg, k))
    launched = counts(k)
    if not launched["flash_decode"] or not launched["flash_prefill"]:
        raise AssertionError(f"cluster phase launches {launched}")
    want = ref["fixed"]
    same = {label: sum(a == b for a, b in zip(o, want))
            for label, o in (("drain", drain), ("crash", crash),
                             ("flaky pd", pairs["flaky pd"]))}
    for line in lines:
        log(f"[cluster] {cfg.name} on {name}: {line}")
    log(f"[cluster] {cfg.name} bf16 full width, requests whose greedy "
        f"tokens equal the fixed engine's (reported, not held): "
        + ", ".join(f"{label} {n}/{len(want)}" for label, n in same.items()))
    log(f"[cluster] on {name}: phase walls "
        + ", ".join(f"{label} {w:.1f} s" for label, w in walls.items())
        + f"; launches in the phase: K1 {launched['flash_decode']}, K2 "
        f"{launched['flash_prefill']}")


# --------------------------------------------------------------------- #
# 8. tessera: the core on the decode step
# --------------------------------------------------------------------- #
TESSERA_ARCHS = ("llama3_8b", "gpt_oss_20b", "rwkv6_3b", "zamba2_7b")
TESSERA_RUN = ("llama3_8b", "gpt_oss_20b")     # planned and executed
MAX_BUILD_GROWTH = 2 ** 30                     # bytes
TESSERA_ROUNDS = 3                             # timing rounds per variant


def kernel_nodes(traced) -> dict:
    """Op nodes of the hand-written kernels in a traced step, by kernel."""
    out = {}
    for n in traced.eqns:
        if getattr(n.target, "namespace", "") == "repro_torch":
            name = n.target._overloadpacket.__name__.split(".")[-1]
            out[name] = out.get(name, 0) + 1
    return out


def trace_counts(cfg, traced, what: str) -> None:
    expect = {n: v for n, v in expected_launches(cfg, 1, 0, 0).items() if v}
    found = kernel_nodes(traced)
    log(f"[tessera] {cfg.name} full width {cfg.dtype}, B {B}, max_len "
        f"{MAX_LEN}: decode step traced ({what}): graph {traced.graph.stats()}"
        f", kernel op nodes {found}")
    if found != expect:
        raise AssertionError(f"{cfg.name}: kernel op nodes {found} != the "
                             f"launches of a decode step {expect}")


def phase_tessera(configs, k) -> None:
    """Trace the decode step of the four models at full width; plan
    llama3-8b and gpt-oss-20b for the GPU pair under both policies and
    execute them on two logical devices of this card (a stream each) and
    fused on one, against the eager step; serve gpt-oss-20b through the
    online monitor's choice of executable, against the eager engine."""
    from repro_torch.core import analyzer
    from repro_torch.core.executor import LogicalDevice, build_executable
    from repro_torch.core.monitor import MonitorConfig, OnlineMonitor
    from repro_torch.launch.serve import PLAN_PAIR, plan_decode
    M = k.M
    meta = torch.device("meta")
    for name in TESSERA_ARCHS:
        if name in TESSERA_RUN:
            continue
        cfg = configs.get(name)
        t = time.perf_counter()
        traced = analyzer.analyze(
            lambda p, c, t_, q, cfg=cfg: M.decode_step(p, cfg, t_, c, q,
                                                       tagged=True),
            M.init_params(cfg, device=meta),
            M.init_cache(cfg, B, MAX_LEN, device=meta),
            torch.zeros((B, 1), dtype=torch.int32, device=meta),
            torch.zeros(B, dtype=torch.int32, device=meta),
            state_argnums=(1,))
        trace_counts(cfg, traced, f"on meta tensors in "
                     f"{time.perf_counter() - t:.1f} s")
    for name in TESSERA_RUN:
        cfg = configs.get(name)
        params = init_params(M, cfg)
        dev = torch.device(DEV, torch.cuda.current_device())
        t = time.perf_counter()
        core = plan_decode(cfg, params, B, MAX_LEN, dev)
        traced, plans = core["traced"], core["plans"]
        trace_counts(cfg, traced, f"and planned in "
                     f"{time.perf_counter() - t:.1f} s")
        for pol, p in plans.items():
            log(f"[tessera] {cfg.name} {pol} plan for {'+'.join(PLAN_PAIR)} "
                f"(modeled, not measured): {p.summary()}, bottleneck "
                f"{p.bottleneck * 1e3:.3f} ms")
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        lds = [LogicalDevice(dev, torch.cuda.Stream(dev), name=f"cuda/{i}")
               for i in range(2)]
        one = LogicalDevice(dev, torch.cuda.Stream(dev), name="cuda/fused")
        t = time.perf_counter()
        exes = {pol: build_executable(traced, p, lds)
                for pol, p in plans.items()}
        exes["throughput, fused"] = build_executable(
            traced, plans["throughput"], [one, one])
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated() - mem0
        log(f"[tessera] {cfg.name}: 3 executables built in "
            f"{time.perf_counter() - t:.1f} s ("
            + ", ".join(f"{pol}: {e.num_units} dispatch units"
                        for pol, e in exes.items())
            + f"), memory_allocated grew by {grown / 2**20:.1f} MiB, "
            f"{sum(e.weight_places for e in exes.values())} weight copies")
        if grown >= MAX_BUILD_GROWTH:
            raise AssertionError(f"{cfg.name}: building the executables "
                                 f"allocated {grown} bytes")
        tessera_steps(cfg, params, k, exes)
        if cfg.family == "moe":
            tessera_serve(cfg, params, k, exes, MonitorConfig, OnlineMonitor)
        free(params)
        del core, traced, exes
        torch.cuda.empty_cache()
    tessera_pipeline()


def tessera_steps(cfg, params, k, exes) -> None:
    """From one prefilled cache, DECODE_STEPS decode steps through each
    executable and through the eager step, every step under
    set_sync_debug_mode("error"): the logits must be bit-identical (the
    same ops and kernels in the same order) and the launches equal."""
    M = k.M
    rng = np.random.default_rng(0)
    lens = np.asarray([PROMPT, 300, 77, 5])
    toks = np.zeros((B, PROMPT), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    dev = torch.device(DEV)
    steps = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        B, DECODE_STEPS)).astype(np.int32)).to(dev)
    cache0 = M.init_cache(cfg, B, MAX_LEN, device=dev)
    M.prefill(params, cfg, torch.from_numpy(toks).to(dev), cache0,
              last_pos=torch.from_numpy((lens - 1).astype(np.int32)).to(dev))

    def eager(p, c, t, q):
        return M.decode_step(p, cfg, t, c, q)

    def run(fn):
        """Logits of each step, its wall time (ms, after a synchronise)
        and the host time it took to queue its work."""
        cache = {part: {n: v.clone() for n, v in leaves.items()}
                 for part, leaves in cache0.items()}
        pos = torch.from_numpy(lens.astype(np.int32)).to(dev)
        outs, wall, enq, cpu = [], [], [], []
        torch.cuda.synchronize()
        for i in range(DECODE_STEPS):
            t, c = time.perf_counter(), time.thread_time()
            torch.cuda.set_sync_debug_mode("error")
            try:
                logits, cache = fn(params, cache, steps[:, i:i + 1], pos)
                outs.append(logits)
                pos = pos + 1
            finally:
                torch.cuda.set_sync_debug_mode(0)
            enq.append((time.perf_counter() - t) * 1e3)
            cpu.append((time.thread_time() - c) * 1e3)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t) * 1e3)
        return outs, wall, enq, cpu

    def eager_tagged(p, c, t, q):
        return M.decode_step(p, cfg, t, c, q, tagged=True)

    # the tagged eager step: what entering the marker regions costs
    fns = {"eager": eager, "eager, tagged": eager_tagged, **exes}
    for fn in fns.values():                    # first calls: allocator
        run(fn)
    results = {}
    for label, fn in fns.items():
        reset_counts(k)
        outs, _, _, _ = run(fn)
        results[label] = (outs, counts(k))
    want, n_e = results["eager"]
    expect = expected_launches(cfg, DECODE_STEPS, 0, 0)
    if n_e != expect:
        raise AssertionError(f"{cfg.name}: eager launches {n_e} != {expect}")
    # host-clock times vary run to run: TESSERA_ROUNDS rounds, the
    # variants alternating, medians over every step of every round
    walls = {label: [] for label in fns}
    enqs = {label: [] for label in fns}
    cpus = {label: [] for label in fns}
    for _ in range(TESSERA_ROUNDS):
        for label, fn in fns.items():
            _, wall, enq, cpu = run(fn)
            walls[label] += wall
            enqs[label] += enq
            cpus[label] += cpu
    for label, (outs, n) in results.items():
        same = all(torch.equal(a, b) for a, b in zip(outs, want))
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(outs, want))
        units = exes[label].num_units if label in exes else "-"
        log(f"[tessera] {cfg.name} {label} ({units} dispatch units): "
            f"{DECODE_STEPS} decode steps (no host sync), logits "
            f"bit-identical to the eager step: {same} (max abs diff "
            f"{err:.3e}), launches {n}; over {TESSERA_ROUNDS} x "
            f"{DECODE_STEPS} steps, alternating: step wall median "
            f"{float(np.median(walls[label])):.2f} ms (min "
            f"{min(walls[label]):.2f}, max {max(walls[label]):.2f}), host "
            f"queueing median {float(np.median(enqs[label])):.2f} ms, of "
            f"which the thread's own CPU time "
            f"{float(np.median(cpus[label])):.2f} ms")
        if not same or n != n_e:
            raise AssertionError(f"{cfg.name} {label}: logits differ "
                                 f"({err:.3e}) or launches {n} != {n_e}")


def tessera_serve(cfg, params, k, exes, MonitorConfig, OnlineMonitor) -> None:
    """The requests of phase_serve (arrivals at 0, so every run batches
    alike) through the eager engine and through the engine whose decode
    step is ``exes[monitor.policy]``, twice each: every request
    completes, the greedy tokens agree and the launches match the steps
    and admissions."""
    from repro_torch.serving.engine import ServingEngine, requests_from_trace
    from repro_torch.serving.workload import make_trace
    trace = make_trace("poisson", RATE, N_REQUESTS, seed=0)
    monitor = OnlineMonitor(MonitorConfig(window=0.5, beta=1.5))

    def decode_fn(p, c, t, q):
        return exes[monitor.policy](p, c, t, q)

    tokens = []
    # eager, executor, executor, eager: the monitor's first window moves
    # it to its second policy between the two executor runs
    for label, fn in (("eager", None), ("executor", decode_fn),
                      ("executor", decode_fn), ("eager", None)):
        policy = monitor.policy if fn is not None else "-"
        reqs = requests_from_trace(trace, cfg.vocab_size,
                                   max_prompt=MAX_LEN // 2, max_new=MAX_NEW,
                                   time_scale=0.0)
        engine = ServingEngine(cfg, params, slots=B, max_len=MAX_LEN,
                               decode_fn=fn, device=DEV)
        engine.warmup()
        reset_counts(k)
        t = time.perf_counter()
        stats = engine.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = counts(k)
        expect = expected_launches(cfg, stats.decode_steps,
                                   stats.prefill_batches,
                                   stats.prefill_batches)
        if stats.completed != len(reqs) or launches != expect or any(
                len(r.output) != r.max_new_tokens for r in reqs):
            raise AssertionError(f"tessera serve ({label}): completed "
                                 f"{stats.completed}/{len(reqs)}, launches "
                                 f"{launches} vs {expect}")
        if label == "executor":
            for r in reqs:
                lat = r.finished - r.arrival
                monitor.record_request(r.finished, lat, lat * 0.5)
            monitor.tick(wall + 1.0)
        s = stats.summary()
        decode_tokens = sum(len(r.output) - 1 for r in reqs)
        log(f"[tessera] serve {cfg.name} {label} (policy {policy}): "
            f"{len(reqs)} requests "
            f"(arrivals at 0), mean TTFT {s['mean_ttft']:.4f} s, mean TPOT "
            f"{s['mean_tpot']:.4f} s, decode tokens/s "
            f"{decode_tokens / wall:.1f} ({decode_tokens} in {wall:.3f} s), "
            f"{stats.decode_steps} decode steps, launches {launches}")
        tokens.append([r.output for r in reqs])
    if any(t != tokens[0] for t in tokens):
        raise AssertionError("tessera serve: greedy tokens differ between "
                             "the eager and the executor engine")
    log(f"[tessera] serve {cfg.name}: greedy tokens identical; monitor "
        f"policy {monitor.policy}, switches {monitor.switches}")


PIPE_DIM = 8192                                # runner check: a chain of
PIPE_DEPTH = 48                                # tanh(x @ w), bf16
PIPE_REQUESTS = 3


def tessera_pipeline() -> None:
    """The pipelined runner on the card, with straggler deadlines.  A
    chain of PIPE_DEPTH bf16 matmuls takes tens of ms on the card and
    about a ms to issue: fused into one unit with a deadline of a quarter
    of its device time, every request's unit must miss it (the deadline
    is on completion, not issue) and be rerun on a fallback stream; with
    a deadline of 60 s none may.  Planned for the GPU pair under
    ``throughput`` (two logical devices, a stream each), a deadline of
    1e-9 s reruns every unit on the fallback stream while its first try
    still runs.  Every output must equal the eager chain."""
    from repro_torch.core import analyzer, planner
    from repro_torch.core.costmodel import CATALOG
    from repro_torch.core.executor import (LogicalDevice, build_executable,
                                           logical_devices)
    from repro_torch.core.pipeline import PipelinedRunner
    from repro_torch.launch.serve import PLAN_PAIR

    def chain(x, w):
        for _ in range(PIPE_DEPTH):
            x = torch.tanh(x @ w)
        return x

    g = torch.Generator(device=DEV)
    g.manual_seed(1)
    w = randn(g, PIPE_DIM, PIPE_DIM, dtype=torch.bfloat16) * PIPE_DIM ** -0.5
    xs = [randn(g, PIPE_DIM, PIPE_DIM, dtype=torch.bfloat16)
          for _ in range(PIPE_REQUESTS)]
    want = [chain(x, w) for x in xs]
    traced = analyzer.analyze(chain, xs[0], w)
    plan = planner.plan(traced.graph, [CATALOG[d] for d in PLAN_PAIR],
                        policy="throughput", cache=False)
    dev = torch.device(DEV, torch.cuda.current_device())
    one = LogicalDevice(dev, torch.cuda.Stream(dev), name="cuda/fused")
    fused = build_executable(traced, plan, [one, one])
    split = build_executable(traced, plan, logical_devices(2, dev))
    fallback = LogicalDevice(dev, torch.cuda.Stream(dev), name="cuda/fallback")
    fused(xs[0], w)                            # first call: allocator
    torch.cuda.synchronize()
    t = time.perf_counter()
    fused(xs[0], w)
    issue = time.perf_counter() - t
    torch.cuda.synchronize()
    device = time.perf_counter() - t
    deadline = device / 4
    log(f"[tessera] runner: {PIPE_DEPTH} x tanh(x @ w) at {PIPE_DIM}, bf16, "
        f"fused into {fused.num_units} unit: issued in {issue * 1e3:.2f} ms, "
        f"done in {device * 1e3:.2f} ms; {plan.summary()} -> "
        f"{split.num_units} units on two streams")
    if fused.num_units != 1 or split.num_units < 2 or deadline < 3 * issue:
        raise AssertionError("runner check: the chain does not separate "
                             "issue from completion, or the plan has one "
                             "unit")
    cases = (("fused", fused, deadline, PIPE_REQUESTS),
             ("fused", fused, 60.0, 0),
             ("two streams", split, 1e-9, None))
    for label, exe, limit, reruns in cases:
        runner = PipelinedRunner(exe, max_inflight=PIPE_REQUESTS,
                                 straggler_deadline=limit,
                                 fallback_device=fallback)
        outs, stats = runner.run([((x, w), {}) for x in xs])
        torch.cuda.synchronize()
        errs = [check(f"runner {label}", o, e, TOL[torch.bfloat16])
                for o, e in zip(outs, want)]
        same = all(torch.equal(o, e) for o, e in zip(outs, want))
        log(f"[tessera] runner {label}, deadline {limit * 1e3:.6g} ms: "
            f"{stats.completed} requests, {stats.stage_dispatches} units "
            f"issued, {stats.straggler_reexecs} straggler reruns, outputs "
            f"bit-identical to the eager chain: {same} (max abs err "
            f"{max(errs):.3e})")
        if stats.completed != PIPE_REQUESTS or (
                reruns is not None and stats.straggler_reexecs != reruns) \
                or (reruns is None and stats.straggler_reexecs < 1):
            raise AssertionError(f"runner {label}: {stats.straggler_reexecs}"
                                 f" straggler reruns, expected {reruns}")


def init_params(M, cfg):
    g = torch.Generator(device=DEV)
    g.manual_seed(0)
    t = time.perf_counter()
    params = M.init_params(cfg, generator=g, device=DEV)
    torch.cuda.synchronize()
    log(f"[{cfg.name}] {cfg.num_layers} layers, {cfg.dtype}: params on the "
        f"card in {time.perf_counter() - t:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    return params


def free(params) -> None:
    params.clear()
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
        return 1
    import repro_torch.configs as configs
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention import ref as FR
    from repro_torch.kernels.mamba2_ssd import kernel as SK
    from repro_torch.kernels.mamba2_ssd import ops as S
    from repro_torch.kernels.mamba2_ssd import ref as SR
    from repro_torch.kernels.moe_gmm import kernel as GK
    from repro_torch.kernels.moe_gmm import ops as G
    from repro_torch.kernels.moe_gmm import ref as GR
    from repro_torch.kernels.rwkv6 import kernel as WK
    from repro_torch.kernels.rwkv6 import ops as W
    from repro_torch.kernels.rwkv6 import ref as WR
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    k = types.SimpleNamespace(M=M, L=L, FA=FA, FR=FR, G=G, GR=GR, W=W, WR=WR,
                              S=S, SR=SR, kernels=(FK, GK, WK, SK))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    import torch.fx.traceback as fx_traceback
    if not hasattr(fx_traceback, "annotate"):
        raise AssertionError(f"torch {torch.__version__} has no "
                             "torch.fx.traceback.annotate (the analyzer's "
                             "block and layer tags)")

    phase_build(nvcc, k.kernels)
    log_phase("build")
    g = torch.Generator(device=DEV)
    g.manual_seed(0)
    errs = check_attention(g, FK, FR)
    rows = time_attention(g, FK, FR, errs) + check_and_time_gmm(g, GK, GR)
    rows += check_and_time_wkv(g, WK, WR) + check_and_time_ssd(g, SK, SR)
    check_two_streams(g, FK, FR, WK, WR)
    log_phase("kernels")
    launches = {}

    def served(cfg, lens, first=None):
        """Optionally a first model check of another configuration (``first``
        = (config, lens)), then the model check, the serving run and the
        "paged" checks of ``cfg`` at full width, with its parameters
        loaded once."""
        if first is not None:
            first_cfg, first_lens = first
            params = init_params(M, first_cfg)
            phase_model(first_cfg, params, k, first_lens)
            free(params)
        params = init_params(M, cfg)
        limit = phase_model(cfg, params, k, lens)
        launches.update(phase_serve(cfg, params, k))
        log_phase(cfg.name)
        if cfg.family == "dense":
            paged, ref = phase_paged_llama(cfg, params, k)
            launches.update(paged)
            phase_paged_identity(cfg, k)
        elif cfg.family == "moe":
            phase_paged_handoff(cfg, params)
        else:
            phase_paged_recurrent(cfg, params, k, limit)
        log_phase(f"{cfg.name} paged")
        if cfg.family == "dense":
            # the cluster layer, with llama3-8b's weights still loaded
            phase_cluster(cfg, params, k, ref)
            log_phase("cluster")
        free(params)

    served(configs.get("llama3_8b"), [PROMPT, 300, 77, 5])
    # the window check (2 layers, fp32, window 128), then gpt-oss-20b
    served(configs.get("gpt_oss_20b"), [PROMPT, 300, 77, 5],
           first=(dataclasses.replace(configs.get("gpt_oss_20b"),
                                      num_layers=2, dtype="float32",
                                      sliding_window=SMALL_WINDOW),
                  [PROMPT, 300, 130, 5]))
    # the recurrent models first in fp32 at full depth (11.7 and 25.2 GiB
    # of parameters): the tight logit check; zamba2's prompt of 300 ends in
    # a ragged chunk
    rwkv = configs.get("rwkv6_3b")
    served(rwkv, [PROMPT] * B,
           first=(dataclasses.replace(rwkv, dtype="float32"), [PROMPT] * B))
    zamba = configs.get("zamba2_7b")
    served(zamba, [PROMPT] * B,
           first=(dataclasses.replace(zamba, dtype="float32"), [300] * B))

    phase_tessera(configs, k)
    log_phase("tessera")

    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
