#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:
  1. build    compile K1 (decode), K2 (prefill) and K3 (MoE grouped
              matmul) from the repo's CUDA sources with nvcc for sm_90a,
              all three sources in parallel;
  2. kernels  hold each kernel against its plain PyTorch version on the
              card in fp32 (tight) and bf16 (stated tolerance) at the
              main paths' shapes (K1/K2 at llama3-8b's head_dim 128 and
              gpt-oss-20b's 64, K2 also with a sliding window; K3 at the
              decode and the prefill shape), and time kernel, plain
              version and one PyTorch call of the same function;
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
  6. card     the card's name and power limit from nvidia-smi.

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
# attention shapes (H, Hkv, D) of the two models
LLAMA_ATTN = (32, 8, 128)
GPTOSS_ATTN = (64, 8, 64)
GPTOSS_WINDOW = 4096                  # gpt-oss-20b's sliding window
SMALL_WINDOW = 128                    # phase 4: the ring wraps

# H100 SXM published peaks (dense), against which bounds are computed
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

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

REPLACES = {"flash_decode": "src/repro/kernels/flash_attention/kernel.py:188",
            "flash_prefill": "src/repro/kernels/flash_attention/kernel.py:93",
            "gmm": "src/repro/kernels/moe_gmm/kernel.py:32"}
FA_SRC = "src/repro_torch/kernels/flash_attention/csrc/"
GMM_SRC = "src/repro_torch/kernels/moe_gmm/csrc/gmm.cu"


def log(*a) -> None:
    print(*a, flush=True)


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
def phase_build(nvcc, FK, GK) -> None:
    t = time.perf_counter()
    nvcc.compile_all({**FK.build_jobs(), **GK.build_jobs()})
    FK.build()
    GK.build()
    log(f"[build] K1+K2+K3 built in {time.perf_counter() - t:.2f} s "
        "(nvcc, sm_90a, one process per source)")
    for name, out in nvcc.BUILD_LOG.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


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
        for attn in (LLAMA_ATTN, GPTOSS_ATTN):
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
                                 ("_d64", GPTOSS_ATTN, GPTOSS_WINDOW)):
        H, Hkv, D = attn
        lengths = [PROMPT] * B
        dec_sets = [decode_inputs(g, dt, lengths, attn) for _ in range(6)]
        n_tok = sum(lengths)
        dec = bound(es * (2 * B * H * D + 2 * n_tok * Hkv * D) + 4 * B,
                    4 * n_tok * H * D, dt)
        pre_sets = [prefill_inputs(g, dt, PROMPT, attn) for _ in range(3)]
        # the window (4096) is wider than the prompt: the causal pairs
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
    return rows


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


# --------------------------------------------------------------------- #
# 3-5. models
# --------------------------------------------------------------------- #
@contextlib.contextmanager
def plain_versions(FA, FR, G, GR):
    """Route the model's attention and expert matmuls to the plain
    versions (on the card)."""
    saved = FA.prefill_attention, FA.decode_attention, G.gmm
    FA.prefill_attention = FR.prefill_attention
    FA.decode_attention = FR.decode_attention
    G.gmm = GR.gmm
    try:
        yield
    finally:
        FA.prefill_attention, FA.decode_attention, G.gmm = saved


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


def counts(*mods) -> dict:
    return {k: v for m in mods for k, v in m.LAUNCHES.items()}


def reset_counts(*mods) -> None:
    for m in mods:
        m.reset_launch_counts()


def phase_model(cfg, params, mods, lens) -> None:
    """Right-padded prefill of ``lens`` and DECODE_STEPS decode steps,
    through the kernels and through the plain versions; logits held at
    MODEL_RTOL.  Through the kernels, every decode step runs under
    ``set_sync_debug_mode("error")``: it must make no host sync.  (The
    plain grouped matmul reads the group sizes on the host.)

    MoE: a router near-tie lets the two runs' rounding pick different
    experts for a token, and in bf16 such flips cascade through the
    layers, so the held comparison replays the kernel run's expert
    choices in the plain run (its gates still come from its own router
    logits).  A second, free-running plain run counts the flipped
    (token, layer) choices and its logit difference is reported, not
    held."""
    M, L, FA, FR, G, GR, FK, GK = mods
    rng = np.random.default_rng(0)
    lens = np.asarray(lens)
    S = int(-(-lens.max() // 8) * 8)
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
    reset_counts(FK, GK)
    with routing(L, record=routes_k):
        got, wall, enq = run(True)
    n_kern = counts(FK, GK)
    with plain_versions(FA, FR, G, GR), routing(L, replay=routes_k):
        want, wall_plain, _ = run(False)
    n_layers, moe = cfg.num_layers, cfg.family == "moe"
    expect = {"flash_prefill": n_layers,
              "flash_decode": n_layers * DECODE_STEPS,
              "gmm": 3 * n_layers * (DECODE_STEPS + 1) if moe else 0}
    if n_kern != expect or counts(FK, GK) != n_kern:
        raise AssertionError(f"model phase launches {n_kern} (expected "
                             f"{expect}) -> {counts(FK, GK)}")
    tag = "bf16" if cfg.torch_dtype == torch.bfloat16 else "fp32"
    rtol = MODEL_RTOL[cfg.torch_dtype]

    def compare(what, outs):
        worst = 0.0
        for i, (a, b) in enumerate(zip(got, outs)):
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
        with plain_versions(FA, FR, G, GR), routing(L, record=routes_p):
            free, _, _ = run(False)
        flips = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1)
                        .sum()) for a, b in zip(routes_k, routes_p))
        total = sum(a.shape[0] for a in routes_k)
        free_worst = compare("kernels vs plain, own routing", free)
        log(f"[{cfg.name}] routing: {flips} of {total} (token, layer) expert "
            "choices differ between the kernel run and a free-running "
            f"plain run, whose logits differ by rel err {free_worst:.3e} "
            "(reported, not held)")
    if worst > rtol:
        raise AssertionError(f"{cfg.name}: rel err {worst:.3e} > {rtol}")
    window = f", window {cfg.sliding_window} (ring of " \
        f"{min(MAX_LEN, cfg.sliding_window)} slots)" \
        if cfg.sliding_window else ""
    log(f"[{cfg.name}] {n_layers} layers {tag}{window}: prefill S={S} rows "
        f"{lens.tolist()} + {DECODE_STEPS} decode steps (no host sync "
        f"through the kernels), kernels vs plain "
        f"{'(same routing) ' if moe else ''}"
        f"versions max rel err {worst:.3e} (tolerance {rtol}), launches "
        f"{n_kern}")
    for name, w in (("kernels", wall), ("plain versions", wall_plain)):
        log(f"[{cfg.name}] wall with {name}: prefill {w[0]:.2f} ms, decode "
            f"step mean {float(np.mean(w[1:])):.2f} ms "
            f"(min {min(w[1:]):.2f}, max {max(w[1:]):.2f})")
    log(f"[{cfg.name}] host time to queue a decode step (kernels): mean "
        f"{float(np.mean(enq)):.2f} ms of {float(np.mean(wall[1:])):.2f} ms "
        "wall")


def phase_serve(cfg, params, mods) -> dict:
    """Serve N_REQUESTS Poisson requests; returns the launches of each
    kernel row (K3 split into those inside admissions and the rest)."""
    from repro_torch.serving.engine import ServingEngine, requests_from_trace
    from repro_torch.serving.workload import make_trace
    M, L, FA, FR, G, GR, FK, GK = mods
    trace = make_trace("poisson", RATE, N_REQUESTS, seed=0)
    reqs = requests_from_trace(trace, cfg.vocab_size,
                               max_prompt=MAX_LEN // 2, max_new=MAX_NEW)
    engine = ServingEngine(cfg, params, slots=B, max_len=MAX_LEN,
                           device=DEV)
    engine.warmup()
    in_prefill = {"gmm": 0}
    prefill = M.prefill

    def counted_prefill(*a, **kw):
        before = GK.LAUNCHES["gmm"]
        out = prefill(*a, **kw)
        in_prefill["gmm"] += GK.LAUNCHES["gmm"] - before
        return out
    M.prefill = counted_prefill
    reset_counts(FK, GK)                # count the main path's run only
    try:
        t = time.perf_counter()
        stats = engine.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        M.prefill = prefill
    launches = counts(FK, GK)
    for r in reqs:
        if len(r.output) != r.max_new_tokens or r.finished < 0 \
                or not all(0 <= x < cfg.vocab_size for x in r.output):
            raise AssertionError(f"request {r.rid}: {len(r.output)} tokens"
                                 f" of {r.max_new_tokens}")
    if stats.completed != len(reqs):
        raise AssertionError(f"completed {stats.completed}/{len(reqs)}")
    n, steps, adm = cfg.num_layers, stats.decode_steps, stats.prefill_batches
    moe = cfg.family == "moe"
    expect = {"flash_decode": n * steps, "flash_prefill": n * adm,
              "gmm": 3 * n * (steps + adm) if moe else 0}
    if launches != expect or (moe and in_prefill["gmm"] != 3 * n * adm) \
            or min(v for k, v in launches.items() if moe or k != "gmm") == 0:
        raise AssertionError(f"serve launches {launches} (K3 in admissions "
                             f"{in_prefill['gmm']}) vs expected {expect}")
    s = stats.summary()
    decode_tokens = sum(len(r.output) - 1 for r in reqs)
    log(f"[serve] {cfg.name} full width {cfg.dtype}, slots {B}, max_len "
        f"{MAX_LEN}: {len(reqs)} requests (prompts "
        f"{[len(r.prompt) for r in reqs]}, new "
        f"{[r.max_new_tokens for r in reqs]})")
    log(f"[serve] {cfg.name}: mean TTFT {s['mean_ttft']:.4f} s, mean TPOT "
        f"{s['mean_tpot']:.4f} s, decode tokens/s "
        f"{decode_tokens / wall:.1f} ({decode_tokens} decode tokens in "
        f"{wall:.3f} s wall), {steps} decode steps, {adm} prefill batches, "
        f"launches {launches} (= {n} x steps / admissions; K3 3 x {n} x "
        f"(steps + admissions), {in_prefill['gmm']} of them in admissions)")
    sfx = "_d64" if moe else ""
    out = {"flash_decode" + sfx: launches["flash_decode"],
           "flash_prefill" + sfx: launches["flash_prefill"]}
    if moe:
        out["gmm_prefill"] = in_prefill["gmm"]
        out["gmm_decode"] = launches["gmm"] - in_prefill["gmm"]
    return out


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
    from repro_torch.kernels.moe_gmm import kernel as GK
    from repro_torch.kernels.moe_gmm import ops as G
    from repro_torch.kernels.moe_gmm import ref as GR
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    mods = (M, L, FA, FR, G, GR, FK, GK)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    phase_build(nvcc, FK, GK)
    g = torch.Generator(device=DEV)
    g.manual_seed(0)
    errs = check_attention(g, FK, FR)
    rows = time_attention(g, FK, FR, errs) + check_and_time_gmm(g, GK, GR)
    launches = {}

    cfg = configs.get("llama3_8b")
    params = init_params(M, cfg)
    phase_model(cfg, params, mods, [PROMPT, 300, 77, 5])
    launches.update(phase_serve(cfg, params, mods))
    free(params)

    cfg = dataclasses.replace(configs.get("gpt_oss_20b"), num_layers=2,
                              dtype="float32", sliding_window=SMALL_WINDOW)
    params = init_params(M, cfg)
    phase_model(cfg, params, mods, [PROMPT, 300, 130, 5])
    free(params)

    cfg = configs.get("gpt_oss_20b")
    params = init_params(M, cfg)
    phase_model(cfg, params, mods, [PROMPT, 300, 77, 5])
    launches.update(phase_serve(cfg, params, mods))
    free(params)

    for row in rows:
        row["launches"] = launches[row["name"]]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"kernels": rows}))
    print(card.splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
