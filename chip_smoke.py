#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:
  1. build    compile K1 (decode) and K2 (prefill) from the repo's CUDA
              sources with nvcc for sm_90a, both sources in parallel;
  2. kernels  hold each kernel against its plain PyTorch version on the
              card in fp32 (tight) and bf16 (stated tolerance) at the
              main path's shapes, and time kernel, plain version and
              PyTorch's scaled_dot_product_attention on the same inputs;
  3. model    full-width llama3-8b in bf16 (random weights from a seeded
              generator): one right-padded prefill and 8 decode steps
              through the kernels and again through the plain attention,
              logits held within a stated relative tolerance;
  4. serve    ServingEngine at full width (4 slots, max_len 1024) serves 8
              Poisson-trace requests (prompts <= 512, 32 new tokens); every
              request must complete with its token count, and both
              kernels' launch counters, zeroed just before, must rise;
  5. card     the card's name and power limit from nvidia-smi.

The last lines are the kernels' JSON record, the nvidia-smi line and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside it, the script fails and prints no result.
"""
from __future__ import annotations

import contextlib
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

ARCH = "llama3_8b"
B, H, HKV, D = 4, 32, 8, 128          # llama3-8b attention, 4 slots
MAX_LEN = 1024                        # engine cache length
PROMPT = 512                          # longest prompt (max_len // 2)
DECODE_STEPS = 8
N_REQUESTS, MAX_NEW, RATE = 8, 32, 20.0

# H100 SXM published peaks (dense), against which bounds are computed
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Kernel vs plain version: |kernel - plain| <= ATOL + RTOL * |plain|.
# fp32 differs only by summation order and expf.  In bf16 the plain
# version rounds q*scale and the softmax weights to bf16 before the
# products and the kernel does not, and both round the output to bf16,
# so one or two bf16 ulps (2^-7 relative) of disagreement are expected.
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 2e-2)}
# Full-width model, kernels vs plain attention: max|a - b| / max|b| of
# the logits.  Per-layer bf16 differences of the size above propagate
# through 32 layers.
MODEL_RTOL = 5e-2

K1_REPLACES = "src/repro/kernels/flash_attention/kernel.py:188"
K2_REPLACES = "src/repro/kernels/flash_attention/kernel.py:93"


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


def check(name, got, want, dtype) -> float:
    torch.cuda.synchronize()
    atol, rtol = TOL[dtype]
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if not torch.isfinite(got.float()).all() or bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside atol={atol} "
            f"rtol={rtol}; max abs err {float(err.max()):.3e}")
    return float(err.max())


# --------------------------------------------------------------------- #
def phase_build(K) -> float:
    t = time.perf_counter()
    K.build()
    dt = time.perf_counter() - t
    log(f"[build] K1+K2 built in {dt:.2f} s (nvcc, sm_90a)")
    for name, out in K.BUILD_LOG.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    return dt


def decode_inputs(g, dtype, lengths, T=MAX_LEN):
    dev = "cuda"
    q = torch.randn(B, H, D, generator=g, device=dev).to(dtype)
    k = torch.randn(B, T, HKV, D, generator=g, device=dev).to(dtype)
    v = torch.randn(B, T, HKV, D, generator=g, device=dev).to(dtype)
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=dev)


def prefill_inputs(g, dtype, S, Skv=None, batch=B):
    Skv = S if Skv is None else Skv
    dev = "cuda"
    q = torch.randn(batch, S, H, D, generator=g, device=dev).to(dtype)
    k = torch.randn(batch, Skv, HKV, D, generator=g, device=dev).to(dtype)
    v = torch.randn(batch, Skv, HKV, D, generator=g, device=dev).to(dtype)
    return q, k, v


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


def phase_kernels(K, ref):
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    errs = {"flash_decode": 0.0, "flash_prefill": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        for T, lengths in ((MAX_LEN, [1, 77, 512, MAX_LEN]),
                           (MAX_LEN, [PROMPT] * B),
                           (1000, [1000, 999, 64, 65])):
            q, k, v, lens = decode_inputs(g, dtype, lengths, T)
            e = check(f"K1 {tag} T={T} lengths={lengths}",
                      K.flash_decode(q, k, v, lens),
                      ref.decode_attention(q, k, v, lens), dtype)
            log(f"[kernels] K1 {tag} T={T} lengths={lengths}: "
                f"max abs err {e:.3e}")
            if dtype == torch.bfloat16:
                errs["flash_decode"] = max(errs["flash_decode"], e)
        for S, Skv, off in ((PROMPT, PROMPT, 0), (300, 300, 0), (37, 37, 0),
                            (200, 456, 256)):
            q, k, v = prefill_inputs(g, dtype, S, Skv)
            e = check(f"K2 {tag} S={S} Skv={Skv} q_offset={off}",
                      K.flash_prefill(q, k, v, q_offset=off),
                      ref.prefill_attention(q, k, v, q_offset=off), dtype)
            log(f"[kernels] K2 {tag} S={S} Skv={Skv} q_offset={off}: "
                f"max abs err {e:.3e}")
            if dtype == torch.bfloat16:
                errs["flash_prefill"] = max(errs["flash_prefill"], e)

    # timing at the main path's shapes, bf16
    dt = torch.bfloat16
    es = 2
    lengths = [PROMPT] * B
    dec_sets = [decode_inputs(g, dt, lengths) for _ in range(6)]
    n_tok = sum(lengths)
    dec_bytes = es * (2 * B * H * D + 2 * n_tok * HKV * D) + 4 * B
    dec_flops = 4 * n_tok * H * D
    pre_sets = [prefill_inputs(g, dt, PROMPT) for _ in range(3)]
    pre_bytes = es * (2 * B * PROMPT * H * D + 2 * B * PROMPT * HKV * D)
    pre_flops = 4 * D * H * B * PROMPT * (PROMPT + 1) // 2
    rows = []
    for name, src, repl, sets, kern, plain, lib, nbytes, flops in (
            ("flash_decode", "flash_decode.cu", K1_REPLACES, dec_sets,
             K.flash_decode, ref.decode_attention, sdpa_decode,
             dec_bytes, dec_flops),
            ("flash_prefill", "flash_prefill.cu", K2_REPLACES, pre_sets,
             K.flash_prefill, ref.prefill_attention, sdpa_prefill,
             pre_bytes, pre_flops)):
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = flops / PEAK_FLOPS_S[dt] * 1e3
        row = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/flash_attention/csrc/{src}",
            "replaces": repl, "launches": 0,
            "max_abs_err": errs[name],
            "ms": time_ms(kern, sets),
            "plain_ms": time_ms(plain, sets, iters=10),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": time_ms(lib, sets),
        }
        log(f"[kernels] {name} bf16 timing: kernel {row['ms']:.4f} ms, "
            f"plain {row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} "
            f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        rows.append(row)
    return rows


@contextlib.contextmanager
def plain_attention(FA, ref):
    """Route the model's attention to the plain versions (on the card)."""
    saved = FA.prefill_attention, FA.decode_attention
    FA.prefill_attention = ref.prefill_attention
    FA.decode_attention = ref.decode_attention
    try:
        yield
    finally:
        FA.prefill_attention, FA.decode_attention = saved


def phase_model(cfg, params, M, K, FA, ref):
    rng = np.random.default_rng(0)
    lens = np.array([PROMPT, 300, 77, 5])
    S = int(-(-lens.max() // 8) * 8)
    toks = np.zeros((B, S), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    steps = rng.integers(0, cfg.vocab_size, (B, DECODE_STEPS)) \
        .astype(np.int32)
    dev = torch.device("cuda")

    def run():
        """Logits of the prefill and each decode step, the wall time (ms,
        host clock after a synchronise) of each, and the host time each
        decode step took to queue its work (before the synchronise)."""
        cache = M.init_cache(cfg, B, MAX_LEN, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = M.prefill(
            params, cfg, torch.from_numpy(toks).to(dev), cache,
            last_pos=torch.from_numpy((lens - 1).astype(np.int32)).to(dev))
        outs = [logits.float()]
        torch.cuda.synchronize()
        wall = [(time.perf_counter() - t) * 1e3]
        pos = torch.from_numpy(lens.astype(np.int32)).to(dev)
        enq = []
        for i in range(DECODE_STEPS):
            t = time.perf_counter()
            tok = torch.from_numpy(steps[:, i:i + 1]).to(dev)
            logits, cache = M.decode_step(params, cfg, tok, cache, pos)
            outs.append(logits.float())
            pos = pos + 1
            enq.append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t) * 1e3)
        return outs, wall, enq

    run()                                   # first calls: allocator, cuBLAS
    K.reset_launch_counts()
    got, wall, enq = run()
    n_kern = dict(K.LAUNCHES)
    with plain_attention(FA, ref):
        want, wall_plain, _ = run()
    if n_kern["flash_prefill"] != cfg.num_layers \
            or n_kern["flash_decode"] != cfg.num_layers * DECODE_STEPS \
            or dict(K.LAUNCHES) != n_kern:
        raise AssertionError(f"model phase launches {n_kern} -> "
                             f"{dict(K.LAUNCHES)}")
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a[:, :cfg.vocab_size], b[:, :cfg.vocab_size]
        if a.shape != (B, cfg.vocab_size) or not torch.isfinite(a).all():
            raise AssertionError(f"model: logits {i} bad shape/non-finite")
        rel = float((a - b).abs().max() / b.abs().max())
        worst = max(worst, rel)
        agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        log(f"[model] {'prefill' if i == 0 else f'decode {i}'}: "
            f"rel err {rel:.3e}, greedy agreement {agree:.2f}")
    if worst > MODEL_RTOL:
        raise AssertionError(f"model: rel err {worst:.3e} > {MODEL_RTOL}")
    log(f"[model] {cfg.name} full width bf16: prefill S={S} rows "
        f"{lens.tolist()} + {DECODE_STEPS} decode steps, kernels vs plain "
        f"attention max rel err {worst:.3e} (tolerance {MODEL_RTOL})")
    for name, w in (("kernels", wall), ("plain attention", wall_plain)):
        log(f"[model] wall with {name}: prefill {w[0]:.2f} ms, decode step "
            f"mean {float(np.mean(w[1:])):.2f} ms "
            f"(min {min(w[1:]):.2f}, max {max(w[1:]):.2f})")
    log(f"[model] host time to queue a decode step (kernels): mean "
        f"{float(np.mean(enq)):.2f} ms of {float(np.mean(wall[1:])):.2f} ms "
        f"wall; {cfg.num_layers} x K1 at these lengths is about "
        f"{cfg.num_layers} x the kernel's time above")


def phase_serve(cfg, params, K):
    from repro_torch.serving.engine import ServingEngine, requests_from_trace
    from repro_torch.serving.workload import make_trace
    trace = make_trace("poisson", RATE, N_REQUESTS, seed=0)
    reqs = requests_from_trace(trace, cfg.vocab_size,
                               max_prompt=MAX_LEN // 2, max_new=MAX_NEW)
    engine = ServingEngine(cfg, params, slots=B, max_len=MAX_LEN,
                           device="cuda")
    engine.warmup()
    K.reset_launch_counts()             # count the main path's run only
    t = time.perf_counter()
    stats = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(K.LAUNCHES)
    for r in reqs:
        if len(r.output) != r.max_new_tokens or r.finished < 0 \
                or not all(0 <= x < cfg.vocab_size for x in r.output):
            raise AssertionError(f"request {r.rid}: {len(r.output)} tokens"
                                 f" of {r.max_new_tokens}")
    if stats.completed != len(reqs):
        raise AssertionError(f"completed {stats.completed}/{len(reqs)}")
    if launches["flash_prefill"] != cfg.num_layers * stats.prefill_batches \
            or launches["flash_decode"] != cfg.num_layers \
            * stats.decode_steps or min(launches.values()) == 0:
        raise AssertionError(f"serve launches {launches} vs {stats}")
    s = stats.summary()
    decode_tokens = sum(len(r.output) - 1 for r in reqs)
    log(f"[serve] {cfg.name} full width bf16, slots {B}, max_len "
        f"{MAX_LEN}: {len(reqs)} requests (prompts "
        f"{[len(r.prompt) for r in reqs]}, new "
        f"{[r.max_new_tokens for r in reqs]})")
    log(f"[serve] mean TTFT {s['mean_ttft']:.4f} s, mean TPOT "
        f"{s['mean_tpot']:.4f} s, decode tokens/s "
        f"{decode_tokens / wall:.1f} ({decode_tokens} decode tokens in "
        f"{wall:.3f} s wall), {s['decode_steps']} decode steps, "
        f"{s['prefill_batches']} prefill batches, launches {launches}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
        return 1
    import repro_torch.configs as configs
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    phase_build(K)
    rows = phase_kernels(K, ref)

    cfg = configs.get(ARCH)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    t = time.perf_counter()
    params = M.init_params(cfg, generator=g, device="cuda")
    torch.cuda.synchronize()
    log(f"[model] {cfg.name} params on the card in "
        f"{time.perf_counter() - t:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    phase_model(cfg, params, M, K, FA, ref)
    launches = phase_serve(cfg, params, K)

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
