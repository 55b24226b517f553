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
              is missing; the same counts in the head_dim-256 kernels'
              own machine code (K2's wgmma kernel HGMMA and UTMALDG,
              K1's mma.sync kernel HMMA and LDGSTS), and fail on any
              spill that ptxas -v reports for the eight D-256 kernels
              (bf16 and fp32 of K1 and K2, each without and with the
              logit softcap);
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
              bottom-right causal mask); K2's non-causal mode at
              seamless-m4t-large-v2's encoder (4 x 1024 frames, 16 heads
              of 64), its cross-attention (512 queries over 1024 frames)
              and a ragged pair (37 over 1000), K1 over a whole cross cache
              and at qwen2-vl-7b's 32 (28 padded) / 4 heads of 128, timed
              against SDPA without a mask; K1 and K2 at gemma-2b's
              head_dim 256 (8 query heads over one KV head): K2 causal at
              4 x 512, with a sliding window, ragged, at one chunk (Sq 128
              at q_offset 384 over 512) and not causal on a ragged pair
              (37 over 1000), K1 at lengths 512 of a 1024-slot cache and
              ragged; its decode, prompt and chunk rows timed against
              SDPA; K1 and K2 with the logit softcap (cap * tanh(logit /
              cap)) at head_dim 64, 112, 128 and 256, fp32 and bf16: K2
              causal, windowed, at one chunk (q_offset 384) and not causal
              (37 over 1000), K1 at lengths 512 and ragged, on inputs whose
              scaled logits reach at least twice the cap, each also apart
              from the uncapped kernel's output by at least 10 x atol; K1
              and K2 (and the D-256 chunk) with the cap timed in bf16
              beside the plain version, flex_attention with a softcap
              score_mod, SDPA without a cap and the kernel without it;
     graph    the engine's decode step as one CUDA graph, for llama3-8b,
              gpt-oss-20b, rwkv6-3b, zamba2-7b and gemma-2b (without and
              with the logit softcap) at full width and GRAPH_LAYERS
              layers in bf16: the serve phase's 8 requests, all at 0, on
              4 slots (admissions between steps), served by an engine
              that captures the step once and replays it, and by one
              forced eager by an identity ``decode_fn``: identical greedy
              tokens, one capture and a replay for every later step, the
              same kernels run on the card on both paths (K1, K3, K4 per
              step; a replay's from a device trace of the graph's first
              replay, which must hold the kernels the capture recorded),
              no host sync in a step or a replay, and each sync window's
              columns distinct tensors; every later engine of the script
              captures its step too, and its launch counts are counted
              the same way (a capture's recorded calls left out, each
              replay's kernels from its graph's device trace);
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
              steps wrap it; kernels against plain versions, tight; then
              once more with a logit softcap of a quarter of the
              uncapped prefill's largest scaled logit (K1's ring decode
              and K2's window with the cap);
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
  ep          after gpt-oss-20b's "paged" check, with its bf16 weights
              still loaded, the expert-parallel MoE (``moe_impl="ep"``,
              ``layers._moe_ep``) on a (1, 1) ("data", "model") mesh
              over a one-rank NCCL group on an in-memory store
              (destroyed after): at capacity factor E/k (dropless) the
              model check's prefill and 8 decode steps (no host sync)
              held against the ragged path (K3) at MODEL_RTOL with its
              expert choices replayed, then free-running with the
              routing flips and the first differing greedy token
              counted; the serve phase's 8 requests through the engine
              with ep and with ragged, token agreement reported; at the
              default factor 1.25 the share of assignments dropped at
              prefill and decode, the prefill and decode-step walls and
              the peak memory beside the ragged path's; K3 launches 0 in
              every ep run, K1 and K2 as in phase 5;
  roofline    after "ep", gpt-oss-20b's weights freed: (a) the dry run
              (``python -m repro_torch.launch.dryrun``, fake CUDA tensors
              on a fake process group) of llama3-8b decode_32k on the
              16 x 16 pod, gpt-oss-20b decode_32k (``ep``) on 2 x 16 x 16
              and qwen3-1.7b train_4k on 16 x 16, in three subprocesses
              at once: each record ok, its per-chip memory, FLOPs, bytes
              and collective bytes, and the report's table (modeled
              numbers); (d) K2 at B 1, S 32768 (llama3-8b's heads) held
              against its plain version run in query chunks; (b) on a
              one-rank NCCL group and the (1, 1) mesh, three reduced
              cells, each dry-run first: llama3-8b decode_32k at the
              largest B whose arguments + temp bytes stay under 90% of
              80 GB, the cache full (pos 32767); llama3-8b prefill_32k
              at B 1, S 32768; qwen3-1.7b train_4k at B 1, S 4096, remat;
              each real step (random weights, plain tensors) counted by
              FlopCounterMode (it must equal the dry run's FLOPs), its
              peak memory against the dry run's inputs + temp, its
              wall and device time (torch.profiler's kernel sum) and
              the roofline bound max(FLOPs / 989e12, bytes / 3.35e12)
              as a share of each (train: also the model-FLOP share);
              (c) the decode cell once more on DTensors over the same
              mesh: logits within MODEL_RTOL of the plain step's, K1
              launched 32 times; K1 at the decode cell's B, T 32768 (and
              its plain version) and K2 at B 1, S 32768, each timed with
              CUDA events beside SDPA (``enable_gqa``; causal for K2);
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
  gemma    gemma-2b (18 layers, d 2048, 8 query heads over one KV head
              of 256, GeGLU, tied embeddings, vocab 256,000) at full
              width and depth, through K1 and K2 at head_dim 256: the
              model check of phase 3 in fp32 (10.0 GB of parameters,
              logits at MODEL_RTOL) and in bf16 (prompts [512, 300, 77,
              5], 8 decode steps without a host sync), its prefill and
              step wall beside the kernels' share; the serving run, with
              K1 = 18 per decode step and K2 = 18 per admission; the
              "paged" checks trimmed to the paged engine (preempt, spill,
              prefetch, a bitwise round trip) and the chunked-admission
              engine (K2 at q_offset > 0); ``launch.serve --arch
              gemma_2b`` once on the card, every request completed; then,
              the same weights loaded, gemma-2b with the logit softcap of
              Gemma 2's published configurations (50.0): the bf16 model
              check, the serving run (K1 = 18 a step, K2 = 18 an
              admission) and the chunked-admission engine;
  8. tessera  the Tessera core on the decode step at full width (bf16, B
              4, max_len 1024): the step of all five models traced with
              torch.export (kernel op nodes = launches per step: 32 K1;
              24 K1 + 72 K3; 32 K4; 27 K1; 18 K1); llama3-8b, gpt-oss-20b
              and gemma-2b planned for the H100 + RTX Pro 6000 pair under
              both
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
  encdec      seamless-m4t-large-v2 at the model level (the engine serves
              neither it nor qwen2-vl, as the reference's): in fp32 at 2
              encoder and 2 decoder layers, then at full width and depth
              in bf16, 1024 encoder frames of N(0, 0.02) embeddings and
              right-padded prompts <= 512, one prefill and 8 decode steps
              (no host sync) through the kernels and the plain versions,
              logits held at MODEL_RTOL; attention launches counted by
              site: 72 K2 a prefill (24 encoder and 24 cross, non-causal;
              24 causal) and 48 K1 a step (24 self, 24 cross); prefill and
              step wall beside the kernels' share; the decode step traced
              (48 K1 op nodes, the cross caches' readers pinned), planned
              for the H100 + RTX Pro 6000 pair under both policies and
              run on two streams of the card, bit-identical to the eager
              step;
  vlm         qwen2-vl-7b the same way (2 layers in fp32, then 28): 256
              patch embeddings spliced at positions [0, 256) and M-RoPE
              ids laid out as Qwen2-VL's get_rope_index lays out a 16 x 16
              image and the text after it (a decode step's ids are its
              slot - 240, computed on the device); 28 K2 a prefill and 28
              K1 a step; a decode step with and without the ids writes
              the same slots with keys rotated apart; the traced step
              takes the ids as a fifth argument;
  train       qwen3-1.7b at full width and depth in bf16 (20 Trainer
              steps, one S 4096 step, fp32 accumulation and remat checks,
              crash and resume, ``launch.train``); rwkv6-3b at full width
              and depth in bf16 through the chunked WKV training scan
              (``ssm._wkv_chunked``): 3 train steps at S 4096, B 1, remat,
              a step at S 512 beside the per-token scan's, and at 2 layers
              in fp32 the two forms' loss and every gradient at the train
              tests' tolerance; no kernel launched by any of it;
  9. card     the card's name and power limit from nvidia-smi.

The last lines are the kernels' JSON record, the nvidia-smi line and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside it, the script fails and prints no result.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import types

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils._pytree as pytree

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
# the "graph" phase's models and their depth (zamba2-7b: two groups of
# three Mamba2 layers, each closed by the shared attention block)
GRAPH_ARCHS = ("llama3_8b", "gpt_oss_20b", "rwkv6_3b", "zamba2_7b",
               "gemma_2b")
GRAPH_LAYERS = 6
# K2 at one chunk of a chunked llama3-8b admission: the last 128-token
# chunk of a 512-token prompt
CHUNK_SQ, CHUNK_OFFSET = 128, 384
# attention shapes (H, Hkv, D) of the attention models (qwen2-vl-7b's 28
# query heads padded to 32, as the reference pads them)
LLAMA_ATTN = (32, 8, 128)
GPTOSS_ATTN = (64, 8, 64)
ZAMBA_ATTN = (32, 32, 112)
SEAMLESS_ATTN = (16, 16, 64)
QWEN_ATTN = (32, 4, 128)
GEMMA_ATTN = (8, 1, 256)              # gemma-2b: MQA, rep 8, head_dim 256
# the "encdec" phase: 1024 encoder frames (the reference's
# ENC_LEN_DEFAULT); the "vlm" phase: 256 patches of a 16 x 16 image at
# positions [0, 256), text after them
ENC_LEN = 1024
VLM_PATCHES, VLM_SIDE = 256, 16
# fp32 depth of the two phases' tight checks (encoder and decoder layers)
SMALL_DEPTH = 2
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
# K1's log-sum-exp form at T 32768 and its 16-shard merge ("roofline"
# (e)): TOL's atol is about the size of a long row's output (~0.01), so
# each row (b) is held instead to LONG_ROW_REL of its own largest |value|,
# and the log-sum-exp (~10.9) to LONG_LSE_ATOL.  Set between the readings
# on an H100 (PERF.md): the sound kernel and merge at most 7.5e-3 and
# 7.6e-4 (the plain version's bf16 rounding of q x scale at D 128), a
# planted fault at least 7.0e-2 or 2.7e-3 (one 64-key tile lost, one
# shard dropped or weighed twice), which (e) plants again on each run.
LONG_ROW_REL, LONG_LSE_ATOL = 2e-2, 2e-3
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
            "flash_decode_lse":
                "src/repro/kernels/flash_attention/kernel.py:188",
            "flash_prefill": "src/repro/kernels/flash_attention/kernel.py:93",
            "gmm": "src/repro/kernels/moe_gmm/kernel.py:32",
            "wkv": "src/repro/kernels/rwkv6/kernel.py:53",
            "ssd": "src/repro/kernels/mamba2_ssd/kernel.py:76"}
# libraries whose kernels must run on wgmma fed by TMA, and those whose
# bf16 paths must run on mma.sync fed by cp.async (phase 1)
WGMMA_TMA_LIBS = ("flash_prefill", "gmm")
MMA_CPASYNC_LIBS = ("flash_decode", "wkv", "ssd")
# K1's and K2's head_dim-256 kernels (gemma-2b), each checked in its own
# machine code (its mangled name holds the template arguments, ILi256E
# and Lb0E without the logit softcap, Lb1E with it) for the instructions
# it must run on, and in ptxas's report for spills
D256_KERNELS = {"flash_prefill": (("prefill_wgmma_kernel", ("HGMMA",
                                                            "UTMALDG")),
                                  ("prefill_fma_kernel", ())),
                "flash_decode": (("decode_mma_kernel", ("HMMA", "LDGSTS")),
                                 ("decode_fma_kernel", ()),
                                 ("decode_mma_lse_kernel", ("HMMA",
                                                            "LDGSTS")),
                                 ("decode_fma_lse_kernel", ()))}
# K1's log-sum-exp kernels, each instantiated at every head_dim
LSE_KERNELS = ("decode_mma_lse_kernel", "decode_fma_lse_kernel")
LSE_HEAD_DIMS = (64, 112, 128, 256)
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


def row_rel_err(got, want) -> float:
    """max over rows (dimension 0) of max|got - want| / max|want| in the
    row; inf if a value is not finite or the shapes differ."""
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got.float()).all():
        return float("inf")
    err = (got.float() - want.float()).abs().flatten(1).amax(1)
    return float((err / want.float().abs().flatten(1).amax(1)).max())


def check_rows(name, got, want, rel) -> float:
    """``row_rel_err`` of got against want, which must be at most rel."""
    err = row_rel_err(got, want)
    if not err <= rel:
        raise AssertionError(f"{name}: a row is {err:.3e} of its largest "
                             f"|value| off (limit {rel})")
    return err


def kcost():
    """K1-K5's operations and bytes (``repro_torch/kernels/cost.py``): the
    formulas the dry run's FLOP counts use."""
    from repro_torch.kernels import cost
    return cost


def bound(work, dtype) -> dict:
    """The least time of ``work`` (operations, bytes) on the card."""
    flops, nbytes = work
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
    for name, lib in libs.items():
        for line in nvcc.build_log(lib).splitlines():
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
    check_d256_build(nvcc, libs)
    check_lse_build(nvcc, libs)


def check_lse_build(nvcc, libs) -> None:
    """Every instantiation of K1's log-sum-exp kernels (LSE_KERNELS at
    each head_dim, without and with the softcap) is in ptxas's report,
    with 0 bytes of spill stores and loads."""
    usage = nvcc.ptxas_usage(nvcc.build_log(libs["flash_decode"]))
    for kern in LSE_KERNELS:
        for D, cap in ((d, c) for d in LSE_HEAD_DIMS for c in (0, 1)):
            tag = f"{kern}ILi{D}ELb{cap}E"
            reports = [u for f, u in usage.items() if tag in f]
            if len(reports) != 1 or reports[0]["spill_stores"] \
                    or reports[0]["spill_loads"]:
                raise AssertionError(f"flash_decode: {kern}<{D}, "
                                     f"{'cap' if cap else 'no cap'}>: "
                                     f"ptxas reports {reports}")
    log(f"[build] flash_decode: {' and '.join(LSE_KERNELS)} at head_dim "
        f"{', '.join(map(str, LSE_HEAD_DIMS))}, without and with the cap: "
        "0 bytes of spill stores and loads")


def check_d256_build(nvcc, libs) -> None:
    """Each of D256_KERNELS, without the softcap and with it: its own SASS
    holds its instructions, and ptxas reports 0 bytes of spill stores and
    loads for it."""
    for name, kerns in D256_KERNELS.items():
        ops = tuple(op for _, o in kerns for op in o)
        by_fn = nvcc.sass_counts_by_function(libs[name], ops)
        usage = nvcc.ptxas_usage(nvcc.build_log(libs[name]))
        for (kern, want), cap in ((kw, c) for kw in kerns for c in (0, 1)):
            tag = f"{kern}ILi256ELb{cap}E"
            what = f"{kern}<256, {'cap' if cap else 'no cap'}>"
            fns = [f for f in by_fn if tag in f]
            reports = [f for f in usage if tag in f]
            if len(fns) != 1 or len(reports) != 1:
                raise AssertionError(f"{name}: {what} in the SASS {fns}, in "
                                     f"ptxas's report {reports}")
            found = {op: by_fn[fns[0]][op] for op in want}
            u = usage[reports[0]]
            log(f"[build] {name}: {what}: "
                + (" and ".join(f"{n} {op}" for op, n in found.items())
                   + " instructions; " if found else "")
                + f"ptxas: {u['registers']} registers, "
                f"{u['spill_stores']} bytes of spill stores, "
                f"{u['spill_loads']} of spill loads")
            if not all(found.values()) or u["spill_stores"] \
                    or u["spill_loads"]:
                raise AssertionError(f"{name}: {what}: {found}, {u}")


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
        dec = bound(kcost().decode(B, H, Hkv, D, n_tok, es), dt)
        pre_sets = [prefill_inputs(g, dt, PROMPT, attn) for _ in range(3)]
        # no window, or one (4096) wider than the prompt: the causal pairs
        pre = bound(kcost().prefill(B, PROMPT, PROMPT, H, Hkv, D,
                                    kcost().prefill_pairs(PROMPT, PROMPT, 0,
                                                          window), es), dt)

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
    pairs = kcost().prefill_pairs(CHUNK_SQ, Skv, CHUNK_OFFSET)
    bnd = bound(kcost().prefill(B, CHUNK_SQ, Skv, H, Hkv, D, pairs, es), dt)
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


def sdpa_full(q, k, v):
    """SDPA with no mask (every query sees every key): the yardstick of
    K2's non-causal mode."""
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        enable_gqa=True)


# K1 and K2 at the encdec and vlm main paths' shapes, B 4: (row, kernel,
# (H, Hkv, D), Sq (K2) or lengths (K1), Skv (K2) or cache slots (K1),
# causal (K2)).  seamless: the encoder (1024 frames), the cross-attention
# of a 512-token prompt over them, the decoder's causal prompt, a decode
# step's self-attention at 512 tokens and its cross-attention over the
# whole cross cache; qwen2-vl: the prompt and a decode step at 512.
ENCDEC_VLM_ROWS = (
    ("flash_prefill_seamless_enc", "flash_prefill", SEAMLESS_ATTN, ENC_LEN,
     ENC_LEN, False),
    ("flash_prefill_seamless_cross", "flash_prefill", SEAMLESS_ATTN, PROMPT,
     ENC_LEN, False),
    ("flash_prefill_seamless_self", "flash_prefill", SEAMLESS_ATTN, PROMPT,
     PROMPT, True),
    ("flash_prefill_qwen2vl", "flash_prefill", QWEN_ATTN, PROMPT, PROMPT,
     True),
    ("flash_decode_seamless_self", "flash_decode", SEAMLESS_ATTN,
     [PROMPT] * B, MAX_LEN, None),
    ("flash_decode_seamless_cross", "flash_decode", SEAMLESS_ATTN,
     [ENC_LEN] * B, ENC_LEN, None),
    ("flash_decode_qwen2vl", "flash_decode", QWEN_ATTN, [PROMPT] * B,
     MAX_LEN, None),
)


def check_and_time_encdec_vlm(g, FK, FR) -> list:
    """K2's non-causal mode and K1 and K2 at the encdec and vlm shapes
    against their plain versions, fp32 (tight) and bf16 (TOL): K2
    non-causal at the encoder (1024 x 1024), the cross-attention (512
    queries over 1024 frames) and a ragged pair (37 over 1000: neither a
    multiple of 64); K1 over a whole cross cache (rep 1, D 64) and at
    qwen2-vl's rep 8, D 128; K2 causal at both families' prompts.  Then
    the rows of ENCDEC_VLM_ROWS timed in bf16 against the plain version
    and SDPA (no mask, ``is_causal``, or the length mask)."""
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        for attn, S, Skv, causal in (
                (SEAMLESS_ATTN, ENC_LEN, ENC_LEN, False),
                (SEAMLESS_ATTN, PROMPT, ENC_LEN, False),
                (SEAMLESS_ATTN, 37, 1000, False),
                (SEAMLESS_ATTN, PROMPT, PROMPT, True),
                (QWEN_ATTN, PROMPT, PROMPT, True),
                (QWEN_ATTN, 37, 37, True)):
            q, k, v = prefill_inputs(g, dtype, S, attn, Skv)
            what = (f"K2 {tag} (H, Hkv, D)={attn} Sq={S} Skv={Skv} "
                    f"causal={causal}")
            e = check(what, FK.flash_prefill(q, k, v, causal=causal),
                      FR.prefill_attention(q, k, v, causal=causal),
                      TOL[dtype])
            log(f"[kernels] {what}: max abs err {e:.3e}")
            if dtype == torch.bfloat16:
                key = ("flash_prefill", attn, causal)
                errs[key] = max(errs.get(key, 0.0), e)
        for attn, T, lengths in ((SEAMLESS_ATTN, ENC_LEN, [ENC_LEN] * B),
                                 (SEAMLESS_ATTN, MAX_LEN, [1, 77, 512, 1024]),
                                 (QWEN_ATTN, MAX_LEN, [1, 300, 512, 1024]),
                                 (QWEN_ATTN, MAX_LEN, [PROMPT] * B)):
            q, k, v, lens = decode_inputs(g, dtype, lengths, attn, T)
            what = f"K1 {tag} (H, Hkv, D)={attn} T={T} lengths={lengths}"
            e = check(what, FK.flash_decode(q, k, v, lens),
                      FR.decode_attention(q, k, v, lens), TOL[dtype])
            log(f"[kernels] {what}: max abs err {e:.3e}")
            if dtype == torch.bfloat16:
                key = ("flash_decode", attn, None)
                errs[key] = max(errs.get(key, 0.0), e)
    dt, es = torch.bfloat16, 2
    rows = []
    for name, kname, attn, S, Skv, causal in ENCDEC_VLM_ROWS:
        H, Hkv, D = attn
        if kname == "flash_prefill":
            sets = [prefill_inputs(g, dt, S, attn, Skv) for _ in range(3)]
            pairs = kcost().prefill_pairs(S, Skv, causal=causal)
            bnd = bound(kcost().prefill(B, S, Skv, H, Hkv, D, pairs, es), dt)

            def kern(q, k, v, causal=causal):
                return FK.flash_prefill(q, k, v, causal=causal)

            def plain(q, k, v, causal=causal):
                return FR.prefill_attention(q, k, v, causal=causal)
            lib = sdpa_prefill if causal else sdpa_full
        else:
            sets = [decode_inputs(g, dt, S, attn, Skv) for _ in range(6)]
            n_tok = sum(S)
            bnd = bound(kcost().decode(B, H, Hkv, D, n_tok, es), dt)
            kern, plain, lib = FK.flash_decode, FR.decode_attention, \
                sdpa_decode
        row = {"name": name, "route": "cuda",
               "source": FA_SRC + kname + ".cu", "replaces": REPLACES[kname],
               "launches": 0, "max_abs_err": errs[(kname, attn, causal)],
               "ms": time_ms(kern, sets),
               "plain_ms": time_ms(plain, sets, iters=10), **bnd,
               "library_ms": time_ms(lib, sets)}
        log(f"[kernels] {name} bf16 (H, Hkv, D)={attn} "
            + (f"Sq={S} Skv={Skv} causal={causal}" if causal is not None
               else f"cache {Skv} lengths {S}")
            + f" timing: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        rows.append(row)
    return rows


# K1 and K2 at gemma-2b's head_dim 256 (B 4, 8 query heads over one KV
# head), fp32 and bf16: K2 (Sq, Skv, q_offset, window, causal) causal at
# the prompt, with a sliding window (the mode no shipped D-256 model
# uses, kept covered), ragged, at one chunk of a chunked admission and
# windowed at an offset, and not causal on a ragged pair; K1 (cache
# slots, lengths) at the serve shape, ragged, and over a ragged cache.
D256_PREFILL = ((PROMPT, PROMPT, 0, None, True),
                (PROMPT, PROMPT, 0, SMALL_WINDOW, True),
                (300, 300, 0, 64, True), (37, 37, 0, None, True),
                (CHUNK_SQ, CHUNK_OFFSET + CHUNK_SQ, CHUNK_OFFSET, None, True),
                (200, 456, 256, 100, True), (37, 1000, 0, None, False))
D256_DECODE = ((MAX_LEN, [PROMPT] * B), (MAX_LEN, [1, 77, 512, MAX_LEN]),
               (1000, [1000, 999, 64, 65]))


def check_and_time_d256(g, FK, FR) -> list:
    """K1 and K2 at head_dim 256 against their plain versions (the cases
    of D256_PREFILL and D256_DECODE; fp32 tight, bf16 at TOL), then three
    rows timed in bf16 against the plain version and SDPA: K1 at lengths
    512 of a 1024-slot cache (the length mask), K2 causal at the 4 x 512
    prompt (``is_causal``) and at one chunk, Sq 128 at q_offset 384 over
    Skv 512 (``causal_lower_right``)."""
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        for S, Skv, off, win, causal in D256_PREFILL:
            q, k, v = prefill_inputs(g, dtype, S, GEMMA_ATTN, Skv)
            kw = dict(q_offset=off, window=win) if causal \
                else dict(causal=False)
            what = (f"K2 {tag} (H, Hkv, D)={GEMMA_ATTN} Sq={S} Skv={Skv} "
                    f"q_offset={off} window={win} causal={causal}")
            e = check(what, FK.flash_prefill(q, k, v, **kw),
                      FR.prefill_attention(q, k, v, **kw), TOL[dtype])
            log(f"[kernels] {what}: max abs err {e:.3e}")
            if dtype == torch.bfloat16:
                key = "flash_prefill_chunk" if off else "flash_prefill"
                errs[key] = max(errs.get(key, 0.0), e)
        for T, lengths in D256_DECODE:
            q, k, v, lens = decode_inputs(g, dtype, lengths, GEMMA_ATTN, T)
            what = f"K1 {tag} (H, Hkv, D)={GEMMA_ATTN} T={T} lengths={lengths}"
            e = check(what, FK.flash_decode(q, k, v, lens),
                      FR.decode_attention(q, k, v, lens), TOL[dtype])
            log(f"[kernels] {what}: max abs err {e:.3e}")
            if dtype == torch.bfloat16:
                errs["flash_decode"] = max(errs.get("flash_decode", 0.0), e)
    dt, es = torch.bfloat16, 2
    H, Hkv, D = GEMMA_ATTN
    Skv = CHUNK_OFFSET + CHUNK_SQ
    pairs = kcost().prefill_pairs(CHUNK_SQ, Skv, CHUNK_OFFSET)
    n_tok = PROMPT * B

    def chunk(q, k, v):
        return FK.flash_prefill(q, k, v, q_offset=CHUNK_OFFSET)

    def plain_chunk(q, k, v):
        return FR.prefill_attention(q, k, v, q_offset=CHUNK_OFFSET)
    # (row, kernel, input sets, kernel, plain, SDPA, bound)
    cases = (
        ("flash_decode_d256", "flash_decode",
         [decode_inputs(g, dt, [PROMPT] * B, GEMMA_ATTN) for _ in range(6)],
         FK.flash_decode, FR.decode_attention, sdpa_decode,
         bound(kcost().decode(B, H, Hkv, D, n_tok, es), dt)),
        ("flash_prefill_d256", "flash_prefill",
         [prefill_inputs(g, dt, PROMPT, GEMMA_ATTN) for _ in range(3)],
         FK.flash_prefill, FR.prefill_attention, sdpa_prefill,
         bound(kcost().prefill(B, PROMPT, PROMPT, H, Hkv, D,
                               kcost().prefill_pairs(PROMPT, PROMPT), es),
               dt)),
        ("flash_prefill_chunk_d256", "flash_prefill",
         [prefill_inputs(g, dt, CHUNK_SQ, GEMMA_ATTN, Skv) for _ in range(3)],
         chunk, plain_chunk, sdpa_prefill_lower_right,
         bound(kcost().prefill(B, CHUNK_SQ, Skv, H, Hkv, D, pairs, es),
               dt)))
    rows = []
    for name, kname, sets, kern, plain, lib, bnd in cases:
        row = {"name": name, "route": "cuda",
               "source": FA_SRC + kname + ".cu", "replaces": REPLACES[kname],
               "launches": 0,
               "max_abs_err": errs[name[:-len("_d256")]],
               "ms": time_ms(kern, sets),
               "plain_ms": time_ms(plain, sets, iters=10), **bnd,
               "library_ms": time_ms(lib, sets)}
        log(f"[kernels] {name} bf16 (H, Hkv, D)={GEMMA_ATTN} timing: kernel "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, sdpa "
            f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})")
        rows.append(row)
        del sets
    return rows


# The logit softcap in K1 and K2 (cap * tanh(logit / cap) on the scaled
# logits), at every head_dim, on phase 2's N(0, 1) inputs, whose scaled
# logits reach about 4 (so a cap of 1.5 bites; wider inputs would make
# the plain version's bf16 rounding of q x scale, which the kernels do
# not round, exceed TOL at D 112 and 128).  K2 (Sq, Skv, q_offset,
# window, causal): causal at the prompt, with a sliding window, at one
# chunk (q_offset 384) and not causal on a ragged pair; K1 (cache
# slots, lengths) at the serve shape and ragged.
SOFTCAP_KERNEL = 1.5
SOFTCAP_MIN_REACH = 2.0               # max |scaled logit| / cap, at least
SOFTCAP_MIN_GAP = 10.0                # capped vs uncapped, in units of atol
SOFTCAP_ATTN = {64: GPTOSS_ATTN, 112: ZAMBA_ATTN, 128: LLAMA_ATTN,
                256: GEMMA_ATTN}
SOFTCAP_PREFILL = ((PROMPT, PROMPT, 0, None, True),
                   (PROMPT, PROMPT, 0, SMALL_WINDOW, True),
                   (CHUNK_SQ, CHUNK_OFFSET + CHUNK_SQ, CHUNK_OFFSET, None,
                    True),
                   (37, 1000, 0, None, False))
SOFTCAP_DECODE = ((MAX_LEN, [PROMPT] * B), (MAX_LEN, [1, 77, 512, MAX_LEN]))
# the rows of the kernels' JSON record (the others are logged): those on
# a main path that runs the cap, phase 4's capped window check (D 64)
# and the gemma phase's softcapped model (D 256)
SOFTCAP_ROWS = ("flash_decode_cap_d64", "flash_prefill_cap_d64",
                "flash_decode_cap_d256", "flash_prefill_cap_d256",
                "flash_prefill_chunk_cap_d256")


def scaled_logit_reach(q, k, cap, causal: bool = False) -> float:
    """max |q . k| / sqrt(D) over the (query, key) pairs of one head group
    (query i and keys <= i when ``causal``), over ``cap``: how far past
    the cap the inputs reach."""
    D, Hkv = q.shape[-1], k.shape[2]
    qg = q.reshape(*q.shape[:-2], Hkv, -1, D).float()
    if qg.dim() == 4:                                   # decode: one query
        qg = qg[:, None]
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qg, k.float()).abs()
    if causal:
        logits = logits.tril()
    return float(logits.max()) / D ** 0.5 / cap


def flex_softcap(cap):
    """``flex_attention`` (compiled) with the softcap as its score_mod: the
    one PyTorch call for attention with a capped logit.  Returns
    (attend(q, k, v, block mask) in the kernels' layouts, q (B, H, D)
    being one query a row; the block mask of a causal prefill (Sq, Skv,
    q_offset, window); that of a decode over per-row lengths)."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    torch._dynamo.config.cache_size_limit = 64
    flex = torch.compile(flex_attention)

    def score_mod(score, b, h, q_idx, kv_idx):
        return cap * torch.tanh(score / cap)

    def attend(q, k, v, mask):
        one = q.dim() == 3
        o = flex(q[:, :, None] if one else q.transpose(1, 2),
                 k.transpose(1, 2), v.transpose(1, 2), score_mod=score_mod,
                 block_mask=mask, enable_gqa=True)
        return o[:, :, 0] if one else o.transpose(1, 2)

    def causal_mask(Sq, Skv, q_offset, window):
        def mask_mod(b, h, q_idx, kv_idx):
            ok = kv_idx <= q_idx + q_offset
            if window is not None:
                ok = ok & (kv_idx > q_idx + q_offset - window)
            return ok
        return create_block_mask(mask_mod, None, None, Sq, Skv, device=DEV)

    def length_mask(lengths, T):
        def mask_mod(b, h, q_idx, kv_idx):
            return kv_idx < lengths[b]
        return create_block_mask(mask_mod, lengths.shape[0], None, 1, T,
                                 device=DEV)
    return attend, causal_mask, length_mask


def check_softcap(g, FK, FR) -> dict:
    """K1 and K2 with the softcap against their plain versions at every
    head_dim and mode (SOFTCAP_PREFILL, SOFTCAP_DECODE; fp32 tight, bf16
    at TOL), each case's inputs reaching SOFTCAP_MIN_REACH times the cap,
    and the capped kernel's output at least SOFTCAP_MIN_GAP x atol from
    the uncapped kernel's (a kernel that ignored the cap would fail).
    Returns the largest bf16 error per (kernel, head_dim, chunk)."""
    errs = {}
    cap = SOFTCAP_KERNEL
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        atol = TOL[dtype][0]
        for D, attn in SOFTCAP_ATTN.items():
            cases = [("flash_prefill", sh) for sh in SOFTCAP_PREFILL] + \
                [("flash_decode", sh) for sh in SOFTCAP_DECODE]
            for name, shape in cases:
                if name == "flash_prefill":
                    S, Skv, off, win, causal = shape
                    q, kk, vv = prefill_inputs(g, dtype, S, attn, Skv)
                    kw = dict(q_offset=off, window=win) if causal \
                        else dict(causal=False)
                    args = (q, kk, vv)
                    kern, plain = FK.flash_prefill, FR.prefill_attention
                    what = (f"K2 {tag} softcap {cap} (H, Hkv, D)={attn} "
                            f"Sq={S} Skv={Skv} q_offset={off} window={win} "
                            f"causal={causal}")
                    key = (name, D, bool(off))
                else:
                    T, lengths = shape
                    args = decode_inputs(g, dtype, lengths, attn, T)
                    kw = {}
                    kern, plain = FK.flash_decode, FR.decode_attention
                    what = (f"K1 {tag} softcap {cap} (H, Hkv, D)={attn} T={T}"
                            f" lengths={lengths}")
                    key = (name, D, False)
                got = kern(*args, softcap=cap, **kw)
                e = check(what, got, plain(*args, softcap=cap, **kw),
                          TOL[dtype])
                reach = scaled_logit_reach(args[0], args[1], cap)
                gap = float((got.float() - kern(*args, **kw).float())
                            .abs().max())
                log(f"[kernels] {what}: max abs err {e:.3e}; max |scaled "
                    f"logit| / cap {reach:.2f}, capped vs uncapped kernel "
                    f"{gap:.3e} apart")
                if reach < SOFTCAP_MIN_REACH or gap < SOFTCAP_MIN_GAP * atol:
                    raise AssertionError(f"{what}: the cap does not bite "
                                         f"(reach {reach:.2f}, gap {gap:.3e})")
                if dtype == torch.bfloat16:
                    errs[key] = max(errs.get(key, 0.0), e)
    return errs


def time_softcap(g, FK, FR, errs) -> list:
    """The softcapped K1 (lengths 512 of 1024 slots) and K2 (causal at the
    4 x 512 prompt; at D 256 also at one chunk, Sq 128 at q_offset 384)
    at every head_dim in bf16, timed beside the plain version, the bound,
    ``flex_attention`` with the softcap score_mod (its output held at TOL
    too), SDPA without a cap (the cap's own cost) and the kernel without
    the cap on the same inputs.  Returns the SOFTCAP_ROWS rows."""
    dt, es, cap = torch.bfloat16, 2, SOFTCAP_KERNEL
    try:
        flex, causal_mask, length_mask = flex_softcap(cap)
    except Exception as e:                      # a library's, not the port's
        log(f"[kernels] flex_attention unavailable: {e!r}")
        flex = None
    rows = []
    for D, attn in SOFTCAP_ATTN.items():
        H, Hkv, _ = attn
        window = GPTOSS_WINDOW if D == 64 else None
        cases = [("flash_decode", f"flash_decode_cap_d{D}", None),
                 ("flash_prefill", f"flash_prefill_cap_d{D}", 0)]
        if D == 256:
            cases.append(("flash_prefill", "flash_prefill_chunk_cap_d256",
                          CHUNK_OFFSET))
        for kname, row_name, off in cases:
            if kname == "flash_decode":
                lengths = [PROMPT] * B
                sets = [decode_inputs(g, dt, lengths, attn) for _ in range(6)]
                kw = {}
                bnd = bound(kcost().decode(B, H, Hkv, D, sum(lengths), es), dt)
                sdpa = sdpa_decode
                mask = (length_mask, sets[0][3], MAX_LEN)
            else:
                Sq = CHUNK_SQ if off else PROMPT
                Skv = off + Sq
                sets = [prefill_inputs(g, dt, Sq, attn, Skv) for _ in range(3)]
                kw = dict(q_offset=off, window=window)
                pairs = kcost().prefill_pairs(Sq, Skv, off, window)
                bnd = bound(kcost().prefill(B, Sq, Skv, H, Hkv, D, pairs, es),
                            dt)
                sdpa = sdpa_prefill_lower_right if off else sdpa_prefill
                mask = (causal_mask, Sq, Skv, off, window)

            def kern(*a):
                return getattr(FK, kname)(*a, softcap=cap, **kw)

            def bare(*a):
                return getattr(FK, kname)(*a, **kw)

            def plain(*a):
                return getattr(FR, {"flash_decode": "decode_attention",
                                    "flash_prefill": "prefill_attention"}
                               [kname])(*a, softcap=cap, **kw)
            lib_ms, lib_err = None, None
            if flex is not None:
                try:
                    block_mask = mask[0](*mask[1:])

                    def lib(q, k_, v, *_):
                        return flex(q, k_, v, block_mask)
                    lib_err = check(f"flex_attention softcap {row_name}",
                                    lib(*sets[0]), plain(*sets[0]), TOL[dt])
                    lib_ms = time_ms(lib, sets)
                except AssertionError:
                    raise
                except Exception as e:              # the library's failure
                    log(f"[kernels] {row_name}: flex_attention failed: "
                        f"{e!r}")
            row = {"name": row_name, "route": "cuda",
                   "source": FA_SRC + kname + ".cu",
                   "replaces": REPLACES[kname], "launches": 0,
                   "max_abs_err": errs[(kname, D, bool(off))],
                   "ms": time_ms(kern, sets),
                   "plain_ms": time_ms(plain, sets, iters=10), **bnd,
                   "library_ms": lib_ms}
            nocap = time_ms(bare, sets)
            sdpa_ms = time_ms(sdpa, sets)
            log(f"[kernels] {row_name} bf16 (H, Hkv, D)={attn} softcap {cap} "
                f"timing: kernel {row['ms']:.4f} ms (without the cap "
                f"{nocap:.4f}), plain {row['plain_ms']:.4f} ms, "
                "flex_attention (score_mod softcap) "
                + (f"{lib_ms:.4f} ms (vs plain {lib_err:.3e})"
                   if lib_ms is not None else "not timed")
                + f", SDPA without a cap {sdpa_ms:.4f} ms, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
            if row_name in SOFTCAP_ROWS:
                rows.append(row)
            del sets
    return rows


# K1's log-sum-exp form (for a cache sharded over T: each shard's output
# in float32 and its log-sum-exp, merged by the caller) at every head_dim,
# without and with the softcap, over three sets of lengths: the serve
# shape, ragged, and rows of length 0 (a shard that holds none of a row's
# tokens) beside a row that ends inside the first of K1's splits and a
# full one (the head shapes of SOFTCAP_ATTN).
def lse_lengths(FK, attn) -> list:
    """The three sets of lengths of one head shape (the split planner's
    first split from its own count for this card)."""
    nsplit = FK.decode_splits(B, attn[1], MAX_LEN, FK._sm_count(0))
    first = FK.split_bounds(MAX_LEN, nsplit)[0][1]
    return [[PROMPT] * B, [1, 300, 77, MAX_LEN],
            [0, first // 2 + 1, 0, MAX_LEN]]


def flash_lse(q, k, v):
    """PyTorch's flash attention with its log-sum-exp over every key of
    k/v, each KV head's rep query heads as rep queries of one head (K/V
    read in place, no copy).  -> (o (B, H, D), lse (B, H))."""
    B, H, D = q.shape
    Hkv = k.shape[2]
    o, lse = torch.ops.aten._scaled_dot_product_flash_attention(
        q.view(B, Hkv, H // Hkv, D), k.transpose(1, 2),
        v.transpose(1, 2))[:2]
    return o.reshape(B, H, D), lse.reshape(B, H)


LSE_LIBRARY = "_scaled_dot_product_flash_attention"


def lse_library(args, FR, dtype):
    """The library call for K1's log-sum-exp form on ``args`` (q, k, v,
    lengths), whose rows all have one length n: ``flash_lse`` over the
    cache's first n tokens (a view; no mask is needed), its output and
    log-sum-exp held at TOL against the plain version's.  -> fn(q, k, v,
    lengths)."""
    q, kk, vv, lens = args
    n = int(lens[0])
    if not bool((lens == n).all()):
        raise ValueError(f"{LSE_LIBRARY}: rows of one length only, not "
                         f"{lens.tolist()}")

    def fn(q, k, v, _):
        return flash_lse(q, k[:, :n], v[:, :n])
    o, lse = fn(*args)
    po, plse = FR.decode_attention_lse(*args)
    check(f"{LSE_LIBRARY} vs plain (o)", o, po, TOL[dtype])
    check(f"{LSE_LIBRARY} vs plain (lse)", lse, plse, TOL[dtype])
    return fn


def check_and_time_lse(g, FK, FR) -> float:
    """K1's log-sum-exp form against its plain version, o and lse, at
    every head_dim of SOFTCAP_ATTN, with and without the softcap (the cap
    bites: the capped lse lies at least SOFTCAP_MIN_GAP x atol from the
    uncapped), over ``lse_lengths``, in fp32 and bf16; its output, rounded
    to the input dtype, against K1's on the same inputs; no NaN for rows
    of length 0 (o 0, lse -1e30).  Then timed at llama3-8b's B 4 (lengths
    512) beside K1, the plain version and the library call.  Returns the
    largest bf16 error."""
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        for D, attn in SOFTCAP_ATTN.items():
            for lengths in lse_lengths(FK, attn):
                args = decode_inputs(g, dtype, lengths, attn)
                empty = args[3] == 0
                lses = {}
                for cap in (0.0, SOFTCAP_KERNEL):
                    what = (f"K1 lse {tag} softcap {cap} (H, Hkv, D)={attn} "
                            f"lengths={lengths}")
                    o, lse = FK.flash_decode_lse(*args, softcap=cap)
                    po, plse = FR.decode_attention_lse(*args, cap)
                    e = max(check(what + " o", o, po, TOL[dtype]),
                            check(what + " lse", lse, plse, TOL[dtype]))
                    k1 = FK.flash_decode(*args, softcap=cap)
                    e1 = check(what + " vs K1", o.to(dtype)[~empty],
                               k1[~empty], TOL[dtype])
                    if not (bool((o[empty] == 0).all())
                            and bool((lse[empty] == -1e30).all())):
                        raise AssertionError(f"{what}: a row of length 0 "
                                             "gave o != 0 or lse != -1e30")
                    lses[cap] = lse
                    log(f"[kernels] {what}: max abs err {e:.3e} (o and lse "
                        f"vs plain), o vs K1's {e1:.3e} (bitwise "
                        f"{torch.equal(o.to(dtype)[~empty], k1[~empty])})")
                    if dtype == torch.bfloat16:
                        worst = max(worst, e)
                gap = float((lses[0.0] - lses[SOFTCAP_KERNEL]).abs().max())
                if gap < SOFTCAP_MIN_GAP * TOL[dtype][0]:
                    raise AssertionError(f"K1 lse {tag} {attn} {lengths}: "
                                         f"the cap does not bite ({gap:.3e})")
    dt = torch.bfloat16
    H, Hkv, D = LLAMA_ATTN
    sets = [decode_inputs(g, dt, [PROMPT] * B, LLAMA_ATTN) for _ in range(6)]
    lib_fn = lse_library(sets[0], FR, dt)
    t = {"lse": time_ms(FK.flash_decode_lse, sets),
         "k1": time_ms(FK.flash_decode, sets),
         "plain": time_ms(FR.decode_attention_lse, sets, iters=10),
         "library": time_ms(lib_fn, sets)}
    bnd = bound(kcost().decode_lse(B, H, Hkv, D, B * PROMPT, 2), dt)
    log(f"[kernels] flash_decode_lse bf16 B {B} (H, Hkv, D)={LLAMA_ATTN} "
        f"lengths {PROMPT} on {card()}: kernel {t['lse']:.4f} ms, K1 without "
        f"the log-sum-exp {t['k1']:.4f} ms, plain {t['plain']:.4f} ms, "
        f"{LSE_LIBRARY} {t['library']:.4f} ms, bound "
        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
    return worst


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
        bnd = bound(kcost().gmm(M, d, f, busy, 2), dt)
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
    return bound(kcost().wkv(Bn, S, H, P, es), torch.float32)


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
    return bound(kcost().ssd(Bn, S, H, P, N, es), "tf32")


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
KERNEL_NAMES = ("flash_decode", "flash_decode_lse", "flash_prefill", "gmm",
                "wkv", "ssd")


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


def vlm_positions3(length: int) -> np.ndarray:
    """(3, B, length) M-RoPE ids of a prompt that starts with one image of
    VLM_PATCHES patches on a VLM_SIDE-wide grid, laid out as Qwen2-VL's
    ``get_rope_index`` does: patch i at (t, h, w) = (0, i // side, i %
    side), then text from the largest id + 1 on all three axes."""
    p3 = np.zeros((3, length), np.int32)
    i = np.arange(VLM_PATCHES)
    p3[1, :VLM_PATCHES], p3[2, :VLM_PATCHES] = i // VLM_SIDE, i % VLM_SIDE
    p3[:, VLM_PATCHES:] = np.arange(length - VLM_PATCHES) + VLM_SIDE
    return np.broadcast_to(p3[:, None], (3, B, length)).copy()


# a vlm text token in cache slot p rotates at p - VLM_SHIFT
VLM_SHIFT = VLM_PATCHES - VLM_SIDE


def model_inputs(cfg, S: int):
    """The extra inputs of a B-row model call with S-token prompts:
    (init_cache kwargs, prefill kwargs, a function of the decode
    positions (B,) giving decode_step kwargs).  encdec: ENC_LEN encoder
    frames of N(0, 0.02) embeddings (as ``tests/test_arch_smoke.py``'s),
    cross caches of ENC_LEN; vlm: VLM_PATCHES patch embeddings of the
    same scale at positions [0, VLM_PATCHES) with the grid's M-RoPE ids,
    and each decode step's ids computed on the device from the positions
    (no host sync); other families: none."""
    g = torch.Generator(device=DEV)
    g.manual_seed(2)
    if cfg.family == "encdec":
        enc = randn(g, B, ENC_LEN, cfg.d_model, dtype=cfg.torch_dtype)
        return {"enc_len": ENC_LEN}, {"enc_embeds": enc * 0.02}, \
            lambda pos: {}
    if cfg.family == "vlm":
        patches = randn(g, B, VLM_PATCHES, cfg.d_model,
                        dtype=cfg.torch_dtype) * 0.02
        p3 = torch.from_numpy(vlm_positions3(S)).to(DEV)
        return {}, {"patch_embeds": patches, "positions3": p3}, \
            lambda pos: {"positions3": (pos - VLM_SHIFT)[None, :, None]
                         .expand(3, B, 1)}
    return {}, {}, lambda pos: {}


def prompt_lens(cfg) -> list:
    """Right-padded prompt lengths of the model checks: a vlm prompt holds
    the image and at least one text token."""
    if cfg.family == "vlm":
        return [PROMPT, 400, 300, VLM_PATCHES + 1]
    return [PROMPT, 300, 77, 5]


@contextlib.contextmanager
def attention_sites(k, sites):
    """Count the model's attention kernel calls in ``sites`` by (kernel,
    site): K1 and K2 inside ``layers.cross_attention`` are "cross", a K2
    call outside it with ``causal=False`` "encoder", every other "self";
    a K2 call whose causal flag does not fit its site raises."""
    where = ["self"]
    cross, pre, dec = k.L.cross_attention, k.FA.prefill_attention, \
        k.FA.decode_attention

    def in_cross(*a, **kw):
        where[0] = "cross"
        try:
            return cross(*a, **kw)
        finally:
            where[0] = "self"

    def prefill(q, k_, v, *, causal=True, **kw):
        site = where[0] if causal or where[0] == "cross" else "encoder"
        if causal != (site == "self"):
            raise AssertionError(f"K2 with causal={causal} at {site}")
        sites[("flash_prefill", site)] += 1
        return pre(q, k_, v, causal=causal, **kw)

    def decode(*a, **kw):
        sites[("flash_decode", where[0])] += 1
        return dec(*a, **kw)
    with swapped(((k.L, "cross_attention", in_cross),
                  (k.FA, "prefill_attention", prefill),
                  (k.FA, "decode_attention", decode))):
        yield


# What the engines' CUDA graphs of the decode step run on the card
# (count_graph_launches): a capture calls each kernel's wrapper, which
# counts a launch, but runs nothing; a replay runs the captured kernels
# and calls no wrapper.  counts() takes the first out and puts the second
# in, each replay's from a device trace of its graph's first replay.
RECORDED: collections.Counter = collections.Counter()
REPLAYED: collections.Counter = collections.Counter()


def counts(k) -> dict:
    return {n: v - RECORDED[n] + REPLAYED[n]
            for m in k.kernels for n, v in m.LAUNCHES.items()}


def reset_counts(k) -> None:
    for m in k.kernels:
        m.reset_launch_counts()
    RECORDED.clear()
    REPLAYED.clear()


def card_kernel(name: str):
    """The launch counter of one of the port's kernels, from its name in
    a device trace (``decode_mma_kernel<128, false>``, ...), or None."""
    if "decode_" in name and "lse_kernel" in name:
        return "flash_decode_lse"
    for tag, counter in (("decode_", "flash_decode"),
                         ("prefill_", "flash_prefill"), ("gmm_", "gmm"),
                         ("wkv_", "wkv"), ("ssd_", "ssd")):
        if tag in name and "_kernel" in name:
            return counter
    return None


def traced_kernels(fn) -> collections.Counter:
    """Run ``fn()`` under torch.profiler's CUDA activity and count the
    port's kernels the card ran, by launch counter.  The sync debug mode
    in force stays on for ``fn`` alone (the profiler's own stop waits for
    the card)."""
    from torch.profiler import ProfilerActivity, profile
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.set_sync_debug_mode(mode)
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    ran = collections.Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            c = card_kernel(e.name())
            if c is not None:
                ran[c] += 1
    return ran


def count_graph_launches(k) -> None:
    """From here on, every engine's CUDA graph is counted by what it runs
    on the card: the wrappers' calls while it records go to RECORDED;
    its first replay runs under a device trace, whose kernels must be
    the recorded ones, and each replay adds them to REPLAYED."""
    from repro_torch.serving.engine import ServingEngine
    record, replay = ServingEngine._record, ServingEngine._replay

    def recorded(self, side):
        before = {n: v for m in k.kernels for n, v in m.LAUNCHES.items()}
        record(self, side)
        calls = collections.Counter({
            n: v - before[n] for m in k.kernels
            for n, v in m.LAUNCHES.items() if v != before[n]})
        RECORDED.update(calls)
        self._smoke_graph = (calls, None)

    def replayed(self):
        calls, ran = self._smoke_graph
        if ran is None:
            out = []
            ran = traced_kernels(lambda: out.append(replay(self)))
            if ran != calls:
                raise AssertionError(
                    f"{self.cfg.name}: a replay of the decode step's graph "
                    f"ran {dict(ran)} on the card, the capture recorded "
                    f"{dict(calls)}")
            self._smoke_graph = (calls, ran)
            out = out[0]
        else:
            out = replay(self)
        REPLAYED.update(ran)
        return out
    ServingEngine._record, ServingEngine._replay = recorded, replayed


def expected_launches(cfg, steps: int, admissions: int,
                      long_admissions: int) -> dict:
    """Launches of each kernel for ``steps`` decode steps and
    ``admissions`` prefills, ``long_admissions`` of them longer than one
    token (a one-token mamba prefill takes the recurrent step, not K5)."""
    n, fam = cfg.num_layers, cfg.family
    out = dict.fromkeys(KERNEL_NAMES, 0)
    if fam in ("dense", "moe", "vlm"):
        out.update(flash_prefill=n * admissions, flash_decode=n * steps)
        if fam == "moe":
            out["gmm"] = 3 * n * (steps + admissions)
    elif fam == "encdec":
        # a prefill: the encoder's layers (non-causal), then each decoder
        # layer's causal self-attention and non-causal cross-attention; a
        # step: each decoder layer's self- and cross-attention
        out.update(flash_prefill=(cfg.encoder_layers + 2 * n) * admissions,
                   flash_decode=2 * n * steps)
    elif fam == "ssm":
        out["wkv"] = n * (steps + admissions)
    elif fam == "hybrid":
        groups = n // cfg.hybrid_attn_every
        out.update(flash_prefill=groups * admissions,
                   flash_decode=groups * steps, ssd=n * long_admissions)
    return out


def phase_model(cfg, params, k, lens, sites=None, walls=None) -> float:
    """Prefill of ``lens`` (right-padded for attention families; equal
    lengths for recurrent ones, whose state a pad token would enter) and
    DECODE_STEPS decode steps, through the kernels and through the plain
    versions; logits held at MODEL_RTOL.  Through the kernels, every
    decode step runs under ``set_sync_debug_mode("error")``: it must make
    no host sync.  (The plain grouped matmul reads the group sizes on the
    host.)  encdec and vlm models take model_inputs' extra inputs.  With
    ``sites`` (a Counter), the kernel run's attention calls are counted
    there by site (attention_sites); ``walls`` gets the kernel run's
    prefill and mean decode-step wall (ms).

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
    cache_kw, prefill_kw, step_kw = model_inputs(cfg, S)

    def run(check_sync: bool):
        """Logits of the prefill and each decode step, the wall time (ms,
        host clock after a synchronise) of each, and the host time each
        decode step took to queue its work (before the synchronise)."""
        cache = M.init_cache(cfg, B, MAX_LEN, device=dev, **cache_kw)
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = M.prefill(params, cfg, toks_d, cache, last_pos=last,
                                  **prefill_kw)
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
                logits, cache = M.decode_step(params, cfg, tok, cache, pos,
                                              **step_kw(pos))
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
    with routing(L, record=routes_k), (
            attention_sites(k, sites) if sites is not None
            else contextlib.nullcontext()):
        got, wall, enq = run(True)
    n_kern = counts(k)
    if walls is not None:
        walls.update(prefill=wall[0], step=float(np.mean(wall[1:])))
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
    if cfg.attn_logit_softcap:
        window += f", logit softcap {cfg.attn_logit_softcap:.4f}"
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
    # a dense model at head_dim 256: its own rows, by name (and with the
    # logit softcap, by name and " softcap")
    "gemma-2b": [("flash_decode_d256", "flash_decode", "decode"),
                 ("flash_prefill_d256", "flash_prefill", "prefill")],
    "gemma-2b softcap": [("flash_decode_cap_d256", "flash_decode", "decode"),
                         ("flash_prefill_cap_d256", "flash_prefill",
                          "prefill")],
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
    rows = SERVE_ROWS.get(cfg.name + (" softcap" if cfg.attn_logit_softcap
                                      else "")) or SERVE_ROWS[cfg.family]
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
    termination; eager, or a replay of its CUDA graph) under
    set_sync_debug_mode("error"): a host sync raises."""
    def guarded(fn):
        def run():
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return run
    engine._step_fused = guarded(engine._step_fused)
    engine._replay = guarded(engine._replay)


def distinct_columns(engine) -> None:
    """Check at each of ``engine``'s syncs that the window's columns are
    distinct tensors (a replay's output is copied, never appended)."""
    settle = engine._settle

    def checked(now):
        ptrs = [c.untyped_storage().data_ptr() for c in engine._cols]
        if len(set(ptrs)) != len(ptrs):
            raise AssertionError(f"a sync window's {len(ptrs)} columns "
                                 "share storage")
        settle(now)
    engine._settle = checked


def phase_graph(configs, k) -> None:
    """GRAPH_ARCHS at full width, GRAPH_LAYERS layers, bf16 (gemma-2b
    without and with the logit softcap, on the same weights): the serve
    phase's trace requests, all arriving at 0 (so admissions fall between
    decode steps as requests finish, in the same order on every run),
    served by the engine as it runs the step (captured at the first step,
    replayed after) and by one forced eager by an identity ``decode_fn``.
    Greedy tokens, decode steps, admissions and the kernels run on the
    card (count_graph_launches: a replay's from its device trace) must be
    identical, the graph engine must have captured once and replayed
    every later step, and neither may make a host sync in a step or a
    replay."""
    for name in GRAPH_ARCHS:
        cfg = dataclasses.replace(configs.get(name), num_layers=GRAPH_LAYERS)
        params = init_params(k.M, cfg)
        graph_against_eager(cfg, params, k)
        if name == GEMMA_ARCH:
            graph_against_eager(dataclasses.replace(
                cfg, attn_logit_softcap=GEMMA_SOFTCAP), params, k)
        free(params)


def graph_against_eager(cfg, params, k) -> None:
    """One model of phase_graph: its graph run against its eager run
    (phase_graph says what must hold)."""
    from repro_torch.serving.engine import requests_from_trace
    from repro_torch.serving.workload import make_trace
    M = k.M
    what = cfg.name + (f" softcap {cfg.attn_logit_softcap}"
                       if cfg.attn_logit_softcap else "")

    def eager(p, c, t, pos):
        return M.decode_step(p, cfg, t, c, pos)
    runs = {}
    for label, knobs in (("graph", {}), ("eager", {"decode_fn": eager})):
        reqs = requests_from_trace(
            make_trace("poisson", RATE, N_REQUESTS, seed=0),
            cfg.vocab_size, max_prompt=PROMPT, max_new=MAX_NEW,
            time_scale=0.0)
        engine, reqs, wall, adm_wall, launches, calls = serve_colocated(
            cfg, params, k, f"graph phase {label}", reqs=reqs,
            hook=distinct_columns, **knobs)
        s = engine.stats.summary()
        long_adm = sum(1 for n, _, _ in calls if n > 1)
        expect = expected_launches(cfg, s["decode_steps"],
                                   s["prefill_batches"], long_adm)
        if launches != expect:
            raise AssertionError(f"graph phase {what} {label}: "
                                 f"launches {launches} vs expected "
                                 f"{expect}")
        runs[label] = (s, [r.output for r in reqs], launches)
        log(f"[graph] {what} {GRAPH_LAYERS} layers {cfg.dtype} "
            f"{label}: {engine_numbers(s, reqs, wall, adm_wall)}, "
            f"{s['graph_captures']} capture(s), {s['graph_steps']} "
            f"replays, launches {launches}")
    (sg, tg, lg), (se, te, le) = runs["graph"], runs["eager"]
    same = ("decode_steps", "prefill_batches", "completed")
    if tg != te or lg != le or any(sg[x] != se[x] for x in same):
        diff = [i for i, (a, b) in enumerate(zip(tg, te)) if a != b]
        raise AssertionError(f"graph phase {what}: the graph's run "
                             f"differs from the eager step's (requests "
                             f"{diff}, launches {lg} / {le}, stats "
                             f"{sg} / {se})")
    if sg["graph_captures"] != 1 \
            or sg["graph_steps"] != sg["decode_steps"] - 1 \
            or (se["graph_captures"], se["graph_steps"]) != (0, 0):
        raise AssertionError(f"graph phase {what}: captures / "
                             f"replays {sg['graph_captures']} / "
                             f"{sg['graph_steps']} of "
                             f"{sg['decode_steps']} steps (eager "
                             f"{se['graph_captures']} / "
                             f"{se['graph_steps']})")
    log(f"[graph] {what}: the graph's greedy tokens, steps and "
        f"launches equal the eager step's ({len(tg)} requests, "
        f"{sg['decode_steps']} steps, {sg['graph_steps']} replays)")


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
    lines["paged"] = paged_run(cfg, params, k, name)
    lines["chunked"], at_offset = chunked_run(cfg, params, k, name)

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


def paged_run(cfg, params, k, name) -> str:
    """A paged engine (KV_POOL blocks of KV_BLOCK tokens, for sessions of
    up to 544 tokens) serves paged_requests: it must preempt, spill and
    prefetch, one session's park -> spill -> prefetch -> activate round
    trip must be bitwise, the pool must drain clean and the launches
    equal the steps' and admissions'.  Returns the run's numbers."""
    M = k.M
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
    line = engine_numbers(eng.stats.summary(), reqs, wall, adm) + (
        f", {pk.preemptions} preemptions, {pk.spills} spills, "
        f"{pk.prefetches} prefetches, round trip of rid {watched[-1][0]} "
        "bitwise")
    pool_mib = KV_POOL * M.kv_block_bytes(cfg, KV_BLOCK) / 2**20
    log(f"[paged] {cfg.name} on {name}, paged engine ({KV_POOL} blocks of "
        f"{KV_BLOCK} tokens = {pool_mib:.0f} MiB pool, {B} slots): "
        f"{line}, launches {launched}")
    return line


def chunked_run(cfg, params, k, name):
    """A chunked-admission engine (PREFILL_CHUNK-token chunks) serves
    paged_requests: every admission is its chunks at offsets 0, chunk,
    ..., each launching K2 once a layer (check_chunk_calls).  Returns the
    run's numbers and the K2 launches at q_offset > 0."""
    eng, reqs, wall, adm, launched, calls = serve_colocated(
        cfg, params, k, "chunked", prefill_chunk=PREFILL_CHUNK)
    at_offset = check_chunk_calls(cfg, calls, eng.stats.prefill_batches,
                                  PREFILL_CHUNK)
    expect = expected_launches(cfg, eng.stats.decode_steps, len(calls), 0)
    if launched != expect:
        raise AssertionError(f"chunked launches {launched} vs {expect}")
    line = engine_numbers(eng.stats.summary(), reqs, wall, adm)
    log(f"[paged] {cfg.name} on {name}, chunked admission "
        f"({PREFILL_CHUNK}-token chunks): {line}; {len(calls)} "
        "prefill calls "
        f"(length, offset) {[(n, o) for n, o, _ in calls]}, K2 = "
        f"{cfg.num_layers} per chunk ({at_offset} at q_offset > 0)")
    return line, at_offset


def phase_paged_gemma(cfg, params, k) -> dict:
    """gemma-2b (bf16, full width): phase_paged_llama's set trimmed to
    its paged engine (paged_run: preempt, spill, prefetch, a bitwise
    round trip) and its chunked-admission engine (chunked_run: K2 at
    q_offset > 0 at head_dim 256); then ``launch.serve --arch gemma_2b``
    once on the card, as cluster_launcher calls the launcher's entry
    point (it makes its own weights; prompts up to max_len / 2 = 512), and
    every request must complete.  Returns {"flash_prefill_chunk_d256": K2
    launches at an offset > 0 in the chunked run}."""
    from repro_torch.launch import serve as launcher
    name = card()
    paged_run(cfg, params, k, name)
    _, at_offset = chunked_run(cfg, params, k, name)
    t = time.perf_counter()
    out = launcher.main(["--arch", GEMMA_ARCH, "--device", DEV,
                         "--requests", str(N_REQUESTS), "--max-len",
                         str(MAX_LEN), "--max-new", str(MAX_NEW), "--trace",
                         "poisson", "--rate", str(RATE)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    torch.cuda.empty_cache()
    if out["completed"] != N_REQUESTS:
        raise AssertionError(f"launch.serve --arch {GEMMA_ARCH}: {out}")
    log(f"[paged] {cfg.name} on {name}: launch.serve --arch {GEMMA_ARCH} "
        f"--device {DEV} --max-len {MAX_LEN}: {out['completed']} requests "
        f"of {N_REQUESTS} completed, {out['decode_steps']} decode steps, "
        f"{out['prefill_batches']} prefill batches, mean TTFT "
        f"{out['mean_ttft']:.4f} s, mean TPOT {out['mean_tpot']:.4f} s, "
        f"{wall:.1f} s with its weights' set-up")
    return {"flash_prefill_chunk_d256": at_offset}


# phase 4 once more with a logit softcap that bites: the cap is the
# model's largest scaled logit of an uncapped kernel prefill over
# WINDOW_SOFTCAP_REACH.  The gemma phase's cap is the one Gemma 2's
# published configurations set (attn_logit_softcapping).
WINDOW_SOFTCAP_REACH = 4.0
GEMMA_SOFTCAP = 50.0


@contextlib.contextmanager
def logit_reach(k, found: list):
    """Each K2 call through ``ops`` also appends the largest causal scaled
    logit of its inputs to ``found`` (a host sync: prefills only)."""
    pre = k.FA.prefill_attention

    def f(q, k_, v, **kw):
        found.append(scaled_logit_reach(q, k_, 1.0,
                                        causal=kw.get("causal", True)))
        return pre(q, k_, v, **kw)
    with swapped(((k.FA, "prefill_attention", f),)):
        yield


def phase_window_softcap(cfg, params, k, lens) -> dict:
    """Phase 4's model (gpt-oss-20b, 2 layers, fp32, window 128: K1's
    ring decode, K2's window) with a logit softcap of its uncapped
    prefill's largest scaled logit / WINDOW_SOFTCAP_REACH: kernels
    against plain versions at MODEL_RTOL (phase_model).  Returns the
    launches of the kernel run for the D-64 softcap rows."""
    M = k.M
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, PROMPT))
                            .astype(np.int32)).to(DEV)
    reach = []
    with logit_reach(k, reach):
        M.prefill(params, cfg, toks, M.init_cache(cfg, B, MAX_LEN,
                                                  device=DEV))
    cap = max(reach) / WINDOW_SOFTCAP_REACH
    capped = dataclasses.replace(cfg, attn_logit_softcap=cap)
    phase_model(capped, params, k, lens)
    n = counts(k)
    log(f"[window] {cfg.name}, {cfg.num_layers} layers, fp32, window "
        f"{cfg.sliding_window}, softcap {cap:.4f} (the uncapped prefill's "
        f"largest scaled logit {max(reach):.3f} / {WINDOW_SOFTCAP_REACH}): "
        f"kernels held against the plain versions as above; launches {n}")
    return {"flash_decode_cap_d64": n["flash_decode"],
            "flash_prefill_cap_d64": n["flash_prefill"]}


def phase_gemma_softcap(cfg, params, k, lens) -> dict:
    """gemma-2b (bf16, full width and depth, its weights loaded) with the
    logit softcap GEMMA_SOFTCAP, which changes no parameter: the model
    check (phase_model: 8 decode steps without a host sync, kernels
    against plain versions at MODEL_RTOL), the serving run (K1 = 18 a
    step, K2 = 18 an admission) and the chunked-admission engine (K2 at
    q_offset > 0).  Returns the launches of the softcap rows."""
    capped = dataclasses.replace(cfg, attn_logit_softcap=GEMMA_SOFTCAP)
    reach = []
    with logit_reach(k, reach):
        phase_model(capped, params, k, lens)
    log(f"[gemma] {cfg.name} softcap {GEMMA_SOFTCAP}: the prompts' largest "
        f"scaled logit over the cap {max(reach):.4f} (random weights)")
    out = phase_serve(capped, params, k)
    _, out["flash_prefill_chunk_cap_d256"] = chunked_run(capped, params, k,
                                                         card())
    return out


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
# ep: expert-parallel MoE on a one-device mesh
# --------------------------------------------------------------------- #
@contextlib.contextmanager
def one_device_mesh():
    """A one-rank NCCL group on an in-memory store (no port opened) and
    the (1, 1) ("data", "model") mesh on the card, made the ambient mesh;
    the group is destroyed on exit."""
    import torch.distributed as dist
    from repro_torch.distributed.context import mesh_context
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device(DEV, 0))
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type=DEV)
        with mesh_context(mesh):
            yield mesh
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def counted_drops(L, out: dict, real: torch.Tensor):
    """Count in ``out`` ("prefill": more than B tokens a call, else
    "decode"; "prefill, prompt tokens": those of a prefill's tokens that
    ``real`` (B*S,) marks, the others being right padding) the
    assignments ``ep_route`` drops, as a device tensor (no host sync),
    and those it routes."""
    ep_route = L.ep_route

    def add(kind, kept):
        dropped, routed = out.get(kind, (0, 0))
        out[kind] = (dropped + (~kept).sum(), routed + kept.numel())

    def counted(xt, router, cfg):
        r = ep_route(xt, router, cfg)
        if xt.shape[0] > B:
            add("prefill", r[3])
            add("prefill, prompt tokens",
                r[3].view(xt.shape[0], -1)[real])
        else:
            add("decode", r[3])
        return r
    L.ep_route = counted
    try:
        yield
    finally:
        L.ep_route = ep_route


def model_run(cfg, params, k, toks, last, lens, steps):
    """One right-padded prefill and DECODE_STEPS decode steps, each step
    under set_sync_debug_mode("error"); returns (fp32 logits of each,
    wall ms of each, host clock after a synchronise; host ms each decode
    step took to queue its work, before the synchronise)."""
    M, dev = k.M, torch.device(DEV)
    cache = M.init_cache(cfg, B, MAX_LEN, device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, cache = M.prefill(params, cfg, toks, cache, last_pos=last)
    outs = [logits.float()]
    torch.cuda.synchronize()
    wall = [(time.perf_counter() - t) * 1e3]
    pos = torch.from_numpy(lens.astype(np.int32)).to(dev)
    enq = []
    for i in range(DECODE_STEPS):
        t = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            logits, cache = M.decode_step(params, cfg, steps[:, i:i + 1],
                                          cache, pos)
            outs.append(logits.float())
            pos = pos + 1
        finally:
            torch.cuda.set_sync_debug_mode(0)
        enq.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t) * 1e3)
    return outs, wall, enq


def device_busy_ms(fn) -> tuple:
    """The summed device time (ms) of the kernels and copies ``fn()``
    launches, from ``torch.profiler``'s CUDA activity (one stream, so
    their sum is the device's busy time, whatever the host's gaps; 0.0
    when the profiler records no device time), and the three largest
    (kernel, ms)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = sorted(((e.self_device_time_total / 1e3, e.key)
                 for e in prof.key_averages()), reverse=True)
    return sum(ms for ms, _ in ev), [(name[:60], ms) for ms, name in ev[:3]]


def logit_gap(cfg, got, want) -> tuple:
    """(max over the calls of max|got - want| / max|want| over the vocab,
    the first (call, row) whose greedy tokens differ, or None)."""
    worst, first = 0.0, None
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a[:, :cfg.vocab_size], b[:, :cfg.vocab_size]
        if a.shape != (B, cfg.vocab_size) or not torch.isfinite(a).all():
            raise AssertionError(f"{cfg.name}: logits {i} bad shape / "
                                 "non-finite")
        worst = max(worst, float((a - b).abs().max() / b.abs().max()))
        rows = (a.argmax(-1) != b.argmax(-1)).nonzero()
        if first is None and len(rows):
            first = (i, int(rows[0, 0]))
    return worst, first


def phase_ep(cfg, params, k) -> None:
    """gpt-oss-20b (bf16, its weights loaded) through the expert-parallel
    MoE (``moe_impl="ep"``) on a (1, 1) mesh over a one-rank NCCL group.
    Dropless (capacity factor E/k): the model check's prefill and 8
    decode steps held against the ragged path (K3) at MODEL_RTOL with the
    ragged run's expert choices replayed, then free-running with the
    routing flips and the first differing greedy token counted; the
    serve phase's 8 requests through the engine beside the ragged
    engine's tokens.  At the default factor 1.25: the share of
    assignments dropped at prefill and decode, the walls and the peak
    memory beside the ragged path's.  Every ep run launches no K3 and
    K1 / K2 as phase 5; no decode step makes a host sync."""
    L = k.L
    t0 = time.perf_counter()
    E, top = cfg.num_experts, cfg.experts_per_token
    dropless = dataclasses.replace(cfg, moe_impl="ep",
                                   moe_capacity_factor=E / top)
    default = dataclasses.replace(cfg, moe_impl="ep")
    rng = np.random.default_rng(0)
    lens = np.asarray([PROMPT, 300, 77, 5])
    toks = np.zeros((B, PROMPT), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    dev = torch.device(DEV)
    steps = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, DECODE_STEPS))
                             .astype(np.int32)).to(dev)
    args = (k, torch.from_numpy(toks).to(dev),
            torch.from_numpy((lens - 1).astype(np.int32)).to(dev), lens,
            steps)
    real = torch.from_numpy(np.arange(PROMPT)[None] < lens[:, None]) \
        .reshape(-1).to(dev)
    expect = expected_launches(cfg, DECODE_STEPS, 1, 1)
    expect_ep = dict(expect, gmm=0)
    rtol = MODEL_RTOL[cfg.torch_dtype]
    labels = ("ragged (K3)", f"ep, factor {E / top:g}",
              f"ep, factor {default.moe_capacity_factor:g}")

    def run(c, check):
        """A model run of config ``c`` from zeroed launch counters, its
        peak memory and its launches, which must be ``check``."""
        reset_counts(k)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        outs, wall, enq = model_run(c, params, *args)
        peak = torch.cuda.max_memory_allocated()
        if counts(k) != check:
            raise AssertionError(f"ep phase: {c.moe_impl} launches "
                                 f"{counts(k)} (expected {check})")
        return outs, (wall, enq), peak

    with one_device_mesh():
        run(dropless, expect_ep)             # first calls: cuBLAS, NCCL
        run(cfg, expect)
        routes_r, routes_e, drops_free, drops = [], [], {}, {}
        with routing(L, record=routes_r):
            ragged, wall_r, peak_r = run(cfg, expect)
        with routing(L, replay=routes_r):
            same, wall_8, peak_8 = run(dropless, expect_ep)
        with routing(L, record=routes_e), \
                counted_drops(L, drops_free, real):
            free, _, _ = run(dropless, expect_ep)
        with counted_drops(L, drops, real):
            _, wall_d, peak_d = run(default, expect_ep)
        held, _ = logit_gap(cfg, same, ragged)
        free_gap, first = logit_gap(cfg, free, ragged)
        flips = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1)
                        .sum()) for a, b in zip(routes_r, routes_e))
        n_choices = sum(a.shape[0] for a in routes_r)
        lost = {w: int(d) for w, (d, _) in drops_free.items()}
        if held > rtol or any(lost.values()):
            raise AssertionError(f"ep (dropless) vs ragged: rel err {held:.3e} "
                                 f"(held at {rtol}), dropped {lost}")
        share = {w: (int(d), n) for w, (d, n) in drops.items()}

        # device time of the prefill and of one decode step: a step is
        # host-bound, and queued behind a device sleep its ~1,500
        # launches fill the launch queue, so the host waits on the sleep
        on_device = {}
        for name, c in zip(labels, (cfg, dropless, default)):
            cache = k.M.init_cache(c, B, MAX_LEN, device=dev)
            pos = torch.from_numpy(lens.astype(np.int32)).to(dev)
            on_device[name] = (
                device_busy_ms(lambda: k.M.prefill(params, c, args[1], cache,
                                                   last_pos=args[2])),
                device_busy_ms(lambda: k.M.decode_step(
                    params, c, steps[:, :1], cache, pos)))

        # the serve phase's 8 requests, all at 0: ragged, then ep
        served = {}
        for c, check in ((cfg, None), (dropless, 0)):
            eng, reqs, wall, _, launches, _ = serve_colocated(
                c, params, k, f"ep phase {c.moe_impl} serve")
            st = eng.stats
            want = expected_launches(cfg, st.decode_steps,
                                     st.prefill_batches, st.prefill_batches)
            if check is not None:
                want["gmm"] = check
            if launches != want:
                raise AssertionError(f"ep phase {c.moe_impl} serve launches "
                                     f"{launches} (expected {want})")
            served[c.moe_impl] = (reqs, engine_numbers(
                st.summary(), reqs, wall), launches)
    rr, re_ = served["ragged"][0], served["ep"][0]
    same_tok = sum(a == b for x, y in zip(rr, re_)
                   for a, b in zip(x.output, y.output))
    n_tok = sum(len(x.output) for x in rr)
    same_req = sum(x.output == y.output for x, y in zip(rr, re_))
    gb = 2 ** 30
    log(f"[ep] {cfg.name} {cfg.dtype} on {card()}: (1, 1) mesh over a one-rank "
        f"NCCL group; dropless (capacity factor {E / top:g}) vs ragged "
        f"(K3), ragged's expert choices replayed: rel err {held:.3e} (held "
        f"at {rtol}); free-running: {flips} of {n_choices} (token, layer) "
        f"expert choices differ, rel err {free_gap:.3e}, first differing "
        f"greedy token at (call, row) {first} (call 0 the prefill; "
        "reported, not held)")
    log(f"[ep] {cfg.name}: launches of an ep run {expect_ep} (K3 0), of "
        f"the ragged run {expect}; no host sync in an ep decode step")
    for name, (w, enq), peak in zip(labels, (wall_r, wall_8, wall_d),
                                    (peak_r, peak_8, peak_d)):
        log(f"[ep] {cfg.name} {name}: prefill 4 x {PROMPT} {w[0]:.2f} ms, "
            f"decode step mean {float(np.mean(w[1:])):.2f} ms (min "
            f"{min(w[1:]):.2f}, max {max(w[1:]):.2f}; host queueing "
            f"{float(np.mean(enq)):.2f} ms of it), peak memory "
            f"{peak / gb:.2f} GiB")
    for name, ((pre, pre_top), (step, step_top)) in on_device.items():
        log(f"[ep] {cfg.name} {name} device busy time (torch.profiler, "
            f"kernels summed): prefill 4 x {PROMPT} "
            + (f"{pre:.2f} ms (largest: "
               + ", ".join(f"{n} {ms:.2f}" for n, ms in pre_top)
               + f"), decode step {step:.2f} ms (largest: "
               + ", ".join(f"{n} {ms:.2f}" for n, ms in step_top) + ")"
               if pre and step
               else "not measured (the profiler saw no device time)"))
    log(f"[ep] {cfg.name} factor 1.25 (prompts {lens.tolist()} right-padded "
        f"to {PROMPT}): dropped " + ", ".join(
        f"{w} {d} of {n} assignments ({100 * d / n:.2f}%)"
        for w, (d, n) in share.items()))
    for impl, (_, numbers, launches) in served.items():
        log(f"[ep] {cfg.name} serve {impl}: {numbers}, launches {launches}")
    log(f"[ep] {cfg.name} serve: ep gives the ragged engine's tokens in "
        f"{same_tok} of {n_tok} positions, {same_req} of {len(rr)} requests "
        f"whole; phase {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------- #
# roofline: the dry run at full width, and three reduced cells on the
# card against their dry runs and the roofline bound
# --------------------------------------------------------------------- #
# (a) full-width dry runs, one subprocess each, on the host's cores
ROOFLINE_DRYRUNS = (("llama3_8b", "decode_32k", "pod1"),
                    ("gpt_oss_20b", "decode_32k", "pod2"),
                    ("qwen3_1_7b", "train_4k", "pod1"))
ROOFLINE_DIR = os.path.join(ROOT, "experiments", "dryrun_torch_chip")
HBM_BYTES, HBM_SHARE = 80e9, 0.9      # (b): the decode cell's B fills 90%
DECODE_ARCH, ROOFLINE_T = "llama3_8b", 32768
K2_LONG_CHUNK = 1024                  # (d): the plain version's query chunk


def start_dryruns() -> list:
    """(a): ``python -m repro_torch.launch.dryrun`` for each cell of
    ROOFLINE_DRYRUNS, started at once (fake CUDA tensors, one thread
    each); the 1-/2-unit extrapolation only for the cheap decode cell."""
    os.makedirs(ROOFLINE_DIR, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = []
    for arch, shape, mesh in ROOFLINE_DRYRUNS:
        out = os.path.join(ROOFLINE_DIR, f"{arch}.{shape}.{mesh}.json")
        if os.path.exists(out):
            os.remove(out)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mesh, "--out",
               ROOFLINE_DIR]
        if shape != "decode_32k":
            cmd.append("--no-extrapolate")
        procs.append((arch, shape, mesh, time.perf_counter(),
                      subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    return procs


def finish_dryruns(procs) -> None:
    """(a): each record ``ok``, its per-chip memory, FLOPs, bytes and
    collective bytes, and the report's table of the single-pod ones."""
    from repro_torch.roofline import report
    recs = []
    for arch, shape, mesh, t0, p in procs:
        text, _ = p.communicate(timeout=900)
        rec = json.load(open(os.path.join(ROOFLINE_DIR,
                                          f"{arch}.{shape}.{mesh}.json")))
        if p.returncode or not rec.get("ok"):
            raise AssertionError(f"[roofline] dry run {arch} {shape} {mesh}:"
                                 f" rc {p.returncode}\n{text[-3000:]}\n"
                                 f"{rec.get('error', '')[-3000:]}")
        m, c = rec["memory"], rec["cost"]
        log(f"[roofline] (a) {arch} {shape} {mesh} ({rec['devices']} chips): "
            f"ok in {time.perf_counter() - t0:.1f} s (trace "
            f"{rec['compile_s']} s); per chip: arguments "
            f"{m['argument_bytes'] / 1e9:.3f} GB, temp "
            f"{m['temp_bytes'] / 1e9:.3f} GB, outputs "
            f"{m['output_bytes'] / 1e9:.3f} GB (in place "
            f"{m['alias_bytes'] / 1e9:.3f}), {c['flops']:.4e} FLOPs, "
            f"{c['bytes']:.4e} bytes, collectives "
            f"{rec['collectives']['per_chip_bytes']:.4e} bytes "
            f"{rec['collectives']['by_op']}")
        recs.append(rec)
    rows = [report.analyze_record(r) for r in recs]
    log("[roofline] (a) " + report.terms_line() + " (modeled, not measured)")
    for line in report.fmt_table([r for r in rows if r]).splitlines():
        log(f"[roofline] (a) {line}")


def held_long_prefill(k) -> None:
    """(d): K2 at llama3-8b's shape, B 1, S 32768, causal, against its
    plain version run in query chunks of K2_LONG_CHUNK (the whole score
    matrix would take 137 GB), bf16."""
    H, Hkv, D = LLAMA_ATTN
    g = torch.Generator(device=DEV)
    g.manual_seed(7)
    q = randn(g, 1, ROOFLINE_T, H, D, dtype=torch.bfloat16)
    kk, vv = (randn(g, 1, ROOFLINE_T, Hkv, D, dtype=torch.bfloat16)
              for _ in range(2))
    t = time.perf_counter()
    got = k.FA.prefill_attention(q, kk, vv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    err = 0.0
    for s in range(0, ROOFLINE_T, K2_LONG_CHUNK):
        e = s + K2_LONG_CHUNK
        want = k.FR.prefill_attention(q[:, s:e], kk[:, :e], vv[:, :e],
                                      q_offset=s)
        err = max(err, check(f"K2 S {ROOFLINE_T} rows [{s}, {e})",
                             got[:, s:e], want, TOL[torch.bfloat16]))
    log(f"[roofline] (d) K2 bf16 B 1 S {ROOFLINE_T} (H, Hkv, D)="
        f"{LLAMA_ATTN} causal: held against the plain version in query "
        f"chunks of {K2_LONG_CHUNK}, max abs err {err:.3e} (atol, rtol "
        f"{TOL[torch.bfloat16]}); first call {wall * 1e3:.1f} ms")


def time_long_attention(k, batch: int) -> None:
    """K1 at the decode cell's shape (B ``batch``, T 32768, every row's
    cache full) and K2 at the prefill cell's (B 1, S 32768, causal), bf16,
    each timed with CUDA events beside SDPA (``enable_gqa``; causal for
    K2) and its bound, K1 also beside its plain version.  K2's plain
    version is not timed: it would hold 137 GB of logits."""
    H, Hkv, D = LLAMA_ATTN
    dt, T = torch.bfloat16, ROOFLINE_T
    g = torch.Generator(device=DEV)
    g.manual_seed(8)
    cost = kcost()
    out = {}
    for name, shape in (("flash_decode", (batch, 1)), ("flash_prefill",
                                                      (1, T))):
        Bn, Sq = shape
        kk, vv = (randn(g, Bn, T, Hkv, D, dtype=dt) for _ in range(2))
        if name == "flash_decode":
            q = randn(g, Bn, H, D, dtype=dt)
            lens = torch.full((Bn,), T, dtype=torch.int32, device=DEV)
            kern = lambda: k.FA.decode_attention(q, kk, vv, lens)  # noqa
            lib = lambda: F.scaled_dot_product_attention(  # noqa
                q[:, :, None], kk.transpose(1, 2), vv.transpose(1, 2),
                enable_gqa=True)
            plain = lambda: k.FR.decode_attention(q, kk, vv, lens)  # noqa
            work = cost.decode(Bn, H, Hkv, D, Bn * T, 2)
        else:
            plain = None
            q = randn(g, Bn, T, H, D, dtype=dt)
            kern = lambda: k.FA.prefill_attention(q, kk, vv)  # noqa
            lib = lambda: sdpa_prefill(q, kk, vv)  # noqa
            work = cost.prefill(Bn, T, T, H, Hkv, D,
                                cost.prefill_pairs(T, T), 2)
        iters = 30 if name == "flash_decode" else 5
        out[name] = {"B": Bn, "ms": time_ms(kern, [()], iters=iters),
                     "library_ms": time_ms(lib, [()], iters=iters),
                     "plain_ms": plain and time_ms(plain, [()], iters=3),
                     **bound(work, dt)}
        del q, kk, vv
        torch.cuda.empty_cache()
        r = out[name]
        log(f"[roofline] {name} bf16 B {Bn} {'T' if Sq == 1 else 'S'} {T} "
            f"(H, Hkv, D)={LLAMA_ATTN} on {card()}: kernel {r['ms']:.4f} ms, "
            f"SDPA {r['library_ms']:.4f} ms (CUDA events), bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}); plain version "
            + (f"{r['plain_ms']:.4f} ms" if plain else "not timed (137 GB "
               "of logits)"))


LSE_SHARDS = 16                       # (e): the pod's model axis


def long_lse_merge(k, batch: int) -> dict:
    """(e) K1's log-sum-exp form at the decode cell's shape (B ``batch``,
    T 32768, bf16), every row's cache full: held against its plain
    version (each row's output at LONG_ROW_REL, the log-sum-exp at
    LONG_LSE_ATOL), and timed beside K1, the plain version, the library
    call and its bound (the JSON row).  Then the cache cut into
    LSE_SHARDS T shards on the card, as the pod's model axis cuts it,
    each shard's lengths clipped as ``distributed.local.attend`` clips
    them (ragged rows, so that some shards hold none of a row's tokens),
    the form run on each and merged by ``merge_partials``, the function
    ``attend`` merges with, held at LONG_ROW_REL against K1 over the
    whole T and against the plain version.  Planted faults must fail
    those limits: the form with one 64-key tile lost, and the merge with
    a shard dropped, weighed twice or short of one 64-key tile."""
    from repro_torch.distributed.local import merge_partials
    H, Hkv, D = LLAMA_ATTN
    dt, T = torch.bfloat16, ROOFLINE_T
    g = torch.Generator(device=DEV)
    g.manual_seed(9)
    q = randn(g, batch, H, D, dtype=dt)
    kk, vv = (randn(g, batch, T, Hkv, D, dtype=dt) for _ in range(2))
    full = torch.full((batch,), T, dtype=torch.int32, device=DEV)
    args = (q, kk, vv, full)
    po, plse = k.FR.decode_attention_lse(*args)

    def held(what, o, lse) -> tuple:
        """(row error of o, max |lse error|) against the plain version
        over the whole T; fails above the limits."""
        e_l = check(what + " lse", lse, plse, (LONG_LSE_ATOL, 0.0))
        return check_rows(what + " o", o, po, LONG_ROW_REL), e_l

    def planted(what, o, lse=None, want=po) -> str:
        """A fault's errors, which must exceed a limit."""
        e_o = row_rel_err(o, want)
        e_l = 0.0 if lse is None else float((lse - plse).abs().max())
        if e_o <= LONG_ROW_REL and e_l <= LONG_LSE_ATOL:
            raise AssertionError(f"(e) the check misses a planted fault, "
                                 f"{what}: row error {e_o:.3e}, lse "
                                 f"{e_l:.3e}")
        return f"{what} {e_o:.3e}" + ("" if lse is None
                                      else f" (lse {e_l:.3e})")

    o, lse = k.FA.decode_attention_lse(*args)
    e_o, e_l = held("K1 lse decode_32k", o, lse)
    err = max(float((o - po).abs().max()), e_l)
    del o, lse
    plants = [planted("one 64-key tile lost", *k.FA.decode_attention_lse(
        q, kk, vv, full - 64))]
    lib_fn = lse_library(args, k.FR, dt)
    row = {"name": "flash_decode_lse", "route": "cuda",
           "source": FA_SRC + "flash_decode.cu",
           "replaces": REPLACES["flash_decode_lse"], "launches": 0,
           "max_abs_err": err,
           "ms": time_ms(lambda: k.FA.decode_attention_lse(*args), [()]),
           "plain_ms": time_ms(lambda: k.FR.decode_attention_lse(*args),
                               [()], iters=3),
           **bound(kcost().decode_lse(batch, H, Hkv, D, batch * T, 2), dt),
           "library_ms": time_ms(lambda: lib_fn(*args), [()])}
    k1_ms = time_ms(lambda: k.FA.decode_attention(*args), [()])
    log(f"[roofline] (e) flash_decode_lse bf16 B {batch} T {T} (H, Hkv, D)="
        f"{LLAMA_ATTN} on {card()}: vs plain, o's rows {e_o:.3e} of their "
        f"largest |value| (limit {LONG_ROW_REL}), lse {e_l:.3e} (limit "
        f"{LONG_LSE_ATOL}), max abs err {err:.3e} (o and lse); "
        f"kernel {row['ms']:.4f} ms, K1 without the log-sum-exp "
        f"{k1_ms:.4f} ms, plain {row['plain_ms']:.4f} ms, {LSE_LIBRARY} "
        f"{row['library_ms']:.4f} ms (CUDA events), bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    # ragged rows: full, one token, inside the first shard, on a shard
    # boundary and one past it, one short of full, three quarters
    tl = T // LSE_SHARDS
    pick = [T, 1, tl // 2, tl, tl + 1, T - 1, 3 * T // 4]
    lens = torch.tensor([pick[i % len(pick)] for i in range(batch)],
                        dtype=torch.int32, device=DEV)
    shards, short = [], None
    cut = LSE_SHARDS // 3          # a shard that all long rows reach
    for i in range(LSE_SHARDS):
        sk, sv = (x[:, i * tl:(i + 1) * tl].contiguous() for x in (kk, vv))
        n = (lens - i * tl).clamp(0, tl).to(torch.int32)
        shards.append(k.FA.decode_attention_lse(q, sk, sv, n))
        if i == cut:
            short = k.FA.decode_attention_lse(
                q, sk, sv, (n - 64).clamp(0, tl).to(torch.int32))
        del sk, sv
    empty = sum(int((s[1] == -1e30).all(-1).sum()) for s in shards)
    os_ = torch.stack([s[0] for s in shards])
    ls_ = torch.stack([s[1] for s in shards])
    got = merge_partials(os_, ls_)
    want = k.FR.decode_attention_lse(q, kk, vv, lens)[0]
    e_k1 = check_rows(f"K1 lse {LSE_SHARDS} shards merged vs K1 over T",
                      got.to(dt), k.FA.decode_attention(q, kk, vv, lens),
                      LONG_ROW_REL)
    e_pl = check_rows(f"K1 lse {LSE_SHARDS} shards merged vs plain", got,
                      want, LONG_ROW_REL)
    rest = [i for i in range(LSE_SHARDS) if i != cut]
    twice = ls_.clone()
    twice[cut] += math.log(2.0)
    o_s, l_s = os_.clone(), ls_.clone()
    o_s[cut], l_s[cut] = short
    plants += [planted(what, merge_partials(o, lse_), want=want)
               for what, o, lse_ in (
                   (f"shard {cut} dropped", os_[rest], ls_[rest]),
                   (f"shard {cut} weighed twice", os_, twice),
                   (f"shard {cut} short of a 64-key tile", o_s, l_s))]
    log(f"[roofline] (e) K1 lse over {LSE_SHARDS} T shards of {tl} at B "
        f"{batch}, lengths {lens.tolist()} ({empty} of "
        f"{LSE_SHARDS * batch} (shard, row) pairs empty), merged by "
        f"merge_partials: rows {e_k1:.3e} of their largest |value| off K1 "
        f"over the whole T, {e_pl:.3e} off the plain version (limit "
        f"{LONG_ROW_REL}); planted faults fail it: " + "; ".join(plants))
    del q, kk, vv, shards, os_, ls_, o_s, l_s, short
    torch.cuda.empty_cache()
    return row


def reduced_cells() -> list:
    """(b): the three reduced cells (cell, batch, seq); the decode cell's
    B the largest whose dry-run arguments + temp bytes stay under
    HBM_SHARE of HBM_BYTES (the per-row bytes from B 1 and B 2, the
    chosen B traced again)."""
    from repro_torch.distributed.context import current_mesh
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import steps as S
    dec = S.get_cell(DECODE_ARCH, "decode_32k")
    need = {}

    def total(b):
        if b not in need:
            tr, tensors, _ = D.compile_cell(dec, current_mesh(), device=DEV,
                                            batch=b, seq=ROOFLINE_T)
            mem = D.analyze_compiled(tr, tensors)["memory"]
            need[b] = mem["argument_bytes"] + mem["temp_bytes"]
        return need[b]
    cap = HBM_SHARE * HBM_BYTES
    b = int((cap - total(1)) // (total(2) - total(1))) + 1
    while total(b) >= cap:
        b -= 1
    log(f"[roofline] (b) {DECODE_ARCH} decode_32k: arguments + temp "
        f"{total(1) / 1e9:.2f} GB at B 1, {total(2) / 1e9:.2f} GB at B 2, "
        f"{total(b) / 1e9:.2f} GB at B {b} (under {cap / 1e9:.0f} GB)")
    return [(dec, b, ROOFLINE_T),
            (S.get_cell(DECODE_ARCH, "prefill_32k"), 1, ROOFLINE_T),
            (S.get_cell("qwen3_1_7b", "train_4k"), 1, 4096)]


def cell_inputs(cell, batch, seq):
    """Random parameters (seeded), a zero cache or fresh AdamW state, and
    the batch of the cell's step on the card; a decode batch reads the
    whole cache (pos T - 1)."""
    from repro_torch.models import model as M
    from repro_torch.train import optim
    cfg = cell.cfg
    g = torch.Generator(device=DEV)
    g.manual_seed(0)
    params = M.init_params(cfg, generator=g, device=DEV)
    tok = lambda *s: torch.randint(0, cfg.vocab_size, s, generator=g,  # noqa
                                   device=DEV, dtype=torch.int32)
    if cell.step_kind == "train":
        return params, optim.init(optim.AdamWConfig(), params), {
            "tokens": tok(batch, seq), "targets": tok(batch, seq)}
    cache = M.init_cache(cfg, batch, seq, device=DEV)
    if cell.step_kind == "prefill":
        return params, cache, {"tokens": tok(batch, seq)}
    return params, cache, {"tokens": tok(batch, 1), "pos": torch.full(
        (batch,), seq - 1, dtype=torch.int32, device=DEV)}


def roofline_cell(cell, batch, seq) -> tuple:
    """(b): one reduced cell dry-run on the (1, 1) mesh, then its real step
    on plain tensors: FLOPs (``FlopCounterMode``) equal to the dry run's,
    peak memory against its inputs + temp bytes, the step's wall and
    device time, and the time as a share of the roofline bound (and, for
    train, the model-FLOP share)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.distributed.context import current_mesh
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import steps as S
    from repro_torch.roofline import report
    name = f"{cell.arch} {cell.shape.name} B {batch} S {seq}"
    tr, tensors, st = D.compile_cell(cell, current_mesh(), device=DEV,
                                     batch=batch, seq=seq)
    rec = D.analyze_compiled(tr, tensors)
    mem, flops, nbytes = rec["memory"], rec["cost"]["flops"], \
        rec["cost"]["bytes"]
    # every input is resident, those only overwritten (a prefill's cache)
    # too, beside the step's own allocations
    predicted = mem["input_bytes"] + mem["temp_bytes"]
    args = cell_inputs(cell, batch, seq)
    step = S.make_step(cell)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        step(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counted = float(fc.get_total_flops())
    if counted != flops:
        raise AssertionError(f"[roofline] (b) {name}: FlopCounterMode counts "
                             f"{counted:.6e} FLOPs on the step, the dry run "
                             f"{flops:.6e}")
    reps = 2 if cell.step_kind != "decode" else 10
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    busy, top = device_busy_ms(lambda: step(*args))
    wall = float(np.median(walls))
    peak_b = PEAK_FLOPS_S[torch.bfloat16]
    bound_ms = max(flops / peak_b, nbytes / PEAK_BYTES_S) * 1e3
    gap = "within it" if peak <= predicted else \
        f"{(peak - predicted) / 1e9:.3f} GB over it"
    out = {"cell": name, "flops": flops, "bytes": nbytes, "wall_ms": wall,
           "device_ms": busy, "bound_ms": bound_ms,
           "bound_by": "operations" if flops / peak_b >=
           nbytes / PEAK_BYTES_S else "bytes",
           "share_wall": bound_ms / wall,
           "share_device": bound_ms / busy if busy else None,
           "peak_gb": peak / 1e9, "predicted_gb": predicted / 1e9}
    if cell.step_kind == "train":
        mf = report.model_flops(cell.arch, cell.shape.name) * batch * seq / (
            cell.shape.global_batch * cell.shape.seq_len)
        out["model_flop_share"] = mf / peak_b / (wall / 1e3)
    log(f"[roofline] (b) {name} on {card()}: dry run (trace "
        f"{st['compile_s']} s): {flops:.6e} FLOPs (FlopCounterMode on the "
        f"step: the same), {nbytes:.4e} bytes, arguments "
        f"{mem['argument_bytes'] / 1e9:.3f} GB read of "
        f"{mem['input_bytes'] / 1e9:.3f} GB of inputs, + temp "
        f"{mem['temp_bytes'] / 1e9:.3f} GB; the step: peak "
        f"{peak / 1e9:.3f} GB ({base / 1e9:.3f} before it), {gap}; wall "
        f"{wall:.2f} ms (median of {reps}: "
        + " ".join(f"{w:.1f}" for w in walls) + f"), device {busy:.2f} ms "
        f"(largest: {', '.join(f'{n} {v:.2f}' for n, v in top)}); bound "
        f"{bound_ms:.3f} ms ({out['bound_by']}): {out['share_wall']:.4f} of "
        f"the wall, "
        + (f"{out['share_device']:.4f}" if busy else "not measured")
        + " of the device time"
        + (f"; model-FLOP share {out['model_flop_share']:.4f}"
           if "model_flop_share" in out else ""))
    return out, args, step


def dtensor_decode(cell, args, k) -> dict:
    """(c): the decode step once more with every parameter, cache and
    batch leaf a DTensor on the (1, 1) mesh (sharing the plain tensors'
    storage): logits within MODEL_RTOL of the plain step's, K1 launched
    once per layer; then with the cache's T sharded over the mesh's
    ``model`` dimension (of size 1), as the pod shards it: the T-sharded
    path of ``distributed.local.attend`` (K1's log-sum-exp form once per
    layer, the merge's all-reduces over NCCL), at MODEL_RTOL too.
    Returns the launches of the log-sum-exp form."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.context import current_mesh
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import steps as S
    mesh = current_mesh()
    params, cache, batch = args
    step = S.make_step(cell)
    want, _ = step(params, cache, batch)
    (p_sh, c_sh, b_sh), _ = D.build_shardings(cell, args, mesh)
    before = torch.cuda.memory_allocated()
    dp = SH.distribute(params, p_sh, src_data_rank=None)
    dc = SH.distribute(cache, c_sh, src_data_rank=None)
    db = SH.distribute(batch, b_sh, src_data_rank=None)
    grown = torch.cuda.memory_allocated() - before
    reset_counts(k)
    got, _ = step(dp, dc, db)
    torch.cuda.synchronize()
    n = counts(k)
    got = got.full_tensor()
    V = cell.cfg.vocab_size
    gap = float((got[:, :V].float() - want[:, :V].float()).abs().max()
                / want[:, :V].float().abs().max())
    n_layers = cell.cfg.num_layers
    if gap > MODEL_RTOL[torch.bfloat16] or n["flash_decode"] != n_layers \
            or not torch.isfinite(got).all():
        raise AssertionError(f"[roofline] (c) DTensor decode: logit gap "
                             f"{gap:.3e}, launches {n}")
    log(f"[roofline] (c) {cell.arch} decode B {batch['pos'].shape[0]} on "
        f"DTensors over the (1, 1) mesh: logits within {gap:.3e} of the "
        f"plain step's (MODEL_RTOL {MODEL_RTOL[torch.bfloat16]}), K1 "
        f"launched {n['flash_decode']} times (one per layer), placing the "
        f"tensors grew memory by {grown / 1e6:.1f} MB")
    # each leaf (L, B, T, Hkv, D) as this rank's whole shard of itself,
    # its storage shared (``distribute_tensor`` would copy it)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    before = torch.cuda.memory_allocated()
    dct = pytree.tree_map(lambda t: DTensor.from_local(
        t, mesh, (Replicate(), Shard(2)), run_check=False, shape=t.shape,
        stride=t.stride()), cache)
    grown = torch.cuda.memory_allocated() - before
    reset_counts(k)
    got, _ = step(dp, dct, db)
    torch.cuda.synchronize()
    n = counts(k)
    got = got.full_tensor()
    gap = float((got[:, :V].float() - want[:, :V].float()).abs().max()
                / want[:, :V].float().abs().max())
    if gap > MODEL_RTOL[torch.bfloat16] or n["flash_decode"] \
            or n["flash_decode_lse"] != n_layers \
            or not torch.isfinite(got).all():
        raise AssertionError(f"[roofline] (c) T-sharded DTensor decode: "
                             f"logit gap {gap:.3e}, launches {n}")
    log(f"[roofline] (c) {cell.arch} decode, the cache's T sharded over "
        f"the model dimension: logits within {gap:.3e} of the plain step's "
        f"(MODEL_RTOL {MODEL_RTOL[torch.bfloat16]}), K1's log-sum-exp form "
        f"launched {n['flash_decode_lse']} times (one per layer), K1 "
        f"{n['flash_decode']}; placing the cache grew memory by "
        f"{grown / 1e6:.1f} MB")
    return {"flash_decode_lse": n["flash_decode_lse"]}


def phase_roofline(k) -> tuple:
    """(a) the three full-width dry runs in subprocesses, while (d) holds
    K2 at S 32768 and (b) dry-runs the reduced cells on the (1, 1) mesh;
    then (b)'s real steps, (c) the DTensor decode (replicated, then
    T-sharded) and (e) K1's log-sum-exp form at the decode cell's shape.
    Returns (e)'s row of the kernels' record and (c)'s launches."""
    t0 = time.perf_counter()
    procs = start_dryruns()
    try:
        held_long_prefill(k)
        with one_device_mesh():
            cells = reduced_cells()
            finish_dryruns(procs)
            rows = []
            for cell, batch, seq in cells:
                row, args, step = roofline_cell(cell, batch, seq)
                rows.append(row)
                if cell.step_kind == "decode":
                    launches = dtensor_decode(cell, args, k)
                del args, step
                torch.cuda.empty_cache()
            time_long_attention(k, cells[0][1])
            row = long_lse_merge(k, cells[0][1])
    finally:
        for *_, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    log("[roofline] " + json.dumps(rows))
    log(f"[roofline] phase {time.perf_counter() - t0:.1f} s")
    return row, launches


# --------------------------------------------------------------------- #
# cluster: the deployment spec's DES and its engines on the card
# --------------------------------------------------------------------- #
CLUSTER_ARCH = "llama3_8b"
GEMMA_ARCH = "gemma_2b"
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
TESSERA_ARCHS = ("llama3_8b", "gpt_oss_20b", "rwkv6_3b", "zamba2_7b",
                 "gemma_2b")
TESSERA_RUN = ("llama3_8b", "gpt_oss_20b", "gemma_2b")  # planned, executed
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
    """Trace the decode step of the five models at full width; plan
    llama3-8b, gpt-oss-20b and gemma-2b for the GPU pair under both
    policies and execute them on two logical devices of this card (a
    stream each) and fused on one, against the eager step; serve
    gpt-oss-20b through the online monitor's choice of executable,
    against the eager engine."""
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


def step_positions3(extra) -> dict:
    """decode_step's keyword for a traced step's extra argument: a vlm
    step's M-RoPE ids (the fifth argument), else nothing."""
    return {"positions3": extra[0]} if extra else {}


def tessera_steps(cfg, params, k, exes) -> None:
    """From one prefilled cache, DECODE_STEPS decode steps through each
    executable and through the eager step, every step under
    set_sync_debug_mode("error"): the logits must be bit-identical (the
    same ops and kernels in the same order) and the launches equal."""
    M = k.M
    rng = np.random.default_rng(0)
    lens = np.asarray(prompt_lens(cfg))
    toks = np.zeros((B, PROMPT), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
    dev = torch.device(DEV)
    steps = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        B, DECODE_STEPS)).astype(np.int32)).to(dev)
    cache_kw, prefill_kw, step_kw = model_inputs(cfg, PROMPT)
    cache0 = M.init_cache(cfg, B, MAX_LEN, device=dev, **cache_kw)
    M.prefill(params, cfg, torch.from_numpy(toks).to(dev), cache0,
              last_pos=torch.from_numpy((lens - 1).astype(np.int32)).to(dev),
              **prefill_kw)

    def eager(p, c, t, q, *p3):
        return M.decode_step(p, cfg, t, c, q, **step_positions3(p3))

    def run(fn):
        """Logits of each step, its wall time (ms, after a synchronise)
        and the host time it took to queue its work."""
        cache = pytree.tree_map(torch.clone, cache0)
        pos = torch.from_numpy(lens.astype(np.int32)).to(dev)
        outs, wall, enq, cpu = [], [], [], []
        torch.cuda.synchronize()
        for i in range(DECODE_STEPS):
            t, c = time.perf_counter(), time.thread_time()
            torch.cuda.set_sync_debug_mode("error")
            try:
                logits, cache = fn(params, cache, steps[:, i:i + 1], pos,
                                   *step_kw(pos).values())
                outs.append(logits)
                pos = pos + 1
            finally:
                torch.cuda.set_sync_debug_mode(0)
            enq.append((time.perf_counter() - t) * 1e3)
            cpu.append((time.thread_time() - c) * 1e3)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t) * 1e3)
        return outs, wall, enq, cpu

    def eager_tagged(p, c, t, q, *p3):
        return M.decode_step(p, cfg, t, c, q, tagged=True,
                             **step_positions3(p3))

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


# --------------------------------------------------------------------- #
# encdec and vlm: seamless-m4t-large-v2 and qwen2-vl-7b at the model level
# --------------------------------------------------------------------- #
ENCDEC_VLM = ("seamless_m4t_large_v2", "qwen2_vl_7b")
# the phase-2 rows that each model's kernel run supplies launches to, by
# attention site (attention_sites)
SITE_ROWS = {
    "encdec": {("flash_prefill", "encoder"): "flash_prefill_seamless_enc",
               ("flash_prefill", "cross"): "flash_prefill_seamless_cross",
               ("flash_prefill", "self"): "flash_prefill_seamless_self",
               ("flash_decode", "self"): "flash_decode_seamless_self",
               ("flash_decode", "cross"): "flash_decode_seamless_cross"},
    "vlm": {("flash_prefill", "self"): "flash_prefill_qwen2vl",
            ("flash_decode", "self"): "flash_decode_qwen2vl"},
}


def phase_encdec_vlm(cfg, k, rows) -> dict:
    """An encdec or vlm model at the model level (the engine serves
    neither, as the reference's): in fp32 at SMALL_DEPTH encoder and
    decoder layers, the prefill and decode check of phase_model, held
    tight; at full width and depth in bf16 the same at MODEL_RTOL, every
    decode step without a host sync, with the attention launches counted
    by site (encdec: 72 K2 a prefill, 48 of them non-causal, and 48 K1 a
    step; vlm: 28 and 28); the prefill's and the step's wall beside the
    kernels' share of them (launches x phase 2's kernel ms); for vlm,
    that M-RoPE ids move the angle and not the cache slot; then the
    decode step traced, planned for the GPU pair under both policies and
    run on two streams of the card, bit-identical to the eager step.
    Returns the launches of each of SITE_ROWS' rows."""
    M = k.M
    lens = prompt_lens(cfg)
    small = dataclasses.replace(
        cfg, num_layers=SMALL_DEPTH,
        encoder_layers=min(cfg.encoder_layers, SMALL_DEPTH), dtype="float32")
    params = init_params(M, small)
    phase_model(small, params, k, lens)
    free(params)
    params = init_params(M, cfg)
    sites, walls = collections.Counter(), {}
    phase_model(cfg, params, k, lens, sites=sites, walls=walls)
    n, steps = cfg.num_layers, DECODE_STEPS
    expect = {("flash_prefill", "self"): n,
              ("flash_decode", "self"): n * steps}
    if cfg.family == "encdec":
        expect.update({("flash_prefill", "encoder"): cfg.encoder_layers,
                       ("flash_prefill", "cross"): n,
                       ("flash_decode", "cross"): n * steps})
    if dict(sites) != expect:
        raise AssertionError(f"{cfg.name}: attention launches by site "
                             f"{dict(sites)} != {expect}")
    launched = {SITE_ROWS[cfg.family][key]: v for key, v in sites.items()}
    ms = {row["name"]: row["ms"] for row in rows}
    share = {"prefill": 0.0, "step": 0.0}
    for name, v in launched.items():
        if name.startswith("flash_prefill"):
            share["prefill"] += v * ms[name]
        else:
            share["step"] += v / steps * ms[name]
    log(f"[{cfg.name}] attention launches by site in one prefill and "
        f"{steps} decode steps: " + ", ".join(
            f"{name} {v}" for name, v in launched.items()))
    for what in ("prefill", "step"):
        log(f"[{cfg.name}] {what} wall {walls[what]:.2f} ms (bf16, B {B}), "
            f"of which the attention kernels take {share[what]:.3f} ms "
            f"({100 * share[what] / walls[what]:.1f}%; launches x phase 2's "
            "kernel ms)")
    if cfg.family == "vlm":
        vlm_slot_and_angle(cfg, params, k)
    tessera_family(cfg, params, k)
    free(params)
    return launched


def vlm_slot_and_angle(cfg, params, k) -> None:
    """From one prefilled cache, one decode step with the grid's M-RoPE
    ids (slot pos, angle pos - VLM_SHIFT) and one without ids (1-D RoPE at
    pos): both write the same slots (layer 0's V bit for bit: it carries
    no rotation), with layer 0's keys rotated apart, and the logits
    differ."""
    M = k.M
    lens = np.asarray(prompt_lens(cfg))
    cache_kw, prefill_kw, step_kw = model_inputs(cfg, PROMPT)
    toks = torch.ones((B, PROMPT), dtype=torch.int32, device=DEV)
    cache = M.init_cache(cfg, B, MAX_LEN, device=DEV)
    M.prefill(params, cfg, toks, cache, last_pos=torch.from_numpy(
        (lens - 1).astype(np.int32)).to(DEV), **prefill_kw)
    pos = torch.from_numpy(lens.astype(np.int32)).to(DEV)
    out = []
    for kw in (step_kw(pos), {}):
        c = pytree.tree_map(torch.clone, cache)
        logits, _ = M.decode_step(params, cfg, toks[:, :1], c, pos, **kw)
        rows = torch.arange(B, device=DEV)
        out.append((logits, c["kv"]["k"][0, rows, pos.long()],
                    c["kv"]["v"][0, rows, pos.long()]))
    (la, ka, va), (lb, kb, vb) = out
    apart = (torch.equal(va, vb) and not torch.equal(ka, kb)
             and not torch.equal(la, lb))
    log(f"[{cfg.name}] a decode step at slots {lens.tolist()} with M-RoPE "
        f"ids {(lens - VLM_SHIFT).tolist()} and with 1-D RoPE: layer 0's "
        f"V at the slots bit-identical, keys max diff "
        f"{float((ka.float() - kb.float()).abs().max()):.3e}, logits max "
        f"diff {float((la.float() - lb.float()).abs().max()):.3e}")
    if not apart:
        raise AssertionError(f"{cfg.name}: M-RoPE ids do not keep the slot "
                             "and move the angle")


def tessera_family(cfg, params, k) -> None:
    """The Tessera core on an encdec or vlm decode step at full width:
    traced with torch.export (a vlm step takes its M-RoPE ids as a fifth
    argument; an encdec step reads the cross caches inside the cache
    argument, and their readers are pinned with the KV cache's), planned
    for PLAN_PAIR under both policies and run as two executables on two
    streams of the card (tessera_steps: bit-identical to the eager step,
    the same launches, no host sync).  A plan may keep the whole step on
    one device (the latency plan of seamless-m4t-large-v2's does); at
    least one must split it."""
    from repro_torch.core import analyzer, planner
    from repro_torch.core.costmodel import CATALOG
    from repro_torch.core.executor import LogicalDevice, build_executable
    from repro_torch.launch.serve import PLAN_PAIR
    M = k.M
    dev = torch.device(DEV, torch.cuda.current_device())
    cache_kw, _, step_kw = model_inputs(cfg, PROMPT)
    pos = torch.zeros(B, dtype=torch.int32, device=dev)
    extra = tuple(step_kw(pos).values())

    def step(p, c, t, q, *p3):
        return M.decode_step(p, cfg, t, c, q, tagged=True,
                             **step_positions3(p3))

    t = time.perf_counter()
    traced = analyzer.analyze(
        step, params, M.init_cache(cfg, B, MAX_LEN, device=dev, **cache_kw),
        torch.zeros((B, 1), dtype=torch.int32, device=dev), pos, *extra,
        state_argnums=(1,))
    pinned = traced.state_readers | traced.state_writers
    g = analyzer.pin_nodes(traced.graph, pinned, 0)
    traced = traced.with_graph(g)
    devs = [CATALOG[d] for d in PLAN_PAIR]
    plans = {pol: planner.plan(g, devs, policy=pol)
             for pol in ("latency", "throughput")}
    trace_counts(cfg, traced, f"and planned in "
                 f"{time.perf_counter() - t:.1f} s; {len(pinned)} nodes "
                 "reading or writing the caches pinned")
    for pol, p in plans.items():
        log(f"[tessera] {cfg.name} {pol} plan for {'+'.join(PLAN_PAIR)} "
            f"(modeled, not measured): {p.summary()}, bottleneck "
            f"{p.bottleneck * 1e3:.3f} ms")
    lds = [LogicalDevice(dev, torch.cuda.Stream(dev), name=f"cuda/{i}")
           for i in range(2)]
    exes = {pol: build_executable(traced, p, lds) for pol, p in plans.items()}
    if max(e.num_units for e in exes.values()) < 2:
        raise AssertionError(f"{cfg.name}: no plan splits the step across "
                             "the two streams")
    tessera_steps(cfg, params, k, exes)


# the "train" phase: qwen3-1.7b, the shipped config whose training state
# (bf16 parameters and gradients, fp32 master, moments and residual: 20
# bytes a parameter) fits one card at full width
TRAIN_ARCH = "qwen3_1_7b"
TRAIN_PARAMS = 2_031_730_688          # its ModelConfig.param_count()
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 512, 20
TRAIN_VOCAB = 1024                    # the Markov chain's ids
TRAIN_LONG_S = 4096                   # train_4k's sequence length
TRAIN_MIN_FALL = 1.0                  # nats, first 5 vs last 5 losses
ACCUM_TOL = dict(rtol=5e-4, atol=5e-5)
RESUME_STEPS, RESUME_EVERY, RESUME_FAIL = 12, 4, 8


class Batches:
    """``TokenBatches``' batches made before the timed run (the Markov
    sampler is host Python), served by step."""

    def __init__(self, source, steps: int):
        self.batches = [source.batch_at(i) for i in range(steps)]

    def batch_at(self, step: int):
        return self.batches[step]


def train_full(cfg, T) -> dict:
    """20 Trainer steps of qwen3-1.7b at full width and depth in bf16 (B 4,
    S 512, default AdamWConfig with warmup 2 of 20 steps, no compression,
    no remat) on a Markov chain over TRAIN_VOCAB ids: finite losses, the
    last five at least TRAIN_MIN_FALL nats below the first five.  Returns
    the trainer's state (for the train_4k step)."""
    torch.cuda.reset_peak_memory_stats()
    trainer = T.Trainer(cfg, T.TrainConfig(steps=TRAIN_STEPS, log_every=1),
                        T.optim.AdamWConfig(warmup_steps=2,
                                            total_steps=TRAIN_STEPS),
                        device=DEV)
    g = torch.Generator(device=DEV)
    g.manual_seed(0)
    t = time.perf_counter()
    state = trainer.init_state(generator=g)
    torch.cuda.synchronize()
    log(f"[train] {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"vocab {cfg.vocab_size}, {TRAIN_PARAMS:,} parameters; state on the "
        f"card in {time.perf_counter() - t:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
    batches = Batches(T.TokenBatches(TRAIN_VOCAB, TRAIN_B, TRAIN_S),
                      TRAIN_STEPS)
    state = trainer.run(batches, state=state)
    losses = [m["loss"] for m in trainer.metrics]
    ends = [m["t"] for m in trainer.metrics]      # after float(loss): synced
    walls = [1e3 * (b - a) for a, b in zip([0.0] + ends, ends)]
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"[train] losses {losses}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    log("[train] losses: " + " ".join(f"{v:.3f}" for v in losses))
    if not last <= first - TRAIN_MIN_FALL:
        raise AssertionError(f"[train] mean loss of the last 5 steps "
                             f"{last:.3f} is not {TRAIN_MIN_FALL} nats below "
                             f"the first 5's {first:.3f}")
    med = float(np.median(walls[1:]))
    tokens = TRAIN_B * TRAIN_S
    mfu = 6 * TRAIN_PARAMS * tokens / (med / 1e3) / \
        PEAK_FLOPS_S[torch.bfloat16]
    log("[train] step walls (ms, each after its loss is read): "
        + " ".join(f"{w:.1f}" for w in walls))
    log(f"[train] on {card()}: bf16, B {TRAIN_B}, S {TRAIN_S}: median step "
        f"{med:.1f} ms (steps 2-{TRAIN_STEPS}), {tokens / med * 1e3:,.0f} "
        f"tokens/s, model-FLOP share {mfu:.3f} of the bf16 peak, peak "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; mean "
        f"loss {first:.3f} -> {last:.3f}")
    # one more step in its two parts, each ending in a synchronize
    split = {}
    t = time.perf_counter()
    _, grads = trainer.loss_and_grads(state["params"], batches.batch_at(0))
    torch.cuda.synchronize()
    split["forward + backward"] = time.perf_counter() - t
    t = time.perf_counter()
    T.optim.apply(trainer.ocfg, grads, state["opt"], state["params"])
    torch.cuda.synchronize()
    split["AdamW"] = time.perf_counter() - t
    del grads
    log("[train] one step's parts: " + ", ".join(
        f"{name} {1e3 * v:.1f} ms" for name, v in split.items()))
    return state


def train_long(cfg, T, state) -> None:
    """Two steps of the cell builder's train step (remat on, its default)
    at train_4k's sequence length, B 1, from the Trainer's state, each
    timed (the first meets the new shapes)."""
    torch.cuda.reset_peak_memory_stats()
    b = T.TokenBatches(TRAIN_VOCAB, 1, TRAIN_LONG_S, seed=1).batch_at(0)
    batch = {k_: torch.as_tensor(v, device=DEV) for k_, v in b.items()}
    step = T.steps.make_train_step(cfg, T.optim.AdamWConfig(
        warmup_steps=2, total_steps=TRAIN_STEPS))
    walls = []
    for _ in range(2):          # the first call meets the new shapes
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, _, loss = step(state["params"], state["opt"], batch)
        loss = float(loss)
        walls.append(time.perf_counter() - t)
        if not np.isfinite(loss):
            raise AssertionError(f"[train] train_4k step loss {loss}")
    log(f"[train] make_train_step at S {TRAIN_LONG_S}, B 1, remat: loss "
        f"{loss:.3f}, walls " + " / ".join(f"{1e3 * w:.1f}" for w in walls)
        + f" ms, peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        " GB")


def train_fp32_checks(cfg, T) -> None:
    """qwen3-1.7b at full width, 2 layers, fp32, one batch: the gradients
    of accum 2 (microbatch gradients summed in fp32) against accum 1 at
    the reference test's tolerance, and of remat against no remat (the
    same loss, gradients within 1e-6).  Then one Trainer step each of
    accum 1 and 2: their parameters' largest difference, and how many
    elements lie outside that tolerance, are reported."""
    small = dataclasses.replace(cfg, num_layers=SMALL_DEPTH, dtype="float32")
    batches = T.TokenBatches(TRAIN_VOCAB, TRAIN_B, TRAIN_S, seed=2)
    batch = batches.batch_at(0)

    def trainer(**kw):
        return T.Trainer(small, T.TrainConfig(steps=1, **kw), device=DEV)

    def state(tr):
        g = torch.Generator(device=DEV)
        g.manual_seed(0)
        return tr.init_state(g)

    params = state(trainer())["params"]
    out = {}
    for name, kw in (("plain", {}), ("accum", {"accum": 2}),
                     ("remat", {"remat": True})):
        out[name] = trainer(**kw).loss_and_grads(params, batch)
    gerr = {}
    for name in ("accum", "remat"):
        gerr[name] = 0.0
        for a, b in zip(pytree.tree_leaves(out["plain"][1]),
                        pytree.tree_leaves(out[name][1])):
            if name == "accum":
                torch.testing.assert_close(b, a, **ACCUM_TOL)
            gerr[name] = max(gerr[name], float((a - b).abs().max()))
    l0, l1 = float(out["plain"][0]), float(out["remat"][0])
    if l0 != l1 or gerr["remat"] > 1e-6:
        raise AssertionError(f"[train] remat: loss {l1} vs {l0}, gradients "
                             f"{gerr['remat']:.3e} apart")
    del params
    out.clear()
    ends = {}
    for accum in (1, 2):
        tr = trainer(accum=accum)
        ends[accum] = tr.run(batches, state=state(tr))["params"]
    perr, outside, total = 0.0, 0, 0
    for a, b in zip(pytree.tree_leaves(ends[1]), pytree.tree_leaves(ends[2])):
        perr = max(perr, float((a - b).abs().max()))
        outside += int((~torch.isclose(b, a, **ACCUM_TOL)).sum())
        total += a.numel()
    ends.clear()
    log(f"[train] fp32, {SMALL_DEPTH} layers: gradients of accum 2 vs 1 "
        f"{gerr['accum']:.3e} apart (held at rtol {ACCUM_TOL['rtol']}, atol "
        f"{ACCUM_TOL['atol']}); remat: loss {l1:.6f} equal, gradients "
        f"{gerr['remat']:.3e} apart; after one AdamW step, accum 2 vs 1 "
        f"parameters {perr:.3e} apart, {outside} of {total:,} elements "
        "outside that tolerance")


# rwkv6-3b's training path through the chunked WKV scan
# (``models/ssm.py:_wkv_chunked``): full width and depth in bf16 at
# train_4k's length, B 1, remat; the per-token scan (``_wkv_scan``, the
# plain version) timed beside it at RWKV_SCAN_S; at SMALL_DEPTH layers in
# fp32 the loss and every gradient of the chunked form and of the
# per-token one against those of the recurrence evaluated in fp64.  At
# full width two fp32 evaluations of this random-weight model can differ
# by more than the train tests' smoke-width tolerance (the per-token
# fp32 scan's own distance from the fp64 recurrence is logged), so each
# of the chunked form's is held to the larger of that tolerance and
# FREE_RUN_K times the per-token fp32 scan's distance.
RWKV_TRAIN_ARCH, RWKV_TRAIN_STEPS, RWKV_SCAN_S = "rwkv6_3b", 3, 512
RWKV_FP32_B, RWKV_FP32_S = 2, 200                 # 200: a ragged last chunk
TRAIN_LOSS_TOL = dict(rtol=1e-4, atol=1e-4)       # tests/test_torch_train.py
TRAIN_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)       # atol x each leaf's max


def wkv_scan_fp64(r, k_, v, w, u, state):
    """The per-token recurrence of ``ssm._wkv_scan`` in fp64 (outputs
    rounded to fp32 at the end): the yardstick of the fp32 forms."""
    s, ys = state.double(), []
    for t in range(r.shape[1]):
        kv = k_[:, t].double()[..., :, None] * v[:, t].double()[..., None, :]
        ys.append(torch.einsum("bhp,bhpq->bhq", r[:, t].double(),
                               s + u.double()[None, :, :, None] * kv))
        s = w[:, t].double()[..., :, None] * s + kv
    return torch.stack(ys, dim=1).float(), s.float()


@contextlib.contextmanager
def per_token_scan(SM, scan=None):
    """rwkv6's training forms run the per-token ``_wkv_scan`` (or
    ``scan``)."""
    scan = scan or SM._wkv_scan

    def f(r, k_, v, w, u, state, chunk=16):
        return scan(r, k_, v, w, u, state)
    with swapped(((SM, "_wkv_chunked", f),)):
        yield


def train_rwkv(configs, T) -> None:
    """rwkv6-3b at full width and depth in bf16: RWKV_TRAIN_STEPS steps of
    the cell builder's train step (remat) at S 4096, B 1, through
    ``_wkv_chunked``: finite losses, each step's wall, the peak memory;
    a step at RWKV_SCAN_S through the chunked and through the per-token
    scan, each timed; then at SMALL_DEPTH layers in fp32 the loss and
    every gradient of the chunked form against the fp64 recurrence's,
    held as the comment above RWKV_TRAIN_ARCH says."""
    from repro_torch.models import ssm as SM
    cfg = configs.get(RWKV_TRAIN_ARCH)
    torch.cuda.reset_peak_memory_stats()
    trainer = T.Trainer(cfg, T.TrainConfig(steps=1), device=DEV)
    g = torch.Generator(device=DEV)
    g.manual_seed(0)
    state = trainer.init_state(generator=g)
    step = T.steps.make_train_step(cfg, T.optim.AdamWConfig(
        warmup_steps=2, total_steps=RWKV_TRAIN_STEPS))

    def batch(S, seed, Bn=1):
        b = T.TokenBatches(TRAIN_VOCAB, Bn, S, seed=seed).batch_at(0)
        return {k_: torch.as_tensor(v, device=DEV) for k_, v in b.items()}

    def timed(b):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, _, loss = step(state["params"], state["opt"], b)
        loss = float(loss)
        if not np.isfinite(loss):
            raise AssertionError(f"[train] {cfg.name} loss {loss}")
        return loss, 1e3 * (time.perf_counter() - t)
    long = batch(TRAIN_LONG_S, 3)
    runs = [timed(long) for _ in range(RWKV_TRAIN_STEPS)]
    log(f"[train] {cfg.name} on {card()}: bf16, {cfg.num_layers} layers, d "
        f"{cfg.d_model}, make_train_step at S {TRAIN_LONG_S}, B 1, remat, "
        "through the chunked WKV scan: losses "
        + " ".join(f"{v:.3f}" for v, _ in runs) + ", walls "
        + " / ".join(f"{w:.1f}" for _, w in runs) + " ms (the first meets "
        f"the shapes), peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        " GB")
    short = batch(RWKV_SCAN_S, 4)
    timed(short)
    chunked = timed(short)[1]
    with per_token_scan(SM):
        per_token = timed(short)[1]
    log(f"[train] {cfg.name} step at S {RWKV_SCAN_S}, B 1: chunked scan "
        f"{chunked:.1f} ms, per-token scan {per_token:.1f} ms "
        f"({per_token / chunked:.1f}x)")
    state.clear()
    del step
    torch.cuda.empty_cache()
    small = dataclasses.replace(cfg, num_layers=SMALL_DEPTH, dtype="float32")
    tr = T.Trainer(small, T.TrainConfig(steps=1), device=DEV)
    g.manual_seed(0)
    params = tr.init_state(generator=g)["params"]
    b = T.TokenBatches(TRAIN_VOCAB, RWKV_FP32_B, RWKV_FP32_S,
                       seed=5).batch_at(0)
    out = {"chunked": tr.loss_and_grads(params, b)}
    with per_token_scan(SM):
        out["per-token"] = tr.loss_and_grads(params, b)
    with per_token_scan(SM, wkv_scan_fp64):
        out["fp64"] = tr.loss_and_grads(params, b)
    loss = {n: float(v[0]) for n, v in out.items()}
    gap = {n: abs(loss[n] - loss["fp64"]) for n in ("chunked", "per-token")}
    if gap["chunked"] > max(TRAIN_LOSS_TOL["atol"] + TRAIN_LOSS_TOL["rtol"]
                            * abs(loss["fp64"]), FREE_RUN_K * gap["per-token"]):
        raise AssertionError(f"[train] {cfg.name} fp32 losses {loss}")
    worst, floor = 0.0, 0.0          # in units of each leaf's largest |g|
    leaves = {n: pytree.tree_leaves(v[1]) for n, v in out.items()}
    for a, p_, t in zip(leaves["chunked"], leaves["per-token"],
                        leaves["fp64"]):
        mag = float(t.abs().max())
        err, base = float((a - t).abs().max()), float((p_ - t).abs().max())
        limit = max(TRAIN_GRAD_TOL["atol"] * max(1.0, mag)
                    + TRAIN_GRAD_TOL["rtol"] * mag, FREE_RUN_K * base)
        if not err <= limit:
            raise AssertionError(f"[train] {cfg.name} fp32: a gradient "
                                 f"{err:.3e} from the fp64 recurrence's, "
                                 f"the per-token scan's {base:.3e}")
        worst = max(worst, err / max(mag, 1e-30))
        floor = max(floor, base / max(mag, 1e-30))
    log(f"[train] {cfg.name}, {SMALL_DEPTH} layers, fp32, B {RWKV_FP32_B}, "
        f"S {RWKV_FP32_S}: losses chunked {loss['chunked']:.6f}, per-token "
        f"{loss['per-token']:.6f}, fp64 recurrence {loss['fp64']:.6f}; every "
        f"gradient of the chunked form within {worst:.3e} of its leaf's "
        f"largest magnitude from the fp64 recurrence's (the per-token fp32 "
        f"scan's: up to {floor:.3e}; held per leaf at the larger of the "
        f"train tests' tolerance and {FREE_RUN_K} x the per-token scan's "
        "distance)")


def train_resume(T) -> None:
    """qwen3's smoke config on the card, fp32: RESUME_STEPS steps straight
    against a crash at RESUME_FAIL and a resume from the checkpoint in a
    fresh Trainer, final parameters within 1e-6; then a bf16 state's
    checkpoint round trip, bit for bit."""
    import tempfile
    smoke = dataclasses.replace(T.configs.get_smoke(TRAIN_ARCH),
                                dtype="float32")
    batches = T.TokenBatches(smoke.vocab_size, 2, 16)
    ocfg = T.optim.AdamWConfig(lr=3e-3, warmup_steps=2,
                               total_steps=RESUME_STEPS)

    def trainer(d):
        return T.Trainer(smoke, T.TrainConfig(
            steps=RESUME_STEPS, ckpt_every=RESUME_EVERY, ckpt_dir=d,
            log_every=1), ocfg, device=DEV)
    with tempfile.TemporaryDirectory() as a, \
            tempfile.TemporaryDirectory() as b, \
            tempfile.TemporaryDirectory() as c:
        final = trainer(a).run(batches)
        try:
            trainer(b).run(batches, fail_at=RESUME_FAIL)
            raise AssertionError("[train] no simulated failure")
        except T.SimulatedFailure:
            pass
        resumed = trainer(b).resume(batches)
        err = 0.0
        for x, y in zip(pytree.tree_leaves(final["params"]),
                        pytree.tree_leaves(resumed["params"])):
            torch.testing.assert_close(y, x, rtol=1e-6, atol=1e-6)
            err = max(err, float((x - y).abs().max()))
        bf16 = T.Trainer(T.configs.get_smoke(TRAIN_ARCH),
                         T.TrainConfig(steps=1), device=DEV)
        state = bf16.run(batches)
        state.pop("last_step")
        mgr = T.CheckpointManager(c)
        mgr.save(1, state)
        _, back = mgr.restore(bf16.init_state())
        for x, y in zip(pytree.tree_leaves(state), pytree.tree_leaves(back)):
            if x.dtype != y.dtype or y.device != x.device or \
                    not torch.equal(x, y):
                raise AssertionError("[train] bf16 checkpoint round trip")
    log(f"[train] crash at step {RESUME_FAIL} of {RESUME_STEPS} and resume "
        f"on the card: final parameters {err:.3e} from the straight run; "
        "a bf16 state's checkpoint round trip bit for bit")


def train_launcher() -> None:
    """``launch.train --arch qwen3_1_7b`` once, in a subprocess, on the
    card (its default device): Markov data over the full vocabulary."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    t = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         TRAIN_ARCH, "--steps", "5", "--batch", str(TRAIN_B), "--seq",
         str(TRAIN_S)], env=env, capture_output=True, text=True,
        timeout=600)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("step")]
    losses = [float(ln.split("loss")[1].split()[0]) for ln in lines]
    if out.returncode or not losses or not np.isfinite(losses).all():
        raise AssertionError(f"[train] launch.train rc {out.returncode}: "
                             f"{out.stdout[-2000:]} {out.stderr[-4000:]}")
    log(f"[train] launch.train --arch {TRAIN_ARCH} --steps 5: rc 0 in "
        f"{time.perf_counter() - t:.1f} s, " + "; ".join(lines))


def phase_train(configs, k) -> None:
    """The port's training path on the card: qwen3-1.7b at full width and
    depth (train_full, train_long), the fp32 accumulation and remat
    checks (train_fp32_checks), rwkv6-3b through the chunked WKV scan
    (train_rwkv), none of which reaches a kernel op; the crash and
    resume (train_resume) and ``launch.train`` (train_launcher)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import TokenBatches
    from repro_torch.launch import steps
    from repro_torch.train import optim
    from repro_torch.train.loop import (SimulatedFailure, TrainConfig,
                                        Trainer)
    T = types.SimpleNamespace(
        configs=configs, CheckpointManager=CheckpointManager,
        TokenBatches=TokenBatches, steps=steps, optim=optim,
        SimulatedFailure=SimulatedFailure, TrainConfig=TrainConfig,
        Trainer=Trainer)
    cfg = configs.get(TRAIN_ARCH)
    if int(cfg.param_count()) != TRAIN_PARAMS:
        raise AssertionError(f"{cfg.name}: {cfg.param_count()} parameters")
    torch.cuda.empty_cache()
    reset_counts(k)
    state = train_full(cfg, T)
    train_long(cfg, T, state)
    state.clear()
    torch.cuda.empty_cache()
    train_fp32_checks(cfg, T)
    torch.cuda.empty_cache()
    train_rwkv(configs, T)
    launched = {n: v for n, v in counts(k).items() if v}
    if launched:
        raise AssertionError(f"[train] the training path launched {launched}")
    log("[train] kernel launches in the full-width, train_4k and fp32 "
        "steps of qwen3-1.7b and rwkv6-3b: none")
    torch.cuda.empty_cache()
    train_resume(T)
    torch.cuda.empty_cache()
    train_launcher()


def kernel_share(cfg, walls, rows) -> None:
    """The model check's prefill (4 x 512) and mean decode-step wall
    beside the attention kernels' share of them: launches (one a layer)
    x phase 2's kernel ms at the model's head_dim."""
    ms = {row["name"]: row["ms"] for row in rows}
    tag = f"_d{cfg.head_dim}"
    for what, row in (("prefill", "flash_prefill"), ("step", "flash_decode")):
        share = cfg.num_layers * ms[row + tag]
        log(f"[{cfg.name}] {what} wall {walls[what]:.2f} ms (bf16, B {B}), "
            f"of which {cfg.num_layers} x {row}{tag} take {share:.3f} ms "
            f"({100 * share / walls[what]:.1f}%; launches x phase 2's "
            "kernel ms)")


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
    rows += check_and_time_encdec_vlm(g, FK, FR)
    rows += check_and_time_d256(g, FK, FR)
    rows += time_softcap(g, FK, FR, check_softcap(g, FK, FR))
    check_and_time_lse(g, FK, FR)
    check_two_streams(g, FK, FR, WK, WR)
    log_phase("kernels")
    count_graph_launches(k)
    phase_graph(configs, k)
    log_phase("graph")
    launches = {}

    def served(cfg, lens, first=None):
        """Optionally a first model check of another configuration (``first``
        = (config, lens)), then the model check, the serving run and the
        "paged" checks of ``cfg`` at full width, with its parameters
        loaded once."""
        if first is not None:
            first_cfg, first_lens, *then = first
            params = init_params(M, first_cfg)
            phase_model(first_cfg, params, k, first_lens)
            for fn in then:
                launches.update(fn(first_cfg, params, k, first_lens))
            free(params)
        params = init_params(M, cfg)
        walls = {}
        limit = phase_model(cfg, params, k, lens, walls=walls)
        launches.update(phase_serve(cfg, params, k))
        log_phase(cfg.name)
        ref = None
        if cfg.head_dim == 256:
            kernel_share(cfg, walls, rows)
            launches.update(phase_paged_gemma(cfg, params, k))
            launches.update(phase_gemma_softcap(cfg, params, k, lens))
        elif cfg.family == "dense":
            paged, ref = phase_paged_llama(cfg, params, k)
            launches.update(paged)
            phase_paged_identity(cfg, k)
        elif cfg.family == "moe":
            phase_paged_handoff(cfg, params)
        else:
            phase_paged_recurrent(cfg, params, k, limit)
        log_phase(f"{cfg.name} paged")
        if ref is not None:
            # the cluster layer, with llama3-8b's weights still loaded
            phase_cluster(cfg, params, k, ref)
            log_phase("cluster")
        if cfg.family == "moe":
            # expert-parallel MoE, with the weights still loaded
            phase_ep(cfg, params, k)
            log_phase("ep")
        free(params)

    served(configs.get("llama3_8b"), [PROMPT, 300, 77, 5])
    # the window check (2 layers, fp32, window 128), without and with a
    # logit softcap, then gpt-oss-20b
    served(configs.get("gpt_oss_20b"), [PROMPT, 300, 77, 5],
           first=(dataclasses.replace(configs.get("gpt_oss_20b"),
                                      num_layers=2, dtype="float32",
                                      sliding_window=SMALL_WINDOW),
                  [PROMPT, 300, 130, 5], phase_window_softcap))
    # after "ep", with gpt-oss-20b's weights freed
    row, lse_launches = phase_roofline(k)
    rows.append(row)
    launches.update(lse_launches)
    log_phase("roofline")
    # the recurrent models first in fp32 at full depth (11.7 and 25.2 GiB
    # of parameters): the tight logit check; zamba2's prompt of 300 ends in
    # a ragged chunk
    rwkv = configs.get("rwkv6_3b")
    served(rwkv, [PROMPT] * B,
           first=(dataclasses.replace(rwkv, dtype="float32"), [PROMPT] * B))
    zamba = configs.get("zamba2_7b")
    served(zamba, [PROMPT] * B,
           first=(dataclasses.replace(zamba, dtype="float32"), [300] * B))
    # gemma-2b (head_dim 256) first in fp32 at full depth (10.0 GB of
    # parameters): the tight logit check
    gemma = configs.get(GEMMA_ARCH)
    served(gemma, prompt_lens(gemma),
           first=(dataclasses.replace(gemma, dtype="float32"),
                  prompt_lens(gemma)))
    log_phase("gemma")

    phase_tessera(configs, k)
    log_phase("tessera")
    for name in ENCDEC_VLM:
        cfg = configs.get(name)
        launches.update(phase_encdec_vlm(cfg, k, rows))
        log_phase(cfg.family)
    phase_train(configs, k)
    log_phase("train")

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
