/*
 * K1: one-token GQA decode attention over the model's KV cache, for
 * Hopper (sm_90a).  Built by kernel.py with nvcc into a shared library
 * with a plain C interface.
 *
 * Replaces: src/repro/kernels/flash_attention/kernel.py,
 *   flash_attention_decode (pl.pallas_call of _decode_kernel).
 *
 * What bounds it on the card: bytes.  A row of the batch reads
 * lengths[b] tokens of K and V for each KV head and does 4 FLOPs per
 * element read for each of the rep query heads that share it: at rep = 4
 * (llama3-8b) or 8 (gpt-oss-20b) in bf16 that is 4-8 FLOP per byte, far
 * below the ~295 FLOP per byte where the H100's tensor cores would become
 * the limit.  So the kernel has to keep enough loads in flight to stream
 * K/V at the memory rate, and do little else.
 *
 * What the design does about it:
 *  - split-KV (flash-decoding): the grid is (KV head, row, split); each
 *    block takes a run of whole 64-token tiles of the row's valid tokens
 *    and serves all rep query heads of its KV head, so each K/V tile is
 *    read from device memory once.  The wrapper plans the split count
 *    from (B, Hkv, T, SM count) alone, never from the lengths;
 *  - the splits are merged in the same launch: each block writes its
 *    partial (max, sum, unnormalised output) and takes a ticket from a
 *    per-(row, KV head) counter; the last block to finish merges them
 *    and sets the counter back to 0 for the next call;
 *  - bf16: K and V stay bf16 in a 3-stage shared-memory ring filled by
 *    16-byte cp.async copies, the next tiles in flight while this one is
 *    computed; QK^T and PV run on mma.sync m16n8k16 tensor cores with
 *    fp32 accumulators.  The rep query heads are the 16 rows of A (zero
 *    past rep); each of the four warps takes 16 tokens of a tile and
 *    keeps its own online softmax on its accumulator fragments, whose
 *    probabilities feed PV as A without leaving registers; the four warps
 *    are merged through shared memory at the end.  Rows are padded by 16
 *    bytes, so the ldmatrix reads are free of bank conflicts.  At D 256
 *    the output fragment alone takes 128 registers a thread, so Q stays
 *    in shared memory (16 padded rows) and each k-step loads its A
 *    fragment by ldmatrix instead of holding all 16 in registers;
 *  - fp32 (the tight check): one thread per channel (two at D 256), the
 *    tile staged in shared memory, FMA for both products;
 *  - a logit softcap (gemma-2 style: cap * tanh(logit / cap) on the
 *    scaled logits, before the mask) is a second instantiation of each
 *    kernel (template flag CAP), so the kernels without it are the same
 *    code as before; the cap is applied only to keys the row sees, so a
 *    masked key stays at -inf (tanh(-inf) cap = -cap would give it a
 *    weight).  bf16 takes tanh.approx.f32 (one MUFU op, about 2^-11
 *    relative), fp32 tanhf, for its tight check;
 *  - it reads the cache in the model's layout (B, T, Hkv, D) in place and
 *    stops at lengths[b] = pos[b] + 1: tokens past it are never read, and
 *    the ragged tail tile is zero-filled and masked, so T needs no
 *    divisibility.  A sliding-window ring buffer needs nothing here: the
 *    caller passes min(pos + 1, capacity), and slot order does not matter
 *    because RoPE was applied before the cache write.  A row of length 0
 *    (a shard of the cache that holds none of the row's tokens) gives
 *    o = 0;
 *  - the log-sum-exp form (a cache sharded over T: each shard attends
 *    over its own tokens and the caller merges the shards) is a second
 *    pair of kernels, decode_*_lse_kernel, over the same body (template
 *    flag LSE): the output is float32, unrounded, and lse = m + log(l)
 *    of the merged (max, sum) of each (row, query head), -1e30 for a row
 *    of length 0.  The kernels without it are the same code as before.
 * No host sync and no allocation: the wrapper allocates the partials and
 * keeps the zeroed counters.
 */
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "../../csrc/mma.cuh"

namespace {

constexpr int BK = 64;          // tokens per KV tile
constexpr int THREADS = 128;    // four warps
constexpr int WARPS = THREADS / 32;
constexpr int MAX_REP = 16;     // query heads per KV head
constexpr int MAX_SPLIT = 64;   // splits per (row, KV head)
constexpr int STAGES = 3;       // bf16 K/V ring depth
constexpr float NEG = -1e30f;
using bf16 = __nv_bfloat16;

// Split sp's tokens [t0, t1) of a row with len valid tokens: the row's
// tiles dealt out in runs of ceil(tiles / nsplit) (kernel.py mirrors it).
__device__ __forceinline__ void split_range(int len, int nsplit, int sp,
                                            int& t0, int& t1) {
  const int tiles = (len + BK - 1) / BK;
  const int per = (tiles + nsplit - 1) / nsplit * BK;
  t0 = sp * per;
  t1 = min(len, t0 + per);
}

// Weight of a partial with max m in a merge whose max is M (a partial
// that saw no token has m = -inf and weighs nothing).
__device__ __forceinline__ float weight(float m, float M) {
  return m == -INFINITY ? 0.f : expf(m - M);
}

// tanh on the MUFU unit (sm_75 and up), about 2^-11 relative error
__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// The log-sum-exp of a softmax whose max is m and sum l (NEG where the
// row saw no token).
__device__ __forceinline__ float log_sum_exp(float m, float l) {
  return l > 0.f ? m + logf(l) : NEG;
}

// The block's split of (row b, KV head hk) is in shared memory: acc_s
// (rep x D, unnormalised), m_s and l_s (rep).  With one split, write the
// output.  Otherwise write the partial, take a ticket, and if this block
// is the last of its (row, KV head), merge every split's partial into the
// output and reset the ticket.  wsm: rep x MAX_SPLIT floats of scratch,
// lsum: rep floats.  LSE: also write each query head's log-sum-exp to lse
// (B, H).  Every thread of the block calls it.
template <int D, bool LSE, typename T>
__device__ void finish(const float* acc_s, const float* m_s,
                       const float* l_s, float* wsm, float* lsum, int rep,
                       T* o, float* lse, float* __restrict__ part_acc,
                       float* __restrict__ part_ml, int* tickets, int H,
                       int Hkv, int nsplit) {
  __shared__ int last;
  const int hk = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int tid = threadIdx.x;
  const size_t bh0 = (size_t)b * H + (size_t)hk * rep;  // first query head
  T* ob = o + bh0 * D;
  if (nsplit == 1) {
    for (int i = tid; i < rep * D; i += THREADS) {
      const float l = l_s[i / D];
      store(ob + i, l > 0.f ? acc_s[i] / l : 0.f);
    }
    if constexpr (LSE) {
      if (tid < rep) lse[bh0 + tid] = log_sum_exp(m_s[tid], l_s[tid]);
    }
    return;
  }
  // partials of (row b, query head h) at slot (b * H + h) * nsplit + sp
  for (int i = tid; i < rep * D; i += THREADS) {
    const int h = i / D, d = i % D;
    part_acc[((bh0 + h) * nsplit + sp) * D + d] = acc_s[i];
  }
  if (tid < rep) {
    part_ml[((bh0 + tid) * nsplit + sp) * 2] = m_s[tid];
    part_ml[((bh0 + tid) * nsplit + sp) * 2 + 1] = l_s[tid];
  }
  __threadfence();
  __syncthreads();
  int* ticket = tickets + (size_t)b * Hkv + hk;
  if (tid == 0) last = atomicAdd(ticket, 1) == nsplit - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid < rep) {
    const float* ml = part_ml + (bh0 + tid) * nsplit * 2;
    float M = -INFINITY;
    for (int s = 0; s < nsplit; ++s) M = fmaxf(M, __ldcg(ml + 2 * s));
    float L = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float w = weight(__ldcg(ml + 2 * s), M);
      wsm[tid * MAX_SPLIT + s] = w;
      L = fmaf(__ldcg(ml + 2 * s + 1), w, L);
    }
    lsum[tid] = L;
    if constexpr (LSE) lse[bh0 + tid] = log_sum_exp(M, L);
  }
  __syncthreads();
  for (int i = tid; i < rep * D; i += THREADS) {
    const int h = i / D, d = i % D;
    const float* pa = part_acc + (bh0 + h) * nsplit * D + d;
    float acc = 0.f;
    for (int s = 0; s < nsplit; ++s)
      acc = fmaf(__ldcg(pa + (size_t)s * D), wsm[h * MAX_SPLIT + s], acc);
    const float L = lsum[h];
    store(ob + i, L > 0.f ? acc / L : 0.f);
  }
  if (tid == 0) *ticket = 0;
}

// ------------------------------------------------------------------ //
// bf16: mma.sync over a cp.async ring
// ------------------------------------------------------------------ //
template <int D>
struct MmaSmem {
  static constexpr int DP = D + 8;  // padded row (bf16): 16 bytes more
  // Q's A fragments stay in registers up to D 128; at D 256 they would
  // take 64 registers beside the output's 128, so Q is kept here
  static constexpr bool Q_SMEM = D > 128;
  static constexpr size_t ring = sizeof(bf16) * 2 * STAGES * BK * DP +
                                 (Q_SMEM ? sizeof(bf16) * 16 * DP : 0);
  // after the loop: per-warp output rows, max and sum; the merged rows;
  // the split merge's weights and sums
  static constexpr size_t epilogue =
      sizeof(float) * (WARPS * 16 * D + 2 * WARPS * 16 + MAX_REP * D +
                       2 * MAX_REP + MAX_REP * MAX_SPLIT + MAX_REP);
  static constexpr size_t bytes = ring > epilogue ? ring : epilogue;
};

// CAP: the logits are capped, cap_in = scale / cap, cap = the softcap.
// LSE: o is float32 and lse (B, H) takes each query head's log-sum-exp;
// else o is bf16 and lse is unused.
template <int D, bool CAP, bool LSE>
__device__ __forceinline__ void decode_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ lengths,
    typename std::conditional<LSE, float, bf16>::type* o, float* lse,
    float* part_acc, float* part_ml, int* tickets, int t_cap, int H,
    int Hkv, int nsplit, float scale, float cap_in, float cap) {
  constexpr int DP = MmaSmem<D>::DP;
  constexpr int KS = D / 16;  // k-steps of QK^T
  constexpr int NT = D / 8;   // n-tiles of PV (even at D = 64, 112, 128, 256)
  constexpr bool Q_SMEM = MmaSmem<D>::Q_SMEM;
  constexpr int CH = D / 8;   // 16-byte chunks per token row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // STAGES x BK x DP
  bf16* vs = ks + STAGES * BK * DP;
  bf16* qs = vs + STAGES * BK * DP;  // 16 x DP when Q_SMEM

  const int hk = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int rep = H / Hkv;
  const int len = min(lengths[b], t_cap);
  int t_begin, t_end;
  split_range(len, nsplit, sp, t_begin, t_end);
  const int ntiles = t_end > t_begin ? (t_end - t_begin + BK - 1) / BK : 0;
  const size_t row = (size_t)Hkv * D;  // elements per cached token
  const bf16* kb = k + (size_t)b * t_cap * row + (size_t)hk * D;
  const bf16* vb = v + (size_t)b * t_cap * row + (size_t)hk * D;
  const bf16* qb = q + ((size_t)b * H + (size_t)hk * rep) * D;

  auto load_tile = [&](int i) {
    const int t0 = t_begin + i * BK, slot = i % STAGES;
#pragma unroll 4
    for (int c = tid; c < BK * CH; c += THREADS) {
      const int r = c / CH, e = (c % CH) * 8;
      const bool ok = t0 + r < t_end;
      const size_t off = (size_t)(ok ? t0 + r : t_begin) * row + e;
      mma::cp_async16(ks + (slot * BK + r) * DP + e, kb + off, ok);
      mma::cp_async16(vs + (slot * BK + r) * DP + e, vb + off, ok);
    }
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < ntiles) load_tile(i);
    mma::cp_async_commit();
  }

  // Q as A fragments: rows are the rep query heads (zero past rep); held
  // in registers, or (Q_SMEM) as 16 rows of shared memory that the first
  // barrier of the loop publishes
  uint32_t qf[Q_SMEM ? 1 : KS][4];
  if constexpr (Q_SMEM) {
    for (int c = tid; c < 16 * CH; c += THREADS) {
      const int r = c / CH, e = (c % CH) * 8;
      *reinterpret_cast<uint4*>(qs + r * DP + e) =
          r < rep ? *reinterpret_cast<const uint4*>(qb + (size_t)r * D + e)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int c = kk * 16 + 2 * t4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = g + (j & 1) * 8, cc = c + (j >> 1) * 8;
        qf[kk][j] = r < rep
            ? *reinterpret_cast<const uint32_t*>(qb + (size_t)r * D + cc)
            : 0u;
      }
    }
  }

  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows g, g+8
  float oacc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) oacc[n][j] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    mma::cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile i has landed; tile i - 1's slot is free
    if (i + STAGES - 1 < ntiles) load_tile(i + STAGES - 1);
    mma::cp_async_commit();
    const int slot = i % STAGES;
    const bf16* kt = ks + (slot * BK + warp * 16) * DP;
    const bf16* vt = vs + (slot * BK + warp * 16) * DP;

    // S = Q K^T over this warp's 16 tokens: two n-tiles of 8 tokens
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t kf[4];  // matrices: (tokens 0-7 | 8-15) x (k 0-7 | 8-15)
      mma::ldmatrix_x4(kf, kt + ((lane >> 4) * 8 + (lane & 7)) * DP +
                               kk * 16 + ((lane >> 3) & 1) * 8);
      if constexpr (Q_SMEM) {
        // matrices: (heads 0-7 | 8-15) x (k 0-7), then x (k 8-15)
        uint32_t qa[4];
        mma::ldmatrix_x4(qa, qs + (lane & 15) * DP + kk * 16 +
                                 (lane >> 4) * 8);
        mma::mma_bf16(s[0], qa, kf[0], kf[1]);
        mma::mma_bf16(s[1], qa, kf[2], kf[3]);
      } else {
        mma::mma_bf16(s[0], qf[kk], kf[0], kf[1]);
        mma::mma_bf16(s[1], qf[kk], kf[2], kf[3]);
      }
    }
    // online softmax on the fragments: this thread holds rows g (s[j][0],
    // s[j][1]) and g + 8 (s[j][2], s[j][3]); a row's 16 values sit in the
    // four threads of a quad
    const int tb = t_begin + i * BK + warp * 16 + 2 * t4;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = tb + j * 8 + e < t_end;
        if constexpr (CAP) {
          s[j][e] = ok ? cap * tanh_approx(s[j][e] * cap_in) : -INFINITY;
          s[j][2 + e] =
              ok ? cap * tanh_approx(s[j][2 + e] * cap_in) : -INFINITY;
        } else {
          s[j][e] = ok ? s[j][e] * scale : -INFINITY;
          s[j][2 + e] = ok ? s[j][2 + e] * scale : -INFINITY;
        }
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // a row that has seen no token yet keeps max -inf: subtract 0 then
    const float base0 = mn0 == -INFINITY ? 0.f : mn0;
    const float base1 = mn1 == -INFINITY ? 0.f : mn1;
    const float a0 = expf(m0 - base0), a1 = expf(m1 - base1);
    m0 = mn0;
    m1 = mn1;
    float p[2][4];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[j][e] = expf(s[j][e] - base0);
        p[j][2 + e] = expf(s[j][2 + e] - base1);
        rs0 += p[j][e];
        rs1 += p[j][2 + e];
      }
    l0 = fmaf(l0, a0, rs0);  // this thread's share; the quad sums at the end
    l1 = fmaf(l1, a1, rs1);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      oacc[n][0] *= a0;
      oacc[n][1] *= a0;
      oacc[n][2] *= a1;
      oacc[n][3] *= a1;
    }
    // O += P V: the accumulator layout of S is the A layout of P
    const uint32_t pa[4] = {mma::pack_bf16(p[0][0], p[0][1]),
                            mma::pack_bf16(p[0][2], p[0][3]),
                            mma::pack_bf16(p[1][0], p[1][1]),
                            mma::pack_bf16(p[1][2], p[1][3])};
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t vf[4];  // transposed: (tokens 0-7 | 8-15) x (d +0 | +8)
      mma::ldmatrix_x4_trans(vf, vt + (((lane >> 3) & 1) * 8 + (lane & 7)) *
                                          DP + np * 16 + (lane >> 4) * 8);
      mma::mma_bf16(oacc[2 * np], pa, vf[0], vf[1]);
      mma::mma_bf16(oacc[2 * np + 1], pa, vf[2], vf[3]);
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();  // the ring is free for the epilogue

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  float* wo = reinterpret_cast<float*>(smem_raw);  // WARPS x 16 x D
  float* wm = wo + WARPS * 16 * D;                 // WARPS x 16
  float* wl = wm + WARPS * 16;
  float* acc_s = wl + WARPS * 16;                  // MAX_REP x D
  float* m_s = acc_s + MAX_REP * D;
  float* l_s = m_s + MAX_REP;
  float* wsm = l_s + MAX_REP;                      // MAX_REP x MAX_SPLIT
  float* lsum = wsm + MAX_REP * MAX_SPLIT;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + 2 * t4;
    if (g < rep) {
      wo[(warp * 16 + g) * D + c] = oacc[n][0];
      wo[(warp * 16 + g) * D + c + 1] = oacc[n][1];
    }
    if (g + 8 < rep) {
      wo[(warp * 16 + g + 8) * D + c] = oacc[n][2];
      wo[(warp * 16 + g + 8) * D + c + 1] = oacc[n][3];
    }
  }
  if (t4 == 0) {
    wm[warp * 16 + g] = m0;
    wm[warp * 16 + g + 8] = m1;
    wl[warp * 16 + g] = l0;
    wl[warp * 16 + g + 8] = l1;
  }
  __syncthreads();
  for (int i = tid; i < rep * D; i += THREADS) {
    const int h = i / D, d = i % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, wm[w * 16 + h]);
    float acc = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float e = weight(wm[w * 16 + h], M);
      acc = fmaf(e, wo[(w * 16 + h) * D + d], acc);
      L = fmaf(e, wl[w * 16 + h], L);
    }
    acc_s[i] = acc;
    if (d == 0) {
      m_s[h] = M;
      l_s[h] = L;
    }
  }
  __syncthreads();
  finish<D, LSE>(acc_s, m_s, l_s, wsm, lsum, rep, o, lse, part_acc, part_ml,
                 tickets, H, Hkv, nsplit);
}

template <int D, bool CAP>
__global__ void __launch_bounds__(THREADS)
    decode_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const int* __restrict__ lengths, bf16* o,
                      float* part_acc, float* part_ml, int* tickets,
                      int t_cap, int H, int Hkv, int nsplit, float scale,
                      float cap_in, float cap) {
  decode_mma<D, CAP, false>(q, k, v, lengths, o, nullptr, part_acc, part_ml,
                            tickets, t_cap, H, Hkv, nsplit, scale, cap_in,
                            cap);
}

template <int D, bool CAP>
__global__ void __launch_bounds__(THREADS)
    decode_mma_lse_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const int* __restrict__ lengths, float* o,
                          float* lse, float* part_acc, float* part_ml,
                          int* tickets, int t_cap, int H, int Hkv,
                          int nsplit, float scale, float cap_in, float cap) {
  decode_mma<D, CAP, true>(q, k, v, lengths, o, lse, part_acc, part_ml,
                           tickets, t_cap, H, Hkv, nsplit, scale, cap_in,
                           cap);
}

// ------------------------------------------------------------------ //
// fp32: FMA, one thread per channel
// ------------------------------------------------------------------ //
template <int D>
constexpr size_t fma_smem_bytes() {
  return sizeof(float) * (MAX_REP * D + BK * (D + 1) + BK * D +
                          MAX_REP * BK + 3 * MAX_REP);
}

// Thread t owns output channels t, t + THREADS, ... below D (one up to
// D 128, two at D 256); K rows are padded to D + 1 floats for
// conflict-free reads.
// CAP: the pre-scaled logits are capped, tanhf(s / cap) * cap.
// LSE: lse (B, H) takes each query head's log-sum-exp.
template <int D, bool CAP, bool LSE>
__device__ __forceinline__ void decode_fma(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ lengths, float* o,
    float* lse, float* part_acc, float* part_ml, int* tickets, int t_cap,
    int H, int Hkv, int nsplit, float scale, float cap) {
  constexpr int DP = D + 1;
  extern __shared__ __align__(16) float smem[];
  const int rep = H / Hkv;
  float* qs = smem;                // rep x D, pre-scaled queries
  float* ks = qs + MAX_REP * D;    // BK x DP
  float* vs = ks + BK * DP;        // BK x D
  float* ps = vs + BK * D;         // rep x BK: scores, then weights
  float* ms = ps + MAX_REP * BK;   // rep running max
  float* ls = ms + MAX_REP;        // rep running sum
  float* as = ls + MAX_REP;        // rep rescale factor of this tile

  const int hk = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(lengths[b], t_cap);
  int t_begin, t_end;
  split_range(len, nsplit, sp, t_begin, t_end);
  const size_t row = (size_t)Hkv * D;
  const float* kb = k + (size_t)b * t_cap * row + (size_t)hk * D;
  const float* vb = v + (size_t)b * t_cap * row + (size_t)hk * D;
  const float* qb = q + ((size_t)b * H + (size_t)hk * rep) * D;

  for (int i = tid; i < rep * D; i += THREADS) qs[i] = qb[i] * scale;
  if (tid < rep) {
    ms[tid] = NEG;
    ls[tid] = 0.f;
  }

  constexpr int CPT = (D + THREADS - 1) / THREADS;  // channels per thread
  static_assert(D <= THREADS || D % THREADS == 0, "channels per thread");
  float acc[CPT][MAX_REP];
#pragma unroll
  for (int j = 0; j < CPT; ++j)
#pragma unroll
    for (int h = 0; h < MAX_REP; ++h) acc[j][h] = 0.f;

  constexpr int CHUNKS = D / 4;                     // float4 loads per row
  constexpr int ITEMS = BK * CHUNKS / THREADS;      // loads per thread
  constexpr int BATCH =                             // loads in flight
      ITEMS <= 8 ? ITEMS : ITEMS <= 16 ? ITEMS / 2 : 8;
  static_assert(BK * CHUNKS % THREADS == 0 && ITEMS % BATCH == 0, "tiling");

  for (int k0 = t_begin; k0 < t_end; k0 += BK) {
    const int n = min(BK, t_end - k0);  // valid tokens in this tile
    __syncthreads();                    // the previous tile is consumed
#pragma unroll
    for (int i0 = 0; i0 < ITEMS; i0 += BATCH) {
      float4 kr[BATCH], vr[BATCH];
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int i = tid + (i0 + j) * THREADS;
        const int r = i / CHUNKS, c = (i % CHUNKS) * 4;
        kr[j] = vr[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < n) {
          const size_t off = (size_t)(k0 + r) * row + c;
          kr[j] = *reinterpret_cast<const float4*>(kb + off);
          vr[j] = *reinterpret_cast<const float4*>(vb + off);
        }
      }
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int i = tid + (i0 + j) * THREADS;
        const int r = i / CHUNKS, c = (i % CHUNKS) * 4;
        float* kd = ks + r * DP + c;
        kd[0] = kr[j].x;
        kd[1] = kr[j].y;
        kd[2] = kr[j].z;
        kd[3] = kr[j].w;
        *reinterpret_cast<float4*>(vs + r * D + c) = vr[j];
      }
    }
    __syncthreads();
    // scores: one (query head, token) pair per iteration
    for (int i = tid; i < rep * BK; i += THREADS) {
      const int h = i / BK, c = i % BK;
      float s = NEG;
      if (c < n) {
        const float* qh = qs + h * D;
        const float* kc = ks + c * DP;
        s = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) s = fmaf(qh[d], kc[d], s);
        if constexpr (CAP) s = tanhf(s / cap) * cap;
      }
      ps[h * BK + c] = s;
    }
    __syncthreads();
    // online-softmax update: one warp per query head
    for (int h = warp; h < rep; h += WARPS) {
      const float s0 = ps[h * BK + lane], s1 = ps[h * BK + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = ms[h];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = lane < n ? expf(s0 - m_new) : 0.f;
      const float p1 = lane + 32 < n ? expf(s1 - m_new) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      ps[h * BK + lane] = p0;
      ps[h * BK + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        as[h] = alpha;
        ls[h] = ls[h] * alpha + sum;
        ms[h] = m_new;
      }
    }
    __syncthreads();
    // acc[j][h] (channel d = tid + j THREADS) = acc[j][h] * alpha[h] +
    // sum_c p[h][c] V[c][d]
    if (tid < D) {
#pragma unroll
      for (int j = 0; j < CPT; ++j)
#pragma unroll
        for (int h = 0; h < MAX_REP; ++h)
          if (h < rep) acc[j][h] *= as[h];
      for (int c = 0; c < n; ++c) {
        float vv[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j) vv[j] = vs[c * D + tid + j * THREADS];
#pragma unroll
        for (int h = 0; h < MAX_REP; ++h)
          if (h < rep) {
            const float p = ps[h * BK + c];
#pragma unroll
            for (int j = 0; j < CPT; ++j) acc[j][h] = fmaf(p, vv[j], acc[j][h]);
          }
      }
    }
  }
  __syncthreads();
  // the queries and scores are consumed: their space holds the epilogue
  float* acc_s = qs;   // MAX_REP x D
  float* wsm = ps;     // MAX_REP x MAX_SPLIT (= MAX_REP x BK)
  static_assert(MAX_SPLIT <= BK, "split weights fit the score buffer");
  if (tid < D) {
#pragma unroll
    for (int j = 0; j < CPT; ++j)
#pragma unroll
      for (int h = 0; h < MAX_REP; ++h)
        if (h < rep) acc_s[h * D + tid + j * THREADS] = acc[j][h];
  }
  __syncthreads();
  finish<D, LSE>(acc_s, ms, ls, wsm, as, rep, o, lse, part_acc, part_ml,
                 tickets, H, Hkv, nsplit);
}

template <int D, bool CAP>
__global__ void __launch_bounds__(THREADS)
    decode_fma_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const int* __restrict__ lengths, float* o,
                      float* part_acc, float* part_ml, int* tickets,
                      int t_cap, int H, int Hkv, int nsplit, float scale,
                      float cap) {
  decode_fma<D, CAP, false>(q, k, v, lengths, o, nullptr, part_acc, part_ml,
                            tickets, t_cap, H, Hkv, nsplit, scale, cap);
}

// At least two blocks an SM: ptxas then lets the body keep its LSE
// epilogue in registers (at D 112 with the cap, by the default budget,
// it spilled 8 bytes); the kernel without it keeps its default.
template <int D, bool CAP>
__global__ void __launch_bounds__(THREADS, 2)
    decode_fma_lse_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const int* __restrict__ lengths, float* o,
                          float* lse, float* part_acc, float* part_ml,
                          int* tickets, int t_cap, int H, int Hkv,
                          int nsplit, float scale, float cap) {
  decode_fma<D, CAP, true>(q, k, v, lengths, o, lse, part_acc, part_ml,
                           tickets, t_cap, H, Hkv, nsplit, scale, cap);
}

// lse null: the kernels without the log-sum-exp (o in the input dtype);
// else the LSE kernels (o float32)
template <int D, bool CAP>
int launch(int dtype, const void* q, const void* k, const void* v,
           const void* lengths, void* o, void* lse, void* part_acc,
           void* part_ml, void* tickets, int B, int t_cap, int H, int Hkv,
           int nsplit, float scale, float cap, cudaStream_t s) {
  const dim3 grid(Hkv, B, nsplit);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  float* ls = static_cast<float*>(lse);
  int* tk = static_cast<int*>(tickets);
  const int* lens = static_cast<const int*>(lengths);
  cudaError_t err;
  if (dtype == 1) {
    constexpr size_t smem = MmaSmem<D>::bytes;
    const bf16* qb = static_cast<const bf16*>(q);
    const bf16* kb = static_cast<const bf16*>(k);
    const bf16* vb = static_cast<const bf16*>(v);
    const float cap_in = CAP ? scale / cap : 0.f;
    if (ls) {
      err = mma::opt_in<decode_mma_lse_kernel<D, CAP>>(smem);
      if (err != cudaSuccess) return (int)err;
      decode_mma_lse_kernel<D, CAP><<<grid, THREADS, smem, s>>>(
          qb, kb, vb, lens, static_cast<float*>(o), ls, pa, pm, tk, t_cap, H,
          Hkv, nsplit, scale, cap_in, cap);
    } else {
      err = mma::opt_in<decode_mma_kernel<D, CAP>>(smem);
      if (err != cudaSuccess) return (int)err;
      decode_mma_kernel<D, CAP><<<grid, THREADS, smem, s>>>(
          qb, kb, vb, lens, static_cast<bf16*>(o), pa, pm, tk, t_cap, H, Hkv,
          nsplit, scale, cap_in, cap);
    }
  } else if (dtype == 0) {
    constexpr size_t smem = fma_smem_bytes<D>();
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    float* of = static_cast<float*>(o);
    if (ls) {
      err = mma::opt_in<decode_fma_lse_kernel<D, CAP>>(smem);
      if (err != cudaSuccess) return (int)err;
      decode_fma_lse_kernel<D, CAP><<<grid, THREADS, smem, s>>>(
          qf, kf, vf, lens, of, ls, pa, pm, tk, t_cap, H, Hkv, nsplit, scale,
          cap);
    } else {
      err = mma::opt_in<decode_fma_kernel<D, CAP>>(smem);
      if (err != cudaSuccess) return (int)err;
      decode_fma_kernel<D, CAP><<<grid, THREADS, smem, s>>>(
          qf, kf, vf, lens, of, pa, pm, tk, t_cap, H, Hkv, nsplit, scale,
          cap);
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// the instantiation without (softcap 0) or with the cap
template <int D>
int launch_cap(int dtype, const void* q, const void* k, const void* v,
               const void* lengths, void* o, void* lse, void* part_acc,
               void* part_ml, void* tickets, int B, int t_cap, int H,
               int Hkv, int nsplit, float scale, float softcap,
               cudaStream_t s) {
  if (softcap > 0.f)
    return launch<D, true>(dtype, q, k, v, lengths, o, lse, part_acc,
                           part_ml, tickets, B, t_cap, H, Hkv, nsplit, scale,
                           softcap, s);
  return launch<D, false>(dtype, q, k, v, lengths, o, lse, part_acc, part_ml,
                          tickets, B, t_cap, H, Hkv, nsplit, scale, 0.f, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim: 64, 112, 128 or 256; rep = H /
// Hkv <= 16; 1 <= nsplit <= 64.  o: (B, H, head_dim), in dtype, or float32
// when lse is given; lse: null, or float32 (B, H), each query head's
// log-sum-exp (-1e30 for a row of length 0).  part_acc: float32 (B, H,
// nsplit, head_dim) and part_ml: float32 (B, H, nsplit, 2), scratch;
// tickets: int32 (B, Hkv), zero before the call and zero after it.
// softcap: 0 for none, else > 0 (the scaled logits become softcap *
// tanh(logit / softcap)).  Returns the cudaError_t of the launch.
extern "C" int fa_decode(int dtype, int head_dim, const void* q,
                         const void* k, const void* v, const void* lengths,
                         void* o, void* lse, void* part_acc, void* part_ml,
                         void* tickets, int B, int t_cap, int H, int Hkv,
                         int nsplit, float scale, float softcap,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nsplit < 1 || nsplit > MAX_SPLIT || Hkv < 1 || H % Hkv ||
      H / Hkv > MAX_REP || !(softcap >= 0.f))
    return (int)cudaErrorInvalidValue;
  if (head_dim == 64)
    return launch_cap<64>(dtype, q, k, v, lengths, o, lse, part_acc, part_ml,
                          tickets, B, t_cap, H, Hkv, nsplit, scale, softcap,
                          s);
  if (head_dim == 112)
    return launch_cap<112>(dtype, q, k, v, lengths, o, lse, part_acc, part_ml,
                          tickets, B, t_cap, H, Hkv, nsplit, scale, softcap,
                          s);
  if (head_dim == 128)
    return launch_cap<128>(dtype, q, k, v, lengths, o, lse, part_acc, part_ml,
                          tickets, B, t_cap, H, Hkv, nsplit, scale, softcap,
                          s);
  if (head_dim == 256)
    return launch_cap<256>(dtype, q, k, v, lengths, o, lse, part_acc, part_ml,
                          tickets, B, t_cap, H, Hkv, nsplit, scale, softcap,
                          s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* fa_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
