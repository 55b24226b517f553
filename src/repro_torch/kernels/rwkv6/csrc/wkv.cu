/*
 * K4: the RWKV6 WKV recurrence, for Hopper (sm_90a).  Built by kernel.py
 * with nvcc into a shared library with a plain C interface.
 *
 * Replaces: src/repro/kernels/rwkv6/kernel.py, wkv (pl.pallas_call of
 *   _wkv_kernel), which computes the model's _wkv_scan
 *   (src/repro/models/ssm.py):
 *     y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
 *     S_t = diag(w_t) S_{t-1} + k_t v_t^T
 *   per (batch row, head), with the P x P fp32 state [key][value] carried
 *   over tokens.  The Pallas kernel keeps the state in VMEM over a
 *   sequential chunk grid and walks the tokens on the VPU.
 *
 * What bounds it on the card: bytes.  Each token reads r, k, v (model
 * dtype) and w (fp32) and writes y (fp32), 14 bytes per channel in bf16,
 * against the recurrence's 4 P = 256 FLOPs per channel: at rwkv6-3b's
 * serve admission (B 1, S 512, H 40, P 64) 19.7 MB, 0.006 ms at 3.35
 * TB/s, and 0.005 ms of fp32 FMA.  A decode step (S 1) reads and writes
 * the 2.6 MB state of 4 rows and little else.  What keeps a kernel from
 * that is the serial token loop on few blocks: one block per (row, head)
 * is 40 blocks at B 1, each walking 512 tokens with a 64-long FMA chain a
 * token (the first port: 0.28 ms at B 1).
 *
 * Each value column of the state evolves on its own; only the read-out
 * sums over the key index.  Two kernels, chosen by S in kernel.py:
 *
 *  - wkv_rec_kernel, the parallel recurrence (decode and S < 16).  A
 *    block of 64 threads owns 16 value columns of one (row, head): four
 *    blocks per head.  Thread (key group, value quad) keeps a 4 x 4 slice
 *    of the state in registers, read and written with 16-byte loads; per
 *    token it does 16 x 4 FMA-class operations, and the read-out's sum
 *    over the 16 key groups is a transposing shuffle reduction (5
 *    shuffles for 4 values) off the state's dependency chain, four tokens
 *    at a time.  A decode step reads its token straight from device
 *    memory; longer inputs arrive in 16-token tiles by cp.async into a
 *    double buffer.  Exact fp32 FMA, as the plain recurrence; only the
 *    order of the read-out's sum differs.
 *
 *  - wkv_chunk_kernel, a chunked form on the tensor cores (S >= 16).  The
 *    tokens go in steps of C = 16, the state carried from step to step.
 *    With A_t the product of w over the step's tokens before t, B_s that
 *    over its tokens after s, and S the state before the step:
 *      y_t = (r_t * A_t) . S + sum_{s<=t} M[t,s] v_s
 *      M[t,s] = sum_i r_t[i] k_s[i] prod_{s<tau<t} w_tau[i]   (s < t)
 *      M[t,t] = sum_i r_t[i] u[i] k_t[i]                       (the bonus)
 *      S <- diag(A_C) S + sum_s (k_s * B_s) v_s^T
 *    The hazard is the per-channel decay: a prefix product of w
 *    underflows within a few dozen tokens for fast channels (w near 0),
 *    so 1 / (prefix product) overflows.  Nothing here divides: every
 *    decay is a product of w over the tokens between the two it connects,
 *    formed by multiplication as the recurrence forms it, so every factor
 *    is at most 1 and a fast channel underflows to 0, as in the
 *    recurrence; M is built by direct products over the step's 120 pairs.
 *    The three products run on TF32 mma.sync m16n8k8 with fp32 accuracy:
 *    each fp32 operand is split into TF32 hi + lo (integer rounding of the
 *    bits, at full ALU rate), the read-out (state x (r A)^T) as 3xTF32,
 *    M v and the update (v^T (k B)) as 2xTF32 when v is bf16 (exact in
 *    TF32).  A block of 8 warps owns one (row, head): 4 producer warps
 *    prepare each step (decays, r~, k~ as hi / lo, M) one step ahead of 4
 *    consumer warps, each of which keeps a 64 x 16 slice of the state in
 *    mma accumulators from first step to last (the read-out feeds them
 *    back as the A operand, the k index renamed, as in K5); named
 *    barriers hand the double-buffered steps over, and raw tiles arrive
 *    by cp.async two steps ahead.
 *    Where the rows and heads alone leave most SMs idle (B 1: 40 blocks),
 *    the sequence is cut into segments, one block each, in one cooperative
 *    launch (every block resident): each segment but the last first makes
 *    its summary, its own contribution to the state at its end from a
 *    zero state and its decay, in bulk (64-token blocks from its end
 *    backwards, 16-token product chains carried over what lies after,
 *    again only products of w); the blocks meet at a grid barrier; then
 *    each segment starts from the state carried over the summaries before
 *    it and runs its steps.  A ragged last step is zero-filled with w = 1,
 *    which leaves the state as the unpadded recurrence leaves it.
 *
 * Both take any S >= 1 and fp32 or bf16 r, k, v (templated), and replace
 * the state in place: each block reads all of its slice of the state
 * before it writes any, and no two blocks write one slice (segments read
 * a copy made before the grid barrier).  w, u, the state and y are fp32,
 * as in the model.
 */
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "../../csrc/mma.cuh"

namespace {

constexpr int P = 64;  // head size
constexpr unsigned FULL = 0xffffffffu;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// Four consecutive values of T as floats (T aligned to 4 elements).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// x = hi + lo with hi and lo TF32 values (their low 13 bits zero), each
// rounded to nearest (ties away from zero) by integer operations on the
// bits: the same split as mma::split_tf32 to within ties, at full ALU
// rate.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// ------------------------------------------------------------------ //
// The parallel recurrence
// ------------------------------------------------------------------ //
constexpr int RV = 16;               // value columns a block
// one token's r, k, w at a thread's four keys and v at its four values
struct Tok {
  float4 r, k, w, v;
};
constexpr int REC_THREADS = 4 * RV;  // 16 key groups x RV / 4 quads
constexpr int TC = 16;               // tokens a tile

// r, k, v, w, y: (B, S, H, P); u: (H, P); state: (B, H, P, P)
// [key][value].  Block (value slice, head, row).
template <typename T>
__global__ void __launch_bounds__(REC_THREADS)
    wkv_rec_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ w,
                   const float* __restrict__ u, float* state,
                   float* __restrict__ y, int S, int H) {
  __shared__ __align__(16) T rs[2][TC][P];
  __shared__ __align__(16) T ks[2][TC][P];
  __shared__ __align__(16) float ws[2][TC][P];
  __shared__ __align__(16) T vs[2][TC][RV];

  const int tid = threadIdx.x, lane = tid & 31;
  const int kg = tid & 15, q = tid >> 4;  // keys 4 kg.., values 4 q..
  const int vb = blockIdx.x * RV, h = blockIdx.y, b = blockIdx.z;
  const size_t row = (size_t)H * P;  // elements per token
  const size_t base = (size_t)b * S * row + (size_t)h * P;
  float* st = state + ((size_t)b * H + h) * P * P + vb + 4 * q;

  float s[4][4], uu[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float4 x = load4(st + (size_t)(4 * kg + e) * P);
    s[e][0] = x.x;
    s[e][1] = x.y;
    s[e][2] = x.z;
    s[e][3] = x.w;
    uu[e] = u[h * P + 4 * kg + e];
  }

  constexpr int PE = 16 / sizeof(T);  // elements of T a 16-byte copy
  auto load_tile = [&](int t0, int buf) {
    const int n = min(TC, S - t0);
    for (int c = tid; c < TC * (P / PE); c += REC_THREADS) {
      const int t = c / (P / PE), e = (c % (P / PE)) * PE;
      const bool ok = t < n;
      const size_t off = base + (size_t)(ok ? t0 + t : 0) * row + e;
      mma::cp_async16(&rs[buf][t][e], r + off, ok);
      mma::cp_async16(&ks[buf][t][e], k + off, ok);
    }
    for (int c = tid; c < TC * (P / 4); c += REC_THREADS) {
      const int t = c / (P / 4), e = (c % (P / 4)) * 4;
      const bool ok = t < n;
      mma::cp_async16(&ws[buf][t][e],
                      w + base + (size_t)(ok ? t0 + t : 0) * row + e, ok);
    }
    for (int c = tid; c < TC * (RV / PE); c += REC_THREADS) {
      const int t = c / (RV / PE), e = (c % (RV / PE)) * PE;
      const bool ok = t < n;
      mma::cp_async16(&vs[buf][t][e],
                      v + base + (size_t)(ok ? t0 + t : 0) * row + vb + e,
                      ok);
    }
    mma::cp_async_commit();
  };

  // after the transposing reduction, lane holds value 2 bit3 + bit2 of
  // its quad, summed over the 16 key groups
  const bool hi8 = lane & 8, hi4 = lane & 4;
  float* yq = y + base + vb + 4 * q + (hi8 ? 2 : 0) + (hi4 ? 1 : 0);

  // U tokens from token t on, their r, k, w (this thread's keys) and v
  // (its values) from fetch(x): the state's chain is one FMA a token, and
  // the U read-out reductions are independent of it and of each other
  auto tokens = [&](int t, auto u_tag, auto fetch) {
    constexpr int U = decltype(u_tag)::value;
    float acc[U][4];
#pragma unroll
    for (int x = 0; x < U; ++x) {
      const Tok tk = fetch(x);
      const float rr[4] = {tk.r.x, tk.r.y, tk.r.z, tk.r.w};
      const float kk[4] = {tk.k.x, tk.k.y, tk.k.z, tk.k.w};
      const float wv[4] = {tk.w.x, tk.w.y, tk.w.z, tk.w.w};
      const float vv[4] = {tk.v.x, tk.v.y, tk.v.z, tk.v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[x][j] = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float kv = kk[e] * vv[j];
          acc[x][j] = fmaf(rr[e], fmaf(uu[e], kv, s[e][j]), acc[x][j]);
          s[e][j] = fmaf(wv[e], s[e][j], kv);
        }
    }
#pragma unroll
    for (int x = 0; x < U; ++x) {
      // sum over the 16 key groups (lane bits 0-3), scattering the four
      // values: bit 3 keeps a pair, bit 2 one of it, bits 1 and 0 add
      const float* a = acc[x];
      const float k0 = hi8 ? a[2] : a[0], k1 = hi8 ? a[3] : a[1];
      const float o0 = hi8 ? a[0] : a[2], o1 = hi8 ? a[1] : a[3];
      const float p0 = k0 + __shfl_xor_sync(FULL, o0, 8);
      const float p1 = k1 + __shfl_xor_sync(FULL, o1, 8);
      float z = (hi4 ? p1 : p0) + __shfl_xor_sync(FULL, hi4 ? p0 : p1, 4);
      z += __shfl_xor_sync(FULL, z, 2);
      z += __shfl_xor_sync(FULL, z, 1);
      if ((lane & 3) == 0) yq[(size_t)(t + x) * row] = z;
    }
  };

  if (S == 1) {
    // a decode step: the token straight from device memory, no staging
    tokens(0, std::integral_constant<int, 1>(), [&](int) {
      return Tok{
          load4(r + base + 4 * kg), load4(k + base + 4 * kg),
          load4(w + base + 4 * kg), load4(v + base + vb + 4 * q)};
    });
  } else {
    const int ntiles = (S + TC - 1) / TC;
    load_tile(0, 0);
    for (int ti = 0; ti < ntiles; ++ti) {
      const int buf = ti & 1, t0 = ti * TC, n = min(TC, S - t0);
      if (ti + 1 < ntiles) load_tile(t0 + TC, buf ^ 1);
      else mma::cp_async_commit();
      mma::cp_async_wait<1>();
      __syncthreads();  // tile ti has landed for every thread
      int t = 0;
      auto staged = [&](int x) {
        return Tok{
            load4(&rs[buf][t + x][4 * kg]), load4(&ks[buf][t + x][4 * kg]),
            load4(&ws[buf][t + x][4 * kg]), load4(&vs[buf][t + x][4 * q])};
      };
      for (; t + 4 <= n; t += 4)
        tokens(t0 + t, std::integral_constant<int, 4>(), staged);
      for (; t < n; ++t)
        tokens(t0 + t, std::integral_constant<int, 1>(), staged);
      __syncthreads();  // tile ti is consumed before its buffer is refilled
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    *reinterpret_cast<float4*>(st + (size_t)(4 * kg + e) * P) =
        make_float4(s[e][0], s[e][1], s[e][2], s[e][3]);
}

// ------------------------------------------------------------------ //
// The chunked form on tensor cores
// ------------------------------------------------------------------ //
constexpr int C = 16;               // tokens a step
constexpr int CT = 128;             // consumer threads: 4 mma warps
constexpr int PT = 128;             // producer threads: 4 warps
constexpr int CH_THREADS = CT + PT;
constexpr int NS = 3;               // stages of the raw tile ring
constexpr int RS = P + 8;           // padded r~ / k~ rows (words)
constexpr int MS = C + 4;           // padded M rows (words)
constexpr int VS = P + 8;           // padded v rows (elements)
constexpr int MPS = 20;             // padded M partial (floats)
constexpr int KG = 16;              // key groups of M's partials
constexpr int SB = 64;              // tokens a block of the segment pass
static_assert(PT == 2 * P && PT == (C / 2) * KG, "a producer per task");
static_assert(CT == 2 * P, "a consumer warp per 16 value columns");
static_assert(CH_THREADS == 4 * P, "segment pass: a thread per key quarter");
// named barriers (0 is __syncthreads): a prepared step is full / has
// been consumed, per parity; the producers among themselves
constexpr int BAR_FULL = 1, BAR_EMPTY = 3, BAR_PROD = 5;

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Shared memory of the outputs pass.
template <typename T>
struct ChunkSmem {
  // the producers' ring of raw tiles (r, k, v in T; w fp32)
  T r[NS][C][P];
  T k[NS][C][P];
  float w[NS][C][P];
  T v[NS][C][P];
  // a prepared step, double-buffered: r~ = r A and k~ = k B as TF32
  // hi / lo, M as hi / lo, the step's decay A_C, and v
  struct Step {
    uint32_t rh[C][RS], rl[C][RS];
    uint32_t kh[C][RS], kl[C][RS];
    uint32_t mh[C][MS], ml[C][MS];
    float ac[P];
    T v[C][VS];
  } step[2];
  float mp[C * C][MPS];  // M's partials over the key groups, [t][s][group]
  float u[P];
};

// Shared memory of the segment pass, in the same bytes.
template <typename T>
struct SegSmem {
  T k[SB][P];
  float w[SB][P];
  T v[SB][VS];
  uint32_t kh[SB][RS], kl[SB][RS];  // k~ as TF32 hi / lo
  float qd[4][P];   // each quarter's decay
  float carry[P];   // the decay of the blocks after this one
};

template <typename T>
constexpr size_t chunk_smem() {
  return sizeof(ChunkSmem<T>) > sizeof(SegSmem<T>) ? sizeof(ChunkSmem<T>)
                                                   : sizeof(SegSmem<T>);
}

// M's partial sums over four keys for one step, at r, k, w (the step's
// tiles, C x P): task (row pair pr, key group kg) walks row s1 = pr
// (tokens pr + 1 ..) and then row s2 = 15 - pr (tokens 16 - pr ..): 15
// pairs for every task, in batches of five whose loads are issued before
// their stores.  mp[t C + s][kg] for s <= t (the diagonal is the bonus).
template <typename T>
__device__ __forceinline__ void m_partials(const T (&rt)[C][P],
                                           const T (&kt)[C][P],
                                           const float (&wt)[C][P],
                                           const float* uu,
                                           float (*mp)[MPS], int task) {
  const int kg = task % KG, pr = task / KG;
  const int s1 = pr, s2 = C - 1 - pr, n1 = C - 1 - pr;
  const float4 u4 = load4(uu + 4 * kg);
  float kd[4], k2[4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int s = half == 0 ? s1 : s2;
    const float4 k4 = load4(&kt[s][4 * kg]);
    const float4 r4 = load4(&rt[s][4 * kg]);
    mp[s * C + s][kg] = r4.x * u4.x * k4.x + r4.y * u4.y * k4.y +
                        r4.z * u4.z * k4.z + r4.w * u4.w * k4.w;
    float* dst = half == 0 ? kd : k2;
    dst[0] = k4.x;
    dst[1] = k4.y;
    dst[2] = k4.z;
    dst[3] = k4.w;
  }
  constexpr int NB = 5;  // pairs a batch
  static_assert((C - 1) % NB == 0, "whole batches");
#pragma unroll
  for (int m0 = 0; m0 < C - 1; m0 += NB) {
    float4 rr[NB], ww[NB];
    int mi[NB];  // M's index t C + s of each pair
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      const int m = m0 + q;
      const bool second = m >= n1;
      const int t = second ? m + 1 : s1 + 1 + m;
      mi[q] = t * C + (second ? s2 : s1);
      rr[q] = load4(&rt[t][4 * kg]);
      ww[q] = load4(&wt[t][4 * kg]);
    }
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      if (m0 + q == n1) {
#pragma unroll
        for (int e = 0; e < 4; ++e) kd[e] = k2[e];
      }
      mp[mi[q]][kg] = fmaf(rr[q].x, kd[0], rr[q].y * kd[1]) +
                      fmaf(rr[q].z, kd[2], rr[q].w * kd[3]);
      kd[0] *= ww[q].x;
      kd[1] *= ww[q].y;
      kd[2] *= ww[q].z;
      kd[3] *= ww[q].w;
    }
  }
}

// M[t][s] (entry e = t C + s) = its partials summed over the key groups,
// 0 above the diagonal, as TF32 hi / lo.
__device__ __forceinline__ void m_entry(float (*mp)[MPS], int e,
                                        uint32_t (*mh)[MS],
                                        uint32_t (*ml)[MS]) {
  const int t = e / C, s = e % C;
  float m = 0.f;
  if (s <= t) {
#pragma unroll
    for (int gq = 0; gq < KG; gq += 4) {
      const float4 x = *reinterpret_cast<const float4*>(&mp[e][gq]);
      m += (x.x + x.y) + (x.z + x.w);
    }
  }
  split_tf32(m, mh[t][s], ml[t][s]);
}

// Producer thread pt's share of the copies of the step tile at token t0
// (zero past te) into stage buf of the ring.
template <typename T>
__device__ __forceinline__ void load_step(ChunkSmem<T>& sm, const T* r,
                                          const T* k, const T* v,
                                          const float* w, size_t base,
                                          size_t row, int t0, int te,
                                          int buf, int pt) {
  constexpr int PE = 16 / sizeof(T);  // elements of T a 16-byte copy
  const int n = min(C, te - t0);
  for (int c = pt; c < C * (P / PE); c += PT) {
    const int t = c / (P / PE), e = (c % (P / PE)) * PE;
    const bool ok = t < n;
    const size_t o = base + (size_t)(ok ? t0 + t : 0) * row + e;
    mma::cp_async16(&sm.r[buf][t][e], r + o, ok);
    mma::cp_async16(&sm.k[buf][t][e], k + o, ok);
    mma::cp_async16(&sm.v[buf][t][e], v + o, ok);
  }
  for (int c = pt; c < C * (P / 4); c += PT) {
    const int t = c / (P / 4), e = (c % (P / 4)) * 4;
    const bool ok = t < n;
    mma::cp_async16(&sm.w[buf][t][e],
                    w + base + (size_t)(ok ? t0 + t : 0) * row + e, ok);
  }
}

// The ring's first NS - 1 tiles of the pass over [tb, te), one commit
// group each (empty past the pass's steps).
template <typename T>
__device__ __forceinline__ void prime(ChunkSmem<T>& sm, const T* r,
                                      const T* k, const T* v,
                                      const float* w, size_t base,
                                      size_t row, int tb, int te, int pt) {
  const int nsteps = (te - tb + C - 1) / C;
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < nsteps)
      load_step<T>(sm, r, k, v, w, base, row, tb + i * C, te, i, pt);
    mma::cp_async_commit();
  }
}

// The segment pass of block (head h, row b, segment seg), before the
// grid barrier.  Unless it is the last segment: the segment's summary,
// its own contribution to the state at its end, from a zero state,
// sum_s (k_s * D_s) v_s^T with D_s the product of w after s to the
// segment's end, and its decay (the product of all its w), written to
// scr[seg + 1] and ascr[seg].  The last segment, which has no summary,
// copies the incoming state to scr[0] (it replaces the state at its
// end).  The segment goes in blocks of SB tokens from its end
// backwards, carrying the decay of the blocks after it, so every factor
// is a product of w, at most 1; each warp owns 16 values x 32 keys of the
// result as mma accumulators.
template <typename T>
__device__ __forceinline__ void seg_pass(
    const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* state,
    float* __restrict__ scr, float* __restrict__ ascr, int B, int S, int H,
    int nseg, int seglen, SegSmem<T>& sm) {
  constexpr bool kExactV = std::is_same<T, bf16>::value;
  constexpr int SBQ = SB / 4;  // tokens a quarter: one thread's chain
  const int tid = threadIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / nseg, seg = blockIdx.z % nseg;
  const size_t slice = ((size_t)b * H + h) * P * P;
  if (seg == nseg - 1) {
    for (int c = tid; c < P * P / 4; c += CH_THREADS)
      reinterpret_cast<float4*>(scr + slice)[c] =
          reinterpret_cast<const float4*>(state + slice)[c];
    return;
  }
  const int tb = seg * seglen, te = min(S, tb + seglen);
  const size_t row = (size_t)H * P;
  const size_t base = (size_t)b * S * row + (size_t)h * P;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int vc = 16 * (warp & 3) + g, kc = 32 * (warp >> 2) + g;
  const size_t slot = (size_t)B * H * P * P;
  // S^T accumulators of this warp's tile: acc[nt] = (value vc | + 8) x
  // (key kc - g + 8 nt + 2 t4, + 1), at (key, value) offset off(nt, e)
  auto off = [&](int nt, int e) {
    return (size_t)(kc - g + 8 * nt + 2 * t4 + (e & 1)) * P + vc +
           (e >> 1) * 8;
  };
  float acc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  for (int i = tid; i < P; i += CH_THREADS) sm.carry[i] = 1.f;
  constexpr int PE = 16 / sizeof(T);
  for (int t0 = tb + ((te - tb - 1) / SB) * SB; t0 >= tb; t0 -= SB) {
    const int n = min(SB, te - t0);
    for (int c = tid; c < SB * (P / PE); c += CH_THREADS) {
      const int t = c / (P / PE), e = (c % (P / PE)) * PE;
      const bool ok = t < n;
      const size_t o = base + (size_t)(ok ? t0 + t : 0) * row + e;
      mma::cp_async16(&sm.k[t][e], k + o, ok);
      mma::cp_async16(&sm.v[t][e], v + o, ok);
    }
    for (int c = tid; c < SB * (P / 4); c += CH_THREADS) {
      const int t = c / (P / 4), e = (c % (P / 4)) * 4;
      const bool ok = t < n;
      mma::cp_async16(&sm.w[t][e],
                      w + base + (size_t)(ok ? t0 + t : 0) * row + e, ok);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
    __syncthreads();  // this block's copies have landed
    {
      // thread (key i, quarter qq): k_t times the decay to its quarter's
      // end, kept in kh as fp32 bits, and the quarter's decay
      const int i = tid % P, qq = tid / P;
      {
        float wv[SBQ], x[SBQ];
#pragma unroll
        for (int a = 0; a < SBQ; ++a) {
          const int t = qq * SBQ + a;
          wv[a] = t < n ? sm.w[t][i] : 1.f;
          x[a] = to_f(sm.k[t][i]);
        }
        float d = 1.f;
#pragma unroll
        for (int a = SBQ - 1; a >= 0; --a) {
          x[a] *= d;
          d *= wv[a];
        }
#pragma unroll
        for (int a = 0; a < SBQ; ++a)
          sm.kh[qq * SBQ + a][i] = __float_as_uint(x[a]);
        sm.qd[qq][i] = d;
      }
      __syncthreads();
      // times the decay of the later quarters and blocks, as TF32 hi / lo
      float later = sm.carry[i];
#pragma unroll
      for (int q2 = 3; q2 > 0; --q2)
        if (q2 > qq) later *= sm.qd[q2][i];
#pragma unroll
      for (int a = 0; a < SBQ; ++a) {
        const int t = qq * SBQ + a;
        split_tf32(__uint_as_float(sm.kh[t][i]) * later, sm.kh[t][i],
                   sm.kl[t][i]);
      }
      __syncthreads();
      if (tid < P)
        sm.carry[tid] *= (sm.qd[0][tid] * sm.qd[1][tid]) *
                         (sm.qd[2][tid] * sm.qd[3][tid]);
      // S^T += v^T k~ over the block's tokens
#pragma unroll 2
      for (int ks = 0; ks < SB / 8; ++ks) {
        const float a4[4] = {to_f(sm.v[8 * ks + t4][vc]),
                             to_f(sm.v[8 * ks + t4][vc + 8]),
                             to_f(sm.v[8 * ks + t4 + 4][vc]),
                             to_f(sm.v[8 * ks + t4 + 4][vc + 8])};
        uint32_t vh[4], vl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (kExactV) {
            vh[e] = __float_as_uint(a4[e]);  // a bf16 is exact in TF32
            vl[e] = 0u;
          } else {
            split_tf32(a4[e], vh[e], vl[e]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const uint32_t bh0 = sm.kh[8 * ks + t4][kc + 8 * nt];
          const uint32_t bh1 = sm.kh[8 * ks + t4 + 4][kc + 8 * nt];
          const uint32_t bl0 = sm.kl[8 * ks + t4][kc + 8 * nt];
          const uint32_t bl1 = sm.kl[8 * ks + t4 + 4][kc + 8 * nt];
          mma::mma_tf32(acc[nt], vh, bh0, bh1);
          mma::mma_tf32(acc[nt], vh, bl0, bl1);
          if (!kExactV) mma::mma_tf32(acc[nt], vl, bh0, bh1);
        }
      }
      __syncthreads();  // k~ is consumed
    }
  }
  float* dst = scr + (seg + 1) * slot + slice;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[off(nt, e)] = acc[nt][e];
  for (int i = tid; i < P; i += CH_THREADS)
    ascr[((size_t)seg * B * H + (size_t)b * H + h) * P + i] = sm.carry[i];
}

// The outputs pass of block (head h, row b, segment seg): the segment's
// y from its incoming state, which is the state itself when there is one
// segment, else scr[0] carried over the segments before it (S <-
// diag(ascr[j]) S + scr[j + 1]); the last segment replaces the state in
// place.  Four producer warps prepare each step (decays, r~, k~, M) one
// step ahead of four consumer warps, each of which owns 16 value columns
// of the state and runs the step's products on the tensor cores.
// `primed`: the ring's first tiles are in flight.
template <typename T>
__device__ __forceinline__ void chunk_pass(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, float* state, float* __restrict__ y,
    const float* __restrict__ scr, const float* __restrict__ ascr, int B,
    int S, int H, int nseg, int seglen, bool primed, ChunkSmem<T>& sm) {
  constexpr bool kExactV = std::is_same<T, bf16>::value;
  const int tid = threadIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / nseg, seg = blockIdx.z % nseg;
  const int tb = seg * seglen, te = min(S, tb + seglen);
  const int nsteps = (te - tb + C - 1) / C;
  const size_t row = (size_t)H * P;  // elements per token
  const size_t base = (size_t)b * S * row + (size_t)h * P;
  for (int i = tid; i < P; i += CH_THREADS) sm.u[i] = u[h * P + i];
  __syncthreads();

  if (tid >= CT) {
    // ---------------------------- producers ---------------------------
    const int pt = tid - CT;
    constexpr int PE = 16 / sizeof(T);  // elements of T a 16-byte copy
    if (!primed) prime<T>(sm, r, k, v, w, base, row, tb, te, pt);
    const int i = pt & (P - 1);       // (a): key i, forward or backward
    const bool pre = pt < P;
    for (int j = 0; j < nsteps; ++j) {
      const int p = j & 1, buf = j % NS, n = min(C, te - (tb + j * C));
      mma::cp_async_wait<NS - 2>();
      bar_sync(BAR_PROD, PT);  // step j's tile has landed; j-1's is read
      if (j + NS - 1 < nsteps)
        load_step<T>(sm, r, k, v, w, base, row, tb + (j + NS - 1) * C, te,
                     (j + NS - 1) % NS, pt);
      mma::cp_async_commit();
      if (j >= 2) bar_sync(BAR_EMPTY + p, CH_THREADS);  // j-2 consumed
      auto& sp = sm.step[p];
      const T(&rt)[C][P] = sm.r[buf];
      const T(&kt)[C][P] = sm.k[buf];
      const float(&wt)[C][P] = sm.w[buf];

      // (a) the step's decay A_C; r~_t = r_t A_t and k~_s = k_s B_s, by
      // running products of w (w = 1 past the valid tokens), split into
      // TF32 hi / lo.  Loads first, then the products, then the stores.
      {
        float wv[C], x[C];
#pragma unroll
        for (int t = 0; t < C; ++t) {
          wv[t] = t < n ? wt[t][i] : 1.f;
          x[t] = to_f(pre ? rt[t][i] : kt[t][i]);
        }
        float a = 1.f;
        if (pre) {
#pragma unroll
          for (int t = 0; t < C; ++t) {
            x[t] *= a;
            a *= wv[t];
          }
          sp.ac[i] = a;
        } else {
#pragma unroll
          for (int t = C - 1; t >= 0; --t) {
            x[t] *= a;
            a *= wv[t];
          }
        }
        uint32_t* dh = pre ? &sp.rh[0][i] : &sp.kh[0][i];
        uint32_t* dl = pre ? &sp.rl[0][i] : &sp.kl[0][i];
#pragma unroll
        for (int t = 0; t < C; ++t) split_tf32(x[t], dh[t * RS], dl[t * RS]);
      }
      // v for the consumers, into the padded rows of the prepared step
      for (int c = pt; c < C * (P / PE); c += PT) {
        const int t = c / (P / PE), e = (c % (P / PE)) * PE;
        *reinterpret_cast<uint4*>(&sp.v[t][e]) =
            *reinterpret_cast<const uint4*>(&sm.v[buf][t][e]);
      }
      // (b) M's partials; (c) M
      m_partials<T>(rt, kt, wt, sm.u, sm.mp, pt);
      bar_sync(BAR_PROD, PT);
      for (int e = pt; e < C * C; e += PT) m_entry(sm.mp, e, sp.mh, sp.ml);
      bar_arrive(BAR_FULL + p, CH_THREADS);
    }
    mma::cp_async_wait<0>();
    return;
  }

  // ----------------------------- consumers ----------------------------
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int vw = 16 * warp;  // this warp's value columns
  const size_t slice = ((size_t)b * H + h) * P * P + vw;
  const size_t slot = (size_t)B * H * P * P;  // floats a scratch state
  // the state slice [key][value] of this warp as accumulators of S^T
  // (rows = values, columns = keys): st[nt] = (value g | g + 8) x (key
  // 8 nt + 2 t4, + 1); at (key, value) offset off(nt, e) in a state
  auto off = [&](int nt, int e) {
    return (size_t)(8 * nt + 2 * t4 + (e & 1)) * P + g + (e >> 1) * 8;
  };
  float st[P / 8][4];
#pragma unroll
  for (int nt = 0; nt < P / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      st[nt][e] = nseg == 1 ? state[slice + off(nt, e)]
                            : __ldcg(scr + slice + off(nt, e));
#pragma unroll 4
  for (int j = 0; j < seg; ++j) {
    const float* aj = ascr + ((size_t)j * B * H + (size_t)b * H + h) * P;
    const float* sj = scr + (j + 1) * slot + slice;
#pragma unroll
    for (int nt = 0; nt < P / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[nt][e] = fmaf(__ldcg(aj + 8 * nt + 2 * t4 + (e & 1)), st[nt][e],
                         __ldcg(sj + off(nt, e)));
  }

  for (int j = 0; j < nsteps; ++j) {
    const int p = j & 1, c0 = tb + j * C, n = min(C, te - c0);
    bar_sync(BAR_FULL + p, CH_THREADS);  // step j is prepared
    const auto& sp = sm.step[p];
    // (d) this warp's values: y^T = S^T (r~)^T + v^T M^T, then
    // S^T <- S^T diag(A_C) + v^T k~.  v^T is the A operand (rows =
    // values, k = tokens) of both of its products.
    uint32_t vh[2][4], vl[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const float a[4] = {to_f(sp.v[8 * ks + t4][vw + g]),
                          to_f(sp.v[8 * ks + t4][vw + g + 8]),
                          to_f(sp.v[8 * ks + t4 + 4][vw + g]),
                          to_f(sp.v[8 * ks + t4 + 4][vw + g + 8])};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (kExactV) {
          vh[ks][e] = __float_as_uint(a[e]);  // a bf16 is exact in TF32
          vl[ks][e] = 0u;
        } else {
          split_tf32(a[e], vh[ks][e], vl[ks][e]);
        }
      }
    }
    // hi.hi and the two cross terms of 3xTF32 in separate accumulators
    float yp[2][2][4];
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2)
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) yp[n2][a][e] = 0.f;
#pragma unroll
    for (int nt = 0; nt < P / 8; ++nt) {
      // S^T as A with k renamed: k t4 -> key 8 nt + 2 t4, k t4 + 4 ->
      // key 8 nt + 2 t4 + 1; so B takes r~ at those two keys
      uint32_t ah[4], al[4];
      split_tf32(st[nt][0], ah[0], al[0]);
      split_tf32(st[nt][2], ah[1], al[1]);
      split_tf32(st[nt][1], ah[2], al[2]);
      split_tf32(st[nt][3], ah[3], al[3]);
#pragma unroll
      for (int n2 = 0; n2 < 2; ++n2) {
        const uint2 bh = *reinterpret_cast<const uint2*>(
            &sp.rh[8 * n2 + g][8 * nt + 2 * t4]);
        const uint2 bl = *reinterpret_cast<const uint2*>(
            &sp.rl[8 * n2 + g][8 * nt + 2 * t4]);
        mma::mma_tf32(yp[n2][0], ah, bh.x, bh.y);
        mma::mma_tf32(yp[n2][1], ah, bl.x, bl.y);
        mma::mma_tf32(yp[n2][1], al, bh.x, bh.y);
      }
    }
    // y^T += v^T M^T over the lower triangle's three 8 x 8 tile pairs
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2)
#pragma unroll
      for (int ks = 0; ks <= n2; ++ks) {
        const uint32_t bh0 = sp.mh[8 * n2 + g][8 * ks + t4];
        const uint32_t bh1 = sp.mh[8 * n2 + g][8 * ks + t4 + 4];
        const uint32_t bl0 = sp.ml[8 * n2 + g][8 * ks + t4];
        const uint32_t bl1 = sp.ml[8 * n2 + g][8 * ks + t4 + 4];
        mma::mma_tf32(yp[n2][0], vh[ks], bh0, bh1);
        mma::mma_tf32(yp[n2][1], vh[ks], bl0, bl1);
        if (!kExactV) mma::mma_tf32(yp[n2][1], vl[ks], bh0, bh1);
      }
    // y rows: tokens 8 n2 + 2 t4 (+ 1), values g (+ 8)
    float* yb = y + base + vw + g;
#pragma unroll
    for (int n2 = 0; n2 < 2; ++n2)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 8 * n2 + 2 * t4 + (e & 1);
        if (t < n)
          yb[(size_t)(c0 + t) * row + (e >> 1) * 8] =
              yp[n2][0][e] + yp[n2][1][e];
      }
    // the update
#pragma unroll
    for (int nt = 0; nt < P / 8; ++nt) {
      const float a0 = sp.ac[8 * nt + 2 * t4];
      const float a1 = sp.ac[8 * nt + 2 * t4 + 1];
      st[nt][0] *= a0;
      st[nt][1] *= a1;
      st[nt][2] *= a0;
      st[nt][3] *= a1;
    }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int nt = 0; nt < P / 8; ++nt) {
        const uint32_t bh0 = sp.kh[8 * ks + t4][8 * nt + g];
        const uint32_t bh1 = sp.kh[8 * ks + t4 + 4][8 * nt + g];
        const uint32_t bl0 = sp.kl[8 * ks + t4][8 * nt + g];
        const uint32_t bl1 = sp.kl[8 * ks + t4 + 4][8 * nt + g];
        mma::mma_tf32(st[nt], vh[ks], bh0, bh1);
        mma::mma_tf32(st[nt], vh[ks], bl0, bl1);
        if (!kExactV) mma::mma_tf32(st[nt], vl[ks], bh0, bh1);
      }
    if (j + 2 < nsteps) bar_arrive(BAR_EMPTY + p, CH_THREADS);
  }
  if (seg == nseg - 1) {
#pragma unroll
    for (int nt = 0; nt < P / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) state[slice + off(nt, e)] = st[nt][e];
  }
}

// A barrier of every block of a launch whose blocks are all resident
// (a cooperative launch), by thread 0 of each: bar[0] counts arrivals and
// the last block resets it to 0 and advances the generation bar[1], for
// which the others wait; so the buffer is ready for the next call.  A
// wait of more than about a second traps (a launch error) rather than
// hang the card.
__device__ __forceinline__ void grid_barrier(unsigned* bar,
                                             unsigned nblocks) {
  volatile unsigned* gen = bar + 1;
  const unsigned g0 = *gen;
  __threadfence();
  if (atomicAdd(bar, 1u) == nblocks - 1) {
    atomicExch(bar, 0u);
    __threadfence();
    atomicAdd(bar + 1, 1u);
  } else {
    for (unsigned spin = 0; *gen == g0; ++spin) {
      if (spin == (1u << 24)) __trap();
      __nanosleep(64);
    }
  }
  __threadfence();
}

// One (head, row, segment) a block.  With one segment, the outputs pass
// from the state.  With more: the segment pass (the summaries), the
// outputs pass's first tiles put in flight, a grid barrier, then the
// outputs pass.
template <typename T>
__global__ void __launch_bounds__(CH_THREADS, 2)
    wkv_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u, float* state,
                     float* __restrict__ y, float* __restrict__ scr,
                     float* __restrict__ ascr, unsigned* gbar, int B,
                     int S, int H, int nseg, int seglen) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSmem<T>& sm = *reinterpret_cast<ChunkSmem<T>*>(smem_raw);
  if (nseg > 1) {
    seg_pass<T>(k, v, w, state, scr, ascr, B, S, H, nseg, seglen,
                *reinterpret_cast<SegSmem<T>*>(smem_raw));
    __threadfence();  // this block's summary, before the barrier
    __syncthreads();
    // the outputs pass's first tiles, in flight across the barrier
    if (threadIdx.x >= CT) {
      const int b = blockIdx.z / nseg, seg = blockIdx.z % nseg;
      const size_t row = (size_t)H * P;
      prime<T>(sm, r, k, v, w, (size_t)b * S * row + (size_t)blockIdx.y * P,
               row, seg * seglen, min(S, (seg + 1) * seglen),
               threadIdx.x - CT);
    }
    if (threadIdx.x == 0)
      grid_barrier(gbar, gridDim.x * gridDim.y * gridDim.z);
    __syncthreads();
  }
  chunk_pass<T>(r, k, v, w, u, state, y, scr, ascr, B, S, H, nseg, seglen,
                nseg > 1, sm);
}

template <typename T>
cudaError_t launch(int path, int nseg, int seglen, const void* r,
                   const void* k, const void* v, const void* w,
                   const void* u, void* state, void* y, void* scr,
                   void* ascr, void* gbar, int B, int S, int H,
                   cudaStream_t stream) {
  const T* r_ = static_cast<const T*>(r);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const float* w_ = static_cast<const float*>(w);
  const float* u_ = static_cast<const float*>(u);
  float* s_ = static_cast<float*>(state);
  float* y_ = static_cast<float*>(y);
  float* scr_ = static_cast<float*>(scr);
  float* ascr_ = static_cast<float*>(ascr);
  unsigned* gbar_ = static_cast<unsigned*>(gbar);
  if (path == 0) {
    wkv_rec_kernel<T><<<dim3(P / RV, H, B), REC_THREADS, 0, stream>>>(
        r_, k_, v_, w_, u_, s_, y_, S, H);
    return cudaGetLastError();
  }
  constexpr size_t smem = chunk_smem<T>();
  const cudaError_t err = mma::opt_in<wkv_chunk_kernel<T>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(1, H, B * nseg);
  if (nseg == 1) {
    wkv_chunk_kernel<T><<<grid, CH_THREADS, smem, stream>>>(
        r_, k_, v_, w_, u_, s_, y_, scr_, ascr_, gbar_, B, S, H, nseg,
        seglen);
    return cudaGetLastError();
  }
  // every block resident, for the grid barrier
  void* args[] = {&r_, &k_, &v_, &w_, &u_, &s_, &y_, &scr_, &ascr_,
                  &gbar_, &B, &S, &H, &nseg, &seglen};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&wkv_chunk_kernel<T>), grid,
      dim3(CH_THREADS), args, smem, stream);
}

template <typename T>
int chunk_blocks_per_sm() {
  constexpr size_t smem = chunk_smem<T>();
  if (mma::opt_in<wkv_chunk_kernel<T>>(smem) != cudaSuccess) return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, wkv_chunk_kernel<T>, CH_THREADS, smem) != cudaSuccess)
    return 0;
  return n;
}

}  // namespace

// dtype (of r, k, v): 0 = float32, 1 = bfloat16; head size 64.
// path 0: the parallel recurrence.  path 1: the chunked form over nseg
// segments of seglen tokens (a multiple of 16; nseg = ceil(S / seglen));
// with nseg > 1, scr holds nseg states (nseg, B, H, 64, 64) and ascr
// nseg decays (nseg, B, H, 64), fp32 scratch, gbar two uint32 that are
// zero before the first call (the launch leaves them ready for the
// next), and B H nseg blocks must be resident at once (see
// wkv_chunk_blocks_per_sm).  w, u, state and y are float32; every tensor
// is contiguous and 16-byte aligned; state is read and replaced in
// place.  Returns the cudaError_t of the launch.
extern "C" int wkv(int dtype, int path, int nseg, int seglen, const void* r,
                   const void* k, const void* v, const void* w,
                   const void* u, void* state, void* y, void* scr,
                   void* ascr, void* gbar, int B, int S, int H,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1 || (path != 0 && path != 1))
    return (int)cudaErrorInvalidValue;
  if (path == 1 &&
      (nseg < 1 || seglen < 1 || seglen % C != 0 ||
       (S + seglen - 1) / seglen != nseg ||
       (nseg > 1 && (scr == nullptr || ascr == nullptr || gbar == nullptr))))
    return (int)cudaErrorInvalidValue;
  for (const void* p : {r, k, v, w, u, (const void*)state, (const void*)y})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(path, nseg, seglen, r, k, v, w, u, state, y, scr,
                         ascr, gbar, B, S, H, s);
  if (dtype == 1)
    return launch<bf16>(path, nseg, seglen, r, k, v, w, u, state, y, scr,
                        ascr, gbar, B, S, H, s);
  return (int)cudaErrorInvalidValue;
}

// Blocks of the chunked path's kernel that one SM holds at once, for
// r, k, v of the given dtype (0 on error).
extern "C" int wkv_chunk_blocks_per_sm(int dtype) {
  return dtype == 0 ? chunk_blocks_per_sm<float>()
                    : chunk_blocks_per_sm<bf16>();
}

extern "C" const char* wkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
