/*
 * K5: the Mamba2 SSD chunked scan with an incoming state, for Hopper
 * (sm_90a).  Built by kernel.py with nvcc into a shared library with a
 * plain C interface.
 *
 * Replaces: src/repro/kernels/mamba2_ssd/kernel.py, ssd_chunk_scan
 *   (pl.pallas_call of _ssd_kernel), and computes what the model calls,
 *   _ssd_chunk_scan (src/repro/models/ssm.py) INCLUDING its incoming
 *   state h0 (the Pallas kernel starts from zeros).  Per (batch row,
 *   head), over chunks of Q = 128 tokens with cum the in-chunk prefix sum
 *   of a_log:
 *     y_t = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) x_s
 *           + exp(cum_t) C_t . h
 *     h  <- exp(cum_{Q-1}) h + sum_s exp(cum_{Q-1} - cum_s) B_s x_s^T
 *
 * What bounds it on the card: at zamba2-7b's prefill (B 4, S 512, H 112,
 * P = N = 64) it moves about 134 MB (x and y in fp32, the state in and
 * out, B, C and a_log), and the recurrence it computes needs 4 N P FLOPs
 * per token and head (3.8 GFLOP, fp32): about 0.040 ms of bytes against
 * 0.056 ms of fp32 FMA on the CUDA cores, but 0.008 ms on the TF32 tensor
 * cores (0.023 ms as 3xTF32, which keeps fp32 accuracy), so the bytes
 * bound it.  The chunked form does about twice those FLOPs in exchange
 * for parallel, matmul-shaped work inside a chunk.
 *
 * What the design does about it (B and C in bf16, the model's path):
 *  - tensor cores with fp32 accuracy: C.B^T on bf16 mma.sync (products of
 *    bf16 are exact in fp32); the products with an fp32 operand on TF32
 *    mma.sync m16n8k8, that operand split as hi + lo: W.x as 3xTF32
 *    (hi.hi + hi.lo + lo.hi), and C.h and B^T (dec x) as two products,
 *    since a bf16 value is exact in TF32 (the decay is folded into x, not
 *    B).  Plain TF32 keeps about 3 decimal digits, too few for the 1e-4
 *    the scan is held to;
 *  - one block of four warps per (head, batch row), chunks in sequence;
 *    the N x P state stays in shared memory from the first chunk to the
 *    last and is read from and written to device memory once (in place: a
 *    block reads all of its state before it writes any);
 *  - warp w takes the 16-row strips w and 7 - w of a chunk, so the causal
 *    triangle is shared evenly; it builds C.B^T 16 tokens at a time up to
 *    the diagonal (the upper triangle is skipped), applies the decay mask
 *    on the accumulator fragments (a select: for s > t exp(cum_t - cum_s)
 *    may be inf; __expf, whose error is far below the cum sums' own), and
 *    feeds them straight back as the A operand of W.x.  Then each warp
 *    updates 16 rows of the state.  Working a tile pair at a time keeps
 *    the block at about 150 registers a thread;
 *  - the chunk's B, C, x and a_log arrive by 16-byte cp.async copies; 89
 *    KB of shared memory a block puts two blocks on an SM, so one block's
 *    copies run behind the other's products (a second buffer per block
 *    measured slower: it leaves one block an SM).  Shared-memory rows are
 *    padded so that fragment loads are free of bank conflicts;
 *  - any S >= 1: the ragged last chunk is zero-filled (x = B = C = 0,
 *    a_log = 0, so its decay is 1 and it adds nothing), which makes the
 *    final state that of the unpadded recurrence, and its y rows past S
 *    are not written;
 *  - B and C are read by stride in the model's layout (token rows of the
 *    conv output); x, a_log, h and y are fp32, as in the model.
 * B and C in fp32 (the tight check) take an FMA kernel: one block of 256
 * threads per (head, row), register-tiled FMA over padded shared-memory
 * rows.
 */
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/mma.cuh"

namespace {

constexpr int Q = 128;        // chunk length (the model's)
constexpr int N = 64;         // state size
constexpr int P = 64;         // head dim
constexpr unsigned FULL = 0xffffffffu;
using bf16 = __nv_bfloat16;

// Inclusive prefix sum of a chunk's Q = 128 log decays, src -> dst (may
// be the same array), by the 32 lanes of one warp: lane l holds tokens
// 4l .. 4l+3.
__device__ __forceinline__ void chunk_prefix_sum(const float* src,
                                                 float* dst, int lane) {
  const float v0 = src[4 * lane];
  const float v1 = v0 + src[4 * lane + 1];
  const float v2 = v1 + src[4 * lane + 2];
  const float v3 = v2 + src[4 * lane + 3];
  float incl = v3;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += o;
  }
  float excl = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) excl = 0.f;
  dst[4 * lane] = excl + v0;
  dst[4 * lane + 1] = excl + v1;
  dst[4 * lane + 2] = excl + v2;
  dst[4 * lane + 3] = excl + v3;
}

// ------------------------------------------------------------------ //
// fp32 B and C: FMA
// ------------------------------------------------------------------ //
constexpr int FMA_THREADS = 256;
constexpr int NP = N + 1;     // padded B/C row (floats)
constexpr int QP = Q + 1;     // padded W row (floats)

constexpr size_t fma_smem_floats() {
  return 2 * Q * NP   // C, B
         + Q * P      // x
         + Q * QP     // W = (C B^T) * decay mask
         + N * P      // h
         + 3 * Q;     // cum, exp(cum), exp(cum_last - cum)
}

// xh, y: (B, S, H, P) fp32; Bm, Cm: rows of N at Bm[b * sb + t * ss + n];
// a_log: (B, S, H) fp32; h: (B, H, N, P) fp32, read and replaced.
__global__ void __launch_bounds__(FMA_THREADS, 1)
    ssd_fma_kernel(const float* __restrict__ xh,
                   const float* __restrict__ Bm,
                   const float* __restrict__ Cm,
                   const float* __restrict__ a_log, float* h,
                   float* __restrict__ y, int S, int H, long long sb,
                   long long ss) {
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;            // Q x NP
  float* Bs = Cs + Q * NP;     // Q x NP
  float* Xs = Bs + Q * NP;     // Q x P
  float* Ws = Xs + Q * P;      // Q x QP
  float* hs = Ws + Q * QP;     // N x P
  float* cum = hs + N * P;     // Q: in-chunk prefix sum of a_log
  float* ecum = cum + Q;       // Q: exp(cum_t)
  float* dec = ecum + Q;       // Q: exp(cum_{Q-1} - cum_s)

  const int hd = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const size_t xrow = (size_t)H * P;  // elements per token of x and y
  const float* xb = xh + (size_t)b * S * xrow + (size_t)hd * P;
  float* yb = y + (size_t)b * S * xrow + (size_t)hd * P;
  const float* Bb = Bm + b * sb;
  const float* Cb = Cm + b * sb;
  const float* ab = a_log + (size_t)b * S * H + hd;
  float* hg = h + ((size_t)b * H + hd) * N * P;

  for (int i = tid; i < N * P; i += FMA_THREADS) hs[i] = hg[i];

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int n = min(Q, S - c0);  // valid tokens in this chunk
    __syncthreads();               // the previous chunk is consumed
    for (int i = tid; i < Q * N; i += FMA_THREADS) {
      const int t = i / N, m = i % N;
      float bv = 0.f, cv = 0.f;
      if (t < n) {
        const long long off = (long long)(c0 + t) * ss + m;
        bv = Bb[off];
        cv = Cb[off];
      }
      Bs[t * NP + m] = bv;
      Cs[t * NP + m] = cv;
    }
    for (int i = tid; i < Q * P; i += FMA_THREADS) {
      const int t = i / P, p = i % P;
      Xs[i] = t < n ? xb[(size_t)(c0 + t) * xrow + p] : 0.f;
    }
    if (tid < Q) cum[tid] = tid < n ? ab[(size_t)(c0 + tid) * H] : 0.f;
    __syncthreads();

    if (tid < 32) chunk_prefix_sum(cum, cum, tid);
    __syncthreads();
    if (tid < Q) {
      ecum[tid] = expf(cum[tid]);
      dec[tid] = expf(cum[Q - 1] - cum[tid]);
    }

    // W[t][s] = (C_t . B_s) exp(cum_t - cum_s) for s <= t, else 0
    {
      const int ty = tid / 16, tx = tid % 16;  // rows ty+16i, cols tx+16j
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int m = 0; m < N; ++m) {
        float cr[8], br[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) cr[i] = Cs[(ty + 16 * i) * NP + m];
#pragma unroll
        for (int j = 0; j < 8; ++j) br[j] = Bs[(tx + 16 * j) * NP + m];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(cr[i], br[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int s = tx + 16 * j;
          Ws[t * QP + s] = s <= t ? acc[i][j] * expf(cum[t] - cum[s]) : 0.f;
        }
      }
    }
    __syncthreads();

    // y_t = sum_s W[t][s] x_s + exp(cum_t) C_t . h
    {
      const int ty = tid / 8, tx = tid % 8;  // rows ty+32i, cols tx+8j
      float acc[4][8], hacc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = hacc[i][j] = 0.f;
      for (int s = 0; s < n; ++s) {
        float wr[4], xr[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) wr[i] = Ws[(ty + 32 * i) * QP + s];
#pragma unroll
        for (int j = 0; j < 8; ++j) xr[j] = Xs[s * P + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(wr[i], xr[j], acc[i][j]);
      }
#pragma unroll 4
      for (int m = 0; m < N; ++m) {
        float cr[4], hr[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) cr[i] = Cs[(ty + 32 * i) * NP + m];
#pragma unroll
        for (int j = 0; j < 8; ++j) hr[j] = hs[m * P + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) hacc[i][j] = fmaf(cr[i], hr[j], hacc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 32 * i;
        if (t < n) {
          float* yr = yb + (size_t)(c0 + t) * xrow;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            yr[tx + 8 * j] = acc[i][j] + ecum[t] * hacc[i][j];
        }
      }
    }

    // h <- exp(cum_{Q-1}) h + sum_s exp(cum_{Q-1} - cum_s) B_s x_s^T
    {
      const int ty = tid / 16, tx = tid % 16;  // n = ty+16i, p = tx+16j
      float st[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = 0.f;
      for (int s = 0; s < n; ++s) {
        const float d = dec[s];
        float br[4], xr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) br[i] = Bs[s * NP + ty + 16 * i] * d;
#pragma unroll
        for (int j = 0; j < 4; ++j) xr[j] = Xs[s * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) st[i][j] = fmaf(br[i], xr[j], st[i][j]);
      }
      const float e_last = ecum[Q - 1];
      __syncthreads();  // every y above has read h
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* hp = hs + (ty + 16 * i) * P + tx + 16 * j;
          *hp = e_last * *hp + st[i][j];
        }
    }
  }
  __syncthreads();
  for (int i = tid; i < N * P; i += FMA_THREADS) hg[i] = hs[i];
}


// ------------------------------------------------------------------ //
// bf16 B and C: tensor cores
// ------------------------------------------------------------------ //
constexpr int MMA_THREADS = 128;  // four warps
constexpr int CP = N + 8;         // padded B/C row (bf16): 144 bytes
constexpr int XP = P + 4;         // padded x and h row (floats)
constexpr int NT = P / 8;         // n-tiles of 8 columns of P
static_assert(MMA_THREADS == Q, "one a_log, exp(cum) and decay per thread");
// C and B (bf16), x and a_log (fp32) of one chunk; then h, cum, exp(cum)
// and exp(cum_last - cum)
constexpr size_t MMA_SMEM = sizeof(bf16) * 2 * Q * CP +
                            sizeof(float) * (Q * XP + Q + N * XP + 3 * Q);

// As ssd_fma_kernel, for bf16 B and C whose rows are 16-byte aligned.
// (128, 3): lets ptxas spend up to 170 registers a thread, which measured
// faster than its own choice of 96; shared memory allows 2 blocks an SM.
__global__ void __launch_bounds__(MMA_THREADS, 3)
    ssd_mma_kernel(const float* __restrict__ xh, const bf16* __restrict__ Bm,
                   const bf16* __restrict__ Cm,
                   const float* __restrict__ a_log, float* h,
                   float* __restrict__ y, int S, int H, long long sb,
                   long long ss) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw);  // Q x CP
  bf16* Bs = Cs + Q * CP;                        // Q x CP
  float* Xs = reinterpret_cast<float*>(Bs + Q * CP);  // Q x XP
  float* As = Xs + Q * XP;                       // Q: a_log
  float* hs = As + Q;                            // N x XP
  float* cum = hs + N * XP;
  float* ecum = cum + Q;
  float* dec = ecum + Q;

  const int hd = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t xrow = (size_t)H * P;  // elements per token of x and y
  const float* xb = xh + (size_t)b * S * xrow + (size_t)hd * P;
  float* yb = y + (size_t)b * S * xrow + (size_t)hd * P;
  const bf16* Bb = Bm + b * sb;
  const bf16* Cb = Cm + b * sb;
  const float* ab = a_log + (size_t)b * S * H + hd;
  float* hg = h + ((size_t)b * H + hd) * N * P;

  // the chunk at token c0, zero past S, by 16-byte cp.async copies
  auto load_chunk = [&](int c0) {
    const int n = min(Q, S - c0);
#pragma unroll 4
    for (int c = tid; c < Q * (N / 8); c += MMA_THREADS) {
      const int t = c / (N / 8), e = (c % (N / 8)) * 8;
      const bool ok = t < n;
      const long long off = (long long)(c0 + (ok ? t : 0)) * ss + e;
      mma::cp_async16(Cs + t * CP + e, Cb + off, ok);
      mma::cp_async16(Bs + t * CP + e, Bb + off, ok);
    }
#pragma unroll 4
    for (int c = tid; c < Q * (P / 4); c += MMA_THREADS) {
      const int t = c / (P / 4), e = (c % (P / 4)) * 4;
      const bool ok = t < n;
      mma::cp_async16(Xs + t * XP + e,
                      xb + (size_t)(c0 + (ok ? t : 0)) * xrow + e, ok);
    }
    const bool ok = tid < n;
    mma::cp_async4(As + tid, ab + (size_t)(c0 + (ok ? tid : 0)) * H, ok);
    mma::cp_async_commit();
  };

  const int nchunks = (S + Q - 1) / Q;
  load_chunk(0);
  for (int i = tid; i < N * (P / 4); i += MMA_THREADS) {
    const int r = i / (P / 4), e = (i % (P / 4)) * 4;
    *reinterpret_cast<float4*>(hs + r * XP + e) =
        *reinterpret_cast<const float4*>(hg + (size_t)r * P + e);
  }

  for (int ci = 0; ci < nchunks; ++ci) {
    const int c0 = ci * Q, n = min(Q, S - c0);
    mma::cp_async_wait<0>();
    __syncthreads();  // this chunk has landed; h is written
    if (warp == 0) chunk_prefix_sum(As, cum, lane);
    __syncthreads();
    ecum[tid] = expf(cum[tid]);
    dec[tid] = expf(cum[Q - 1] - cum[tid]);
    __syncthreads();

    // y for the strips of rows [16 si, 16 si + 16), si = warp and
    // 7 - warp: every warp gets 9 of the 36 tiles of the causal triangle
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const int si = half == 0 ? warp : 7 - warp;
      const int t0 = 16 * si;
      const int ta = t0 + g, tb = t0 + g + 8;  // this thread's two rows
      float acc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

      // exp(cum_t) C_t . h: C exact in TF32, h as hi + lo; k = state
      // index, renamed so that one 32-bit load gives a0 and a2
#pragma unroll 2
      for (int kk = 0; kk < N / 8; ++kk) {
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(
            Cs + ta * CP + 8 * kk + 2 * t4);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(
            Cs + tb * CP + 8 * kk + 2 * t4);
        const uint32_t a[4] = {w0 << 16, w1 << 16, w0 & 0xffff0000u,
                               w1 & 0xffff0000u};
        const float* h0 = hs + (8 * kk + 2 * t4) * XP + g;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t hh0, hl0, hh1, hl1;
          mma::split_tf32(h0[nt * 8], hh0, hl0);
          mma::split_tf32(h0[XP + nt * 8], hh1, hl1);
          mma::mma_tf32(acc[nt], a, hh0, hh1);
          mma::mma_tf32(acc[nt], a, hl0, hl1);
        }
      }
      const float ca = cum[ta], cb = cum[tb];
      {
        const float ea = ecum[ta], eb = ecum[tb];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          acc[nt][0] *= ea;
          acc[nt][1] *= ea;
          acc[nt][2] *= eb;
          acc[nt][3] *= eb;
        }
      }

      // C as the A operand of C B^T (bf16), for its four k-steps
      uint32_t cf[N / 16][4];
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        mma::ldmatrix_x4(cf[kk], Cs + (t0 + (lane & 15)) * CP + kk * 16 +
                                     (lane >> 4) * 8);
      // 16 tokens s = [16 jp, 16 jp + 16) at a time, up to the diagonal
      // (the upper triangle is skipped)
#pragma unroll 1
      for (int jp = 0; jp <= si; ++jp) {
        // C B^T on two 8-token tiles (bf16, exact products)
        float w[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) {
          uint32_t bf[4];  // (s 0-7 | 8-15) x (k 0-7 | 8-15)
          mma::ldmatrix_x4(bf, Bs + (16 * jp + (lane >> 4) * 8 +
                                     (lane & 7)) * CP +
                                   kk * 16 + ((lane >> 3) & 1) * 8);
          mma::mma_bf16(w[0], cf[kk], bf[0], bf[1]);
          mma::mma_bf16(w[1], cf[kk], bf[2], bf[3]);
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * jp + jj;
          // W = C B^T * exp(cum_t - cum_s) for s <= t, else 0 (a select:
          // for s > t the exponential may be inf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int s = 8 * j + 2 * t4 + e;
            const float cs = cum[s];
            w[jj][e] = s <= ta ? w[jj][e] * __expf(ca - cs) : 0.f;
            w[jj][2 + e] = s <= tb ? w[jj][2 + e] * __expf(cb - cs) : 0.f;
          }
          // y += W x as 3xTF32; the accumulator tile is A for s in
          // [8 j, 8 j + 8) with k renamed: column 2 t4 -> k t4,
          // 2 t4 + 1 -> k t4 + 4, so B takes x rows 8 j + 2 t4 and + 1
          uint32_t ah[4], al[4];
          mma::split_tf32(w[jj][0], ah[0], al[0]);
          mma::split_tf32(w[jj][2], ah[1], al[1]);
          mma::split_tf32(w[jj][1], ah[2], al[2]);
          mma::split_tf32(w[jj][3], ah[3], al[3]);
          const float* x0 = Xs + (8 * j + 2 * t4) * XP + g;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            uint32_t xh0, xl0, xh1, xl1;
            mma::split_tf32(x0[nt * 8], xh0, xl0);
            mma::split_tf32(x0[XP + nt * 8], xh1, xl1);
            mma::mma_tf32(acc[nt], ah, xh0, xh1);
            mma::mma_tf32(acc[nt], ah, xl0, xl1);
            mma::mma_tf32(acc[nt], al, xh0, xh1);
          }
        }
      }

#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = nt * 8 + 2 * t4;
        if (ta < n)
          *reinterpret_cast<float2*>(yb + (size_t)(c0 + ta) * xrow + col) =
              make_float2(acc[nt][0], acc[nt][1]);
        if (tb < n)
          *reinterpret_cast<float2*>(yb + (size_t)(c0 + tb) * xrow + col) =
              make_float2(acc[nt][2], acc[nt][3]);
      }
    }

    // h <- exp(cum_{Q-1}) h + B^T (dec x): warp w updates state rows
    // [16 w, 16 w + 16); B exact in TF32, dec x as hi + lo
    {
      const int n0 = 16 * warp;
      const float el = ecum[Q - 1];
      float hacc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = nt * 8 + 2 * t4;
        hacc[nt][0] = el * hs[(n0 + g) * XP + col];
        hacc[nt][1] = el * hs[(n0 + g) * XP + col + 1];
        hacc[nt][2] = el * hs[(n0 + g + 8) * XP + col];
        hacc[nt][3] = el * hs[(n0 + g + 8) * XP + col + 1];
      }
#pragma unroll 2
      for (int kk = 0; kk < Q / 8; ++kk) {
        const int s = 8 * kk + 2 * t4;
        const uint32_t a[4] = {mma::bf16_as_tf32(Bs[s * CP + n0 + g]),
                               mma::bf16_as_tf32(Bs[s * CP + n0 + g + 8]),
                               mma::bf16_as_tf32(Bs[(s + 1) * CP + n0 + g]),
                               mma::bf16_as_tf32(Bs[(s + 1) * CP + n0 + g + 8])};
        const float d0 = dec[s], d1 = dec[s + 1];
        const float* x0 = Xs + s * XP + g;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t bh0, bl0, bh1, bl1;
          mma::split_tf32(d0 * x0[nt * 8], bh0, bl0);
          mma::split_tf32(d1 * x0[XP + nt * 8], bh1, bl1);
          mma::mma_tf32(hacc[nt], a, bh0, bh1);
          mma::mma_tf32(hacc[nt], a, bl0, bl1);
        }
      }
      __syncthreads();  // every warp has read h and this chunk's buffer
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = nt * 8 + 2 * t4;
        hs[(n0 + g) * XP + col] = hacc[nt][0];
        hs[(n0 + g) * XP + col + 1] = hacc[nt][1];
        hs[(n0 + g + 8) * XP + col] = hacc[nt][2];
        hs[(n0 + g + 8) * XP + col + 1] = hacc[nt][3];
      }
    }
    // the next chunk's copies run behind the other block of this SM
    if (ci + 1 < nchunks) load_chunk(c0 + Q);
  }
  __syncthreads();
  for (int i = tid; i < N * (P / 4); i += MMA_THREADS) {
    const int r = i / (P / 4), e = (i % (P / 4)) * 4;
    *reinterpret_cast<float4*>(hg + (size_t)r * P + e) =
        *reinterpret_cast<const float4*>(hs + r * XP + e);
  }
}

cudaError_t launch_fma(const void* xh, const void* Bm, const void* Cm,
                       const void* a_log, void* h, void* y, int B, int S,
                       int H, long long sb, long long ss, cudaStream_t s) {
  constexpr size_t smem = sizeof(float) * fma_smem_floats();
  const cudaError_t err = mma::opt_in<ssd_fma_kernel>(smem);
  if (err != cudaSuccess) return err;
  ssd_fma_kernel<<<dim3(H, B), FMA_THREADS, smem, s>>>(
      static_cast<const float*>(xh), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(a_log),
      static_cast<float*>(h), static_cast<float*>(y), S, H, sb, ss);
  return cudaGetLastError();
}

cudaError_t launch_mma(const void* xh, const void* Bm, const void* Cm,
                       const void* a_log, void* h, void* y, int B, int S,
                       int H, long long sb, long long ss, cudaStream_t s) {
  const cudaError_t err = mma::opt_in<ssd_mma_kernel>(MMA_SMEM);
  if (err != cudaSuccess) return err;
  ssd_mma_kernel<<<dim3(H, B), MMA_THREADS, MMA_SMEM, s>>>(
      static_cast<const float*>(xh), static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), static_cast<const float*>(a_log),
      static_cast<float*>(h), static_cast<float*>(y), S, H, sb, ss);
  return cudaGetLastError();
}

}  // namespace

// dtype (of B and C): 0 = float32, 1 = bfloat16.  N = P = 64, chunk 128.
// B and C share the strides sb (batch) and ss (token), in elements, with
// unit stride along N; in bf16 B, C and their strides are 16-byte aligned.
// xh, h and y are 16-byte aligned.  h is read and replaced in place.  Returns the cudaError_t of the launch.
extern "C" int ssd(int dtype, const void* xh, const void* Bm, const void* Cm,
                   const void* a_log, void* h, void* y, int B, int S, int H,
                   long long sb, long long ss, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_fma(xh, Bm, Cm, a_log, h, y, B, S, H, sb, ss, s);
  // bf16: cp.async copies 16 bytes, so rows of B and C start 16-byte
  // aligned
  const bool aligned = (reinterpret_cast<uintptr_t>(Bm) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(Cm) % 16 == 0) &&
                       sb % 8 == 0 && ss % 8 == 0;
  if (dtype != 1 || !aligned) return (int)cudaErrorInvalidValue;
  return launch_mma(xh, Bm, Cm, a_log, h, y, B, S, H, sb, ss, s);
}

extern "C" const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
