/*
 * K2: causal GQA prefill attention, for Hopper (sm_90a).  Built by
 * kernel.py with nvcc into a shared library with a plain C interface.
 *
 * Replaces: src/repro/kernels/flash_attention/kernel.py,
 *   flash_attention_prefill (pl.pallas_call of _prefill_kernel).
 *
 * What bounds it on the card: at the main path's shapes (S = 512,
 * D = 128) the ideal kernel is bound by bytes (q, k, v read once, o
 * written once: ~42 MB against ~8.6 GFLOP at B = 4, H = 32), with the
 * operations close behind; the work per byte grows with S, so longer
 * prompts are bound by the tensor cores' rate.  In practice this kernel
 * is bound by its own instruction rate: mma.sync, ldmatrix and the softmax
 * arithmetic, with no overlap of a tile's loads and its math.
 *
 * What the design does about it:
 *  - bf16 (the main path) runs both products on tensor cores with
 *    mma.sync m16n8k16 (fp32 accumulation): one block per (64-query
 *    tile, query head, row), four warps of 16 query rows each; Q's
 *    fragments stay in registers for the whole key loop, and the softmax
 *    weights P go from the QK^T accumulators straight into the A operand
 *    of the PV product (rounded to bf16, as the plain version does)
 *    without touching shared memory;
 *  - shared-memory rows are padded by 16 bytes, so every ldmatrix reads
 *    8 rows from 8 different bank groups;
 *  - the block loops over 64-key tiles and stops at the causal diagonal
 *    (keys at positions <= q_offset + last query); with a sliding window
 *    (a query at p sees keys in (p - window, p], as the Pallas kernel's
 *    `window`) it starts at the first tile inside its first query's
 *    window, so tiles wholly outside are never read; the longest query
 *    tiles are scheduled first;
 *  - head_dim 64 (gpt-oss-20b), 112 (zamba2-7b) and 128 are
 *    instantiated: D/16 k-steps for QK^T and D/8 n-tiles of 8 for PV (7
 *    and 14 at 112, whose 224-byte bf16 rows keep 16-byte loads aligned);
 *  - Q, K and V are read in the model's layouts (B, S, H, D) and
 *    (B, S, Hkv, D) with GQA by index (query head h reads KV head
 *    h / rep), 16 bytes per thread per load: no transpose and no KV
 *    replication in device memory;
 *  - the query and key tails are masked, so S needs no divisibility;
 *  - online softmax with m, l and the output accumulators in fp32.
 * The fp32 variant (the tight check against the plain version) keeps the
 * same tiling, causal stop, masking and online softmax in plain FMA from
 * shared memory.
 * Left for later work: wgmma fed by TMA, and overlapping the next tile's
 * loads with this tile's math.
 */
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// head_dim D is a template parameter (64, 112 or 128; the wrapper
// rejects any other).
constexpr int BQ = 64;        // queries per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // 16 row groups x 8 column groups
constexpr int PP = BK + 1;    // padded P row (floats)
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// ------------------------------------------------------------------ //
// fp32: plain FMA from shared memory
// ------------------------------------------------------------------ //
template <int D>
constexpr size_t fma_smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * PP);
}

// First key a query tile must read: the window of its first query starts
// at q_offset + q0 - window + 1; rounded down to a whole tile.
__device__ __forceinline__ int kv_begin(int q_offset, int q0, int window) {
  return max(0, q_offset + q0 - window + 1) / BK * BK;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    prefill_fma_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int Sq, int Skv, int H, int Hkv, int q_offset,
                       int window, float scale) {
  constexpr int DP = D + 1;   // padded Q/K row (floats)
  constexpr int NJ = D / 8;   // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;          // BQ x DP, pre-scaled queries
  float* ks = qs + BQ * DP;  // BK x DP
  float* vs = ks + BK * DP;  // BK x D
  float* ps = vs + BK * D;   // BQ x PP softmax weights of this tile

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // rows rg*4 .. rg*4+3 of the tile
  const int cg = tid & 7;   // score columns cg + 8j, output columns cg + 8j
  const size_t qrow = (size_t)H * D, kvrow = (size_t)Hkv * D;
  const float* qb = q + (size_t)b * Sq * qrow + (size_t)h * D;
  const float* kb = k + (size_t)b * Skv * kvrow + (size_t)hk * D;
  const float* vb = v + (size_t)b * Skv * kvrow + (size_t)hk * D;
  const int nq = min(BQ, Sq - q0);  // valid queries in this tile

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    qs[r * DP + d] =
        r < nq ? qb[(size_t)(q0 + r) * qrow + d] * scale : 0.f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // keys this tile can see: positions <= q_offset + q0 + nq - 1, and
  // inside the window of its first query
  const int kv_end = min(Skv, q_offset + q0 + nq);
  for (int k0 = kv_begin(q_offset, q0, window); k0 < kv_end; k0 += BK) {
    const int n = min(BK, kv_end - k0);  // valid keys in this tile
    __syncthreads();                     // the previous tile is consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i % D;
      float kv = 0.f, vv = 0.f;
      if (r < n) {
        const size_t off = (size_t)(k0 + r) * kvrow + d;
        kv = kb[off];
        vv = vb[off];
      }
      ks[r * DP + d] = kv;
      vs[r * D + d] = vv;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(rg * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = ks[(cg + 8 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + rg * 4 + i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = cg + 8 * j;
        if (!(c < n && k0 + c <= qpos && k0 + c > qpos - window))
          s[i][j] = NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 8 threads of a row group are adjacent lanes of one warp
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = cg + 8 * j;
        const float p = (c < n && k0 + c <= qpos && k0 + c > qpos - window)
                            ? expf(s[i][j] - m_new)
                            : 0.f;
        ps[(rg * 4 + i) * PP + c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(FULL, sum, 1);
      sum += __shfl_xor_sync(FULL, sum, 2);
      sum += __shfl_xor_sync(FULL, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < n; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(rg * 4 + i) * PP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = vs[c * D + cg + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
    if (r < nq) {
      const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
      float* orow = o + ((size_t)b * Sq + q0 + r) * qrow + (size_t)h * D;
#pragma unroll
      for (int j = 0; j < NJ; ++j) orow[cg + 8 * j] = acc[i][j] * inv;
    }
  }
}

// ------------------------------------------------------------------ //
// bf16: tensor cores (mma.sync m16n8k16, fp32 accumulation)
// ------------------------------------------------------------------ //
using bf16 = __nv_bfloat16;
// smem row stride (bf16): D + 8 elements (144, 240 or 272 B), so the 8
// rows of an ldmatrix fall in 8 different 16-byte bank groups
template <int D>
__host__ __device__ constexpr int ld_of() {
  return D + 8;
}
template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * (BQ + 2 * BK) * ld_of<D>();
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows [0, n) of a 64 x D tile (global row stride `stride` elements)
// into shared memory (row stride LD); rows n..63 are zero.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst,
                                          const bf16* __restrict__ src,
                                          size_t stride, int n, int tid) {
  constexpr int LD = ld_of<D>();
  constexpr int ITEMS = 64 * (D / 8) / THREADS;  // 16-byte loads each
  uint4 r[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int i = tid + j * THREADS;
    const int row = i / (D / 8), col = (i % (D / 8)) * 8;
    r[j] = make_uint4(0u, 0u, 0u, 0u);
    if (row < n)
      r[j] = *reinterpret_cast<const uint4*>(src + (size_t)row * stride + col);
  }
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int i = tid + j * THREADS;
    const int row = i / (D / 8), col = (i % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + row * LD + col) = r[j];
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    prefill_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       int Sq, int Skv, int H, int Hkv, int q_offset,
                       int window, float scale) {
  constexpr int LD = ld_of<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // BQ x LD
  bf16* ks = qs + BQ * LD;                       // BK x LD
  bf16* vs = ks + BK * LD;                       // BK x LD

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;  // fragment row / column pair
  const size_t qrow = (size_t)H * D, kvrow = (size_t)Hkv * D;
  const bf16* kb = k + (size_t)b * Skv * kvrow + (size_t)hk * D;
  const bf16* vb = v + (size_t)b * Skv * kvrow + (size_t)hk * D;
  const int nq = min(BQ, Sq - q0);

  load_tile<D>(qs, q + ((size_t)b * Sq + q0) * qrow + (size_t)h * D, qrow,
               nq, tid);
  __syncthreads();
  // this warp's 16 query rows as A fragments, 8 steps of 16 channels
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                            (lane >> 4) * 8);

  float acc[D / 8][4];  // O: 16 rows x D channels, D/8 n-tiles of 8
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // rows g and g + 8
  const int pos0 = q_offset + q0 + warp * 16 + g;  // position of row g

  const int kv_end = min(Skv, q_offset + q0 + nq);
  for (int k0 = kv_begin(q_offset, q0, window); k0 < kv_end; k0 += BK) {
    const int n = min(BK, kv_end - k0);
    __syncthreads();  // the previous tile is consumed
    load_tile<D>(ks, kb + (size_t)k0 * kvrow, kvrow, n, tid);
    load_tile<D>(vs, vb + (size_t)k0 * kvrow, kvrow, n, tid);
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys, 8 n-tiles of 8 keys
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // mask, scale, online softmax (a row's 4 threads are one quad)
    uint32_t live = 0;
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * c4 + (e & 1);
        const int qp = pos0 + (e >> 1) * 8;
        const bool ok = col < k0 + n && col <= qp && col > qp - window;
        live |= (uint32_t)ok << (j * 4 + e);
        s[j][e] = ok ? s[j][e] * scale : NEG;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            (live >> (j * 4 + e)) & 1u ? expf(s[j][e] - m[e >> 1]) : 0.f;
        s[j][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V: P's accumulators are the A fragments, V via ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vs + (kk * 16 + (lane & 15)) * LD + np * 16 +
                                  (lane >> 4) * 8);
        mma_bf16(acc[2 * np], a, bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], a, bf[2], bf[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
    const int row = q0 + warp * 16 + g + r * 8;
    if (row < Sq) {
      const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
      bf16* orow = o + ((size_t)b * Sq + row) * qrow + (size_t)h * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * c4) =
            __floats2bfloat162_rn(acc[j][2 * r] * inv,
                                  acc[j][2 * r + 1] * inv);
    }
  }
}

template <int D>
cudaError_t launch_fp32(const void* q, const void* k, const void* v,
                        void* o, int B, int Sq, int Skv, int H, int Hkv,
                        int q_offset, int window, float scale,
                        cudaStream_t stream) {
  constexpr size_t kSmem = fma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      prefill_fma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  prefill_fma_kernel<D><<<grid, THREADS, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Skv, H, Hkv,
      q_offset, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* o, int B, int Sq, int Skv, int H, int Hkv,
                        int q_offset, int window, float scale,
                        cudaStream_t stream) {
  constexpr size_t kSmem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      prefill_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  prefill_mma_kernel<D><<<grid, THREADS, kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Sq, Skv, H, Hkv,
      q_offset, window, scale);
  return cudaGetLastError();
}

template <int D>
int launch_dtype(int dtype, const void* q, const void* k, const void* v,
                 void* o, int B, int Sq, int Skv, int H, int Hkv,
                 int q_offset, int window, float scale, cudaStream_t s) {
  if (dtype == 0)
    return launch_fp32<D>(q, k, v, o, B, Sq, Skv, H, Hkv, q_offset, window,
                          scale, s);
  if (dtype == 1)
    return launch_bf16<D>(q, k, v, o, B, Sq, Skv, H, Hkv, q_offset, window,
                          scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim: 64, 112 or 128.  A query at
// position p sees keys at positions in (p - window, p]; the caller passes
// a window of at least q_offset + Sq for none.  Returns the cudaError_t
// of the launch.
extern "C" int fa_prefill(int dtype, int head_dim, const void* q,
                          const void* k, const void* v, void* o, int B,
                          int Sq, int Skv, int H, int Hkv, int q_offset,
                          int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return launch_dtype<64>(dtype, q, k, v, o, B, Sq, Skv, H, Hkv, q_offset,
                            window, scale, s);
  if (head_dim == 112)
    return launch_dtype<112>(dtype, q, k, v, o, B, Sq, Skv, H, Hkv, q_offset,
                             window, scale, s);
  if (head_dim == 128)
    return launch_dtype<128>(dtype, q, k, v, o, B, Sq, Skv, H, Hkv, q_offset,
                             window, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* fa_prefill_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
