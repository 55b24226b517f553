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
 * K/V at the memory rate.
 *
 * head_dim 64, 112 and 128 are instantiated; a block has one thread per
 * channel, so at 112 its last warp is half full: the warp-wide softmax
 * reductions run only on the full warps.  A sliding-window ring buffer needs nothing here: the caller
 * passes min(pos + 1, capacity) as the length, and slot order does not
 * matter because RoPE was applied before the cache write.
 *
 * What the design does about it:
 *  - split-KV (flash-decoding): the grid is (KV head, row, split); each
 *    block takes one slice of the row's valid tokens, so a batch of 4
 *    rows x 8 KV heads still puts about two blocks on every SM.  A second
 *    small kernel combines the splits' partial (max, sum, accumulator);
 *  - each block serves all rep query heads of its KV head, so each K/V
 *    tile is read from device memory once (the Pallas grid reads it once
 *    per query head);
 *  - it reads the cache in the model's layout (B, T, Hkv, D) in place,
 *    16 bytes per thread per load, all of a tile's loads started before
 *    any is used;
 *  - it stops at lengths[b] = pos[b] + 1: tokens past it are never read,
 *    and the ragged tail tile is masked, so T needs no divisibility;
 *  - online softmax with m, l and the accumulators in fp32; plain FMA,
 *    since the work per byte is too small for tensor cores to matter.
 * Left for later work: TMA bulk loads and a persistent grid.
 */
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;        // tokens per KV tile
constexpr int MAX_REP = 16;   // query heads per KV head
constexpr float NEG = -1e30f;
// head_dim D is a template parameter (64, 112 or 128; the wrapper rejects
// any other): one thread per output channel, so a block has D threads, and
// K rows are padded to D + 1 floats for conflict-free reads.

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Element e of a 16-byte load holding VEC = 16 / sizeof(T) values (e is
// a compile-time constant after unrolling, so the selects fold away).
// A bf16 is the high half of the fp32 with the same bits.
__device__ __forceinline__ uint32_t word(const uint4& u, int w) {
  return w == 0 ? u.x : w == 1 ? u.y : w == 2 ? u.z : u.w;
}
template <typename T> __device__ __forceinline__ float elem(const uint4& u, int e);
template <> __device__ __forceinline__ float elem<float>(const uint4& u, int e) {
  return __uint_as_float(word(u, e));
}
template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& u, int e) {
  const uint32_t w = word(u, e >> 1);
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (MAX_REP * D + BK * (D + 1) + BK * D +
                          MAX_REP * BK + 3 * MAX_REP);
}

// Partial results of split sp for (row b, query head h) live at
// part_acc[((b * H + h) * nsplit + sp) * D + d] (unnormalised accumulator)
// and part_ml[((b * H + h) * nsplit + sp) * 2 + {0: max, 1: sum}].
template <int D, typename T>
__global__ void __launch_bounds__(D)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths,
                        float* __restrict__ part_acc,
                        float* __restrict__ part_ml, int t_cap, int H,
                        int Hkv, int nsplit, float scale) {
  constexpr int THREADS = D, DP = D + 1;
  // warps whose 32 lanes all exist (at D = 112 the fourth warp has 16):
  // only they run the full-mask shuffles of the softmax update
  constexpr int FULL_WARPS = THREADS / 32;
  extern __shared__ float smem[];
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
  // this split's tokens [t_begin, t_end): a whole number of tiles
  const int per = ((len + nsplit - 1) / nsplit + BK - 1) / BK * BK;
  const int t_begin = sp * per, t_end = min(len, t_begin + per);
  const size_t row = (size_t)Hkv * D;  // elements per cached token
  const T* kb = k + (size_t)b * t_cap * row + (size_t)hk * D;
  const T* vb = v + (size_t)b * t_cap * row + (size_t)hk * D;
  const T* qb = q + ((size_t)b * H + (size_t)hk * rep) * D;

  for (int i = tid; i < rep * D; i += THREADS) qs[i] = to_f(qb[i]) * scale;
  if (tid < rep) {
    ms[tid] = NEG;
    ls[tid] = 0.f;
  }

  float acc[MAX_REP];
#pragma unroll
  for (int h = 0; h < MAX_REP; ++h) acc[h] = 0.f;

  constexpr int VEC = 16 / sizeof(T);               // elements per load
  constexpr int CHUNKS = D / VEC;                   // loads per row
  constexpr int ITEMS = BK * CHUNKS / THREADS;      // loads per thread
  constexpr int BATCH = ITEMS < 8 ? ITEMS : 8;      // loads kept in flight

  for (int k0 = t_begin; k0 < t_end; k0 += BK) {
    const int n = min(BK, t_end - k0);  // valid tokens in this tile
    __syncthreads();                    // the previous tile is consumed
#pragma unroll
    for (int i0 = 0; i0 < ITEMS; i0 += BATCH) {
      uint4 kr[BATCH], vr[BATCH];
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int i = tid + (i0 + j) * THREADS;
        const int r = i / CHUNKS, c = (i % CHUNKS) * VEC;
        kr[j] = make_uint4(0u, 0u, 0u, 0u);
        vr[j] = make_uint4(0u, 0u, 0u, 0u);
        if (r < n) {
          const size_t off = (size_t)(k0 + r) * row + c;
          kr[j] = *reinterpret_cast<const uint4*>(kb + off);
          vr[j] = *reinterpret_cast<const uint4*>(vb + off);
        }
      }
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int i = tid + (i0 + j) * THREADS;
        const int r = i / CHUNKS, c = (i % CHUNKS) * VEC;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          ks[r * DP + c + e] = elem<T>(kr[j], e);
          vs[r * D + c + e] = elem<T>(vr[j], e);
        }
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
      }
      ps[h * BK + c] = s;
    }
    __syncthreads();
    // online-softmax update: one full warp per query head
    for (int h = warp; warp < FULL_WARPS && h < rep; h += FULL_WARPS) {
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
    // acc[h] (channel d = tid) = acc[h] * alpha[h] + sum_c p[h][c] V[c][d]
#pragma unroll
    for (int h = 0; h < MAX_REP; ++h)
      if (h < rep) acc[h] *= as[h];
    for (int c = 0; c < n; ++c) {
      const float vv = vs[c * D + tid];
#pragma unroll
      for (int h = 0; h < MAX_REP; ++h)
        if (h < rep) acc[h] = fmaf(ps[h * BK + c], vv, acc[h]);
    }
  }
  __syncthreads();
  // an empty split (t_begin >= len) writes max NEG, sum 0, accumulator 0
#pragma unroll
  for (int h = 0; h < MAX_REP; ++h) {
    if (h < rep) {
      const size_t slot = ((size_t)b * H + hk * rep + h) * nsplit + sp;
      part_acc[slot * D + tid] = acc[h];
      if (tid == 0) {
        part_ml[slot * 2] = ms[h];
        part_ml[slot * 2 + 1] = ls[h];
      }
    }
  }
}

// One block per (row, query head), thread d: merge the splits.
template <int D, typename T>
__global__ void __launch_bounds__(D)
    decode_combine_kernel(const float* __restrict__ part_acc,
                          const float* __restrict__ part_ml,
                          T* __restrict__ o, int nsplit) {
  const size_t bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = part_ml + bh * nsplit * 2;
  float m = NEG;
  for (int s = 0; s < nsplit; ++s) m = fmaxf(m, ml[2 * s]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float w = expf(ml[2 * s] - m);
    l = fmaf(ml[2 * s + 1], w, l);
    acc = fmaf(part_acc[(bh * nsplit + s) * D + d], w, acc);
  }
  o[bh * D + d] = from_f<T>(acc / (l == 0.f ? 1.f : l));
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* o, void* part_acc,
                   void* part_ml, int B, int t_cap, int H, int Hkv,
                   int nsplit, float scale, cudaStream_t stream) {
  constexpr size_t kSmem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return err;
  decode_split_kernel<D, T>
      <<<dim3(Hkv, B, nsplit), D, kSmem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const int*>(lengths),
          static_cast<float*>(part_acc), static_cast<float*>(part_ml), t_cap,
          H, Hkv, nsplit, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<D, T><<<B * H, D, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<T*>(o), nsplit);
  return cudaGetLastError();
}

template <int D>
int launch_dtype(int dtype, const void* q, const void* k, const void* v,
                 const void* lengths, void* o, void* part_acc, void* part_ml,
                 int B, int t_cap, int H, int Hkv, int nsplit, float scale,
                 cudaStream_t s) {
  if (dtype == 0)
    return launch<D, float>(q, k, v, lengths, o, part_acc, part_ml, B, t_cap,
                            H, Hkv, nsplit, scale, s);
  if (dtype == 1)
    return launch<D, __nv_bfloat16>(q, k, v, lengths, o, part_acc, part_ml,
                                    B, t_cap, H, Hkv, nsplit, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim: 64, 112 or 128.  part_acc:
// float32 (B, H, nsplit, head_dim); part_ml: float32 (B, H, nsplit, 2).
// Returns the cudaError_t of the launches.
extern "C" int fa_decode(int dtype, int head_dim, const void* q,
                         const void* k, const void* v, const void* lengths,
                         void* o, void* part_acc, void* part_ml, int B,
                         int t_cap, int H, int Hkv, int nsplit, float scale,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return launch_dtype<64>(dtype, q, k, v, lengths, o, part_acc, part_ml, B,
                            t_cap, H, Hkv, nsplit, scale, s);
  if (head_dim == 112)
    return launch_dtype<112>(dtype, q, k, v, lengths, o, part_acc, part_ml,
                             B, t_cap, H, Hkv, nsplit, scale, s);
  if (head_dim == 128)
    return launch_dtype<128>(dtype, q, k, v, lengths, o, part_acc, part_ml,
                             B, t_cap, H, Hkv, nsplit, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* fa_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
