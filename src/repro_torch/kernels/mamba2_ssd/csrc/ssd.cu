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
 * What the design does about it:
 *  - one block per (head, batch row), 256 threads, chunks in sequence;
 *    the N x P state (16 KB fp32) stays in shared memory from the first
 *    chunk to the last and is read from and written to device memory once
 *    (in place: a block reads all of its state before it writes any);
 *  - per chunk, B, C (N = 64 wide rows), x (P = 64) and the decays are
 *    staged in shared memory, the prefix sum runs on one warp with
 *    shuffles, and the three products run as register-tiled fp32 FMA
 *    (8 x 8, 4 x 8 and 4 x 4 outputs a thread) over padded rows, so that
 *    every shared-memory read is a broadcast or conflict-free;
 *  - the Q x Q decay mask is a select, not a multiply: for s > t,
 *    exp(cum_t - cum_s) may be inf, and inf * 0 is NaN;
 *  - any S >= 1: the ragged last chunk is zero-filled (x = B = C = 0,
 *    a_log = 0, so its decay is 1 and it adds nothing), which makes the
 *    final state that of the unpadded recurrence, and its y rows past S
 *    are not written;
 *  - B and C are read by stride in the model's layout (token rows of the
 *    conv output), templated on their dtype (fp32 or bf16); x, a_log, h
 *    and y are fp32, as in the model;
 *  - 179 KB of shared memory, so the kernel opts in to the large dynamic
 *    limit with cudaFuncSetAttribute.
 * Left for later work: tensor cores for the in-chunk products (TF32 or a
 * split bf16 form) and blocks that share one chunk's C.B^T across heads.
 */
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 128;        // chunk length (the model's)
constexpr int N = 64;         // state size
constexpr int P = 64;         // head dim
constexpr int THREADS = 256;
constexpr int NP = N + 1;     // padded B/C row (floats)
constexpr int QP = Q + 1;     // padded W row (floats)
constexpr unsigned FULL = 0xffffffffu;

constexpr size_t smem_floats() {
  return 2 * Q * NP   // C, B
         + Q * P      // x
         + Q * QP     // W = (C B^T) * decay mask
         + N * P      // h
         + 3 * Q;     // cum, exp(cum), exp(cum_last - cum)
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// xh, y: (B, S, H, P) fp32; Bm, Cm: rows of N at Bm[b * sb + t * ss + n];
// a_log: (B, S, H) fp32; h: (B, H, N, P) fp32, read and replaced.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    ssd_kernel(const float* __restrict__ xh, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ a_log,
               float* h, float* __restrict__ y, int S, int H, long long sb,
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
  const T* Bb = Bm + b * sb;
  const T* Cb = Cm + b * sb;
  const float* ab = a_log + (size_t)b * S * H + hd;
  float* hg = h + ((size_t)b * H + hd) * N * P;

  for (int i = tid; i < N * P; i += THREADS) hs[i] = hg[i];

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int n = min(Q, S - c0);  // valid tokens in this chunk
    __syncthreads();               // the previous chunk is consumed
    for (int i = tid; i < Q * N; i += THREADS) {
      const int t = i / N, m = i % N;
      float bv = 0.f, cv = 0.f;
      if (t < n) {
        const long long off = (long long)(c0 + t) * ss + m;
        bv = to_f(Bb[off]);
        cv = to_f(Cb[off]);
      }
      Bs[t * NP + m] = bv;
      Cs[t * NP + m] = cv;
    }
    for (int i = tid; i < Q * P; i += THREADS) {
      const int t = i / P, p = i % P;
      Xs[i] = t < n ? xb[(size_t)(c0 + t) * xrow + p] : 0.f;
    }
    if (tid < Q) cum[tid] = tid < n ? ab[(size_t)(c0 + tid) * H] : 0.f;
    __syncthreads();

    // inclusive prefix sum over the chunk: lane l holds tokens 4l .. 4l+3
    if (tid < 32) {
      const float v0 = cum[4 * tid];
      const float v1 = v0 + cum[4 * tid + 1];
      const float v2 = v1 + cum[4 * tid + 2];
      const float v3 = v2 + cum[4 * tid + 3];
      float incl = v3;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(FULL, incl, off);
        if (tid >= off) incl += o;
      }
      float excl = __shfl_up_sync(FULL, incl, 1);
      if (tid == 0) excl = 0.f;
      cum[4 * tid] = excl + v0;
      cum[4 * tid + 1] = excl + v1;
      cum[4 * tid + 2] = excl + v2;
      cum[4 * tid + 3] = excl + v3;
    }
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
  for (int i = tid; i < N * P; i += THREADS) hg[i] = hs[i];
}

template <typename T>
cudaError_t launch(const void* xh, const void* Bm, const void* Cm,
                   const void* a_log, void* h, void* y, int B, int S, int H,
                   long long sb, long long ss, cudaStream_t stream) {
  constexpr size_t kSmem = sizeof(float) * smem_floats();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  ssd_kernel<T><<<dim3(H, B), THREADS, kSmem, stream>>>(
      static_cast<const float*>(xh), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(a_log),
      static_cast<float*>(h), static_cast<float*>(y), S, H, sb, ss);
  return cudaGetLastError();
}

}  // namespace

// dtype (of B and C): 0 = float32, 1 = bfloat16.  N = P = 64, chunk 128.
// B and C share the strides sb (batch) and ss (token), in elements, with
// unit stride along N.  h is read and replaced in place.  Returns the
// cudaError_t of the launch.
extern "C" int ssd(int dtype, const void* xh, const void* Bm, const void* Cm,
                   const void* a_log, void* h, void* y, int B, int S, int H,
                   long long sb, long long ss, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(xh, Bm, Cm, a_log, h, y, B, S, H, sb, ss, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xh, Bm, Cm, a_log, h, y, B, S, H, sb, ss,
                                 s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
