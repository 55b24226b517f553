/*
 * K4: the RWKV6 WKV recurrence, for Hopper (sm_90a).  Built by kernel.py
 * with nvcc into a shared library with a plain C interface.
 *
 * Replaces: src/repro/kernels/rwkv6/kernel.py, wkv (pl.pallas_call of
 *   _wkv_kernel), which computes the model's _wkv_scan
 *   (src/repro/models/ssm.py):
 *     y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
 *     S_t = diag(w_t) S_{t-1} + k_t v_t^T
 *   per (batch row, head), with the P x P fp32 state carried over tokens.
 *
 * What bounds it on the card: bytes, in principle.  Each token reads
 * r, k, v (model dtype) and w (fp32) and writes y (fp32), about
 * 14-20 bytes per channel against 4 P FLOPs per channel (~256): 13-18 FLOP
 * per byte, below the fp32 FMA units' ~20 FLOP per byte at 3.35 TB/s.
 * In practice it is bound by latency: the recurrence is serial over
 * tokens, and at B = 4, H = 40 the grid has only 160 blocks.
 *
 * What the design does about it:
 *  - one block per (head, batch row), P = 64 threads; thread j owns value
 *    column j of the state, S[:, j], in 64 registers for the whole
 *    sequence: the state is read from device memory once and written once
 *    (in place: a block reads all of its state before it writes any);
 *  - u is held in registers too; r, k, v and w of 32 tokens at a time are
 *    staged in shared memory with coalesced loads (one token row of a head
 *    is 64 contiguous values) and read back as broadcasts, so the token
 *    loop runs with no device-memory latency on its serial path and one
 *    barrier pair per 32 tokens;
 *  - the read-out's sum over the key index runs in four partial sums, so
 *    its dependency chain is a quarter of P;
 *  - any S >= 1: decode (S = 1) and ragged prompt lengths need no padding
 *    or divisibility (the Pallas kernel's chunk is a TPU tiling detail);
 *  - templated on the dtype of r, k, v (fp32 or bf16); w, u, the state and
 *    y are fp32, as in the model.
 * Left for later work: more threads per (row, head), each with a slice of
 * the key index, to shorten the per-token path and fill the card at
 * small batch.
 */
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int P = 64;   // head size: one thread per value column
constexpr int TC = 32;  // tokens staged in shared memory per pass

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// r, k, v, w, y: (B, S, H, P); u: (H, P); state: (B, H, P, P) [key][value]
template <typename T>
__global__ void __launch_bounds__(P)
    wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, float* state,
               float* __restrict__ y, int S, int H) {
  __shared__ __align__(16) float rs[TC][P];
  __shared__ __align__(16) float ks[TC][P];
  __shared__ __align__(16) float vs[TC][P];
  __shared__ __align__(16) float ws[TC][P];

  const int h = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const size_t row = (size_t)H * P;  // elements per token
  const size_t base = (size_t)b * S * row + (size_t)h * P + j;
  float* st = state + ((size_t)b * H + h) * P * P + j;

  float s[P], uu[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    s[i] = st[(size_t)i * P];
    uu[i] = u[h * P + i];
  }

  for (int t0 = 0; t0 < S; t0 += TC) {
    const int n = min(TC, S - t0);
    __syncthreads();  // the previous pass is consumed
#pragma unroll 8
    for (int t = 0; t < n; ++t) {
      const size_t off = base + (size_t)(t0 + t) * row;
      rs[t][j] = to_f(r[off]);
      ks[t][j] = to_f(k[off]);
      vs[t][j] = to_f(v[off]);
      ws[t][j] = w[off];
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float vj = vs[t][j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < P; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&rs[t][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[t][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&ws[t][i]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float kv = kk[e] * vj;
          acc[e] = fmaf(rr[e], s[i + e] + uu[i + e] * kv, acc[e]);
          s[i + e] = fmaf(ww[e], s[i + e], kv);
        }
      }
      y[base + (size_t)(t0 + t) * row] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
  }
#pragma unroll
  for (int i = 0; i < P; ++i) st[(size_t)i * P] = s[i];
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, void* state, void* y, int B,
                   int S, int H, cudaStream_t stream) {
  wkv_kernel<T><<<dim3(H, B), P, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<float*>(state),
      static_cast<float*>(y), S, H);
  return cudaGetLastError();
}

}  // namespace

// dtype (of r, k, v): 0 = float32, 1 = bfloat16; head size 64.  w, u,
// state and y are float32; state is read and replaced in place.  Returns
// the cudaError_t of the launch.
extern "C" int wkv(int dtype, const void* r, const void* k, const void* v,
                   const void* w, const void* u, void* state, void* y, int B,
                   int S, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(r, k, v, w, u, state, y, B, S, H, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, u, state, y, B, S, H, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* wkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
