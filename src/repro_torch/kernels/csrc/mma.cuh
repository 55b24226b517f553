/*
 * Warp-level tensor-core and async-copy building blocks shared by the
 * port's mma.sync kernels: K1 (flash_attention/csrc/flash_decode.cu), K4
 * (rwkv6/csrc/wkv.cu) and K5 (mamba2_ssd/csrc/ssd.cu).  Included by a quoted relative path, so an
 * edit here changes the hash of every library that includes it (nvcc.py)
 * and rebuilds them.
 *
 *  - host: a kernel's opt-in to large dynamic shared memory, made once;
 *  - cp.async 16-byte and 4-byte copies from device to shared memory,
 *    zero-filled when the source is out of range, with commit / wait;
 *  - ldmatrix x4 (and .trans) of four 8 x 8 bf16 matrices;
 *  - mma.sync m16n8k16 f32 += bf16 x bf16 and m16n8k8 f32 += tf32 x tf32;
 *  - the split of an fp32 value into two TF32 values (hi + lo) for the
 *    3xTF32 products that keep fp32 accuracy on the tensor cores.
 *
 * Fragment layouts (lane = 4 g + t4, g = lane / 4, t4 = lane % 4), as the
 * PTX ISA defines them for row-major A and column-major B:
 *  - m16n8k16 bf16: A regs {a0, a1, a2, a3} hold (row g, cols 2 t4, +1),
 *    (g + 8, 2 t4), (g, 2 t4 + 8), (g + 8, 2 t4 + 8), two bf16 each;
 *    B regs {b0, b1} hold (k = 2 t4, +1; n = g) and (k = 2 t4 + 8, +9; g);
 *  - m16n8k8 tf32: A {a0..a3} = (g, t4), (g + 8, t4), (g, t4 + 4),
 *    (g + 8, t4 + 4); B {b0, b1} = (k = t4, n = g), (k = t4 + 4, g);
 *  - accumulator C {c0..c3} = (g, 2 t4), (g, 2 t4 + 1), (g + 8, 2 t4),
 *    (g + 8, 2 t4 + 1).
 * A product sums over k, so any one-to-one renaming of the k index that A
 * and B share gives the same result: the kernels use that to feed an
 * accumulator straight back as an A operand.
 */
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

// Host: opt a kernel in to more than 48 KB of dynamic shared memory, once
// per kernel and device rather than on every launch.
template <auto Kernel>
cudaError_t opt_in(size_t bytes) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && dev >= 0 && dev < 64) done[dev] = true;
  return err;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from `src` to shared `dst`, or 16 zero bytes when !ok (`src`
// must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes, or 4 zero bytes when !ok.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8 (16 bytes each), and r[j] receives matrix j's fragment.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16 x 16, bf16) * b (16 x 8, bf16), fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16 x 8, tf32) * b (8 x 8, tf32), fp32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values as one register of two bf16 (x in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}

// fp32 rounded to the nearest TF32 (10 mantissa bits), as its bits.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to about 2^-22 relative: hi = tf32(x), lo = tf32(x - hi).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// A bf16 is exact in TF32: its bits shifted into the high half.
__device__ __forceinline__ uint32_t bf16_as_tf32(__nv_bfloat16 x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(x)) << 16;
}

}  // namespace mma
