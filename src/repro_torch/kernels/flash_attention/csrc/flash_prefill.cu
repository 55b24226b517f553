/*
 * K2: GQA prefill attention, causal (a decoder's prompt) or not (an
 * encoder's self-attention, cross-attention over an encoder's K/V), for
 * Hopper (sm_90a).  Built by kernel.py with nvcc into a shared library
 * with a plain C interface.
 *
 * Replaces: src/repro/kernels/flash_attention/kernel.py,
 *   flash_attention_prefill (pl.pallas_call of _prefill_kernel).
 *
 * What bounds it on the card: at the main path's shapes (S = 512,
 * D = 128) the ideal kernel is bound by bytes (q, k, v read once, o
 * written once: ~42 MB against ~8.6 GFLOP at B = 4, H = 32), with the
 * operations close behind; the work per byte grows with S, so longer
 * prompts are bound by the tensor cores' rate.  The kernel it replaces
 * (mma.sync m16n8k16 fed by thread loads and ldmatrix, with no overlap
 * of a tile's loads with its math) was bound by its own issue rate, at
 * 3x SDPA.
 *
 * What the design does about it (bf16, the main path):
 *  - both products run on wgmma (sm90.cuh), fp32 accumulation: S = Q K^T
 *    with Q and K from shared memory (K is K-major as stored), then
 *    O += P V with the softmax weights P in registers (the S accumulator
 *    fragment is the A fragment, rounded to bf16) and V from shared
 *    memory as an MN-major B;
 *  - Q, K and V come by TMA, straight from the model's layouts (B, S, H,
 *    D) and (B, S, Hkv, D) as 4-d tensor maps, in 64-column boxes under
 *    128-byte swizzle; rows past S and columns past D read as zero, so
 *    the query and key tails need no divisibility and head_dim 112 is two
 *    boxes whose second one is partly zeros (its QK^T depth is 7 steps of
 *    16, its PV width 112); head_dim 256 is four boxes, 16 QK^T steps and
 *    the widest PV (m64n256k16, its V spanning four boxes LBO apart);
 *  - a work item is 64 query rows: 64 / hp positions of the hp query heads
 *    that share one KV head (hp the largest of 8, 4, 2, 1 dividing
 *    H / Hkv), so each K/V tile is loaded once for all of them;
 *  - a persistent grid of as many blocks as fit on the card (two an SM at
 *    D 112 and 128, three at D 64, one at D 256) walks the items, longest
 *    first, in a snake order that evens out the blocks' work.  A block is
 *    one producer warp and one consumer warpgroup: the producer loads
 *    each item's Q into one of two buffers and the K and V 64-key tiles
 *    into a 2-stage ring (full / empty mbarriers; K and V complete
 *    separately, so QK^T starts before V lands), running on into the next
 *    item while the consumers finish this one;
 *  - the consumers loop over the key tiles an item's positions can see:
 *    they stop at the causal diagonal and, with a sliding window (a query
 *    at p sees keys in (p - window, p], as the Pallas kernel's `window`),
 *    start at the first tile inside the first position's window; masks
 *    are computed only on tiles that cross the diagonal, the window's
 *    edge or the key tail.  Not causal, every item reads all the key
 *    tiles and only the last, ragged one is masked (key < Skv); the items
 *    are then all of one length, which the longest-first order and the
 *    snake deal out evenly as they are;
 *  - online softmax in fp32 in the log2 domain: the row max on the raw
 *    logits, each weight one FFMA and one ex2;
 *  - the output, normalised once, goes out as whole rows of 16-byte
 *    stores through the item's Q buffer (swizzled by row), which measured
 *    faster on the H100 than the fragments' own 4-byte stores to 8 rows
 *    at a time; at D 64 the fragments' stores measured faster and stay.
 * What holds it back now: each warpgroup runs QK^T, the softmax and PV of
 * a tile one after the other, and the second and third blocks on an SM
 * hide only part of that (the K/V loads cost little).  Issuing the next
 * tile's QK^T before this tile's softmax is the fix.  ptxas serialises
 * every wgmma of the kernel (warning C7513) if anything writes a later
 * wgmma's A-fragment registers while a wgmma is in flight, so the next P
 * must be converted after wgmma_wait<0>; written so, it measured slower
 * than this kernel at two or three blocks an SM.
 * The fp32 variant (the tight check against the plain version) keeps one
 * block per (64-query tile, head, row) in plain FMA from shared memory,
 * with the same causal stop, window start and masking.
 *
 * A logit softcap (gemma-2 style: cap * tanh(logit / cap) on the scaled
 * logits, before the mask) is a second instantiation of each kernel
 * (template flag CAP), so the kernels without it are the same code as
 * before.  The capped logit is monotone in the raw one, so the wgmma
 * kernel still takes the row max on the raw logits and caps it once per
 * row; each weight then costs one FMUL, one tanh.approx.f32 (about 2^-11
 * relative), one FFMA and the ex2.  The fp32 kernel caps with tanhf.
 * Masked keys keep no weight either way (their weight is set to 0, never
 * computed from a capped -inf, which would be -cap).
 */
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/sm90.cuh"

namespace {

// head_dim D is a template parameter (64, 112, 128 or 256; the wrapper
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

// CAP: the pre-scaled logits are capped, tanhf(s / cap) * cap
template <int D, bool CAP>
__global__ void __launch_bounds__(THREADS)
    prefill_fma_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int Sq, int Skv, int H, int Hkv, int q_offset,
                       int window, int causal, float scale, float cap) {
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

  // keys this tile can see: positions <= q_offset + q0 + nq - 1 (all
  // Skv when not causal), and inside the window of its first query
  const int kv_end = causal ? min(Skv, q_offset + q0 + nq) : Skv;
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
    if constexpr (CAP) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = tanhf(s[i][j] / cap) * cap;
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + rg * 4 + i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = cg + 8 * j;
        if (!(c < n && (!causal || k0 + c <= qpos) &&
              k0 + c > qpos - window))
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
        const float p = (c < n && (!causal || k0 + c <= qpos) &&
                         k0 + c > qpos - window)
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
// bf16: persistent wgmma fed by TMA (sm90.cuh)
// ------------------------------------------------------------------ //
using bf16 = __nv_bfloat16;
constexpr int ROWS = 64;              // query rows of a work item
constexpr int WG_THREADS = 128 + 32;  // consumer warpgroup + producer warp
constexpr int BOX = 64 * 128;         // a 64-row box of 128-byte rows
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Wg {
  static constexpr int NCH = (D + 63) / 64;  // 64-column boxes of a row
  static constexpr int TILE = NCH * BOX;     // 64 rows of Q, K or V
  static constexpr int STAGES = 2;           // K/V ring
  // 1 KB for alignment, two Q buffers, the K and V rings, mbarriers
  static constexpr size_t SMEM =
      1024 + TILE * (2 + 2 * STAGES) + 8 * (4 + 3 * STAGES);
};

struct Shape {
  int Sq, Skv, H, Hkv, B, q_offset, window;
  int causal;  // 0: every query sees all Skv keys
  int hp;      // query heads of a work item (they share one KV head)
  int pr;      // positions of a work item: 64 / hp
  int tiles;   // position tiles: ceil(Sq / pr)
};

// A work item: positions q0 .. q0 + pr - 1 of query heads h0 .. h0 + hp - 1
// of row b; the key tiles [t_begin, t_end) are the ones its positions see
// (inside the first one's window, up to the last one's diagonal; all of
// them when not causal).  Items are numbered longest first.
struct Item {
  int q0, h0, hk, b, p_lo, p_hi, t_begin, t_end;
};

__device__ __forceinline__ Item item_at(int i, const Shape& s) {
  const int groups = s.H / s.hp, per_tile = groups * s.B;
  Item it;
  it.q0 = (s.tiles - 1 - i / per_tile) * s.pr;
  it.h0 = (i % per_tile % groups) * s.hp;
  it.b = i % per_tile / groups;
  it.hk = it.h0 / (s.H / s.Hkv);
  it.p_lo = s.q_offset + it.q0;
  it.p_hi = it.p_lo + min(s.pr, s.Sq - it.q0) - 1;
  it.t_begin = max(0, it.p_lo - s.window + 1) / 64;
  it.t_end = ((s.causal ? min(s.Skv, it.p_hi + 1) : s.Skv) + 63) / 64;
  return it;
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// tanh on the MUFU unit (sm_75 and up), about 2^-11 relative error
__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Blocks an SM the register budget is cut for: two up to D 128; at D 256
// (193 KiB of shared memory, so one block an SM anyway) the consumers'
// 64 x 256 fp32 output fragment alone takes 128 registers a thread, and
// a budget for two blocks (about 200) would spill.
template <int D>
constexpr int wg_min_blocks() {
  return D > 128 ? 1 : 2;
}

// A persistent grid: each block takes a share of the work items.  CAP:
// the logits are capped; a raw logit x weighs 2^(tanh(x cap_in) cap_out -
// the row's capped max), cap_in = scale / cap, cap_out = cap log2(e).
template <int D, bool CAP>
__global__ void __launch_bounds__(WG_THREADS, wg_min_blocks<D>())
    prefill_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         bf16* __restrict__ o, const Shape sh,
                         float scale_log2, float cap_in, float cap_out) {
  using G = Wg<D>;
  constexpr int STAGES = G::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs =  // two Q buffers
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ks = qs + 2 * G::TILE;       // STAGES x TILE
  unsigned char* vs = ks + STAGES * G::TILE;  // STAGES x TILE
  uint64_t* qfull = reinterpret_cast<uint64_t*>(vs + STAGES * G::TILE);
  uint64_t* qempty = qfull + 2;
  uint64_t* kfull = qempty + 2;
  uint64_t* vfull = kfull + STAGES;
  uint64_t* empty = vfull + STAGES;

  // Round r of this block takes item r G + x, or r G + G - 1 - x in odd
  // rounds (G blocks, x = blockIdx.x): items come longest first, so the
  // snake order evens out the blocks' total work.  Only the last round
  // can run past the last item.
  const int items = sh.tiles * (sh.H / sh.hp) * sh.B;
  const int grid = gridDim.x, x = blockIdx.x;
  auto item_of = [=](int r) { return r * grid + (r & 1 ? grid - 1 - x : x); };
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      sm90::mbar_init(&qfull[i], 1);
      sm90::mbar_init(&qempty[i], 4);  // one arrival per consumer warp
    }
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&kfull[s], 1);
      sm90::mbar_init(&vfull[s], 1);
      sm90::mbar_init(&empty[s], 4);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {  // producer: Q of each item, then its K/V tiles
    if (lane == 0) {
      int n = 0, j = 0;  // K/V tiles and items loaded so far
      for (int r = 0; r * (int)gridDim.x < items; ++r, ++j) {
        const int i = item_of(r);
        if (i >= items) break;
        const Item it = item_at(i, sh);
        unsigned char* qt = qs + (j & 1) * G::TILE;
        sm90::mbar_wait(&qempty[j & 1], ((j >> 1) & 1) ^ 1);
        sm90::mbar_expect_tx(&qfull[j & 1], G::TILE);
        for (int h = 0; h < sh.hp; ++h)
          for (int c = 0; c < G::NCH; ++c)
            sm90::tma_load(qt + c * BOX + h * sh.pr * 128, &tq,
                           &qfull[j & 1], c * 64, it.h0 + h, it.q0, it.b);
        for (int t = it.t_begin; t < it.t_end; ++t, ++n) {
          const int s = n % STAGES;
          sm90::mbar_wait(&empty[s], ((n / STAGES) & 1) ^ 1);
          sm90::mbar_expect_tx(&kfull[s], G::TILE);
          for (int c = 0; c < G::NCH; ++c)
            sm90::tma_load(ks + s * G::TILE + c * BOX, &tk, &kfull[s],
                           c * 64, it.hk, t * 64, it.b);
          sm90::mbar_expect_tx(&vfull[s], G::TILE);
          for (int c = 0; c < G::NCH; ++c)
            sm90::tma_load(vs + s * G::TILE + c * BOX, &tv, &vfull[s],
                           c * 64, it.hk, t * 64, it.b);
        }
      }
    }
    return;
  }

  // consumer warpgroup: this thread holds rows r0 = 16 warp + g and
  // r0 + 8 of an item, at positions p_lo + r % pr of heads h0 + r / pr
  const int g = lane >> 2, c4 = lane & 3;
  const int r0 = warp * 16 + g;
  int n = 0, j = 0;
  for (int r = 0; r * (int)gridDim.x < items; ++r, ++j) {
    const int i = item_of(r);
    if (i >= items) break;
    const Item it = item_at(i, sh);
    const unsigned char* qt = qs + (j & 1) * G::TILE;
    const int pos[2] = {it.p_lo + r0 % sh.pr, it.p_lo + (r0 + 8) % sh.pr};
    float oacc[D / 2];
#pragma unroll
    for (int k = 0; k < D / 2; ++k) oacc[k] = 0.f;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

    sm90::mbar_wait(&qfull[j & 1], (j >> 1) & 1);
    for (int t = it.t_begin; t < it.t_end; ++t, ++n) {
      const int s = n % STAGES;
      const uint32_t phase = (n / STAGES) & 1;
      const int k0 = t * 64;
      const unsigned char* kt = ks + s * G::TILE;
      const unsigned char* vt = vs + s * G::TILE;

      // S = Q K^T: 64 rows x 64 keys, D / 16 steps of 16 channels
      float sc[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) sc[k] = 0.f;
      sm90::mbar_wait(&kfull[s], phase);
      sm90::fence_regs(sc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk / 4) * BOX + (kk % 4) * 32;
        sm90::Wgmma<64, 0>::ss(sc, sm90::desc(qt + off, 16, 1024),
                               sm90::desc(kt + off, 16, 1024), 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);

      // mask (only where the tile crosses the diagonal, the window's edge
      // or the key tail), online softmax in the log2 domain: the max is
      // taken on the raw logits (the scale is positive), and each weight
      // is one FFMA and one ex2, 2^(s scale - m scale)
      const bool masked = (sh.causal && k0 + 63 > it.p_lo) ||
                          k0 + 64 > sh.Skv || k0 <= it.p_hi - sh.window;
      uint32_t live = 0xffffffffu;
      float mx[2] = {NEG, NEG};
      if (masked) {
        live = 0;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + jj * 8 + 2 * c4 + (e & 1);
            const int qp = pos[e >> 1];
            const bool ok = key < sh.Skv && (!sh.causal || key <= qp) &&
                            key > qp - sh.window;
            live |= (uint32_t)ok << (jj * 4 + e);
            if (ok) mx[e >> 1] = fmaxf(mx[e >> 1], sc[jj * 4 + e]);
          }
      } else {
#pragma unroll
        for (int k = 0; k < 32; ++k)
          mx[(k >> 1) & 1] = fmaxf(mx[(k >> 1) & 1], sc[k]);
      }
      float alpha[2], ms[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        if constexpr (CAP) {
          // the max capped once per row (m stays raw; while a row has
          // seen no key, l and its output are 0 and alpha scales zeros)
          ms[r] = tanh_approx(m_new * cap_in) * cap_out;
          alpha[r] =
              exp2_approx(tanh_approx(m[r] * cap_in) * cap_out - ms[r]);
        } else {
          alpha[r] = exp2_approx((m[r] - m_new) * scale_log2);
          ms[r] = m_new * scale_log2;
        }
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        float p;
        if constexpr (CAP)
          p = (live >> k) & 1u
                  ? exp2_approx(fmaf(tanh_approx(sc[k] * cap_in), cap_out,
                                     -ms[(k >> 1) & 1]))
                  : 0.f;
        else
          p = (live >> k) & 1u
                  ? exp2_approx(fmaf(sc[k], scale_log2, -ms[(k >> 1) & 1]))
                  : 0.f;
        sc[k] = p;
        l[(k >> 1) & 1] += p;
      }
#pragma unroll
      for (int k = 0; k < D / 2; ++k) oacc[k] *= alpha[(k >> 1) & 1];
      // P as the A fragments of four 16-key steps
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          pa[kk][k] = pack_bf16(sc[8 * kk + 2 * k], sc[8 * kk + 2 * k + 1]);

      // O += P V: V (keys x D, D contiguous) is an MN-major B
      sm90::mbar_wait(&vfull[s], phase);
      sm90::fence_regs(oacc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::Wgmma<D, 1>::rs(oacc, pa[kk],
                              sm90::desc(vt + kk * 2048, BOX, 1024), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(oacc);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[s]);
    }
    if constexpr (D > 64) {
      // epilogue: O / l in bf16 into this item's Q buffer (its last QK^T has
      // retired), 16-byte chunks XOR-swizzled by row against bank conflicts,
      // then stored as whole rows of D channels; the buffer goes back to the
      // producer after a proxy fence (TMA writes it next)
      constexpr int LDO = G::NCH * 64;  // staged row: 8 or 16 chunks
      bf16* ot = reinterpret_cast<bf16*>(qs + (j & 1) * G::TILE);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(FULL, l[r], 1);
        l[r] += __shfl_xor_sync(FULL, l[r], 2);
        const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
        const int row = r0 + 8 * r;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj)
          *reinterpret_cast<__nv_bfloat162*>(
              ot + row * LDO + (jj ^ (row & 7)) * 8 + 2 * c4) =
              __floats2bfloat162_rn(oacc[4 * jj + 2 * r] * inv,
                                    oacc[4 * jj + 2 * r + 1] * inv);
      }
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      for (int i = tid; i < 64 * (D / 8); i += 128) {
        const int row = i / (D / 8), c = i % (D / 8);
        const int qi = it.q0 + row % sh.pr;
        if (qi < sh.Sq)
          *reinterpret_cast<uint4*>(
              o + (((size_t)it.b * sh.Sq + qi) * sh.H + it.h0 + row / sh.pr) *
                      D +
              c * 8) =
              *reinterpret_cast<const uint4*>(ot + row * LDO +
                                              (c ^ (row & 7)) * 8);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      if (lane == 0) sm90::mbar_arrive(&qempty[j & 1]);
    } else {
      // at D 64 (128-byte rows) stores straight from the fragments were
      // measured faster than staging
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&qempty[j & 1]);  // Q read for good

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(FULL, l[r], 1);
        l[r] += __shfl_xor_sync(FULL, l[r], 2);
        const int row = r0 + 8 * r;
        const int qi = it.q0 + row % sh.pr;
        if (qi < sh.Sq) {
          const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
          bf16* orow =
              o + (((size_t)it.b * sh.Sq + qi) * sh.H + it.h0 + row / sh.pr) *
                      D;
#pragma unroll
          for (int jj = 0; jj < D / 8; ++jj)
            *reinterpret_cast<__nv_bfloat162*>(orow + jj * 8 + 2 * c4) =
                __floats2bfloat162_rn(oacc[4 * jj + 2 * r] * inv,
                                      oacc[4 * jj + 2 * r + 1] * inv);
        }
      }
    }
  }
}

template <int D, bool CAP>
cudaError_t launch_fp32(const void* q, const void* k, const void* v,
                        void* o, int B, int Sq, int Skv, int H, int Hkv,
                        int q_offset, int window, int causal, float scale,
                        float cap, cudaStream_t stream) {
  constexpr size_t kSmem = fma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      prefill_fma_kernel<D, CAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  prefill_fma_kernel<D, CAP><<<grid, THREADS, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Skv, H, Hkv,
      q_offset, window, causal, scale, cap);
  return cudaGetLastError();
}

// Q (B, Sq, H, D) and K, V (B, Skv, Hkv, D) as 4-d tensor maps, innermost
// first; a box is 64 channels of `rows` positions of one head of one row.
inline cudaError_t attention_map(CUtensorMap* map, const void* p, int D,
                                 int heads, int S, int B, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return sm90::make_map(map, p, 4, dims, strides, box);
}

// A persistent grid: as many blocks as fit on the card at once (or one per
// work item).
template <int D, bool CAP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* o, int B, int Sq, int Skv, int H, int Hkv,
                        int q_offset, int window, int causal, float scale,
                        float cap, cudaStream_t stream) {
  const int rep = H / Hkv;
  Shape sh;
  sh.Sq = Sq, sh.Skv = Skv, sh.H = H, sh.Hkv = Hkv, sh.B = B;
  sh.q_offset = q_offset, sh.window = window, sh.causal = causal;
  sh.hp = rep % 8 == 0 ? 8 : rep % 4 == 0 ? 4 : rep % 2 == 0 ? 2 : 1;
  sh.pr = ROWS / sh.hp;
  sh.tiles = (Sq + sh.pr - 1) / sh.pr;
  const long long items = (long long)sh.tiles * (H / sh.hp) * B;
  if (items == 0) return cudaSuccess;
  CUtensorMap tq, tk, tv;
  cudaError_t err = attention_map(&tq, q, D, H, Sq, B, sh.pr);
  if (err == cudaSuccess) err = attention_map(&tk, k, D, Hkv, Skv, B, 64);
  if (err == cudaSuccess) err = attention_map(&tv, v, D, Hkv, Skv, B, 64);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(prefill_wgmma_kernel<D, CAP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Wg<D>::SMEM);
  if (err != cudaSuccess) return err;
  static int per_sm = 0;  // resident blocks of this kernel on an SM
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, prefill_wgmma_kernel<D, CAP>, WG_THREADS, Wg<D>::SMEM);
    if (err != cudaSuccess) return err;
    per_sm = per_sm < 1 ? 1 : per_sm;
  }
  const long long most = (long long)per_sm * sm90::sm_count();
  const int grid = (int)(items < most ? items : most);
  prefill_wgmma_kernel<D, CAP><<<grid, WG_THREADS, Wg<D>::SMEM, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), sh, scale * LOG2E,
      CAP ? scale / cap : 0.f, cap * LOG2E);
  return cudaGetLastError();
}

template <int D, bool CAP>
int launch_dtype(int dtype, const void* q, const void* k, const void* v,
                 void* o, int B, int Sq, int Skv, int H, int Hkv,
                 int q_offset, int window, int causal, float scale,
                 float cap, cudaStream_t s) {
  if (dtype == 0)
    return launch_fp32<D, CAP>(q, k, v, o, B, Sq, Skv, H, Hkv, q_offset,
                               window, causal, scale, cap, s);
  if (dtype == 1)
    return launch_bf16<D, CAP>(q, k, v, o, B, Sq, Skv, H, Hkv, q_offset,
                               window, causal, scale, cap, s);
  return (int)cudaErrorInvalidValue;
}

// the instantiation without (softcap 0) or with the cap
template <int D>
int launch_cap(int dtype, const void* q, const void* k, const void* v,
               void* o, int B, int Sq, int Skv, int H, int Hkv, int q_offset,
               int window, int causal, float scale, float softcap,
               cudaStream_t s) {
  if (softcap > 0.f)
    return launch_dtype<D, true>(dtype, q, k, v, o, B, Sq, Skv, H, Hkv,
                                 q_offset, window, causal, scale, softcap, s);
  return launch_dtype<D, false>(dtype, q, k, v, o, B, Sq, Skv, H, Hkv,
                                q_offset, window, causal, scale, 0.f, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim: 64, 112, 128 or 256.  Causal
// (causal != 0): a query at position p sees keys at positions in
// (p - window, p]; the caller passes a window of at least q_offset + Sq
// for none.  Not causal: every query sees all Skv keys; the caller passes
// q_offset 0 and a window of at least Sq (it then masks nothing).
// softcap: 0 for none, else > 0 (the scaled logits become softcap *
// tanh(logit / softcap)).  Returns the cudaError_t of the launch.
extern "C" int fa_prefill(int dtype, int head_dim, const void* q,
                          const void* k, const void* v, void* o, int B,
                          int Sq, int Skv, int H, int Hkv, int q_offset,
                          int window, int causal, float scale, float softcap,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!(softcap >= 0.f)) return (int)cudaErrorInvalidValue;
  if (head_dim == 64)
    return launch_cap<64>(dtype, q, k, v, o, B, Sq, Skv, H, Hkv, q_offset,
                          window, causal, scale, softcap, s);
  if (head_dim == 112)
    return launch_cap<112>(dtype, q, k, v, o, B, Sq, Skv, H, Hkv, q_offset,
                           window, causal, scale, softcap, s);
  if (head_dim == 128)
    return launch_cap<128>(dtype, q, k, v, o, B, Sq, Skv, H, Hkv, q_offset,
                           window, causal, scale, softcap, s);
  if (head_dim == 256)
    return launch_cap<256>(dtype, q, k, v, o, B, Sq, Skv, H, Hkv, q_offset,
                           window, causal, scale, softcap, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* fa_prefill_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
