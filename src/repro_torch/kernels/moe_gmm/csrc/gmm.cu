/*
 * K3: grouped matmul for the MoE experts, for Hopper (sm_90a).  Built by
 * kernel.py with nvcc into a shared library with a plain C interface.
 *
 * Replaces: src/repro/kernels/moe_gmm/kernel.py, gmm (pl.pallas_call of
 *   _gmm_kernel), and its host helper pad_groups.
 *
 * Computes out[r] = x[r] @ w[e(r)] for rows r sorted by expert, where
 * expert e owns the group_sizes[e] consecutive rows after those of
 * experts 0..e-1; fp32 accumulation, output in x's dtype.  x (M, K),
 * w (E, K, N), group_sizes (E,) int32 on the device, out (M, N).
 *
 * What bounds it on the card:
 *  - decode (M = slots x top-k = 16 rows over ~13 distinct experts): bytes.
 *    Every touched expert's K x N weight is read once (~211 MB at
 *    gpt-oss-20b) for ~1 FLOP per byte;
 *  - prefill (M = 8192 rows, ~256 per expert): bytes and operations about
 *    equally: the 31 touched experts' weights (514 MB, 0.15 ms at
 *    3.35 TB/s) against 2 M K N = 136 GFLOP (0.14 ms at 989 TFLOP/s).
 *
 * No host metadata: the Pallas kernel needs every group padded to whole
 * row tiles by a numpy loop on the host (pad_groups), which would stop
 * the sync-free decode loop.  Here every block reads the E group sizes on
 * the device, prefix-sums them with one warp and finds its own tiles'
 * (expert, first row, row count).  Rows are never padded or copied.
 *
 * Two bf16 paths, chosen by the host from M alone:
 *  - Large (M >= 64 E, prefill): a persistent grid of one block per SM
 *    walks the list of (expert, row tile of 128, column tile of 256)
 *    tiles, expert by expert and row tiles innermost, so the blocks in
 *    flight share each weight tile through L2 (column tiles innermost
 *    measured slower).  A block is a producer warpgroup, of which one
 *    thread issues TMA loads (sm90.cuh), and two consumer warpgroups of 64
 *    rows each that run wgmma m64n256k16 from shared memory: A = 64
 *    K-values of x's rows (K-major), B = w[e]'s N-contiguous rows as an
 *    MN-major operand, four 64-column boxes.  K goes 64 deep per stage
 *    through a 4-stage ring of 48 KB stages (full / empty mbarriers); each
 *    consumer keeps one group of products in flight and frees a stage as
 *    soon as its products retire, and the producer runs on into the next
 *    tile's stages while the consumers store this one.  The 128 x 256
 *    tile reads a third less shared memory per product than 128 x 128,
 *    and measured faster.  A tile's rows past its group's end are the
 *    next expert's rows (or zeros past M, and past K, from TMA's
 *    out-of-bounds fill): they are computed and not stored, and a
 *    consumer with no valid row skips its products.  The epilogue goes
 *    through shared memory, 64 columns at a time, and stores whole
 *    128-byte row segments with 16-byte stores, masking rows at the
 *    group's end and columns at N (gpt-oss-20b's 2880 is 11.25 tiles):
 *    the fragments' own 4-byte stores to 8 rows at a time left the
 *    tensor cores idle for a large share of each tile.
 *  - Small (decode, under 64 rows per expert on average): mma.sync
 *    m16n8k16 on 64 x 128 tiles of 4 warps, ldmatrix for A and
 *    ldmatrix.trans for the N-contiguous weight, fed by a 4-stage
 *    cp.async pipeline 32 deep; a grid of ceil(M / 64) + E row tiles by
 *    ceil(N / 128) column tiles, blocks past the last tile exit.  It
 *    keeps three 8 KB weight stages in flight per block, which is what
 *    streams the weights; rows past a group's end are zero-filled (no
 *    read), and a warp whose 32 rows are all past it skips its products.
 * The fp32 variant (the tight check against the plain version) keeps
 * the Small tiles and tile lookup on plain FMA from shared memory.  The
 * N and K tails are masked on every path; rows are 16-byte aligned
 * because K and N are multiples of 8.
 * What holds the Large path back now: about 10% of its rows are computed
 * past their group's end (64-row granularity on ~256-row groups), and
 * the weights are read from L2 by every row tile of an expert (a 2-block
 * cluster multicasting them would halve that); a block's epilogue does
 * not overlap its own products.  The decode path is held by the weights'
 * bytes (at 1.4x its bound), not by its products.
 */
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/sm90.cuh"

namespace {

constexpr int BN = 128;       // output columns per tile
constexpr int MAX_E = 256;    // the wrapper rejects more experts

using bf16 = __nv_bfloat16;

// Tile shape of the Small bf16 kernel: BM rows, BK deep per pipeline stage,
// STAGES stages; (BM / 32) x 2 warps of 32 x 64 outputs.  Row strides of
// BK + 8 and BN + 8 bf16 put the 8 rows of an ldmatrix in 8 different
// 16-byte bank groups.
template <int BM_, int BK_, int STAGES_>
struct Cfg {
  static constexpr int BM = BM_, BK = BK_, STAGES = STAGES_;
  static constexpr int THREADS = 2 * BM;
  static constexpr int LDA = BK + 8, LDB = BN + 8;
  static constexpr int A_STAGE = BM * LDA, B_STAGE = BK * LDB;
  static constexpr size_t SMEM =
      sizeof(bf16) * STAGES * (A_STAGE + B_STAGE);
};
using Small = Cfg<64, 32, 4>;

// ------------------------------------------------------------------ //
// Tile lookup from the group sizes (both paths)
// ------------------------------------------------------------------ //
struct Tile {
  int expert;  // -1: this block has no tile
  int row0;    // first row of the tile in x / out
  int rows;    // valid rows, 1..BM
};

// Block-wide: the tile with index blockIdx.x in expert order, each
// expert's rows cut into ceil(size / BM) tiles.
template <int BM, int THREADS>
__device__ Tile find_tile(const int* __restrict__ group_sizes, int E, int M) {
  __shared__ int sizes[MAX_E];
  __shared__ Tile tile;
  const int tid = threadIdx.x, lane = tid & 31;
  for (int e = tid; e < E; e += THREADS) sizes[e] = max(group_sizes[e], 0);
  if (tid == 0) tile.expert = -1;
  __syncthreads();
  if (tid < 32) {
    // lane owns experts [lane * per, lane * per + per)
    const int per = (E + 31) / 32;
    int tiles = 0, rows = 0;
    for (int j = 0; j < per; ++j) {
      const int e = lane * per + j;
      if (e < E) {
        tiles += (sizes[e] + BM - 1) / BM;
        rows += sizes[e];
      }
    }
    int tiles_inc = tiles, rows_inc = rows;  // inclusive prefix sums
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, tiles_inc, off);
      const int r = __shfl_up_sync(0xffffffffu, rows_inc, off);
      if (lane >= off) {
        tiles_inc += t;
        rows_inc += r;
      }
    }
    int t = (int)blockIdx.x - (tiles_inc - tiles);
    if (t >= 0 && t < tiles) {
      int row = rows_inc - rows;
      for (int j = 0; j < per; ++j) {
        const int e = lane * per + j;
        const int n = (sizes[e] + BM - 1) / BM;
        if (t < n) {
          const int r0 = row + t * BM;
          if (r0 < M) {
            tile.expert = e;
            tile.row0 = r0;
            tile.rows = min(min(BM, sizes[e] - t * BM), M - r0);
          }
          break;
        }
        t -= n;
        row += sizes[e];
      }
    }
  }
  __syncthreads();
  return tile;
}

// ------------------------------------------------------------------ //
// bf16: tensor cores (mma.sync m16n8k16, fp32 accumulation)
// ------------------------------------------------------------------ //
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
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
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage `kt` (depth k0 = kt * BK) of the A rows and the B = w[e] columns
// into shared memory, asynchronously, 16 bytes per copy.
template <class C>
__device__ __forceinline__ void load_stage(bf16* as, bf16* bs,
                                           const bf16* __restrict__ xa,
                                           const bf16* __restrict__ wb,
                                           int rows, int K, int N, int n0,
                                           int k0, int tid) {
  constexpr int BK = C::BK, THREADS = C::THREADS;
#pragma unroll
  for (int j = 0; j < C::BM * BK / 8 / THREADS; ++j) {  // A: BM x BK
    const int i = tid + j * THREADS;
    const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
    const bool ok = r < rows && k0 + c < K;
    cp_async16(as + r * C::LDA + c, ok ? xa + (size_t)r * K + k0 + c : xa,
               ok);
  }
#pragma unroll
  for (int j = 0; j < BK * BN / 8 / THREADS; ++j) {  // B: BK x BN
    const int i = tid + j * THREADS;
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    const bool ok = k0 + r < K && n0 + c < N;
    cp_async16(bs + r * C::LDB + c,
               ok ? wb + (size_t)(k0 + r) * N + n0 + c : wb, ok);
  }
}

template <class C>
__global__ void __launch_bounds__(C::THREADS)
    gmm_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const int* __restrict__ group_sizes,
                   bf16* __restrict__ out, int M, int K, int N, int E) {
  constexpr int BK = C::BK, STAGES = C::STAGES, LDA = C::LDA, LDB = C::LDB;
  constexpr int A_STAGE = C::A_STAGE, B_STAGE = C::B_STAGE;
  const Tile t = find_tile<C::BM, C::THREADS>(group_sizes, E, M);
  if (t.expert < 0) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* as = reinterpret_cast<bf16*>(smem_raw);  // STAGES x BM x LDA
  bf16* bs = as + STAGES * A_STAGE;              // STAGES x BK x LDB

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;  // warp tile: 32 rows x 64 cols
  const int g = lane >> 2, c4 = lane & 3;
  const int n0 = blockIdx.y * BN;
  const bf16* xa = x + (size_t)t.row0 * K;
  const bf16* wb = w + (size_t)t.expert * K * N;
  // m16 sub-tiles of this warp that hold any valid row (warp-uniform)
  const int live_m = min(2, max(0, (t.rows - wm * 32 + 15) / 16));

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

  const int ktiles = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles)
      load_stage<C>(as + s * A_STAGE, bs + s * B_STAGE, xa, wb, t.rows, K, N,
                    n0, s * BK, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // stage kt has landed
    __syncthreads();              // ... for every thread; kt - 1 consumed
    const int nk = kt + STAGES - 1;
    if (nk < ktiles)
      load_stage<C>(as + (nk % STAGES) * A_STAGE,
                    bs + (nk % STAGES) * B_STAGE, xa, wb, t.rows, K, N, n0,
                    nk * BK, tid);
    cp_async_commit();
    if (live_m == 0) continue;

    const bf16* a_s = as + (kt % STAGES) * A_STAGE;
    const bf16* b_s = bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        if (mi < live_m)
          ldmatrix_x4(af[mi], a_s + (wm * 32 + mi * 16 + (lane & 15)) * LDA +
                                  kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, b_s + (kk * 16 + (lane & 15)) * LDB + wn * 64 +
                                  np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          if (mi < live_m) {
            mma_bf16(acc[mi][2 * np], af[mi], bf[0], bf[1]);
            mma_bf16(acc[mi][2 * np + 1], af[mi], bf[2], bf[3]);
          }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 32 + mi * 16 + g + h * 8;
      if (r >= t.rows) continue;
      bf16* orow = out + (size_t)(t.row0 + r) * N;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = n0 + wn * 64 + ni * 8 + 2 * c4;
        if (col < N)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(acc[mi][ni][2 * h],
                                    acc[mi][ni][2 * h + 1]);
      }
    }
}

// ------------------------------------------------------------------ //
// fp32: plain FMA from shared memory, the Small tiles
// ------------------------------------------------------------------ //
constexpr int BM = Small::BM, BK = Small::BK, THREADS = Small::THREADS;
constexpr int APAD = BK + 1;  // padded A row (floats)

__global__ void __launch_bounds__(THREADS)
    gmm_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const int* __restrict__ group_sizes,
                   float* __restrict__ out, int M, int K, int N, int E) {
  const Tile t = find_tile<BM, THREADS>(group_sizes, E, M);
  if (t.expert < 0) return;
  __shared__ float as[BM * APAD];  // BM x BK
  __shared__ float bs[BK * BN];    // BK x BN

  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows ty * 8 .. ty * 8 + 7
  const int tx = tid & 15;  // columns tx + 16 j
  const int n0 = blockIdx.y * BN;
  const float* xa = x + (size_t)t.row0 * K;
  const float* wb = w + (size_t)t.expert * K * N;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      as[r * APAD + c] =
          (r < t.rows && k0 + c < K) ? xa[(size_t)r * K + k0 + c] : 0.f;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      bs[i] = (k0 + r < K && n0 + c < N) ? wb[(size_t)(k0 + r) * N + n0 + c]
                                         : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = as[(ty * 8 + i) * APAD + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = bs[kk * BN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty * 8 + i;
    if (r >= t.rows) continue;
    float* orow = out + (size_t)(t.row0 + r) * N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) orow[col] = acc[i][j];
    }
  }
}

// ------------------------------------------------------------------ //
// bf16 Large: persistent wgmma fed by TMA (sm90.cuh)
// ------------------------------------------------------------------ //
namespace large {
constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int THREADS = 3 * 128;  // producer warpgroup + 2 consumers
constexpr int BOX = 64 * 128;     // a 64-row box of 128-byte rows
constexpr int A_BYTES = BM * BK * 2, B_BYTES = BK * BN * 2;
// 1 KB for alignment, the ring, 2 x STAGES mbarriers, 2 prefix arrays
// epilogue staging: 64 rows x 64 columns of bf16 per consumer, rows padded
// to 144 bytes so the fragment writes hit 32 different banks
constexpr int OUT_LD = 72, OUT_BYTES = 64 * OUT_LD * 2;
constexpr size_t SMEM = 1024 + STAGES * (A_BYTES + B_BYTES) +
                        2 * STAGES * 8 + 2 * (MAX_E + 1) * sizeof(int) +
                        2 * OUT_BYTES;

struct Tile {
  int expert, row0, rows, n0;  // rows <= 0: nothing to do
};

// Tile `t` of the list: expert by expert, within an expert column tiles
// by row tiles (row tiles innermost).
__device__ __forceinline__ Tile tile_at(int t, const int* row_start,
                                        const int* tile_start, int E, int M) {
  int lo = 0, hi = E - 1;  // the last expert whose tiles start at <= t
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tile_start[mid] <= t)
      lo = mid;
    else
      hi = mid - 1;
  }
  const int size = row_start[lo + 1] - row_start[lo];
  const int rt = (size + BM - 1) / BM;  // >= 1: expert lo has tile t
  const int local = t - tile_start[lo];
  Tile tile;
  tile.expert = lo;
  tile.row0 = row_start[lo] + (local % rt) * BM;
  tile.rows = min(min(BM, size - (local % rt) * BM), M - tile.row0);
  tile.n0 = (local / rt) * BN;
  return tile;
}

__global__ void __launch_bounds__(THREADS, 1)
    gmm_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tw,
                     const int* __restrict__ group_sizes,
                     bf16* __restrict__ out, int M, int K, int N, int E) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* as =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* bs = as + STAGES * A_BYTES;
  bf16* stage_out = reinterpret_cast<bf16*>(bs + STAGES * B_BYTES);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(bs + STAGES * B_BYTES + 2 * OUT_BYTES);
  uint64_t* empty = full + STAGES;
  int* row_start = reinterpret_cast<int*>(empty + STAGES);  // E + 1
  int* tile_start = row_start + MAX_E + 1;                  // E + 1

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ntn = (N + BN - 1) / BN;
  if (warp == 0) {
    // prefix sums of rows and tiles; lane owns experts [lane * per, +per)
    const int per = (E + 31) / 32;
    int rows = 0, tiles = 0;
    for (int j = 0; j < per; ++j) {
      const int e = lane * per + j;
      if (e < E) {
        const int n = max(group_sizes[e], 0);
        rows += n;
        tiles += (n + BM - 1) / BM * ntn;
      }
    }
    int rows_inc = rows, tiles_inc = tiles;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int r = __shfl_up_sync(0xffffffffu, rows_inc, off);
      const int t = __shfl_up_sync(0xffffffffu, tiles_inc, off);
      if (lane >= off) {
        rows_inc += r;
        tiles_inc += t;
      }
    }
    rows = rows_inc - rows;
    tiles = tiles_inc - tiles;
    for (int j = 0; j < per; ++j) {
      const int e = lane * per + j;
      if (e < E) {
        const int n = max(group_sizes[e], 0);
        row_start[e] = rows;
        tile_start[e] = tiles;
        rows += n;
        tiles += (n + BM - 1) / BM * ntn;
      }
    }
    if (lane == 31) {
      row_start[E] = rows_inc;
      tile_start[E] = tiles_inc;
    }
  } else if (tid == 32) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  const int ntiles = tile_start[E];
  const int kt_n = (K + BK - 1) / BK;

  if (warp < 4) {  // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      sm90::prefetch_map(&tx);
      sm90::prefetch_map(&tw);
      int it = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const Tile tile = tile_at(t, row_start, tile_start, E, M);
        if (tile.rows <= 0) continue;
        for (int kt = 0; kt < kt_n; ++kt, ++it) {
          const int s = it % STAGES;
          sm90::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          sm90::mbar_expect_tx(&full[s], A_BYTES + B_BYTES);
          sm90::tma_load(as + s * A_BYTES, &tx, &full[s], kt * BK,
                         tile.row0);
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            sm90::tma_load(bs + s * B_BYTES + c * BOX, &tw, &full[s],
                           tile.n0 + c * 64, kt * BK, tile.expert);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg (0 or 1): rows 64 wg .. 64 wg + 63 of a tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp / 4 - 1, wq = warp & 3;
  const int g = lane >> 2, c4 = lane & 3;
  int it = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const Tile tile = tile_at(t, row_start, tile_start, E, M);
    if (tile.rows <= 0) continue;
    const bool live = tile.rows > 64 * wg;  // warpgroup-uniform
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < kt_n; ++kt, ++it) {
      const int s = it % STAGES;
      sm90::mbar_wait(&full[s], (it / STAGES) & 1);
      if (live) {
        sm90::fence_regs(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          sm90::Wgmma<BN, 1>::ss(
              acc,
              sm90::desc(as + s * A_BYTES + wg * 64 * 128 + kk * 32, 16,
                         1024),
              sm90::desc(bs + s * B_BYTES + kk * 2048, BOX, 1024), 1);
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();  // the previous stage's products retired
        sm90::fence_regs(acc);
      }
      if (kt > 0 && lane == 0) sm90::mbar_arrive(&empty[(it - 1) % STAGES]);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    if (lane == 0) sm90::mbar_arrive(&empty[(it - 1) % STAGES]);

    // epilogue: 64-column slices through shared memory, stored as whole
    // 128-byte row segments (rows past the group's end and columns past N
    // are not stored)
    bf16* so = stage_out + wg * 64 * OUT_LD;
    const int tw = threadIdx.x - 128 * (wg + 1);  // 0..127 in the group
#pragma unroll
    for (int q = 0; q < BN / 64; ++q) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = q * 8 + jj;
          *reinterpret_cast<__nv_bfloat162*>(
              so + (wq * 16 + g + 8 * h) * OUT_LD + jj * 8 + 2 * c4) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                    acc[4 * j + 2 * h + 1]);
        }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = tw + k * 128, r = i >> 3, ch = i & 7;
        const int col = tile.n0 + q * 64 + ch * 8;
        if (wg * 64 + r < tile.rows && col < N)
          *reinterpret_cast<uint4*>(out + (size_t)(tile.row0 + wg * 64 + r) *
                                              N + col) =
              *reinterpret_cast<const uint4*>(so + r * OUT_LD + ch * 8);
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    }
  }
}

// x (M, K) in boxes of 64 K-values x 128 rows; w (E, K, N) in boxes of
// 64 N-values x 64 K-rows of one expert.  A persistent grid of at most
// one block per SM.
int launch(const void* x, const void* w, const int* gs, void* out, int M,
           int K, int N, int E, cudaStream_t s) {
  CUtensorMap tx, tw;
  const cuuint64_t xd[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t xs[1] = {(cuuint64_t)K * 2};
  const cuuint32_t xb[2] = {BK, BM};
  const cuuint64_t wd[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t ws[2] = {(cuuint64_t)N * 2, (cuuint64_t)K * N * 2};
  const cuuint32_t wb[3] = {64, BK, 1};
  cudaError_t err = sm90::make_map(&tx, x, 2, xd, xs, xb);
  if (err == cudaSuccess) err = sm90::make_map(&tw, w, 3, wd, ws, wb);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gmm_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  // (ceil(M / BM) + E) x ceil(N / BN) bounds the tiles of any grouping
  const long long most =
      (long long)((M + BM - 1) / BM + E) * ((N + BN - 1) / BN);
  const int sms = sm90::sm_count();
  const int grid = (int)(most < sms ? most : sms);
  gmm_wgmma_kernel<<<grid, THREADS, SMEM, s>>>(
      tx, tw, gs, static_cast<bf16*>(out), M, K, N, E);
  return (int)cudaGetLastError();
}
}  // namespace large

// A grid of ceil(M / BM) + E row tiles (an upper bound on the tiles of
// any grouping of M rows into E groups) by ceil(N / BN) column tiles.
template <class C>
int launch_mma(const void* x, const void* w, const int* gs, void* out, int M,
               int K, int N, int E, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      gmm_mma_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + C::BM - 1) / C::BM + E, (N + BN - 1) / BN);
  gmm_mma_kernel<C><<<grid, C::THREADS, C::SMEM, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), gs,
      static_cast<bf16*>(out), M, K, N, E);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x (M, K), w (E, K, N), group_sizes
// (E,) int32 summing to M (rows past the sum are not written), out
// (M, N); K and N multiples of 8, E <= 256.  Returns the cudaError_t of
// the launch.
extern "C" int gmm(int dtype, const void* x, const void* w,
                   const void* group_sizes, void* out, int M, int K, int N,
                   int E, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E < 1 || E > MAX_E || K % 8 || N % 8) return (int)cudaErrorInvalidValue;
  const int* gs = static_cast<const int*>(group_sizes);
  if (dtype == 0) {
    const dim3 grid((M + BM - 1) / BM + E, (N + BN - 1) / BN);
    gmm_fma_kernel<<<grid, THREADS, 0, s>>>(static_cast<const float*>(x),
                                            static_cast<const float*>(w), gs,
                                            static_cast<float*>(out), M, K, N,
                                            E);
    return (int)cudaGetLastError();
  }
  // Large once the groups average half a Large tile (64 rows): decode
  // (under one row per expert) keeps the Small tiles.
  if (dtype == 1)
    return M >= 64 * E ? large::launch(x, w, gs, out, M, K, N, E, s)
                       : launch_mma<Small>(x, w, gs, out, M, K, N, E, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* gmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
