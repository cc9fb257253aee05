// Grouped matrix product for Hopper (sm_90a): the experts of an MoE layer.
//
// Replaces repro/kernels/moe_gmm/kernel.py::_gmm_kernel (the Pallas TPU
// kernel launched by moe_gmm_kernel). Same arithmetic: each output row is a
// row of x times its group's weight matrix, accumulated in f32, written in
// x's type once.
//
// Layout. The TPU kernel takes dense groups, x [E, C, D] and w [E, D, F],
// and its grid (E, C/bc, F/bf, D/bd) visits every row slot of every expert,
// used or not; the dropless MoE layer (C = T * top_k) would hold a
// [E, T*k, D] buffer and do E times the routed work. Here the rows are
// ragged: x [R, D] holds only the routed rows, sorted by expert, and group e
// owns rows offsets[e] .. offsets[e] + counts[e] - 1, multiplied by w[e].
// Rows in no group are never written.
//
// Schedule, with no host sync. offsets and counts stay on the device, so
// the host cannot know how many row tiles each group needs. The tiles are
// counted from R and E alone: ceil(R / TM) + min(E, R) row tiles (a bound on
// sum_e ceil(counts[e] / TM) when the groups are disjoint ranges of R) by
// ceil(F / TN) column tiles. A warp finds a row tile's (group, tile) by a
// prefix sum of per-group tile counts over the counts; tiles past the last
// are skipped at once. A group with no rows owns no tile, so an expert
// that received no row reads none of its weights.
//
// Bound. At the serving prefill's gate product (36,864 routed rows, D 2048,
// F 1408, bf16) the call needs 2.13e11 operations (0.215 ms at 989 TFLOP/s)
// and moves 624 MB (0.186 ms at 3.35 TB/s): it is bound by operations, so
// the 16-bit path runs on wgmma, the only way to the tensor cores' full
// rate. At a bucket-8 decode step (48 rows) it is bound by the bytes of the
// experts hit (~34 of 64, 196 MB, 0.058 ms): every weight tile is read once
// per (group, row tile), and tiles of empty groups are never read.
//
// 16-bit design (bf16, f16), for views TMA can read (16-byte aligned
// pointers and row strides, D and F multiples of 8):
//   * One block per SM walks the output tiles (row tile of 128, column
//     tile of 256) in order, the column tile fastest, so the blocks in
//     flight share their x tiles and their expert's weights in L2; while
//     the consumers store one tile, the producer loads the next, and no
//     block waits out a new block's ramp when a decode step's tiles
//     outnumber the SMs. Each warp looks up a tile's group itself, so the
//     warps never meet at a block barrier. Two consumer warpgroups of 64
//     rows each issue two wgmma m64n128k16 per k-step with f32
//     accumulators (128 a thread); one producer warp keeps the loads in
//     flight. A 128 x 128 tile, one or two blocks per SM, was slower at
//     every main-path shape on the card: each block streams its x and w
//     tiles from L2, and the wider tile does more products per byte it
//     reads.
//   * x and w move through a 4-stage ring of 64-deep K stages in shared
//     memory (48 KB a stage) by TMA with the 128-byte swizzle, behind a
//     full and an empty mbarrier per stage (as flash_attention.cu's
//     attn_fwd_tc): x by a 2-d tensor map over [R, D] at row stride sx, one
//     box of 64 columns x 128 rows starting at the tile's first row,
//     wherever its group begins; w by a 3-d map over [E, D, F] at strides
//     swe and swd (a layer's leaf of stacked [L, E, D, F] weights needs no
//     copy), four boxes of 64 columns x 64 rows, which wgmma reads as an
//     MN-major ("transposed") B operand. Rows past R and columns past D or F
//     arrive as zeros from the maps' bounds; a box of w that starts past F
//     is not loaded, and the columns it would feed are never stored.
//   * A tile that starts inside a group reads and multiplies the next
//     group's rows too; each consumer stores only its fragment's rows in
//     [rlo, rhi), the tile's rows inside its group, by paired 4-byte
//     stores. A warpgroup with no such row issues no product.
//   * Batch invariance: a row's bytes depend on its x row, w[e] and the
//     fixed K order alone. There is no split of K, no atomic, and neither
//     the tile nor the instance depends on R or on the group sizes, so a
//     token's output is the same alone and in a batch of any size.
// Views TMA cannot read go to gmm_mma_kernel: 64 x 128 tiles from
// mma.sync m16n8k16, staged by element loads. No model path makes one.
//
// f32: scalar FMAs over 64 x 64 tiles, 4 x 4 outputs per thread, so that
// the result is an f32 product and not a TF32 one. Only the tests use it;
// the model path runs bf16.
//
// The kernel allocates nothing and launches on the caller's stream; the
// tensor maps are encoded on the host for each call (x, w and out change
// with every call) through one cached driver entry point. The C entry point
// returns cudaGetLastError() so that the Python wrapper can raise on a
// refused launch.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "../../common/hopper.cuh"   // mbarriers, TMA, wgmma

namespace {

// wgmma kernel
constexpr int TM = 128;             // rows per tile (two warpgroups)
constexpr int NT = 2;               // m64n128 products per k-step
constexpr int TN = 128 * NT;        // columns per tile
constexpr int TK = 64;              // depth per stage: one 128-byte row
constexpr int TSTAGES = 4;
constexpr int T_CONSUMERS = 256;    // two consumer warpgroups
constexpr int T_THREADS = T_CONSUMERS + 32;   // and one producer warp
constexpr uint32_t A_BYTES = TM * TK * 2;     // x tile of a stage
constexpr uint32_t B_HALF = TK * 64 * 2;      // one 64-column box of w
constexpr uint32_t STAGE_BYTES = A_BYTES + 2 * NT * B_HALF;
constexpr int T_BAR_BYTES = 128;
// barriers, up to 1023 bytes to align the swizzled tiles, the ring
constexpr int T_SMEM = T_BAR_BYTES + 1024 + TSTAGES * STAGE_BYTES;
// mma.sync kernel (element loads) and f32 kernel
constexpr int BM = 64;              // rows per tile (both kernels)
constexpr int BN = 128;             // columns per tile, mma.sync kernel
constexpr int BK = 32;              // depth per step, mma.sync kernel
constexpr int MMA_THREADS = 128;
constexpr int A_STRIDE = BK + 8;    // shared row strides, in elements
constexpr int B_STRIDE = BN + 8;
constexpr int FBN = 64;             // f32 kernel: columns per tile
constexpr int FBK = 16;             // f32 kernel: depth per step
constexpr int F_THREADS = 256;

struct Args {
  const void* x;
  const void* w;
  void* out;
  const int* offsets;
  const int* counts;
  int64_t R, D, F;
  int E;
  int64_t sx;         // x row stride
  int64_t swe, swd;   // w expert and row strides
  int64_t so;         // out row stride
};

// The (group, tile) of row tile t of ROWS rows, found by each warp on its
// own (no block barrier, so the warps of a block may look up different
// tiles at different times): group e owns ceil(counts[e] / ROWS)
// consecutive tiles. Returns false when t lies past the last tile. Also
// fills [rlo, rhi): the tile's rows that lie inside the group and inside
// [0, R).
template <int ROWS>
__device__ bool find_tile(const Args& a, int64_t t, int* e_out,
                          int64_t* row0_out, int* rlo_out, int* rhi_out) {
  const int lane = threadIdx.x & 31;
  int64_t base = 0;                  // tiles of the groups before the chunk
  int e = -1;
  int64_t tile = 0;
  for (int c0 = 0; c0 < a.E && e < 0; c0 += 32) {
    const int g = c0 + lane;
    const int c = g < a.E ? a.counts[g] : 0;
    const int n = c > 0 ? (c + ROWS - 1) / ROWS : 0;
    int v = n;                       // inclusive scan within the warp
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    const int64_t start = base + v - n;
    const unsigned hit =
        __ballot_sync(0xffffffffu, n > 0 && t >= start && t < start + n);
    if (hit) {
      const int src = __ffs(hit) - 1;
      e = __shfl_sync(0xffffffffu, g, src);
      tile = t - (base + __shfl_sync(0xffffffffu, v - n, src));
    }
    base += __shfl_sync(0xffffffffu, v, 31);
  }
  if (e < 0) return false;
  const int64_t row0 = (int64_t)a.offsets[e] + tile * ROWS;
  const int64_t rows = min((int64_t)a.counts[e] - tile * ROWS, (int64_t)ROWS);
  const int64_t lo = row0 < 0 ? -row0 : 0;
  const int64_t hi = min(rows, a.R - row0);
  *e_out = e;
  *row0_out = row0;
  *rlo_out = (int)min(lo, (int64_t)ROWS);
  *rhi_out = (int)max(hi, (int64_t)0);
  return hi > lo;
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Two neighbouring outputs as one 4-byte store.
template <typename T> __device__ __forceinline__ void store2(T* p, float v0,
                                                             float v1);
template <> __device__ __forceinline__ void store2<__half>(__half* p, float v0,
                                                           float v1) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(v0, v1);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(
    __nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

template <typename T> __device__ __forceinline__ void mma16816(
    float c[4], const uint32_t a[4], const uint32_t b[2]);
template <> __device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
template <> __device__ __forceinline__ void mma16816<__half>(
    float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------------------
// 16-bit types on wgmma, loads by TMA (views TMA can read).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(T_THREADS, 1) gmm_wgmma_kernel(
    const Args a, const __grid_constant__ CUtensorMap tx,
    const __grid_constant__ CUtensorMap tw, const int64_t n_tiles) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);   // [TSTAGES]
  uint64_t* empty = full + TSTAGES;                          // [TSTAGES]
  // swizzled tiles start on 1024-byte boundaries
  unsigned char* ring = smem_raw + ((smem_u32(smem_raw) + T_BAR_BYTES +
                                     1023) & ~1023u) - smem_u32(smem_raw);
  const int64_t cols = (a.F + TN - 1) / TN;
  const int KT = (int)((a.D + TK - 1) / TK);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < TSTAGES; ++s) {
      mbar_init(&full[s], 1);                  // the producer
      mbar_init(&empty[s], T_CONSUMERS);       // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Each block walks the tiles blockIdx.x, + gridDim.x, ...; every warp
  // looks each one up itself. `it` counts the K stages the block has used,
  // across tiles, and picks the ring slot and its phase.
  if (tid >= T_CONSUMERS) {
    // ---- producer warp: lane 0 issues every box ----
    uint32_t it = 0;
    for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      int e, rlo, rhi;
      int64_t row0;
      if (!find_tile<TM>(a, t / cols, &e, &row0, &rlo, &rhi)) continue;
      const int n0 = (int)(t % cols) * TN;
      int boxes = 0;                          // boxes of w that start in F
      while (boxes < 2 * NT && n0 + 64 * boxes < a.F) ++boxes;
      const uint32_t bytes = A_BYTES + boxes * B_HALF;
      for (int kt = 0; kt < KT; ++kt, ++it) {
        if (tid != T_CONSUMERS) continue;
        const uint32_t st = it % TSTAGES;
        if (it >= TSTAGES)                     // use it - TSTAGES released
          mbar_wait(&empty[st], ((it / TSTAGES) - 1) & 1);
        unsigned char* as = ring + st * STAGE_BYTES;
        mbar_expect_tx(&full[st], bytes);
        tma_load(as, &tx, &full[st], kt * TK, (int)row0);
        for (int j = 0; j < boxes; ++j)
          tma_load(as + A_BYTES + j * B_HALF, &tw, &full[st], n0 + 64 * j,
                   kt * TK, e);
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 rows each ----
  const int wg = tid / 128;
  const int lane = tid % 32, warp = (tid % 128) / 32;
  const uint32_t ring_at = smem_u32(ring);
  T* out = (T*)a.out;
  uint32_t it = 0;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    int e, rlo, rhi;
    int64_t row0;
    if (!find_tile<TM>(a, t / cols, &e, &row0, &rlo, &rhi)) continue;
    const int n0 = (int)(t % cols) * TN;
    const bool live = rlo < wg * 64 + 64 && rhi > wg * 64;
    float d[NT][64];
#pragma unroll
    for (int q = 0; q < NT; ++q)
#pragma unroll
      for (int j = 0; j < 64; ++j) d[q][j] = 0.f;
    for (int kt = 0; kt < KT; ++kt, ++it) {
      const uint32_t st = it % TSTAGES;
      mbar_wait(&full[st], (it / TSTAGES) & 1);
      if (!live) {                             // release what it skips
        mbar_arrive(&empty[st]);
        continue;
      }
      const uint32_t as = ring_at + st * STAGE_BYTES + wg * 64 * 128;
      const uint32_t bs = ring_at + st * STAGE_BYTES + A_BYTES;
      __syncwarp();
#pragma unroll
      for (int q = 0; q < NT; ++q) pin(d[q]);
      wg_fence();
      // four k-steps of 16: 32 bytes along x's 128-byte rows, 16 rows of w
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
#pragma unroll
        for (int q = 0; q < NT; ++q)
          wgmma_ss_tb<T>(d[q], smem_desc(as + kk * 32, 16, 1024),
                         smem_desc(bs + 2 * q * B_HALF + kk * 16 * 128,
                                   B_HALF, 1024), 1);
      wg_commit();
      wg_wait<1>();                 // the previous stage's products are done
#pragma unroll
      for (int q = 0; q < NT; ++q) pin(d[q]);
      if (kt > 0) mbar_arrive(&empty[(it - 1) % TSTAGES]);
    }
    if (!live) continue;
    wg_wait<0>();
#pragma unroll
    for (int q = 0; q < NT; ++q) pin(d[q]);
    mbar_arrive(&empty[(it - 1) % TSTAGES]);   // the tile's last stage

    // d[q][4j + 2i + c] is row 16 (warp) + lane / 4 + 8i of the
    // warpgroup's 64, column n0 + 128q + 8j + 2 (lane % 4) + c; the
    // producer already loads the next tile meanwhile
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wg * 64 + warp * 16 + lane / 4 + 8 * i;
      if (r < rlo || r >= rhi) continue;
      T* orow = out + (row0 + r) * a.so;
#pragma unroll
      for (int q = 0; q < NT; ++q)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int64_t col = n0 + 128 * q + 8 * j + 2 * (lane & 3);
          if (col < a.F)             // F % 8 == 0: the pair is wholly in
            store2<T>(orow + col, d[q][4 * j + 2 * i],
                      d[q][4 * j + 2 * i + 1]);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// 16-bit types on mma.sync, for views TMA cannot read: tiles staged by
// element loads (zeros past the group's rows and past D and F).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(MMA_THREADS) gmm_mma_kernel(Args a) {
  __shared__ __align__(16) uint16_t As[BM * A_STRIDE];
  __shared__ __align__(16) uint16_t Bs[BK * B_STRIDE];
  int e, rlo, rhi;
  int64_t row0;
  if (!find_tile<BM>(a, blockIdx.x, &e, &row0, &rlo, &rhi)) return;
  const int64_t n0 = (int64_t)blockIdx.y * BN;
  const int64_t D = a.D, F = a.F;
  const uint16_t* x = (const uint16_t*)a.x;
  const uint16_t* w = (const uint16_t*)a.w + (int64_t)e * a.swe;
  T* out = (T*)a.out;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;   // warp tile: 32 rows x 64 cols
  const bool warp_rows = wm * 32 < rhi && wm * 32 + 32 > rlo;

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

  for (int64_t k0 = 0; k0 < D; k0 += BK) {
    __syncthreads();                 // the previous step's reads are done
    for (int i = tid; i < BM * BK; i += MMA_THREADS) {         // x: 64 x 32
      const int r = i / BK, k = i % BK;
      const bool ok = r >= rlo && r < rhi && k0 + k < D;
      As[r * A_STRIDE + k] = ok ? x[(row0 + r) * a.sx + k0 + k] : (uint16_t)0;
    }
    for (int i = tid; i < BK * BN; i += MMA_THREADS) {         // w: 32 x 128
      const int k = i / BN, n = i % BN;
      const bool ok = k0 + k < D && n0 + n < F;
      Bs[k * B_STRIDE + n] = ok ? w[(k0 + k) * a.swd + n0 + n] : (uint16_t)0;
    }
    __syncthreads();
    if (!warp_rows) continue;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[2][4], bfr[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + (lane & 15);
        ldmatrix_x4(af[mi], As + r * A_STRIDE + kk + (lane >> 4) * 8);
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t t4[4];
        const int kr = kk + (lane & 15);
        ldmatrix_x4_trans(
            t4, Bs + kr * B_STRIDE + wn * 64 + nj * 16 + (lane >> 4) * 8);
        bfr[2 * nj][0] = t4[0];
        bfr[2 * nj][1] = t4[1];
        bfr[2 * nj + 1][0] = t4[2];
        bfr[2 * nj + 1][1] = t4[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma16816<T>(acc[mi][ni], af[mi], bfr[ni]);
    }
  }
  if (!warp_rows) return;

  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * 32 + mi * 16 + g + half * 8;
      if (r < rlo || r >= rhi) continue;
      T* orow = out + (row0 + r) * a.so;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int64_t col = n0 + wn * 64 + ni * 8 + tq * 2;
        if (col < F) orow[col] = from_f32<T>(acc[mi][ni][half * 2]);
        if (col + 1 < F) orow[col + 1] = from_f32<T>(acc[mi][ni][half * 2 + 1]);
      }
    }
}

// ---------------------------------------------------------------------------
// f32: scalar FMAs, 64 x 64 tile, 4 x 4 outputs per thread.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(F_THREADS) gmm_f32_kernel(Args a) {
  __shared__ float As[FBK][BM + 4];      // x tile, transposed: [k][row]
  __shared__ float Bs[FBK][FBN + 4];     // w tile: [k][col]
  int e, rlo, rhi;
  int64_t row0;
  if (!find_tile<BM>(a, blockIdx.x, &e, &row0, &rlo, &rhi)) return;
  const int64_t n0 = (int64_t)blockIdx.y * FBN;
  const int64_t D = a.D, F = a.F;
  const float* x = (const float*)a.x;
  const float* w = (const float*)a.w + (int64_t)e * a.swe;
  float* out = (float*)a.out;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float acc[4][4] = {};
  for (int64_t k0 = 0; k0 < D; k0 += FBK) {
#pragma unroll
    for (int i = 0; i < BM * FBK / F_THREADS; ++i) {
      const int c = tid + i * F_THREADS;
      const int r = c / FBK, k = c % FBK;
      const bool ok = r >= rlo && r < rhi && k0 + k < D;
      As[k][r] = ok ? x[(row0 + r) * a.sx + k0 + k] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < FBK * FBN / F_THREADS; ++i) {
      const int c = tid + i * F_THREADS;
      const int k = c / FBN, n = c % FBN;
      const bool ok = k0 + k < D && n0 + n < F;
      Bs[k][n] = ok ? w[(k0 + k) * a.swd + n0 + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = As[k][ty * 4 + i];
        bv[i] = Bs[k][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r < rlo || r >= rhi) continue;
    float* orow = out + (row0 + r) * a.so;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t col = n0 + tx * 4 + j;
      if (col < F) orow[col] = acc[i][j];
    }
  }
}

// The two tensor maps of a call: x as [R, D] in boxes of 64 columns x TM
// rows, w as [E, D, F] in boxes of 64 columns x TK rows of one expert; the
// 128-byte swizzle, zeros past each bound. Strides in bytes, 16-byte
// multiples (a dimension of size 1 takes any).
template <typename T>
cudaError_t launch_wgmma(const Args& a, int64_t tiles, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gmm_wgmma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T_SMEM);
  if (attr != cudaSuccess) return attr;
  static const int sms = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    return n;
  }();
  if (sms <= 0) return cudaErrorInvalidValue;
  const int64_t blocks = tiles * ((a.F + TN - 1) / TN);   // output tiles
  if (a.R > INT_MAX || a.D > INT_MAX || a.F > INT_MAX)
    return cudaErrorInvalidValue;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorInvalidValue;
  const cuuint32_t unit[3] = {1, 1, 1};
  CUtensorMap tx, tw;
  const cuuint64_t xdims[2] = {(cuuint64_t)a.D, (cuuint64_t)a.R};
  const cuuint64_t xstr[1] = {(cuuint64_t)(a.R > 1 ? a.sx * 2 : 16)};
  const cuuint32_t xbox[2] = {64, TM};
  const cuuint64_t wdims[3] = {(cuuint64_t)a.F, (cuuint64_t)a.D,
                               (cuuint64_t)a.E};
  const cuuint64_t wstr[2] = {(cuuint64_t)(a.D > 1 ? a.swd * 2 : 16),
                              (cuuint64_t)(a.E > 1 ? a.swe * 2 : 16)};
  const cuuint32_t wbox[3] = {64, TK, 1};
  if (encode(&tx, kMapType<T>, 2, const_cast<void*>(a.x), xdims, xstr,
             xbox, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&tw, kMapType<T>, 3, const_cast<void*>(a.w), wdims, wstr,
             wbox, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  gmm_wgmma_kernel<T><<<(unsigned)(blocks < sms ? blocks : sms), T_THREADS,
                        T_SMEM, s>>>(a, tx, tw, blocks);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16. Strides in elements. 16-bit
// views whose pointers are 16-byte aligned, whose strides and D, F are
// multiples of 8 go to the wgmma kernel, other 16-bit views to the mma.sync
// kernel (ops.py's _wgmma_view states the same rule). Returns a cudaError_t
// (0 on success).
extern "C" int moe_gmm_launch(const void* x, const void* w, void* out,
                              const void* offsets, const void* counts,
                              int64_t R, int64_t D, int64_t F, int64_t E,
                              int64_t sx, int64_t swe, int64_t swd, int64_t so,
                              int dtype, void* stream) {
  if (R <= 0 || F <= 0 || E <= 0) return 0;
  if (E > 0x7fffffff) return (int)cudaErrorInvalidValue;
  Args a{x, w, out, (const int*)offsets, (const int*)counts,
         R, D, F, (int)E, sx, swe, swd, so};
  cudaStream_t s = (cudaStream_t)stream;
  const bool tma = aligned16(x) && aligned16(w) && aligned16(out) &&
                   D % 8 == 0 && F % 8 == 0 && sx % 8 == 0 &&
                   swe % 8 == 0 && swd % 8 == 0 && so % 8 == 0;
  if (dtype == 1 && tma)
    return (int)launch_wgmma<__half>(a, (R + TM - 1) / TM + (E < R ? E : R), s);
  if (dtype == 2 && tma)
    return (int)launch_wgmma<__nv_bfloat16>(
        a, (R + TM - 1) / TM + (E < R ? E : R), s);
  const int64_t tiles = (R + BM - 1) / BM + (E < R ? E : R);
  const int64_t bn = dtype == 0 ? FBN : BN;
  const int64_t cols = (F + bn - 1) / bn;
  if (tiles > 0x7fffffff || cols > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)cols);
  if (dtype == 0) gmm_f32_kernel<<<grid, F_THREADS, 0, s>>>(a);
  else if (dtype == 1) gmm_mma_kernel<__half><<<grid, MMA_THREADS, 0, s>>>(a);
  else if (dtype == 2)
    gmm_mma_kernel<__nv_bfloat16><<<grid, MMA_THREADS, 0, s>>>(a);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
