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
// Backward (moe_gmm_bwd_launch), the VJP at dy [R, F]; the reference has
// no backward kernel (its models differentiate moe_gmm_ref in XLA). At
// phase 12 (d)'s products (131,072 routed rows, 1024 <-> 512, 32 experts,
// bf16) the two products need 2.75e11 operations (0.28 ms at 989 TFLOP/s):
// bound by operations, hence wgmma. Each output element is one sum in a
// fixed order: no float atomics, two calls give the same bytes.
//   * dx = dy w[e]^T on each group's rows: gmm_wgmma_kernel's DX
//     instance, the forward's tile walk, ring and mainloop over dy's rows
//     (depth F), w's boxes of 64 F columns x 128 D rows read as a K-major
//     B operand. At depth 512 a tile has 8 stages, so its epilogue weighs:
//     paired 4-byte stores from registers, as the forward writes, took
//     0.44 ms of a 0.74 ms call at the gate product. The consumers write
//     half a tile at a time into a 32 KB shared-memory buffer in the
//     128-byte swizzle (conflict-free), one thread stores it by TMA and
//     the consumers go on while the store drains; the buffer is reused
//     once that store has read it, and a tile ending inside its group
//     copies only its rows out, 16 bytes a thread. Half a tile leaves room
//     for 4 stages (a whole-tile buffer for 3, 5% slower on the card). The
//     epilogue still holds the tensor cores: timed on the card at the gate
//     product, dx took 0.19 ms with its epilogue cut out and 0.30-0.32 ms
//     with it; a ping-pong of two warpgroups on 128 x 128 tiles of their
//     own, taking turns on the tensor cores, took 0.43. dx is not zeroed
//     first (a fill of 0.08 ms there): the consumers zero the rows in no
//     group themselves before their first tile, while the producer fills
//     the ring, so no byte of dx is written twice. The model path's
//     dropless routing leaves no such row; expert shards and capacity do.
//   * dw[e] = x^T dy over the group's rows, gmm_dw_wgmma_kernel: one block
//     per (e, 128 rows of D, 256 columns of F), the group's rows the depth
//     in 64-row stages (x^T an MN-major A, dy an MN-major B); the rows of
//     the last stage past the group are zeroed in shared memory, and an
//     empty group's tile is written as zeros. A group's whole depth is one
//     block's loop, so a group far above the mean sets the time (one
//     expert with 75% of the gate product's rows: 0.88 ms of dw against
//     0.22 balanced, on the card). Routing seen so far (phase 12 (d)'s
//     router) keeps every group near the mean; splitting a group's depth
//     over blocks waits for a router that does not.
//   * f32, and 16-bit views TMA cannot read: scalar FMA kernels of the
//     same tiles as the f32 forward, dx's rows in no group zeroed by every
//     block's share of the same walk.
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

// D[64x128] += A[64x16] . B[16x128] from shared memory; TA, TB: 0 for a
// K-major operand, 1 for an MN-major ("transposed") one (the forward's
// K-major A and MN-major B is hopper.cuh's wgmma_ss_tb).
#define WG_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
    "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_D16(i) WG_D8(i), WG_D8(i + 8)
#define WG_REGS "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, " \
    "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
    "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
    "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, " \
    "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
    "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
    "%60, %61, %62, %63}, "
template <typename T, int TA, int TB>
__device__ __forceinline__ void wgmma128(float (&d)[64], uint64_t da,
                                         uint64_t db);
template <> __device__ __forceinline__ void wgmma128<__nv_bfloat16, 0, 0>(
    float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_D16(0), WG_D16(16), WG_D16(32), WG_D16(48)
      : "l"(da), "l"(db), "r"(1));
}
template <> __device__ __forceinline__ void wgmma128<__half, 0, 0>(
    float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " WG_REGS
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_D16(0), WG_D16(16), WG_D16(32), WG_D16(48)
      : "l"(da), "l"(db), "r"(1));
}
template <> __device__ __forceinline__ void wgmma128<__nv_bfloat16, 1, 1>(
    float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS
      "%64, %65, p, 1, 1, 1, 1;\n}\n"
      : WG_D16(0), WG_D16(16), WG_D16(32), WG_D16(48)
      : "l"(da), "l"(db), "r"(1));
}
template <> __device__ __forceinline__ void wgmma128<__half, 1, 1>(
    float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " WG_REGS
      "%64, %65, p, 1, 1, 1, 1;\n}\n"
      : WG_D16(0), WG_D16(16), WG_D16(32), WG_D16(48)
      : "l"(da), "l"(db), "r"(1));
}
#undef WG_REGS
#undef WG_D16
#undef WG_D8

// The backward's element conversions, and what dx's epilogue uses.
template <typename T> __device__ __forceinline__ float as_f32(T v);
template <> __device__ __forceinline__ float as_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float as_f32<__half>(__half v) {
  return __half2float(v);
}
template <> __device__ __forceinline__ float as_f32<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T to_type(float v);
template <> __device__ __forceinline__ float to_type<float>(float v) { return v; }
template <> __device__ __forceinline__ __half to_type<__half>(float v) {
  return __float2half_rn(v);
}
template <> __device__ __forceinline__ __nv_bfloat16 to_type<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// dx's rows in no group are zero. Warp `part` of `parts` takes 32 rows at a
// time: a lane walks the groups to find whether its row lies in one, then
// the warp writes zeros over the rows in none (16 bytes a lane when VEC:
// rows of a 16-byte multiple, 16-byte aligned). A row in a group is written
// by its tile alone, so no byte of dx is written twice. Groups are the
// forward's Args: a.R rows of a.F (dx: D) columns at row stride a.so.
template <typename T, bool VEC>
__device__ void zero_bare_rows(const Args& a, T* dx, int64_t part,
                               int64_t parts) {
  const int lane = threadIdx.x & 31;
  for (int64_t r0 = part * 32; r0 < a.R; r0 += parts * 32) {
    const int64_t r = r0 + lane;
    bool covered = r >= a.R;
    for (int e = 0; e < a.E && !covered; ++e) {
      const int64_t o = a.offsets[e];
      covered = r >= o && r < o + a.counts[e];
    }
    unsigned bare = __ballot_sync(0xffffffffu, !covered);
    while (bare) {
      T* row = dx + (r0 + __ffs(bare) - 1) * a.so;
      bare &= bare - 1;
      if (VEC) {
        constexpr int V = 16 / sizeof(T);
        for (int64_t c = (int64_t)V * lane; c < a.F; c += 32 * V)
          *reinterpret_cast<uint4*>(row + c) = make_uint4(0, 0, 0, 0);
      } else {
        for (int64_t c = lane; c < a.F; c += 32) row[c] = to_type<T>(0.f);
      }
    }
  }
}

// TMA stores from shared memory (the async proxy), in bulk groups
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0),
         "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the committed stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// the committed stores are done
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// the two consumer warpgroups only (the producer warp may have left)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

template <typename T> __device__ __forceinline__ uint32_t pack2(float v0,
                                                                float v1);
template <> __device__ __forceinline__ uint32_t pack2<__half>(float v0,
                                                              float v1) {
  __half2 h = __floats2half2_rn(v0, v1);
  return *reinterpret_cast<uint32_t*>(&h);
}
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(
    float v0, float v1) {
  __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  return *reinterpret_cast<uint32_t*>(&h);
}

// dx's epilogue buffer (the tile walk's DX instance): two 64-column boxes
// of TM rows, half a tile, beside the 4-stage ring
constexpr uint32_t EPI_BOX = TM * 64 * 2;          // one 64-column box
constexpr int DX_SMEM = T_SMEM + 2 * EPI_BOX;

// ---------------------------------------------------------------------------
// 16-bit types on wgmma, loads by TMA (views TMA can read). One tile walk
// for the forward and for the backward's dx = dy w[e]^T (DX): there x is
// dy (depth F) and w's boxes are 64 columns (the depth) x 128 rows (the
// output columns, D), read as a K-major B operand. The forward stores each
// fragment from registers; DX zeroes the rows in no group first and writes
// its tiles through shared memory and TMA stores (tout), as the header
// describes.
// ---------------------------------------------------------------------------
template <typename T, bool DX>
__global__ void __launch_bounds__(T_THREADS, 1) gmm_wgmma_kernel(
    const Args a, const __grid_constant__ CUtensorMap tx,
    const __grid_constant__ CUtensorMap tw,
    const __grid_constant__ CUtensorMap tout, const int64_t n_tiles) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);   // [TSTAGES]
  uint64_t* empty = full + TSTAGES;                          // [TSTAGES]
  // swizzled tiles start on 1024-byte boundaries
  unsigned char* ring = smem_raw + ((smem_u32(smem_raw) + T_BAR_BYTES +
                                     1023) & ~1023u) - smem_u32(smem_raw);
  unsigned char* epi = ring + TSTAGES * STAGE_BYTES;   // DX: 1024-aligned
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
    constexpr int box_n = DX ? 128 : 64;      // output columns a box feeds
    uint32_t it = 0;
    for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      int e, rlo, rhi;
      int64_t row0;
      if (!find_tile<TM>(a, t / cols, &e, &row0, &rlo, &rhi)) continue;
      const int n0 = (int)(t % cols) * TN;
      int boxes = 0;                          // boxes of w that start in F
      while (boxes < TN / box_n && n0 + box_n * boxes < a.F) ++boxes;
      const uint32_t bytes = A_BYTES + boxes * (box_n / 64) * B_HALF;
      for (int kt = 0; kt < KT; ++kt, ++it) {
        if (tid != T_CONSUMERS) continue;
        const uint32_t st = it % TSTAGES;
        if (it >= TSTAGES)                     // use it - TSTAGES released
          mbar_wait(&empty[st], ((it / TSTAGES) - 1) & 1);
        unsigned char* as = ring + st * STAGE_BYTES;
        mbar_expect_tx(&full[st], bytes);
        tma_load(as, &tx, &full[st], kt * TK, (int)row0);
        for (int j = 0; j < boxes; ++j) {
          if constexpr (DX)
            tma_load(as + A_BYTES + j * 2 * B_HALF, &tw, &full[st], kt * TK,
                     n0 + 128 * j, e);
          else
            tma_load(as + A_BYTES + j * B_HALF, &tw, &full[st], n0 + 64 * j,
                     kt * TK, e);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 rows each ----
  const int wg = tid / 128;
  const int lane = tid % 32, warp = (tid % 128) / 32;
  const uint32_t ring_at = smem_u32(ring);
  T* out = (T*)a.out;
  if constexpr (DX)            // while the producer fills the ring
    zero_bare_rows<T, true>(a, out,
                            (int64_t)blockIdx.x * (T_CONSUMERS / 32) + tid / 32,
                            (int64_t)gridDim.x * (T_CONSUMERS / 32));
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
      // four k-steps of 16: 32 bytes along x's 128-byte rows; 16 rows of w
      // (the forward) or 32 bytes along its 128-byte rows (DX)
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
#pragma unroll
        for (int q = 0; q < NT; ++q) {
          if constexpr (DX)
            wgmma128<T, 0, 0>(d[q], smem_desc(as + kk * 32, 16, 1024),
                              smem_desc(bs + 2 * q * B_HALF + kk * 32, 16,
                                        1024));
          else
            wgmma_ss_tb<T>(d[q], smem_desc(as + kk * 32, 16, 1024),
                           smem_desc(bs + 2 * q * B_HALF + kk * 16 * 128,
                                     B_HALF, 1024), 1);
        }
      wg_commit();
      wg_wait<1>();                 // the previous stage's products are done
#pragma unroll
      for (int q = 0; q < NT; ++q) pin(d[q]);
      if (kt > 0) mbar_arrive(&empty[(it - 1) % TSTAGES]);
    }
    if constexpr (!DX) {
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
            if (col < a.F)           // F % 8 == 0: the pair is wholly in
              store2<T>(orow + col, d[q][4 * j + 2 * i],
                        d[q][4 * j + 2 * i + 1]);
          }
      }
    } else {
      if (live) {
        wg_wait<0>();
#pragma unroll
        for (int q = 0; q < NT; ++q) pin(d[q]);
        mbar_arrive(&empty[(it - 1) % TSTAGES]);   // the tile's last stage
      }
      // the epilogue, one round a 128-column half q: the previous round's
      // store has read the buffer, then d[q][4j + 2i + c] (row 16 warp +
      // lane / 4 + 8i of the warpgroup's 64, column 128q + 8j + 2 (lane %
      // 4) + c) goes to box j / 8, 16-byte chunk (j % 8) ^ (row % 8) of its
      // 128-byte row
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        const int c0 = n0 + 128 * q;          // the round's first column
        if (tid == 0) bulk_wait_read();
        consumers_sync();
        if (live) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = wg * 64 + warp * 16 + lane / 4 + 8 * i;
            unsigned char* rowp = epi + r * 128 + 4 * (lane & 3);
#pragma unroll
            for (int j = 0; j < 16; ++j)
              *reinterpret_cast<uint32_t*>(rowp + (j / 8) * EPI_BOX +
                                           (((j & 7) ^ (r & 7)) << 4)) =
                  pack2<T>(d[q][4 * j + 2 * i], d[q][4 * j + 2 * i + 1]);
          }
        }
        fence_proxy_async();
        consumers_sync();
        if (rlo == 0 && rhi == TM) {  // every row in the group: TMA stores
          if (tid == 0) {
            for (int j = 0; j < 2 && c0 + 64 * j < a.F; ++j)
              tma_store(&tout, epi + j * EPI_BOX, c0 + 64 * j, (int)row0);
            bulk_commit();
          }
        } else {                      // rows [rlo, rhi), 16 bytes a thread
          const int n16 = (rhi - rlo) * 16;   // 16 chunks of 16 bytes a row
          for (int k = tid; k < n16; k += T_CONSUMERS) {
            const int r = rlo + k / 16, c16 = k % 16;
            const int64_t col = c0 + 8 * c16;
            if (col < a.F)           // D % 8 == 0: the chunk is wholly in
              *reinterpret_cast<uint4*>(out + (row0 + r) * a.so + col) =
                  *reinterpret_cast<const uint4*>(
                      epi + (c16 / 8) * EPI_BOX + r * 128 +
                      (((c16 & 7) ^ (r & 7)) << 4));
          }
        }
      }
    }
  }
  if constexpr (DX) {
    if (tid == 0) bulk_wait();
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

// The SM count of the current device, read once.
int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    return n;
  }();
  return sms;
}

// A 2-d tensor map over a [rows, cols] 16-bit matrix of row stride `stride`
// elements, in boxes of box_cols x box_rows, the 128-byte swizzle, zeros
// past each bound (a load) or nothing written there (a store).
template <typename T>
bool encode_2d(CUtensorMap* map, const void* p, int64_t cols, int64_t rows,
               int64_t stride, uint32_t box_cols, uint32_t box_rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t str[1] = {(cuuint64_t)(rows > 1 ? stride * 2 : 16)};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, kMapType<T>, 2, const_cast<void*>(p), dims, str, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// w [E, D, F] as a 3-d tensor map at strides swe and swd (a layer's leaf of
// stacked [L, E, D, F] weights needs no copy): the forward's boxes of 64
// columns of F x TK rows of D; the backward's dx (DX) reads boxes of 64
// columns of F x 128 rows of D, a K-major B operand.
template <typename T>
bool encode_w(CUtensorMap* map, const void* w, int64_t D, int64_t F,
              int64_t E, int64_t swe, int64_t swd, bool DX) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)F, (cuuint64_t)D, (cuuint64_t)E};
  const cuuint64_t str[2] = {(cuuint64_t)(D > 1 ? swd * 2 : 16),
                             (cuuint64_t)(E > 1 ? swe * 2 : 16)};
  const cuuint32_t box[3] = {64, DX ? 128u : (cuuint32_t)TK, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, kMapType<T>, 3, const_cast<void*>(w), dims, str, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}


// The tensor maps of a call: x as [R, D] in boxes of 64 columns x TM rows,
// w as above; DX, whose Args are the forward's over dy (a.D = F, the depth;
// a.F = D), reads w K-major and stores dx [R, D] by boxes of 64 columns x
// TM rows (tout; the forward's is unused). One block per SM.
template <typename T, bool DX>
cudaError_t launch_wgmma(const Args& a, int64_t tiles, cudaStream_t s) {
  constexpr int smem = DX ? DX_SMEM : T_SMEM;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gmm_wgmma_kernel<T, DX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return attr;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidValue;
  const int64_t blocks = tiles * ((a.F + TN - 1) / TN);   // output tiles
  if (a.R > INT_MAX || a.D > INT_MAX || a.F > INT_MAX)
    return cudaErrorInvalidValue;
  CUtensorMap tx, tw, tout;
  if (!encode_2d<T>(&tx, a.x, a.D, a.R, a.sx, 64, TM) ||
      !(DX ? encode_w<T>(&tw, a.w, a.F, a.D, a.E, a.swe, a.swd, true)
           : encode_w<T>(&tw, a.w, a.D, a.F, a.E, a.swe, a.swd, false)))
    return cudaErrorInvalidValue;
  if (!DX) tout = tw;
  else if (!encode_2d<T>(&tout, a.out, a.F, a.R, a.so, 64, TM))
    return cudaErrorInvalidValue;
  gmm_wgmma_kernel<T, DX><<<(unsigned)(blocks < sms ? blocks : sms),
                            T_THREADS, smem, s>>>(a, tx, tw, tout, blocks);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The backward (moe_gmm_bwd_launch): dx = dy w[e]^T on each group's rows,
// dw[e] = x^T dy over the group's rows.
// ---------------------------------------------------------------------------
struct BwdArgs {
  const void* x;      // [R, D], row stride sx
  const void* w;      // [E, D, F], strides swe, swd
  const void* dy;     // [R, F], row stride sdy
  void* dw;           // [E, D, F] contiguous
  const int* offsets;
  const int* counts;
  int64_t R, D, F;
  int E;
  int64_t sx, swe, swd, sdy;
};


// dw tiles on wgmma: one block per (e, 128 rows of D, 256 columns of F),
// two consumer warpgroups of 64 D rows and a producer warp, the group's rows
// the depth in 64-row stages through the forward's 4-stage ring: x by boxes
// of 64 D columns x 64 rows (an MN-major A: x^T), dy by four of 64 F
// columns x 64 rows (an MN-major B). In the last stage the rows past the
// group (the next group's, whose x and dy the boxes hold) are zeroed in
// shared memory before the product. An empty group's tile is zero.
template <typename T>
__global__ void __launch_bounds__(T_THREADS, 1) gmm_dw_wgmma_kernel(
    const BwdArgs a, const __grid_constant__ CUtensorMap tx,
    const __grid_constant__ CUtensorMap tdy, const int mtiles,
    const int ntiles) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);   // [TSTAGES]
  uint64_t* empty = full + TSTAGES;                          // [TSTAGES]
  unsigned char* ring = smem_raw + ((smem_u32(smem_raw) + T_BAR_BYTES +
                                     1023) & ~1023u) - smem_u32(smem_raw);
  const int e = blockIdx.x / (mtiles * ntiles);
  const int m0 = (blockIdx.x / ntiles % mtiles) * TM;        // rows of D
  const int n0 = (blockIdx.x % ntiles) * TN;                 // columns of F
  const int64_t o = a.offsets[e];
  const int c = a.counts[e] > 0 ? a.counts[e] : 0;
  const int KT = (c + TK - 1) / TK;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int st = 0; st < TSTAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], T_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int aboxes = 0, bboxes = 0;        // boxes that start inside D and F
  while (aboxes < 2 && m0 + 64 * aboxes < a.D) ++aboxes;
  while (bboxes < 2 * NT && n0 + 64 * bboxes < a.F) ++bboxes;

  if (tid >= T_CONSUMERS) {          // producer warp: lane 0 issues
    if (tid != T_CONSUMERS) return;
    const uint32_t bytes = (aboxes + bboxes) * B_HALF;
    for (int kt = 0; kt < KT; ++kt) {
      const uint32_t st = kt % TSTAGES;
      if (kt >= TSTAGES) mbar_wait(&empty[st], ((kt / TSTAGES) - 1) & 1);
      unsigned char* as = ring + st * STAGE_BYTES;
      const int row = (int)(o + (int64_t)kt * TK);
      mbar_expect_tx(&full[st], bytes);
      for (int j = 0; j < aboxes; ++j)
        tma_load(as + j * B_HALF, &tx, &full[st], m0 + 64 * j, row);
      for (int j = 0; j < bboxes; ++j)
        tma_load(as + A_BYTES + j * B_HALF, &tdy, &full[st], n0 + 64 * j,
                 row);
    }
    return;
  }

  const int wg = tid / 128;
  const int lane = tid % 32, warp = (tid % 128) / 32;
  const uint32_t ring_at = smem_u32(ring);
  float d[NT][64];
#pragma unroll
  for (int q = 0; q < NT; ++q)
#pragma unroll
    for (int j = 0; j < 64; ++j) d[q][j] = 0.f;
  for (int kt = 0; kt < KT; ++kt) {
    const uint32_t st = kt % TSTAGES;
    mbar_wait(&full[st], (kt / TSTAGES) & 1);
    const int kv = c - kt * TK;                // rows of the stage in group
    if (kv < TK) {                             // zero the rest, all 6 boxes
      uint4* base = reinterpret_cast<uint4*>(ring + st * STAGE_BYTES);
      const int per_box = (TK - kv) * 8;       // 16-byte words
      for (int i = tid; i < 6 * per_box; i += T_CONSUMERS) {
        const int box = i / per_box, w16 = i % per_box;
        base[box * (B_HALF / 16) + kv * 8 + w16] = make_uint4(0, 0, 0, 0);
      }
      fence_proxy_async();
      consumers_sync();
    }
    const uint32_t as = ring_at + st * STAGE_BYTES + wg * B_HALF;
    const uint32_t bs = ring_at + st * STAGE_BYTES + A_BYTES;
    __syncwarp();
#pragma unroll
    for (int q = 0; q < NT; ++q) pin(d[q]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
#pragma unroll
      for (int q = 0; q < NT; ++q)
        wgmma128<T, 1, 1>(d[q], smem_desc(as + kk * 16 * 128, B_HALF, 1024),
                          smem_desc(bs + 2 * q * B_HALF + kk * 16 * 128,
                                    B_HALF, 1024));
    wg_commit();
    wg_wait<1>();
#pragma unroll
    for (int q = 0; q < NT; ++q) pin(d[q]);
    if (kt > 0) mbar_arrive(&empty[(kt - 1) % TSTAGES]);
  }
  wg_wait<0>();
#pragma unroll
  for (int q = 0; q < NT; ++q) pin(d[q]);

  // d[q][4j + 2i + c] is D row m0 + 64 wg + 16 warp + lane / 4 + 8i,
  // F column n0 + 128q + 8j + 2 (lane % 4) + c
  T* out = (T*)a.dw + (int64_t)e * a.D * a.F;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t r = m0 + wg * 64 + warp * 16 + lane / 4 + 8 * i;
    if (r >= a.D) continue;
#pragma unroll
    for (int q = 0; q < NT; ++q)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int64_t col = n0 + 128 * q + 8 * j + 2 * (lane & 3);
        if (col < a.F)               // F % 8 == 0: the pair is wholly in
          store2<T>(out + r * a.F + col, d[q][4 * j + 2 * i],
                    d[q][4 * j + 2 * i + 1]);
      }
  }
}


// dx on scalar FMAs (f32, and 16-bit views TMA cannot read): the f32
// forward kernel's tiles with w read transposed: Bs[k][n] = w[e][n][k].
template <typename T>
__global__ void __launch_bounds__(F_THREADS) gmm_dx_scalar_kernel(
    const BwdArgs a, T* dx) {
  __shared__ float As[FBK][BM + 4];      // dy tile, transposed: [k][row]
  __shared__ float Bs[FBK][FBN + 4];     // w[e]^T tile: [k][col]
  // the forward's tile lookup over dy's rows (Args: D = F, the depth)
  const Args fa{a.dy, a.w, dx, a.offsets, a.counts, a.R, a.F, a.D, a.E,
                a.sdy, 0, 0, a.D};
  // rows in no group: every block takes its share of the walk
  const int64_t blk = (int64_t)blockIdx.y * gridDim.x + blockIdx.x;
  zero_bare_rows<T, false>(fa, dx, blk * (F_THREADS / 32) + threadIdx.x / 32,
                           (int64_t)gridDim.x * gridDim.y * (F_THREADS / 32));
  int e, rlo, rhi;
  int64_t row0;
  if (!find_tile<BM>(fa, blockIdx.x, &e, &row0, &rlo, &rhi)) return;
  const int64_t n0 = (int64_t)blockIdx.y * FBN;
  const int64_t K = a.F, N = a.D;
  const T* y = (const T*)a.dy;
  const T* w = (const T*)a.w + (int64_t)e * a.swe;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float acc[4][4] = {};
  for (int64_t k0 = 0; k0 < K; k0 += FBK) {
#pragma unroll
    for (int i = 0; i < BM * FBK / F_THREADS; ++i) {
      const int cidx = tid + i * F_THREADS;
      const int r = cidx / FBK, k = cidx % FBK;
      const bool ok = r >= rlo && r < rhi && k0 + k < K;
      As[k][r] = ok ? as_f32(y[(row0 + r) * a.sdy + k0 + k]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < FBK * FBN / F_THREADS; ++i) {
      const int cidx = tid + i * F_THREADS;
      const int n = cidx / FBK, k = cidx % FBK;
      const bool ok = k0 + k < K && n0 + n < N;
      Bs[k][n] = ok ? as_f32(w[(n0 + n) * a.swd + k0 + k]) : 0.f;
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
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t col = n0 + tx * 4 + j;
      if (col < N) dx[(row0 + r) * N + col] = to_type<T>(acc[i][j]);
    }
  }
}

// dw on scalar FMAs: one block per (e, 64 rows of D, 64 columns of F), the
// group's rows in steps of FBK, in order; zero for an empty group.
template <typename T>
__global__ void __launch_bounds__(F_THREADS) gmm_dw_scalar_kernel(
    const BwdArgs a, const int mtiles, const int ntiles) {
  __shared__ float As[FBK][BM + 4];      // x rows: [k][d]
  __shared__ float Bs[FBK][FBN + 4];     // dy rows: [k][f]
  const int e = blockIdx.x / (mtiles * ntiles);
  const int64_t m0 = (int64_t)(blockIdx.x / ntiles % mtiles) * BM;
  const int64_t n0 = (int64_t)(blockIdx.x % ntiles) * FBN;
  const int64_t o = a.offsets[e];
  const int c = a.counts[e] > 0 ? a.counts[e] : 0;
  const T* x = (const T*)a.x;
  const T* y = (const T*)a.dy;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < c; k0 += FBK) {
#pragma unroll
    for (int i = 0; i < FBK * BM / F_THREADS; ++i) {
      const int cidx = tid + i * F_THREADS;
      const int k = cidx / BM, m = cidx % BM;
      const bool ok = k0 + k < c && m0 + m < a.D;
      As[k][m] = ok ? as_f32(x[(o + k0 + k) * a.sx + m0 + m]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < FBK * FBN / F_THREADS; ++i) {
      const int cidx = tid + i * F_THREADS;
      const int k = cidx / FBN, n = cidx % FBN;
      const bool ok = k0 + k < c && n0 + n < a.F;
      Bs[k][n] = ok ? as_f32(y[(o + k0 + k) * a.sdy + n0 + n]) : 0.f;
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
  T* out = (T*)a.dw + (int64_t)e * a.D * a.F;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = m0 + ty * 4 + i;
    if (r >= a.D) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t col = n0 + tx * 4 + j;
      if (col < a.F) out[r * a.F + col] = to_type<T>(acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch_dw_wgmma(const BwdArgs& a, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gmm_dw_wgmma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T_SMEM);
  if (attr != cudaSuccess) return attr;
  const int mtiles = (int)((a.D + TM - 1) / TM);
  const int ntiles = (int)((a.F + TN - 1) / TN);
  const int64_t blocks = (int64_t)a.E * mtiles * ntiles;
  if (blocks > INT_MAX || a.R > INT_MAX) return cudaErrorInvalidValue;
  CUtensorMap tx, tdy;
  if (!encode_2d<T>(&tx, a.x, a.D, a.R, a.sx, 64, TK) ||
      !encode_2d<T>(&tdy, a.dy, a.F, a.R, a.sdy, 64, TK))
    return cudaErrorInvalidValue;
  gmm_dw_wgmma_kernel<T><<<(unsigned)blocks, T_THREADS, T_SMEM, s>>>(
      a, tx, tdy, mtiles, ntiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_scalar(const BwdArgs& a, void* dx, void* dw,
                              cudaStream_t s) {
  if (dx != nullptr) {
    const int64_t tiles = (a.R + BM - 1) / BM + (a.E < a.R ? a.E : a.R);
    const int64_t cols = (a.D + FBN - 1) / FBN;
    if (tiles > 0x7fffffff || cols > 65535) return cudaErrorInvalidValue;
    gmm_dx_scalar_kernel<T><<<dim3((unsigned)tiles, (unsigned)cols),
                              F_THREADS, 0, s>>>(a, (T*)dx);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (dw != nullptr) {
    const int mtiles = (int)((a.D + BM - 1) / BM);
    const int ntiles = (int)((a.F + FBN - 1) / FBN);
    const int64_t blocks = (int64_t)a.E * mtiles * ntiles;
    if (blocks > INT_MAX) return cudaErrorInvalidValue;
    gmm_dw_scalar_kernel<T><<<(unsigned)blocks, F_THREADS, 0, s>>>(
        a, mtiles, ntiles);
  }
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
    return (int)launch_wgmma<__half, false>(
        a, (R + TM - 1) / TM + (E < R ? E : R), s);
  if (dtype == 2 && tma)
    return (int)launch_wgmma<__nv_bfloat16, false>(
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

// The VJP of moe_gmm_launch's function at dy [R, F] (row stride sdy): dx
// [R, D] and dw [E, D, F], both contiguous, in the inputs' dtype (0 float32,
// 1 float16, 2 bfloat16); either may be null (not asked). Every byte of dx
// is written once: rows in no group as zeros. 16-bit views that TMA can
// read (moe_gmm_launch's rule, with dy, dx and dw) take the wgmma kernels:
// dx on gmm_wgmma_kernel's DX instance, dw on gmm_dw_wgmma_kernel; other
// views and float32 the scalar kernels. One launch a product asked.
// Returns a cudaError_t (0 on success).
extern "C" int moe_gmm_bwd_launch(const void* x, const void* w,
                                  const void* dy, void* dx, void* dw,
                                  const void* offsets, const void* counts,
                                  int64_t R, int64_t D, int64_t F, int64_t E,
                                  int64_t sx, int64_t swe, int64_t swd,
                                  int64_t sdy, int dtype, void* stream) {
  if (R < 0 || D <= 0 || F <= 0 || E <= 0 || E > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  BwdArgs b{x, w, dy, dw, (const int*)offsets, (const int*)counts, R, D, F,
            (int)E, sx, swe, swd, sdy};
  const bool tma = aligned16(x) && aligned16(w) && aligned16(dy) &&
                   (dx == nullptr || aligned16(dx)) &&
                   (dw == nullptr || aligned16(dw)) && D % 8 == 0 &&
                   F % 8 == 0 && sx % 8 == 0 && swe % 8 == 0 &&
                   swd % 8 == 0 && sdy % 8 == 0;
  if (dtype == 0) return (int)launch_bwd_scalar<float>(b, dx, dw, s);
  if (!tma) {
    if (dtype == 1) return (int)launch_bwd_scalar<__half>(b, dx, dw, s);
    if (dtype == 2)
      return (int)launch_bwd_scalar<__nv_bfloat16>(b, dx, dw, s);
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSuccess;
  if (dx != nullptr && R > 0) {
    // the forward's tile walk with x -> dy (depth F) and w read K-major
    const Args a{dy, w, dx, (const int*)offsets, (const int*)counts,
                 R, F, D, (int)E, sdy, swe, swd, D};
    const int64_t tiles = (R + TM - 1) / TM + (E < R ? E : R);
    err = dtype == 1 ? launch_wgmma<__half, true>(a, tiles, s)
        : dtype == 2 ? launch_wgmma<__nv_bfloat16, true>(a, tiles, s)
                     : cudaErrorInvalidValue;
    if (err != cudaSuccess) return (int)err;
  }
  if (dw != nullptr) {
    err = dtype == 1 ? launch_dw_wgmma<__half>(b, s)
        : dtype == 2 ? launch_dw_wgmma<__nv_bfloat16>(b, s)
                     : cudaErrorInvalidValue;
  }
  return (int)err;
}
