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
// Rows in no group are neither read nor written.
//
// Schedule, with no host sync. offsets and counts stay on the device, so
// the host cannot know how many row tiles each group needs. The grid is
// sized from R and E alone: ceil(R / BM) + min(E, R) row tiles (a bound on
// sum_e ceil(counts[e] / BM) when the groups are disjoint ranges of R) by
// ceil(F / BN) column tiles. Each block scans the counts (a block-wide
// prefix sum of per-group tile counts) to find its (group, tile); blocks
// past the last tile return at once. A group with no rows owns no tile, so
// an expert that received no row reads none of its weights.
//
// Bound. At the serving prefill's gate product (36,864 routed rows, D 2048,
// F 1408, bf16) the call needs 2.13e11 operations (0.215 ms at 989 TFLOP/s)
// and moves 624 MB (0.186 ms at 3.35 TB/s): it is bound by operations, so
// the 16-bit path runs on the tensor cores. At a bucket-8 decode step (48
// rows) it is bound by the bytes of the experts hit (~34 of 64, 196 MB,
// 0.058 ms): every weight tile is read once per column tile, by one block
// per (group, row tile), and tiles of empty groups are never read.
//
// Design (simple first; wgmma and TMA are later work):
//   * 16-bit types (bf16, f16): a 64 x 128 output tile per block of 4 warps,
//     each warp 32 x 64, from mma.sync m16n8k16 with f32 accumulators.
//     Tiles of x (64 x 32) and w (32 x 128) go through a 3-stage cp.async
//     ring in shared memory (41.5 KB, no opt-in needed); operands reach the
//     registers by ldmatrix (w transposed on the way), rows padded by 8
//     elements so that the 8 rows of each ldmatrix phase hit distinct banks.
//     cp.async zero-fills rows past the group and columns past D or F. When
//     a pointer or a stride is not a multiple of 16 bytes, or D or F not a
//     multiple of 8, the same kernel stages its tiles with element loads.
//     Warps whose 32 rows hold no row of the group skip their products.
//   * f32: scalar FMAs over 64 x 64 tiles, 4 x 4 outputs per thread, so
//     that the result is an f32 product and not a TF32 one. Only the tests
//     use it; the model path runs bf16.
//   * x, w and out are read and written through the strides given (the
//     last dimension contiguous): a layer's leaf w[i] of a stacked
//     [L, E, D, F] tensor needs no copy, and D and F need no padding.
//
// The kernel allocates nothing and launches on the caller's stream. The C
// entry point returns cudaGetLastError() so that the Python wrapper can
// raise on a refused launch.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;              // rows per tile (both kernels)
constexpr int BN = 128;             // columns per tile, tensor-core kernel
constexpr int BK = 32;              // depth per stage, tensor-core kernel
constexpr int STAGES = 3;
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

// The (group, tile) of row tile t, found by the whole block: group e owns
// ceil(counts[e] / BM) consecutive tiles. Returns false when t lies past
// the last tile. Also fills [rlo, rhi): the tile's rows that lie inside the
// group and inside [0, R).
__device__ bool find_tile(const Args& a, int t, int* e_out, int64_t* row0_out,
                          int* rlo_out, int* rhi_out) {
  __shared__ int s_warp[32];
  __shared__ int s_e, s_tile;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (threadIdx.x == 0) s_e = -1;
  __syncthreads();
  int base = 0;                      // tiles of the groups before the chunk
  for (int c0 = 0; c0 < a.E; c0 += blockDim.x) {
    const int e = c0 + threadIdx.x;
    const int c = e < a.E ? a.counts[e] : 0;
    const int n = c > 0 ? (c + BM - 1) / BM : 0;
    int v = n;                       // inclusive scan within the warp
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    if (lane == 31) s_warp[wid] = v;
    __syncthreads();
    int off = 0, tot = 0;
    for (int i = 0; i < nw; ++i) {
      const int s = s_warp[i];
      if (i < wid) off += s;
      tot += s;
    }
    const int start = base + off + v - n;
    if (n > 0 && t >= start && t < start + n) {
      s_e = e;
      s_tile = t - start;
    }
    base += tot;
    __syncthreads();
    if (s_e >= 0 || t < base) break;  // uniform: read after the barrier
  }
  const int e = s_e;
  if (e < 0) return false;
  const int64_t row0 = (int64_t)a.offsets[e] + (int64_t)s_tile * BM;
  const int64_t rows = min((int64_t)a.counts[e] - (int64_t)s_tile * BM,
                           (int64_t)BM);
  const int64_t lo = row0 < 0 ? -row0 : 0;
  const int64_t hi = min(rows, a.R - row0);
  *e_out = e;
  *row0_out = row0;
  *rlo_out = (int)min(lo, (int64_t)BM);
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = ok ? 16 : 0;         // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
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
// 16-bit types on the tensor cores. VEC: every pointer and stride is a
// multiple of 16 bytes and D, F multiples of 8, so tiles move by cp.async in
// 16-byte pieces that lie wholly inside or wholly outside the matrices.
// ---------------------------------------------------------------------------
template <typename T, bool VEC>
__global__ void __launch_bounds__(MMA_THREADS) gmm_mma_kernel(Args a) {
  __shared__ __align__(16) uint16_t As[STAGES][BM * A_STRIDE];
  __shared__ __align__(16) uint16_t Bs[STAGES][BK * B_STRIDE];
  int e, rlo, rhi;
  int64_t row0;
  if (!find_tile(a, blockIdx.x, &e, &row0, &rlo, &rhi)) return;
  const int64_t n0 = (int64_t)blockIdx.y * BN;
  const int64_t D = a.D, F = a.F;
  const uint16_t* x = (const uint16_t*)a.x;
  const uint16_t* w = (const uint16_t*)a.w + (int64_t)e * a.swe;
  T* out = (T*)a.out;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;   // warp tile: 32 rows x 64 cols
  const bool warp_rows = wm * 32 < rhi && wm * 32 + 32 > rlo;

  auto load = [&](int s, int64_t k0) {
#pragma unroll
    for (int i = 0; i < (BM * BK / 8) / MMA_THREADS; ++i) {   // x: 64 x 32
      const int c = tid + i * MMA_THREADS;
      const int r = c >> 2, kc = (c & 3) * 8;
      const bool row_ok = r >= rlo && r < rhi;
      const uint16_t* src = x + (row0 + r) * a.sx + k0 + kc;
      uint16_t* dst = &As[s][r * A_STRIDE + kc];
      if (VEC) {
        const bool ok = row_ok && k0 + kc < D;
        cp_async16(dst, ok ? (const void*)src : a.x, ok);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dst[j] = (row_ok && k0 + kc + j < D) ? src[j] : (uint16_t)0;
      }
    }
#pragma unroll
    for (int i = 0; i < (BK * BN / 8) / MMA_THREADS; ++i) {   // w: 32 x 128
      const int c = tid + i * MMA_THREADS;
      const int kr = c >> 4, nc = (c & 15) * 8;
      const bool k_ok = k0 + kr < D;
      const uint16_t* src = w + (k0 + kr) * a.swd + n0 + nc;
      uint16_t* dst = &Bs[s][kr * B_STRIDE + nc];
      if (VEC) {
        const bool ok = k_ok && n0 + nc < F;
        cp_async16(dst, ok ? (const void*)src : a.w, ok);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dst[j] = (k_ok && n0 + nc + j < F) ? src[j] : (uint16_t)0;
      }
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

  const int KT = (int)((D + BK - 1) / BK);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, (int64_t)s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // stage kt landed; stage kt-1 is free for reuse
    const int nk = kt + STAGES - 1;
    if (nk < KT) load(nk % STAGES, (int64_t)nk * BK);
    cp_async_commit();
    if (!warp_rows) continue;
    const uint16_t* as = As[kt % STAGES];
    const uint16_t* bs = Bs[kt % STAGES];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[2][4], bfr[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + (lane & 15);
        ldmatrix_x4(af[mi], as + r * A_STRIDE + kk + (lane >> 4) * 8);
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t t4[4];
        const int kr = kk + (lane & 15);
        ldmatrix_x4_trans(
            t4, bs + kr * B_STRIDE + wn * 64 + nj * 16 + (lane >> 4) * 8);
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
  cp_async_wait<0>();
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
        const float v0 = acc[mi][ni][half * 2], v1 = acc[mi][ni][half * 2 + 1];
        if (VEC) {            // F % 8 == 0: the pair is wholly in or out
          if (col < F) store2<T>(orow + col, v0, v1);
        } else {
          if (col < F) orow[col] = from_f32<T>(v0);
          if (col + 1 < F) orow[col + 1] = from_f32<T>(v1);
        }
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
  if (!find_tile(a, blockIdx.x, &e, &row0, &rlo, &rhi)) return;
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

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16. Strides in elements. Returns a
// cudaError_t (0 on success).
extern "C" int moe_gmm_launch(const void* x, const void* w, void* out,
                              const void* offsets, const void* counts,
                              int64_t R, int64_t D, int64_t F, int64_t E,
                              int64_t sx, int64_t swe, int64_t swd, int64_t so,
                              int dtype, void* stream) {
  if (R <= 0 || F <= 0 || E <= 0) return 0;
  if (E > 0x7fffffff) return (int)cudaErrorInvalidValue;
  Args a{x, w, out, (const int*)offsets, (const int*)counts,
         R, D, F, (int)E, sx, swe, swd, so};
  const int64_t tiles = (R + BM - 1) / BM + (E < R ? E : R);
  const int64_t bn = dtype == 0 ? FBN : BN;
  const int64_t cols = (F + bn - 1) / bn;
  if (tiles > 0x7fffffff || cols > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)cols);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    gmm_f32_kernel<<<grid, F_THREADS, 0, s>>>(a);
  } else {
    const bool vec = aligned16(x) && aligned16(w) && aligned16(out) &&
                     D % 8 == 0 && F % 8 == 0 && sx % 8 == 0 &&
                     swe % 8 == 0 && swd % 8 == 0 && so % 8 == 0;
    if (dtype == 1) {
      if (vec) gmm_mma_kernel<__half, true><<<grid, MMA_THREADS, 0, s>>>(a);
      else gmm_mma_kernel<__half, false><<<grid, MMA_THREADS, 0, s>>>(a);
    } else if (dtype == 2) {
      if (vec) gmm_mma_kernel<__nv_bfloat16, true><<<grid, MMA_THREADS, 0, s>>>(a);
      else gmm_mma_kernel<__nv_bfloat16, false><<<grid, MMA_THREADS, 0, s>>>(a);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
