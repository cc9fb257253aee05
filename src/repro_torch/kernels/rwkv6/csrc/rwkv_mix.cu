// RWKV-6's token-shift mixes, fused, for Hopper (sm_90a).
//
// No TPU kernel: the reference writes the mixes as plain jnp
// (repro/models/rwkv.py) and leaves them to XLA. Added because on the card
// the same composition (rwkv_mix_plain in ../mix.py) ran as some ten
// elementwise passes a mix over [B, S, D] tensors and materialised the
// [B, S, 5, D] mixes, and its backward as as many passes plus the autograd
// engine's sums of a zero-filled gradient per select.
//
// Function, per row n of x [N, D] (N = B S, rows of a sequence adjacent):
//   xs[n] = x[n - 1], or prev[b] (zeros without prev) at a sequence's first
//           row: the token shift, which never crosses two sequences;
//   out_i[n] = x[n] + (xs[n] - x[n]) * m_i[n],   i < K <= 5,
//   m_i[n] = mix_i + lr[n, i] B_i   with lr [N, K, R], B [K, R, D] (the time
//            mix: K = 5, the data-dependent "ddlerp"), or
//   m_i[n] = mix_i                  (the channel mix: K = 2, no lr).
// Backward, with Q[n] = sum_i dy_i[n] m_i[n]:
//   dx[n]    = sum_i dy_i[n] - Q[n] + Q[n + 1]   (Q[n + 1] only within the
//              sequence: the shift's transpose stops at its last row);
//   dprev[b] = Q[the sequence's first row];
//   dlr[n,i] = (dy_i[n] * (xs[n] - x[n])) B_i^T.
// The weights' gradients (mix, B), wanted only when they train, are plain
// reductions in the wrapper (../mix.py).
//
// Bound. Below the ridge: the only gain is fewer bytes. At rwkv6-7b's
// training shape (N 16384, D 4096, R 64, bf16) the time mix's forward reads
// x (134 MB) and lr (10 MB) and writes five outputs (671 MB): 0.82 GB, 0.245
// ms at 3.35 TB/s; its products, 2 N K R D = 43 GFLOP, take 0.04 ms on the
// tensor cores. The backward reads five dy and x and writes dx and dlr:
// 0.96 GB, 0.29 ms; 86 GFLOP of products (the second split in two bf16
// halves: 129 GFLOP issued). The channel mix moves 0.40 GB each way.
//
// Design. In bf16 the products stay inside the kernel, on mma.sync
// m16n8k16 (bf16 in, f32 sums), so m_i never reaches device memory:
//   * rwkv_mix_fwd<R>: a block owns 64 rows (four warps of 16) and walks D
//     in chunks of 32 columns. lr's 64 rows sit in shared memory for the
//     whole walk; each chunk's x rows (one row above the tile for the shift),
//     B_i columns and mixes come in by cp.async, double-buffered, one
//     barrier a chunk. A warp holds x and xs - x of its 16 x 32 in registers
//     in the mma's accumulator layout and forms m_i = lr_i B_i (A by
//     ldmatrix, B by ldmatrix.trans), issuing mix i + 1's product before
//     mix i's outputs x + (xs - x) m_i are rounded and leave through a
//     per-warp shared tile as 16-byte rows. Two blocks an SM.
//   * rwkv_mix_bwd<R>: the same walk with the K dy_i chunks staged too, and
//     two kinds of warps. Four m-warps (16 rows each) recompute m_i, sum Q
//     and sum_i dy_i over i in registers, and write dx; the row below Q's
//     comes from the next lane group by a shuffle, across warps by a
//     32-float exchange in shared memory. Ten G-warps, one per (32-row
//     half, i), form G = dy_i (xs - x) in f32 straight into the A operand's
//     layout, split into bf16 hi + lo (16 bits of mantissa: no rounding the
//     f32 sum would see), and accumulate dlr_i = G B_i^T over the whole of D
//     in registers, each B fragment (ldmatrix from the same tile) serving
//     both halves: the sum over D never leaves the block. One block an SM.
//   * rwkv_mix_seam: dx at each tile's last row needs Q at the next tile's
//     first. The backward leaves sum dy - Q of that row and Q of each tile's
//     first row in an f32 workspace [2][tiles][D]; this second launch adds
//     them (within a sequence) and writes those rows of dx.
//   * rwkv_mix_ew_fwd<T, P> / rwkv_mix_ew_bwd<T, P>, elementwise, float32
//     and bfloat16: the channel mix (no lr), and with P the time mix where
//     the tile kernels do not run (float32, whose products the tensor cores
//     would round, or another rank), the products P_i = lr_i B_i handed in
//     as [K, N, D] by the wrapper's batched GEMM, which also forms dlr_i =
//     G_i B_i^T from the G_i = dy_i (xs - x) the backward writes. One thread
//     per 16-byte vector of channels walks 8 rows, the row above (or below,
//     for the shift's transpose) carried in registers.
// Against the tile kernels, the elementwise route for bf16 (the products
// and dlr in cuBLAS, P and G through device memory) took 0.78 and 2.21 ms
// against 0.48 and 1.37, and 2.0 GiB of peak against 0.8 (PERF.md, row 11).
// What the tile kernels are bound by is not known (no ncu on the card's
// machine). Tried on the card and slower or no faster: 64-column chunks,
// 3-5 chunk buffers, a staggered walk, one warp per (16 rows, i) in both
// kernels, direct 4-byte stores of the outputs, lr's fragments held in
// registers (PERF.md, row 11).
// Numbers: loads in T, every sum and product in f32, one rounding to T on
// each store (the composition rounded after every operation). The tensor
// cores take lr and B as they are (bf16, exact) and G as hi + lo; the
// elementwise route's P and G are rounded to T once each.
// No atomics: every sum runs in a fixed order, so two calls give the same
// bytes. Each launch allocates nothing; the C entry points return the
// first cudaGetLastError() that is not 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int MAX_K = 5;
constexpr int BM = 64;                  // rows of a block's tile
constexpr int BN = 32;                  // columns of a chunk
constexpr int LD = BN + 8;              // a chunk tile's row, elements (80 B)
constexpr int NT = BN / 8;              // n8 tiles (and 16-byte vectors) a row
constexpr int M_WARPS = BM / 16;        // m-warps: 16 rows each
constexpr int G_WARPS = 2 * MAX_K;      // G-warps: (32-row half, i)
constexpr int FWD_THREADS = M_WARPS * 32;
constexpr int BWD_THREADS = (M_WARPS + G_WARPS) * 32;
constexpr int EW_THREADS = 256;
constexpr int EW_ROWS = 8;              // rows a thread walks, no lr
constexpr int SEAM_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct Args {
  const T* x;               // [N, D]
  const T* prev;            // [N / seq, D], or null: zeros
  const T* lr;              // [N, K R], or null: the channel mix
  const T* lb;              // [K, R, D]
  const T* prod;            // [K, N, D]: lr_i B_i, given (elementwise)
  const T* mix[MAX_K];      // [D] each
  T* out[MAX_K];            // [N, D] each (forward)
  const T* dy[MAX_K];       // [N, D] each (backward)
  T* dx;                    // [N, D]
  T* dlr;                   // [N, K R]
  T* g;                     // [K, N, D]: dy_i (xs - x) (elementwise, prod)
  float* dprev;             // [N / seq, D], or null
  float* plast;             // [tiles, D]: sum dy - Q at a tile's last row
  float* qfirst;            // [tiles, D]: Q at a tile's first row
  int64_t n;
  int d, seq, k;
};
using TArgs = Args<bf16>;   // the tile kernels'

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, f32 sums
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float2 ld2(const bf16* p) {     // shared
  return __bfloat1622float2(*reinterpret_cast<const bf162*>(p));
}
__device__ __forceinline__ float2 ldg2(const bf16* p) {    // global
  return __bfloat1622float2(__ldg(reinterpret_cast<const bf162*>(p)));
}
__device__ __forceinline__ uint32_t pack2(bf162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ void unpack8(uint4 raw, float (&v)[8]) {
  const bf162* h = reinterpret_cast<const bf162*>(&raw);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    v[2 * q] = f.x;
    v[2 * q + 1] = f.y;
  }
}
__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  uint4 raw;
  bf162* h = reinterpret_cast<bf162*>(&raw);
#pragma unroll
  for (int q = 0; q < 4; ++q) h[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
  return raw;
}

// A row of the tile as the shift sees it: its index, whether it starts a
// sequence (then xs is prev[b], or zeros) and whether the next one does.
struct Row {
  int64_t n, b;
  bool start, next_start;
};
__device__ __forceinline__ Row row_of(const TArgs& a, int64_t n) {
  Row r;
  r.n = n;
  r.b = n / a.seq;
  r.start = n - r.b * a.seq == 0;
  r.next_start = n + 1 - (n + 1) / a.seq * a.seq == 0;
  return r;
}
// xs at (row j of the tile, local column lc, global column col) as two
// floats; the chunk's x tile holds the row above the tile in its row 0
__device__ __forceinline__ float2 shifted(const TArgs& a, const bf16* xt,
                                          int j, const Row& r, int lc, int col) {
  if (!r.start) return ld2(xt + j * LD + lc);
  if (a.prev == nullptr || col >= a.d) return make_float2(0.f, 0.f);
  return ldg2(a.prev + r.b * a.d + col);
}

// ---------------------------------------------------------------------------
// Staging by cp.async (16-byte vectors, zeros past N and past D)
// ---------------------------------------------------------------------------
template <int R>
__device__ __forceinline__ void load_lr(const TArgs& a, bf16* lrs, int ldr,
                                        int64_t t0, int tid, int nthr) {
  const int kr = a.k * R, vr = kr / 8;
  for (int q = tid; q < BM * vr; q += nthr) {
    const int j = q / vr, v = q % vr;
    const int64_t n = t0 + j;
    const bool ok = n < a.n;
    cp16(lrs + j * ldr + v * 8, ok ? a.lr + n * kr + v * 8 : a.lr, ok);
  }
}

// A chunk buffer: B_i rows [K R][LD], x rows t0 - 1 .. t0 + BM - 1
// [BM + 1][LD], the mixes [MAX_K][BN] and, in the backward, the dy_i rows
// t0 .. t0 + BM - 1 [K BM][LD]
struct Chunk {
  bf16 *b, *x, *m, *dy;
};
template <int R>
__device__ __forceinline__ Chunk chunk_at(bf16* base, int k, bool with_dy,
                                          int s) {
  const int elems = k * R * LD + (BM + 1) * LD + MAX_K * BN +
                    (with_dy ? k * BM * LD : 0);
  Chunk c;
  c.b = base + s * elems;
  c.x = c.b + k * R * LD;
  c.m = c.x + (BM + 1) * LD;
  c.dy = with_dy ? c.m + MAX_K * BN : nullptr;
  return c;
}

// chunk c0 into buffer c, as one cp.async group
template <int R>
__device__ __forceinline__ void load_chunk(const TArgs& a, const Chunk& c,
                                           int64_t t0, int c0, int tid,
                                           int nthr) {
  for (int q = tid; q < (BM + 1) * NT; q += nthr) {
    const int j = q / NT, col = c0 + (q % NT) * 8;
    const int64_t n = t0 - 1 + j;
    const bool ok = n >= 0 && n < a.n && col < a.d;
    cp16(c.x + j * LD + (q % NT) * 8, ok ? a.x + n * a.d + col : a.x, ok);
  }
  for (int q = tid; q < a.k * R * NT; q += nthr) {
    const int row = q / NT, col = c0 + (q % NT) * 8;
    const bool ok = col < a.d;
    cp16(c.b + row * LD + (q % NT) * 8,
         ok ? a.lb + static_cast<int64_t>(row) * a.d + col : a.lb, ok);
  }
  if (tid < MAX_K * NT) {
    const int i = tid / NT, col = c0 + (tid % NT) * 8;
    const bf16* src = a.x;
#pragma unroll
    for (int q = 0; q < MAX_K; ++q)     // a.mix[i] without indexing the
      if (q == i) src = a.mix[q] + col;  // parameters at run time
    const bool ok = i < a.k && col < a.d;
    cp16(c.m + i * BN + (tid % NT) * 8, ok ? src : a.x, ok);
  }
  if (c.dy != nullptr) {
#pragma unroll
    for (int i = 0; i < MAX_K; ++i) {
      if (i >= a.k) break;
      const bf16* src = a.dy[i];
      bf16* dst = c.dy + i * BM * LD;
      for (int q = tid; q < BM * NT; q += nthr) {
        const int j = q / NT, col = c0 + (q % NT) * 8;
        const int64_t n = t0 + j;
        const bool ok = n < a.n && col < a.d;
        cp16(dst + j * LD + (q % NT) * 8, ok ? src + n * a.d + col : src, ok);
      }
    }
  }
  cp_commit();
}

// acc[16 x 32] = lr_i[rows 16 w ..][R] . B_i[R][chunk]
template <int R>
__device__ __forceinline__ void mix_product(float (&acc)[NT][4],
                                            const bf16* lrs, int ldr,
                                            const bf16* bt, int i, int w,
                                            int lane) {
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, lrs + (16 * w + (lane & 15)) * ldr + i * R + kk * 16 +
                        (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, bt + (i * R + kk * 16 + (lane & 15)) * LD +
                               np * 16 + (lane >> 4) * 8);
      mma(acc[2 * np], af, b[0], b[1]);
      mma(acc[2 * np + 1], af, b[2], b[3]);
    }
  }
}

// a warp's 16 staged rows [16][LD] to out's rows r0 .. r0 + 15 as 16-byte
// vectors, but for the row `skip` of the warp (-1: none)
__device__ __forceinline__ void store_rows(const TArgs& a, const bf16* st,
                                           bf16* out, int64_t r0, int c0,
                                           int lane, int skip) {
#pragma unroll
  for (int q = lane; q < 16 * NT; q += 32) {
    const int j = q / NT, col = c0 + (q % NT) * 8;
    const int64_t n = r0 + j;
    if (n < a.n && col < a.d && j != skip)
      *reinterpret_cast<uint4*>(out + n * a.d + col) =
          *reinterpret_cast<const uint4*>(st + j * LD + (q % NT) * 8);
  }
}

template <int R> __host__ __device__ constexpr int lr_ld(int k) {
  return k * R + 8;
}
template <int R> __host__ __device__ constexpr int fwd_smem(int k) {
  return 2 * (BM * lr_ld<R>(k) +
              2 * (k * R * LD + (BM + 1) * LD + MAX_K * BN) + BM * LD);
}
template <int R> __host__ __device__ constexpr int bwd_smem(int k) {
  return 2 * (BM * lr_ld<R>(k) +
              2 * (k * R * LD + (BM + 1) * LD + MAX_K * BN + k * BM * LD) +
              BM * LD) + 4 * M_WARPS * BN;
}

// ---------------------------------------------------------------------------
// Forward with lr: the time mix
// ---------------------------------------------------------------------------
template <int R>
__global__ void __launch_bounds__(FWD_THREADS, 2) rwkv_mix_fwd(const TArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldr = lr_ld<R>(a.k);
  bf16* lrs = reinterpret_cast<bf16*>(smem);             // [BM][ldr]
  bf16* bufs = lrs + BM * ldr;                            // two Chunks
  bf16* sts = chunk_at<R>(bufs, a.k, false, 2).b;         // [BM][LD]
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int nch = (a.d + BN - 1) / BN;
  const Row rows[2] = {row_of(a, t0 + 16 * w + g), row_of(a, t0 + 16 * w + g + 8)};
  bf16* st = sts + 16 * w * LD;

  load_lr<R>(a, lrs, ldr, t0, tid, FWD_THREADS);
  load_chunk<R>(a, chunk_at<R>(bufs, a.k, false, 0), t0, 0, tid, FWD_THREADS);
  for (int ch = 0; ch < nch; ++ch) {
    const int c0 = ch * BN;
    cp_wait_all();
    __syncthreads();    // chunk ch is in; every warp is done with ch - 1
    if (ch + 1 < nch)
      load_chunk<R>(a, chunk_at<R>(bufs, a.k, false, (ch + 1) & 1), t0,
                    c0 + BN, tid, FWD_THREADS);
    const Chunk c = chunk_at<R>(bufs, a.k, false, ch & 1);

    float xv[NT][4], dv[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 16 * w + g + 8 * h, lc = t * 8 + c2;
        const float2 xx = ld2(c.x + (j + 1) * LD + lc);
        const float2 ss = shifted(a, c.x, j, rows[h], lc, c0 + lc);
        xv[t][2 * h] = xx.x;
        xv[t][2 * h + 1] = xx.y;
        dv[t][2 * h] = ss.x - xx.x;
        dv[t][2 * h + 1] = ss.y - xx.y;
      }
    // the product of mix i + 1 is issued before mix i's outputs are formed
    // and stored, so that the tensor cores overlap the stores
    float acc[2][NT][4];
    mix_product<R>(acc[0], lrs, ldr, c.b, 0, w, lane);
#pragma unroll
    for (int i = 0; i < MAX_K; ++i) {
      if (i >= a.k) break;
      if (i + 1 < MAX_K && i + 1 < a.k)
        mix_product<R>(acc[(i + 1) & 1], lrs, ldr, c.b, i + 1, w, lane);
      float (&ac)[NT][4] = acc[i & 1];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int lc = t * 8 + c2;
        const float2 mv = ld2(c.m + i * BN + lc);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float y0 = fmaf(dv[t][2 * h], ac[t][2 * h] + mv.x, xv[t][2 * h]);
          const float y1 =
              fmaf(dv[t][2 * h + 1], ac[t][2 * h + 1] + mv.y, xv[t][2 * h + 1]);
          *reinterpret_cast<bf162*>(st + (g + 8 * h) * LD + lc) =
              __floats2bfloat162_rn(y0, y1);
        }
      }
      __syncwarp();
      store_rows(a, st, a.out[i], t0 + 16 * w, c0, lane, -1);
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// Backward with lr: dx (but for each tile's last row), dprev, dlr
// ---------------------------------------------------------------------------
template <int R>
__global__ void __launch_bounds__(BWD_THREADS, 1) rwkv_mix_bwd(const TArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldr = lr_ld<R>(a.k);
  bf16* lrs = reinterpret_cast<bf16*>(smem);             // [BM][ldr]
  bf16* bufs = lrs + BM * ldr;                            // two Chunks
  bf16* sts = chunk_at<R>(bufs, a.k, true, 2).b;          // [BM][LD]
  float* qrow = reinterpret_cast<float*>(sts + BM * LD);  // [M_WARPS][BN]
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int nch = (a.d + BN - 1) / BN;
  const bool mwarp = w < M_WARPS;
  // G-warp: mix gi, rows 32 gh .. 32 gh + 31 of the tile
  const int gi = (w - M_WARPS) % MAX_K, gh = (w - M_WARPS) / MAX_K;
  const bool gwarp = !mwarp && gi < a.k;
  // the thread's rows: an m-warp's 16 w + g + 8 h (h < 2); a G-warp's
  // 32 gh + 16 mt + g + 8 h as rows[2 mt + h]
  Row rows[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    rows[q] = row_of(a, t0 + (mwarp ? 16 * w + g + 8 * (q & 1)
                                    : 32 * gh + 16 * (q >> 1) + g + 8 * (q & 1)));
  float dl[2][R / 8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int t = 0; t < R / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) dl[mt][t][e] = 0.f;

  load_lr<R>(a, lrs, ldr, t0, tid, BWD_THREADS);
  load_chunk<R>(a, chunk_at<R>(bufs, a.k, true, 0), t0, 0, tid, BWD_THREADS);
  for (int ch = 0; ch < nch; ++ch) {
    const int c0 = ch * BN;
    cp_wait_all();
    __syncthreads();    // chunk ch is in; every warp is done with ch - 1
    if (ch + 1 < nch)
      load_chunk<R>(a, chunk_at<R>(bufs, a.k, true, (ch + 1) & 1), t0,
                    c0 + BN, tid, BWD_THREADS);
    const Chunk c = chunk_at<R>(bufs, a.k, true, ch & 1);

    if (mwarp) {
      float q[NT][4], sd[NT][4];
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) q[t][e] = sd[t][e] = 0.f;
#pragma unroll
      for (int i = 0; i < MAX_K; ++i) {
        if (i >= a.k) break;
        float acc[NT][4];
        mix_product<R>(acc, lrs, ldr, c.b, i, w, lane);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int lc = t * 8 + c2;
          const float2 mv = ld2(c.m + i * BN + lc);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 d = ld2(c.dy + (i * BM + 16 * w + g + 8 * h) * LD + lc);
            q[t][2 * h] = fmaf(d.x, acc[t][2 * h] + mv.x, q[t][2 * h]);
            q[t][2 * h + 1] = fmaf(d.y, acc[t][2 * h + 1] + mv.y, q[t][2 * h + 1]);
            sd[t][2 * h] += d.x;
            sd[t][2 * h + 1] += d.y;
          }
        }
      }
      // Q of the warp's first row, for the warp above
      if (g == 0) {
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          qrow[w * BN + t * 8 + c2] = q[t][0];
          qrow[w * BN + t * 8 + c2 + 1] = q[t][1];
        }
      }
      asm volatile("bar.sync 1, %0;\n" :: "n"(M_WARPS * 32));
      bf16* st = sts + 16 * w * LD;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int lc = t * 8 + c2, col = c0 + lc;
        float dxv[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float lo = q[t][e], hi = q[t][2 + e];
          const float dlo = __shfl_down_sync(FULL, lo, 4);
          const float dhi = __shfl_down_sync(FULL, hi, 4);
          const float row8 = __shfl_sync(FULL, hi, lane & 3);
          // Q of rows g + 1 and g + 9: the next lane group's, or row 8's
          // (lane group 0's second row), or the next warp's first (the
          // tile's last row: the seam's)
          float nlo = g < 7 ? dlo : row8;
          float nhi = g < 7 ? dhi
                            : (w + 1 < M_WARPS ? qrow[(w + 1) * BN + lc + e] : 0.f);
          if (rows[0].next_start) nlo = 0.f;
          if (rows[1].next_start) nhi = 0.f;
          dxv[e] = sd[t][e] - lo + nlo;
          dxv[2 + e] = sd[t][2 + e] - hi + nhi;
        }
        if (col < a.d) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (rows[h].start && a.dprev != nullptr && rows[h].n < a.n) {
              a.dprev[rows[h].b * a.d + col] = q[t][2 * h];
              a.dprev[rows[h].b * a.d + col + 1] = q[t][2 * h + 1];
            }
          }
          if (w == 0 && g == 0) {
            a.qfirst[blockIdx.x * static_cast<int64_t>(a.d) + col] = q[t][0];
            a.qfirst[blockIdx.x * static_cast<int64_t>(a.d) + col + 1] = q[t][1];
          }
          if (w == M_WARPS - 1 && g == 7 && rows[1].n < a.n) {
            a.plast[blockIdx.x * static_cast<int64_t>(a.d) + col] = sd[t][2] - q[t][2];
            a.plast[blockIdx.x * static_cast<int64_t>(a.d) + col + 1] =
                sd[t][3] - q[t][3];
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<bf162*>(st + (g + 8 * h) * LD + lc) =
              __floats2bfloat162_rn(dxv[2 * h], dxv[2 * h + 1]);
      }
      __syncwarp();
      store_rows(a, st, a.dx, t0 + 16 * w, c0, lane,
                 w == M_WARPS - 1 ? 15 : -1);
    } else if (gwarp) {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        // A of both 16-row halves: a[mt][r] at row g + 8 (r & 1), column
        // + 8 (r >> 1); each B fragment then serves both
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int h = r & 1, j = 32 * gh + 16 * mt + g + 8 * h;
            const int lc = kk * 16 + (r >> 1) * 8 + c2;
            const float2 xx = ld2(c.x + (j + 1) * LD + lc);
            const float2 ss = shifted(a, c.x, j, rows[2 * mt + h], lc, c0 + lc);
            const float2 d = ld2(c.dy + (gi * BM + j) * LD + lc);
            const float g0 = d.x * (ss.x - xx.x), g1 = d.y * (ss.y - xx.y);
            const bf162 hi = __floats2bfloat162_rn(g0, g1);
            const float2 hf = __bfloat1622float2(hi);
            ahi[mt][r] = pack2(hi);
            alo[mt][r] = pack2(__floats2bfloat162_rn(g0 - hf.x, g1 - hf.y));
          }
#pragma unroll
        for (int np = 0; np < R / 16; ++np) {
          uint32_t b[4];
          ldmatrix_x4(b, c.b + (gi * R + np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                             kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma(dl[mt][2 * np], ahi[mt], b[0], b[1]);
            mma(dl[mt][2 * np + 1], ahi[mt], b[2], b[3]);
            mma(dl[mt][2 * np], alo[mt], b[0], b[1]);
            mma(dl[mt][2 * np + 1], alo[mt], b[2], b[3]);
          }
        }
      }
    }
  }
  if (!gwarp) return;
  const int kr = a.k * R;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t n = rows[2 * mt + h].n;
      if (n >= a.n) continue;
#pragma unroll
      for (int t = 0; t < R / 8; ++t)
        *reinterpret_cast<bf162*>(a.dlr + n * kr + gi * R + t * 8 + c2) =
            __floats2bfloat162_rn(dl[mt][t][2 * h], dl[mt][t][2 * h + 1]);
    }
}

// dx at each whole tile's last row: its sum dy - Q plus, within the
// sequence, Q of the next tile's first row
__global__ void __launch_bounds__(SEAM_THREADS) rwkv_mix_seam(const TArgs a) {
  const int col = blockIdx.y * SEAM_THREADS + threadIdx.x;
  const int64_t tile = blockIdx.x;
  const int64_t n = tile * BM + BM - 1;
  if (col >= a.d || n >= a.n) return;
  float v = a.plast[tile * a.d + col];
  if (n + 1 < a.n && (n + 1) % a.seq != 0) v += a.qfirst[(tile + 1) * a.d + col];
  a.dx[n * a.d + col] = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// Elementwise: without lr (the channel mix), or with the products P_i =
// lr_i B_i given per row, [K, N, D] (the time mix where the tile kernels do
// not run: float32, or a rank they are not built for). One thread per
// 16-byte vector of channels walks EW_ROWS rows, the row above (or below,
// for the shift's transpose) carried in registers.
// ---------------------------------------------------------------------------
template <typename T> struct Vec;       // 16 bytes of T as floats
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(uint4 r, float (&v)[4]) {
    v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
  }
  __device__ static uint4 pack(const float (&v)[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};
template <> struct Vec<bf16> {
  static constexpr int N = 8;
  __device__ static void unpack(uint4 r, float (&v)[8]) { unpack8(r, v); }
  __device__ static uint4 pack(const float (&v)[8]) { return pack8(v); }
};

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]) {
  Vec<T>::unpack(__ldg(reinterpret_cast<const uint4*>(p)), v);
}
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  *reinterpret_cast<uint4*>(p) = Vec<T>::pack(v);
}

template <typename T, int V>
__device__ __forceinline__ void load_mix(const Args<T>& a, int col,
                                         float (&m)[MAX_K][V]) {
#pragma unroll
  for (int i = 0; i < MAX_K; ++i) {
    if (i < a.k) {
      load_vec<T, V>(a.mix[i] + col, m[i]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) m[i][e] = 0.f;
    }
  }
}
template <typename T, int V>
__device__ __forceinline__ void load_prev(const Args<T>& a, int64_t b, int col,
                                          float (&s)[V]) {
  if (a.prev != nullptr) {
    load_vec<T, V>(a.prev + b * a.d + col, s);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) s[e] = 0.f;
  }
}

template <typename T, bool P>
__global__ void __launch_bounds__(EW_THREADS) rwkv_mix_ew_fwd(const Args<T> a) {
  constexpr int V = Vec<T>::N;
  const int col = (blockIdx.y * EW_THREADS + threadIdx.x) * V;
  if (col >= a.d) return;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * EW_ROWS;
  const int64_t nd = a.n * a.d;
  float m[MAX_K][V];
  load_mix<T, V>(a, col, m);
  uint4 raw[EW_ROWS + 1];                 // rows n0 - 1 .. n0 + EW_ROWS - 1
#pragma unroll
  for (int r = 0; r <= EW_ROWS; ++r) {
    const int64_t n = n0 - 1 + r;
    raw[r] = n >= 0 && n < a.n
                 ? __ldg(reinterpret_cast<const uint4*>(a.x + n * a.d + col))
                 : make_uint4(0, 0, 0, 0);
  }
  float s[V];
  Vec<T>::unpack(raw[0], s);
  int64_t pos = n0 % a.seq;
#pragma unroll
  for (int r = 0; r < EW_ROWS; ++r) {
    const int64_t n = n0 + r;
    if (n >= a.n) break;
    float xv[V];
    Vec<T>::unpack(raw[r + 1], xv);
    if (pos == 0) load_prev<T, V>(a, n / a.seq, col, s);
#pragma unroll
    for (int i = 0; i < MAX_K; ++i) {
      if (i >= a.k) break;
      float mi[V], y[V];
      if (P) {
        load_vec<T, V>(a.prod + i * nd + n * a.d + col, mi);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) mi[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) y[e] = fmaf(s[e] - xv[e], m[i][e] + mi[e], xv[e]);
      store_vec<T, V>(a.out[i] + n * a.d + col, y);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) s[e] = xv[e];
    if (++pos == a.seq) pos = 0;
  }
}

// the sums of row n over i: p = sum dy_i (1 - m_i), q = sum dy_i m_i; with
// d0 (xs - x of the row) also G_i = dy_i d0 stored
template <typename T, bool P, int V>
__device__ __forceinline__ void ew_sums(const Args<T>& a, int64_t n, int col,
                                        const float (&m)[MAX_K][V],
                                        const float* d0, float (&p)[V],
                                        float (&q)[V]) {
#pragma unroll
  for (int e = 0; e < V; ++e) p[e] = q[e] = 0.f;
  if (n >= a.n) return;
  const int64_t nd = a.n * a.d;
#pragma unroll
  for (int i = 0; i < MAX_K; ++i) {
    if (i >= a.k) break;
    float d[V], mi[V];
    load_vec<T, V>(a.dy[i] + n * a.d + col, d);
    if (P) {
      load_vec<T, V>(a.prod + i * nd + n * a.d + col, mi);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) mi[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      mi[e] += m[i][e];
      q[e] = fmaf(d[e], mi[e], q[e]);
      p[e] = fmaf(d[e], 1.f - mi[e], p[e]);
    }
    if (P && d0 != nullptr) {
      float gv[V];
#pragma unroll
      for (int e = 0; e < V; ++e) gv[e] = d[e] * d0[e];
      store_vec<T, V>(a.g + i * nd + n * a.d + col, gv);
    }
  }
}

// x[n] into xv and xs - x of row n into d0, `above` holding x[n - 1]
template <typename T, int V>
__device__ __forceinline__ void ew_delta(const Args<T>& a, int64_t n, int col,
                                         const float (&above)[V], float (&xv)[V],
                                         float (&d0)[V]) {
  load_vec<T, V>(a.x + n * a.d + col, xv);
  float s[V];
  if (n % a.seq == 0) {
    load_prev<T, V>(a, n / a.seq, col, s);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) s[e] = above[e];
  }
#pragma unroll
  for (int e = 0; e < V; ++e) d0[e] = s[e] - xv[e];
}

template <typename T, bool P>
__global__ void __launch_bounds__(EW_THREADS) rwkv_mix_ew_bwd(const Args<T> a) {
  constexpr int V = Vec<T>::N;
  const int col = (blockIdx.y * EW_THREADS + threadIdx.x) * V;
  if (col >= a.d) return;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * EW_ROWS;
  float m[MAX_K][V];
  load_mix<T, V>(a, col, m);
  // with P: x of the row in hand, xs - x of the row whose sums are formed;
  // G only for the block's own rows
  float xv[V] = {}, d0[V] = {};
  if (P) {
    float above[V] = {};
    if (n0 % a.seq != 0) load_vec<T, V>(a.x + (n0 - 1) * a.d + col, above);
    ew_delta<T, V>(a, n0, col, above, xv, d0);
  }
  float p[V], q[V];
  ew_sums<T, P, V>(a, n0, col, m, P ? d0 : nullptr, p, q);
  int64_t pos = n0 % a.seq;
#pragma unroll 1
  for (int r = 0; r < EW_ROWS; ++r) {
    const int64_t n = n0 + r;
    if (n >= a.n) break;
    const bool own = r + 1 < EW_ROWS && n + 1 < a.n;
    if (P && own) {
      float above[V];
#pragma unroll
      for (int e = 0; e < V; ++e) above[e] = xv[e];
      ew_delta<T, V>(a, n + 1, col, above, xv, d0);
    }
    float pn[V], qn[V];
    ew_sums<T, P, V>(a, n + 1, col, m, P && own ? d0 : nullptr, pn, qn);
    const bool next = n + 1 < a.n && pos + 1 != a.seq;
    float dxv[V];
#pragma unroll
    for (int e = 0; e < V; ++e) dxv[e] = next ? p[e] + qn[e] : p[e];
    store_vec<T, V>(a.dx + n * a.d + col, dxv);
    if (pos == 0 && a.dprev != nullptr) {
      float* dp = a.dprev + (n / a.seq) * a.d + col;
#pragma unroll
      for (int e = 0; e < V; ++e) dp[e] = q[e];
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      p[e] = pn[e];
      q[e] = qn[e];
    }
    if (++pos == a.seq) pos = 0;
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------
template <int R>
cudaError_t launch_fwd(const TArgs& a, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      rwkv_mix_fwd<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      fwd_smem<R>(MAX_K));
  if (attr != cudaSuccess) return attr;
  const unsigned tiles = static_cast<unsigned>((a.n + BM - 1) / BM);
  rwkv_mix_fwd<R><<<tiles, FWD_THREADS, fwd_smem<R>(a.k), s>>>(a);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_bwd(const TArgs& a, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      rwkv_mix_bwd<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bwd_smem<R>(MAX_K));
  if (attr != cudaSuccess) return attr;
  const unsigned tiles = static_cast<unsigned>((a.n + BM - 1) / BM);
  rwkv_mix_bwd<R><<<tiles, BWD_THREADS, bwd_smem<R>(a.k), s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles, (a.d + SEAM_THREADS - 1) / SEAM_THREADS);
  rwkv_mix_seam<<<grid, SEAM_THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T, bool P>
cudaError_t launch_ew(const Args<T>& a, bool backward, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((a.n + EW_ROWS - 1) / EW_ROWS),
                  (a.d / Vec<T>::N + EW_THREADS - 1) / EW_THREADS);
  if (backward)
    rwkv_mix_ew_bwd<T, P><<<grid, EW_THREADS, 0, s>>>(a);
  else
    rwkv_mix_ew_fwd<T, P><<<grid, EW_THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

// The pointers of one call. Exactly one of lr (the tile kernels: bf16, r 32
// or 64) and prod (the elementwise kernels with P) with the time mix,
// neither with the channel mix.
struct Ptrs {
  const void *x, *prev, *lr, *lb, *prod;
  const void* mix[MAX_K];
  void* out[MAX_K];
  const void* dy[MAX_K];
  void *dx, *dlr, *g, *dprev, *work;
};

template <typename T>
Args<T> args_of(const Ptrs& p, int64_t n, int d, int seq, int k) {
  Args<T> a = {};
  a.x = static_cast<const T*>(p.x);
  a.prev = static_cast<const T*>(p.prev);
  a.lr = static_cast<const T*>(p.lr);
  a.lb = static_cast<const T*>(p.lb);
  a.prod = static_cast<const T*>(p.prod);
  for (int i = 0; i < MAX_K; ++i) {
    a.mix[i] = static_cast<const T*>(p.mix[i]);
    a.out[i] = static_cast<T*>(p.out[i]);
    a.dy[i] = static_cast<const T*>(p.dy[i]);
  }
  a.dx = static_cast<T*>(p.dx);
  a.dlr = static_cast<T*>(p.dlr);
  a.g = static_cast<T*>(p.g);
  a.dprev = static_cast<float*>(p.dprev);
  a.plast = static_cast<float*>(p.work);
  a.qfirst = a.plast == nullptr ? nullptr : a.plast + (n + BM - 1) / BM * d;
  a.n = n; a.d = d; a.seq = seq; a.k = k;
  return a;
}

template <typename T>
cudaError_t launch_elementwise(const Ptrs& p, int64_t n, int d, int seq,
                               int k, bool backward, cudaStream_t s) {
  if (d % Vec<T>::N != 0 || (backward && (p.prod == nullptr) != (p.g == nullptr)))
    return cudaErrorInvalidValue;
  const Args<T> a = args_of<T>(p, n, d, seq, k);
  return p.prod != nullptr ? launch_ew<T, true>(a, backward, s)
                           : launch_ew<T, false>(a, backward, s);
}

cudaError_t dispatch(const Ptrs& p, int64_t n, int d, int seq, int k, int r,
                     int dtype, bool backward, cudaStream_t s) {
  if (n <= 0 || d <= 0 || seq <= 0 || n % seq != 0 || k < 1 || k > MAX_K ||
      (n + EW_ROWS - 1) / EW_ROWS > INT_MAX ||         // the grids' x
      (p.lr != nullptr && p.prod != nullptr))
    return cudaErrorInvalidValue;
  if (p.lr == nullptr) {
    switch (dtype) {
      case 0: return launch_elementwise<float>(p, n, d, seq, k, backward, s);
      case 1: return launch_elementwise<bf16>(p, n, d, seq, k, backward, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype != 1 || d % 8 != 0 || (backward && p.work == nullptr))
    return cudaErrorInvalidValue;
  const TArgs a = args_of<bf16>(p, n, d, seq, k);
  switch (r) {
    case 32: return backward ? launch_bwd<32>(a, s) : launch_fwd<32>(a, s);
    case 64: return backward ? launch_bwd<64>(a, s) : launch_fwd<64>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The forward: x [n, d] contiguous (rows of sequences of `seq` rows, n a
// multiple of seq, d a multiple of one 16-byte vector, every pointer
// 16-byte aligned), prev [n / seq, d] or null (zeros), the k <= 5 mixes
// [d] and outputs [n, d]: m0..m4 and o0..o4, the unused ones null. With the
// time mix either lr [n, k r] and lb [k, r, d] (bf16, r 32 or 64: the tile
// kernel forms the products) or prod [k, n, d] (the products lr_i B_i);
// with the channel mix neither. dtype 0 float32, 1 bfloat16, every tensor
// of it. One launch on `stream`. Returns a cudaError_t (0 = launched).
extern "C" int rwkv_mix_launch(const void* x, const void* prev, const void* lr,
                               const void* lb, const void* prod,
                               const void* m0, const void* m1, const void* m2,
                               const void* m3, const void* m4, void* o0,
                               void* o1, void* o2, void* o3, void* o4,
                               int64_t n, int d, int seq, int k, int r,
                               int dtype, void* stream) {
  const Ptrs p = {x, prev, lr, lb, prod, {m0, m1, m2, m3, m4},
                  {o0, o1, o2, o3, o4}, {}, nullptr, nullptr, nullptr,
                  nullptr, nullptr};
  return static_cast<int>(dispatch(p, n, d, seq, k, r, dtype, false,
                                   static_cast<cudaStream_t>(stream)));
}

// The backward at dy0..dy4 ([n, d] each, the unused null): dx [n, d] and
// dprev [n / seq, d] float32 (or null: not wanted); with lr, dlr [n, k r]
// and work, float32 scratch of 2 ceil(n / 64) d (two launches: the tiles,
// the seams between them); with prod, g [k, n, d], G_i = dy_i (xs - x),
// whose product with B_i^T is the caller's (one launch); with neither, one
// launch.
extern "C" int rwkv_mix_bwd_launch(const void* x, const void* prev,
                                   const void* lr, const void* lb,
                                   const void* prod, const void* m0,
                                   const void* m1, const void* m2,
                                   const void* m3, const void* m4,
                                   const void* dy0, const void* dy1,
                                   const void* dy2, const void* dy3,
                                   const void* dy4, void* dx, void* dlr,
                                   void* g, void* dprev, void* work,
                                   int64_t n, int d, int seq, int k, int r,
                                   int dtype, void* stream) {
  const Ptrs p = {x, prev, lr, lb, prod, {m0, m1, m2, m3, m4}, {},
                  {dy0, dy1, dy2, dy3, dy4}, dx, dlr, g, dprev, work};
  return static_cast<int>(dispatch(p, n, d, seq, k, r, dtype, true,
                                   static_cast<cudaStream_t>(stream)));
}
