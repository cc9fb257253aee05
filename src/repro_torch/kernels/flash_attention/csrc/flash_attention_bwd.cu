// Flash attention backward for Hopper (sm_90a): dQ, dK, dV of the forward in
// flash_attention.cu (GQA, causal or bidirectional, q_offset), without the
// n^2 scores in device memory.
//
// No TPU kernel computes it: the reference differentiates its plain XLA
// attention. It exists because the port's forward is a hand-written kernel
// that autograd cannot see through (FlashAttentionFn in ../ops.py).
//
// Arithmetic (all f32; scale = 1/sqrt(Dh); masked scores as the forward:
// KV positions at or past skv, and, causal, past q + q_offset):
//   P  = exp(S scale - lse)      recomputed from Q, K and the forward's
//                                per-row log-sum-exp lse [B, Hq, Sq]
//   Di = rowsum(dO o O)          launch (a), f32 [B, Hq, Sq]
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - Di)
//   dK = dS^T Q scale            launch (b), summed over the G = Hq / Hkv
//   dQ = dS K scale              launch (c)        query heads of a KV head
//
// Three launches, no atomics: (b) owns a (batch, KV head, 64-row KV block)
// and loops over the G query heads of its group and over the 32-row query
// blocks the causal mask leaves; (c) owns a (batch, query head, 64-row query
// block) and loops over the 32-row KV blocks. Each output element is summed
// by one thread in a fixed order, so the result is the same every run.
//
// Bound. At llama-7b's training shape (B=4, S=4096, 32 heads of 128, causal,
// bf16) the five products need 5 x 2 x B H (S^2/2) Dh = 2.75e12 operations
// (2.8 ms at 989 TFLOP/s) and the call moves Q, K, V, O, dO in and dQ, dK, dV
// out, 1.07 GB (0.32 ms at 3.35 TB/s): it is bound by operations.
//
// Design: a simple right kernel first. Tiles go from device memory to
// shared memory by 16-byte loads (element loads for unaligned views), rows
// padded by 8 elements to spread the banks. Each warp owns 16 rows of the
// block and computes its products with mma.sync m16n8k16 (f32 accumulators)
// from operands it loads out of shared memory by ldmatrix; the transposed
// operands (dO and Q for dV and dK, K for dQ) by ldmatrix.trans. P and
// dS go through shared memory in the input type between the two products
// that use them. In bf16, P and dS are rounded as hi = bf16(x) plus
// lo = bf16(x - hi) and issued as two products, as the forward splits P:
// one bf16 rounding of every weight (2^-9) exceeds the two-ulp limit the
// gradients are held to over millions of elements. f16 keeps 11 bits and is
// issued once. f32 runs the same tiles with scalar FMAs (no TF32).
// A wgmma/TMA redesign is later work (ROADMAP queue B).
//
// q, k, v, o, dO, dQ, dK, dV are read and written through the (batch, seq,
// head) strides given, head dimension contiguous. The kernel allocates
// nothing: Di is a workspace the wrapper allocates. It launches on the
// caller's stream, and the C entry point returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int KB = 64;    // (b): KV rows per block, 16 a warp
constexpr int QB = 32;    // (b): query rows per step
constexpr int QB2 = 64;   // (c): query rows per block, 16 a warp
constexpr int KB2 = 32;   // (c): KV rows per step
constexpr int PLD = 40;   // row stride of the P / dS tiles (32 + 8)

struct Params {
  const void* q; const void* k; const void* v; const void* o; const void* dout;
  const float* lse; float* di;
  void* dq; void* dk; void* dv;
  // (batch, seq, head) strides in elements, in the order
  // q, k, v, o, dout, dq, dk, dv
  int64_t st[8][3];
  int batch, hq, hkv, sq, skv, group, q_offset, causal;
  float scale, scale_log2;
};
enum { SQ = 0, SK, SV, SO, SDO, SDQ, SDK, SDV };

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// bf16 operands of the P and dS products are split into hi + lo
template <typename T> constexpr bool kSplit = false;
template <> constexpr bool kSplit<__nv_bfloat16> = true;

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

// four 8 x 8 matrices of 16-bit elements from shared memory; lane l gives
// the address of row l % 8 of matrix l / 8. Plain: lane T receives row
// T / 4, columns 2 (T % 4) and +1 of each matrix; .trans: column T / 4,
// rows 2 (T % 4) and +1.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// C[16 x 8 NT] += A[16 x K] B[K x 8 NT] for one warp. A in shared memory
// row-major (row stride lda, k contiguous). B(k, n) at bs[n ldb + k] when
// KC (k contiguous), else at bs[k ldb + n]. c[nt][e] is row g + 8 (e >> 1),
// column 8 nt + 2 t + (e & 1), with g = lane / 4, t = lane % 4 (the mma
// accumulator layout); the f32 instance computes the same elements by
// scalar FMAs. 16 bits: each k-step loads A's fragment with one ldmatrix
// x4, and the B fragments of two n-tiles with one more (.trans when B is
// n-contiguous, as dO, Q and K are in the dV, dK and dQ products); rows
// start on 16-byte boundaries (row strides of DH + 8 and 40 elements,
// which also keep the eight rows of a matrix on distinct banks). NT is
// even.
template <typename T, int NT, int K, bool KC>
__device__ __forceinline__ void warp_mm(float (&c)[NT][4], const T* as, int lda,
                                        const T* bs, int ldb, int lane) {
  if constexpr (sizeof(T) == 4) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
    for (int k = 0; k < K; ++k) {
      const float a0 = as[g * lda + k], a1 = as[(g + 8) * lda + k];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = 8 * nt + 2 * t;
        const float b0 = KC ? bs[n * ldb + k] : bs[k * ldb + n];
        const float b1 = KC ? bs[(n + 1) * ldb + k] : bs[k * ldb + n + 1];
        c[nt][0] = fmaf(a0, b0, c[nt][0]);
        c[nt][1] = fmaf(a0, b1, c[nt][1]);
        c[nt][2] = fmaf(a1, b0, c[nt][2]);
        c[nt][3] = fmaf(a1, b1, c[nt][3]);
      }
    }
  } else {
    static_assert(NT % 2 == 0, "two n-tiles a B load");
    const int l8 = lane & 7, lj = lane >> 3;
#pragma unroll
    for (int kk = 0; kk < K; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, as + (l8 + 8 * (lj & 1)) * lda + kk + 8 * (lj >> 1));
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t b[4];    // b0, b1 of n-tile nt, then of nt + 1
        if (KC)
          ldsm_x4(b, bs + (8 * nt + l8 + 8 * (lj >> 1)) * ldb + kk +
                         8 * (lj & 1));
        else
          ldsm_x4_t(b, bs + (kk + l8 + 8 * (lj & 1)) * ldb + 8 * nt +
                           8 * (lj >> 1));
        mma16816<T>(c[nt], a, b);
        mma16816<T>(c[nt + 1], a, b + 2);
      }
    }
  }
}

// Rows [row0, row0 + ROWS) of a [rows, DH] view (row stride rs elements)
// into shared memory at row stride ld, rows at or past `limit` as zeros; by
// the block's THREADS threads, 16 bytes at a time when `vec`.
template <typename T, int ROWS, int DH>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          int64_t rs, int row0, int limit,
                                          bool vec) {
  constexpr int N = 16 / sizeof(T);
  if (vec) {
    for (int i = threadIdx.x; i < ROWS * (DH / N); i += THREADS) {
      const int r = i / (DH / N), c = (i % (DH / N)) * N;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < limit)
        w = *reinterpret_cast<const uint4*>(src + (row0 + r) * rs + c);
      *reinterpret_cast<uint4*>(dst + r * ld + c) = w;
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DH; i += THREADS) {
      const int r = i / DH, c = i % DH;
      dst[r * ld + c] = row0 + r < limit ? src[(row0 + r) * rs + c]
                                         : from_f32<T>(0.f);
    }
  }
}

// the (row, column) pair of c[nt][e] stored into a [16 x 8 NT] tile of
// shared memory at row stride PLD; bf16: hi into `hi`, lo into `lo`
template <typename T, int NT>
__device__ __forceinline__ void store_tile(T* hi, T* lo, const float (&c)[NT][4],
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int at = (g + 8 * (e >> 1)) * PLD + 8 * nt + 2 * t + (e & 1);
      const T h = from_f32<T>(c[nt][e]);
      hi[at] = h;
      if constexpr (kSplit<T>) lo[at] = from_f32<T>(c[nt][e] - to_f32(h));
    }
  }
}

// ---------------------------------------------------------------------------
// (a) Di = rowsum(dO o O): one warp a (b, h, row)
// ---------------------------------------------------------------------------
template <typename T, int DH>
__global__ void __launch_bounds__(256) attn_bwd_di(const Params p) {
  const int64_t w = (static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= static_cast<int64_t>(p.batch) * p.hq * p.sq) return;
  const int row = static_cast<int>(w % p.sq);
  const int h = static_cast<int>((w / p.sq) % p.hq);
  const int b = static_cast<int>(w / (static_cast<int64_t>(p.sq) * p.hq));
  const T* o = static_cast<const T*>(p.o) + b * p.st[SO][0] +
               row * p.st[SO][1] + h * p.st[SO][2];
  const T* d = static_cast<const T*>(p.dout) + b * p.st[SDO][0] +
               row * p.st[SDO][1] + h * p.st[SDO][2];
  float s = 0.f;
  for (int c = lane; c < DH; c += 32) s += to_f32(o[c]) * to_f32(d[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) p.di[w] = s;
}

// masked P and dS of one warp's [16 x 8 NT] tile; rows r (+8) and columns
// col + ... are positions, `kv_rows` says whether rows are KV (b) or
// queries (c)
__device__ __forceinline__ bool visible(const Params& p, int qpos, int kvpos) {
  return qpos < p.sq && kvpos < p.skv &&
         (!p.causal || kvpos <= qpos + p.q_offset);
}

// ---------------------------------------------------------------------------
// (b) dK, dV: one block a (b, KV head, 64-row KV block)
// ---------------------------------------------------------------------------
template <typename T, int DH>
constexpr int dkdv_smem_bytes() {
  constexpr int LD = DH + 8;
  return (2 * KB * LD + 2 * QB * LD + (kSplit<T> ? 4 : 2) * KB * PLD) *
             static_cast<int>(sizeof(T)) + 2 * QB * static_cast<int>(sizeof(float));
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS) attn_bwd_dkdv(const Params p,
                                                         int vec) {
  constexpr int LD = DH + 8;
  constexpr int ND = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + KB * LD;
  T* qs = vs + KB * LD;
  T* ds = qs + QB * LD;                       // dO
  T* ph = ds + QB * LD;                       // P^T  [KB x QB]
  T* sh = ph + KB * PLD;                      // dS^T
  T* pl = sh + KB * PLD;                      // lo halves (bf16)
  T* sl = kSplit<T> ? pl + KB * PLD : pl;
  float* lse_s = reinterpret_cast<float*>(kSplit<T> ? sl + KB * PLD : pl);
  float* di_s = lse_s + QB;

  const int n_kb = (p.skv + KB - 1) / KB;
  const int kb = blockIdx.x % n_kb;
  const int hk = (blockIdx.x / n_kb) % p.hkv;
  const int b = blockIdx.x / (n_kb * p.hkv);
  const int kv0 = kb * KB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  load_tile<T, KB, DH>(ks, LD, static_cast<const T*>(p.k) + b * p.st[SK][0] +
                       hk * p.st[SK][2], p.st[SK][1], kv0, p.skv, vec);
  load_tile<T, KB, DH>(vs, LD, static_cast<const T*>(p.v) + b * p.st[SV][0] +
                       hk * p.st[SV][2], p.st[SV][1], kv0, p.skv, vec);

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  int q_start = 0;
  if (p.causal) q_start = max(0, kv0 - p.q_offset) / QB * QB;
  const int r0 = 16 * warp;                   // the warp's KV rows
  for (int hh = 0; hh < p.group; ++hh) {
    const int h = hk * p.group + hh;
    const T* qg = static_cast<const T*>(p.q) + b * p.st[SQ][0] + h * p.st[SQ][2];
    const T* dg = static_cast<const T*>(p.dout) + b * p.st[SDO][0] +
                  h * p.st[SDO][2];
    const int64_t row_at = (static_cast<int64_t>(b) * p.hq + h) * p.sq;
    for (int q0 = q_start; q0 < p.sq; q0 += QB) {
      __syncthreads();              // the previous step's reads are done
      load_tile<T, QB, DH>(qs, LD, qg, p.st[SQ][1], q0, p.sq, vec);
      load_tile<T, QB, DH>(ds, LD, dg, p.st[SDO][1], q0, p.sq, vec);
      if (threadIdx.x < QB) {
        const int q = q0 + threadIdx.x;
        lse_s[threadIdx.x] = q < p.sq ? p.lse[row_at + q] * LOG2E : 0.f;
        di_s[threadIdx.x] = q < p.sq ? p.di[row_at + q] : 0.f;
      }
      __syncthreads();
      float s[QB / 8][4], dp[QB / 8][4];
#pragma unroll
      for (int j = 0; j < QB / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      warp_mm<T, QB / 8, DH, true>(s, ks + r0 * LD, LD, qs, LD, lane);
      warp_mm<T, QB / 8, DH, true>(dp, vs + r0 * LD, LD, ds, LD, lane);
#pragma unroll
      for (int j = 0; j < QB / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kvpos = kv0 + r0 + g + 8 * (e >> 1);
          const int qi = 8 * j + 2 * t + (e & 1);
          float pe = 0.f;
          if (visible(p, q0 + qi, kvpos))
            pe = exp2f(fmaf(s[j][e], p.scale_log2, -lse_s[qi]));
          s[j][e] = pe;
          dp[j][e] = pe * (dp[j][e] - di_s[qi]);
        }
      }
      store_tile<T, QB / 8>(ph + r0 * PLD, pl + r0 * PLD, s, lane);
      store_tile<T, QB / 8>(sh + r0 * PLD, sl + r0 * PLD, dp, lane);
      __syncwarp();
      warp_mm<T, ND, QB, false>(dv, ph + r0 * PLD, PLD, ds, LD, lane);
      warp_mm<T, ND, QB, false>(dk, sh + r0 * PLD, PLD, qs, LD, lane);
      if constexpr (kSplit<T>) {
        warp_mm<T, ND, QB, false>(dv, pl + r0 * PLD, PLD, ds, LD, lane);
        warp_mm<T, ND, QB, false>(dk, sl + r0 * PLD, PLD, qs, LD, lane);
      }
    }
  }

  T* dkg = static_cast<T*>(p.dk) + b * p.st[SDK][0] + hk * p.st[SDK][2];
  T* dvg = static_cast<T*>(p.dv) + b * p.st[SDV][0] + hk * p.st[SDV][2];
#pragma unroll
  for (int j = 0; j < ND; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kvpos = kv0 + r0 + g + 8 * (e >> 1);
      if (kvpos >= p.skv) continue;
      const int c = 8 * j + 2 * t + (e & 1);
      dkg[kvpos * p.st[SDK][1] + c] = from_f32<T>(dk[j][e] * p.scale);
      dvg[kvpos * p.st[SDV][1] + c] = from_f32<T>(dv[j][e]);
    }
  }
}

// ---------------------------------------------------------------------------
// (c) dQ: one block a (b, query head, 64-row query block)
// ---------------------------------------------------------------------------
template <typename T, int DH>
constexpr int dq_smem_bytes() {
  constexpr int LD = DH + 8;
  return (2 * QB2 * LD + 2 * KB2 * LD + (kSplit<T> ? 2 : 1) * QB2 * PLD) *
             static_cast<int>(sizeof(T)) + 2 * QB2 * static_cast<int>(sizeof(float));
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS) attn_bwd_dq(const Params p,
                                                       int vec) {
  constexpr int LD = DH + 8;
  constexpr int ND = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ds = qs + QB2 * LD;                      // dO
  T* ks = ds + QB2 * LD;
  T* vs = ks + KB2 * LD;
  T* sh = vs + KB2 * LD;                      // dS [QB2 x KB2]
  T* sl = kSplit<T> ? sh + QB2 * PLD : sh;
  float* lse_s = reinterpret_cast<float*>(sl + QB2 * PLD);
  float* di_s = lse_s + QB2;

  const int n_qb = (p.sq + QB2 - 1) / QB2;
  const int qb = blockIdx.x % n_qb;
  const int h = (blockIdx.x / n_qb) % p.hq;
  const int b = blockIdx.x / (n_qb * p.hq);
  const int hk = h / p.group;
  const int q0 = qb * QB2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;                   // the warp's query rows

  load_tile<T, QB2, DH>(qs, LD, static_cast<const T*>(p.q) + b * p.st[SQ][0] +
                        h * p.st[SQ][2], p.st[SQ][1], q0, p.sq, vec);
  load_tile<T, QB2, DH>(ds, LD, static_cast<const T*>(p.dout) +
                        b * p.st[SDO][0] + h * p.st[SDO][2], p.st[SDO][1], q0,
                        p.sq, vec);
  const int64_t row_at = (static_cast<int64_t>(b) * p.hq + h) * p.sq;
  if (threadIdx.x < QB2) {
    const int q = q0 + threadIdx.x;
    lse_s[threadIdx.x] = q < p.sq ? p.lse[row_at + q] * LOG2E : 0.f;
    di_s[threadIdx.x] = q < p.sq ? p.di[row_at + q] : 0.f;
  }

  float dq[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  int kv_end = p.skv;
  if (p.causal) kv_end = min(kv_end, min(p.sq, q0 + QB2) + p.q_offset);
  const T* kg = static_cast<const T*>(p.k) + b * p.st[SK][0] + hk * p.st[SK][2];
  const T* vg = static_cast<const T*>(p.v) + b * p.st[SV][0] + hk * p.st[SV][2];
  for (int k0 = 0; k0 < kv_end; k0 += KB2) {
    __syncthreads();
    load_tile<T, KB2, DH>(ks, LD, kg, p.st[SK][1], k0, p.skv, vec);
    load_tile<T, KB2, DH>(vs, LD, vg, p.st[SV][1], k0, p.skv, vec);
    __syncthreads();
    float s[KB2 / 8][4], dp[KB2 / 8][4];
#pragma unroll
    for (int j = 0; j < KB2 / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    warp_mm<T, KB2 / 8, DH, true>(s, qs + r0 * LD, LD, ks, LD, lane);
    warp_mm<T, KB2 / 8, DH, true>(dp, ds + r0 * LD, LD, vs, LD, lane);
#pragma unroll
    for (int j = 0; j < KB2 / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = r0 + g + 8 * (e >> 1);
        const int kvpos = k0 + 8 * j + 2 * t + (e & 1);
        float pe = 0.f;
        if (visible(p, q0 + qi, kvpos))
          pe = exp2f(fmaf(s[j][e], p.scale_log2, -lse_s[qi]));
        dp[j][e] = pe * (dp[j][e] - di_s[qi]);
      }
    }
    store_tile<T, KB2 / 8>(sh + r0 * PLD, sl + r0 * PLD, dp, lane);
    __syncwarp();
    warp_mm<T, ND, KB2, false>(dq, sh + r0 * PLD, PLD, ks, LD, lane);
    if constexpr (kSplit<T>)
      warp_mm<T, ND, KB2, false>(dq, sl + r0 * PLD, PLD, ks, LD, lane);
  }

  T* dqg = static_cast<T*>(p.dq) + b * p.st[SDQ][0] + h * p.st[SDQ][2];
#pragma unroll
  for (int j = 0; j < ND; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = q0 + r0 + g + 8 * (e >> 1);
      if (q >= p.sq) continue;
      dqg[q * p.st[SDQ][1] + 8 * j + 2 * t + (e & 1)] =
          from_f32<T>(dq[j][e] * p.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
template <typename K>
cudaError_t opt_in(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T, int DH>
cudaError_t launch_dh(const Params& p, int vec, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(p.batch) * p.hq * p.sq;
  const int64_t di_blocks = (rows * 32 + 255) / 256;
  const int64_t kv_blocks = static_cast<int64_t>(p.batch) * p.hkv *
                            ((p.skv + KB - 1) / KB);
  const int64_t q_blocks = static_cast<int64_t>(p.batch) * p.hq *
                           ((p.sq + QB2 - 1) / QB2);
  if (di_blocks > 0x7fffffffLL || kv_blocks > 0x7fffffffLL ||
      q_blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  attn_bwd_di<T, DH><<<static_cast<unsigned>(di_blocks), 256, 0, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  constexpr int b1 = dkdv_smem_bytes<T, DH>();
  static const cudaError_t a1 = opt_in(attn_bwd_dkdv<T, DH>, b1);
  if (a1 != cudaSuccess) return a1;
  attn_bwd_dkdv<T, DH><<<static_cast<unsigned>(kv_blocks), THREADS, b1,
                         stream>>>(p, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  constexpr int b2 = dq_smem_bytes<T, DH>();
  static const cudaError_t a2 = opt_in(attn_bwd_dq<T, DH>, b2);
  if (a2 != cudaSuccess) return a2;
  attn_bwd_dq<T, DH><<<static_cast<unsigned>(q_blocks), THREADS, b2,
                       stream>>>(p, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const Params& p, int dh, int vec, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch_dh<T, 32>(p, vec, stream);
    case 64: return launch_dh<T, 64>(p, vec, stream);
    case 112: return launch_dh<T, 112>(p, vec, stream);
    case 128: return launch_dh<T, 128>(p, vec, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The VJP of flash_attention_launch. Pointers: q, k, v, o, dout (inputs), lse
// [B, Hq, Sq] f32 (the forward's), di [B, Hq, Sq] f32 (workspace), dq, dk,
// dv (outputs; dk and dv [B, Skv, Hkv, Dh]). `strides` holds 24 int64: the
// (batch, seq, head) strides in elements of q, k, v, o, dout, dq, dk, dv in
// that order, each view's last dimension contiguous. dtype: 0 = float32,
// 1 = float16, 2 = bfloat16. Three launches; returns a cudaError_t (0 =
// launched).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* di, void* dq, void* dk,
    void* dv, const int64_t* strides, int batch, int sq, int skv, int hq,
    int hkv, int dh, int q_offset, int causal, int dtype, void* stream) {
  if (batch <= 0 || sq <= 0 || skv <= 0 || hq <= 0 || hkv <= 0 ||
      hq % hkv != 0 || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.lse = lse; p.di = di; p.dq = dq; p.dk = dk; p.dv = dv;
  int vec = 1;
  const void* ptrs[8] = {q, k, v, o, dout, dq, dk, dv};
  const int isz = dtype == 0 ? 4 : 2;
  for (int i = 0; i < 8; ++i) {
    for (int j = 0; j < 3; ++j) {
      p.st[i][j] = strides[3 * i + j];
      if (p.st[i][j] % (16 / isz) != 0) vec = 0;
    }
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) vec = 0;
  }
  p.batch = batch; p.hq = hq; p.hkv = hkv; p.sq = sq; p.skv = skv;
  p.group = hq / hkv; p.q_offset = q_offset; p.causal = causal ? 1 : 0;
  const double scale = 1.0 / sqrt(static_cast<double>(dh));
  p.scale = static_cast<float>(scale);
  p.scale_log2 = static_cast<float>(scale * 1.4426950408889634);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_t<float>(p, dh, vec, s));
    case 1: return static_cast<int>(launch_t<__half>(p, dh, vec, s));
    case 2: return static_cast<int>(launch_t<__nv_bfloat16>(p, dh, vec, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
