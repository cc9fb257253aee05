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
//   Di = rowsum(dO o O)          f32 [B, Hq, Sq], launch (a)
//   dS = P o (dP - Di),  dP = dO V^T
//   dQ = dS K scale              launch (a)
//   dV = P^T dO,  dK = dS^T Q scale   launch (b), summed over the G = Hq / Hkv
//                                query heads of a KV head
//
// Two launches, no atomics: (a) owns a (batch, query head, 128-row query
// block), writes its rows' Di to a workspace and loops over the KV tiles;
// (b), after it on the stream, owns a (batch, KV head, 128-row KV block) and
// loops over the G query heads of its group and over the query tiles the
// causal mask leaves. Each output element is summed by one thread in a
// fixed order, so two calls on the same inputs give the same bytes.
//
// Bound. At llama-7b's training shape (B=4, S=4096, 32 heads of 128, causal,
// bf16) the five products need 5 x 2 x B H (S^2/2) Dh = 1.37e12 operations
// (1.39 ms at 989 TFLOP/s) and the call moves Q, K, V, O, dO in and dQ, dK,
// dV out, 1.07 GB (0.32 ms at 3.35 TB/s): it is bound by operations. The
// design computes S and dP twice (once in each launch) and issues the bf16
// P and dS products as hi + lo (below), so its tensor-core work is 10
// products where the bound counts 5 (7 in f16): at the full tensor rate it
// could reach half its bound.
//
// 16-bit design (bf16, f16; head sizes 32, 64, 112, 128), the forward's
// scheme (flash_attention.cu; helpers in attention_tc.cuh):
//   * Each block has two consumer warpgroups of 64 rows and one producer
//     warp. The producer stages tiles by TMA into shared memory in TMA's
//     128-byte swizzle, the layout wgmma reads, through an mbarrier ring:
//     "full" counts a stage's bytes, and the consumers release it
//     ("empty") after their last product on it. Dh 112 is two 64-channel
//     boxes, channels past Dh and rows past S zero-filled by TMA. A view
//     whose pointer or strides are not 16-byte aligned is staged instead by
//     the producer warp's element loads into the same layout, so both
//     routes give the same bytes.
//   * (a) dQ: the block stages its Q and dO rows once and K, V tiles of 64
//     rows through a 4-stage ring. Per tile, S = Q K^T and dP = dO V^T by
//     wgmma (K-major operands), P and dS on the accumulator fragments, then
//     dQ += dS K by wgmma with dS from registers (the accumulator fragment
//     is, column pair for column pair, the A fragment) and K MN-major: the
//     same K tile serves both products. Tile t's S and dP are issued ahead
//     of tile t-1's dQ product, whose registers stay untouched until it
//     completes. Each consumer computes Di of its two rows from O and dO
//     (16-byte loads) before its first tile. The grid runs (batch, head)
//     by (batch, head), each one's causal blocks longest-first (the last
//     query blocks); a warpgroup skips the tiles past its causal edge.
//   * (b) dK, dV: the block stages its K and V rows once and the Q and dO
//     tiles of 64 rows, with their lse (times log2 e) and Di, through a
//     3-stage ring, over the G heads of the group in order. Per tile,
//     S^T = K Q^T and dP^T = V dO^T (K-major), P^T and dS^T on the
//     fragments, then dV += P^T dO and dK += dS^T Q with P^T, dS^T from
//     registers and dO, Q MN-major. The dK and dV accumulators (Dh
//     registers a thread together) stay in registers over the whole loop,
//     so a warpgroup does not overlap a tile's products with the next
//     tile's scores: the two warpgroups of the block interleave instead.
//     The grid runs (batch, KV head) by (batch, KV head), the first KV
//     blocks, the longest under the causal mask, first; a warpgroup skips
//     the tiles wholly before its causal edge (each head's first).
//   * The scores of a tile (P = 2^(S c - lse2), the mask, dS) run on the
//     accumulator fragments. Whether a tile holds masked pairs (past Sq,
//     Skv or the causal edge) is tested once a tile, and only such tiles
//     test each pair: tested per pair, the masks cost a fifth of the
//     kernel (bwd_variants.py, variant mask_per_score).
//   * Precision: in bf16, P and dS are issued as hi = bf16(x) plus
//     lo = bf16(x - hi), two products into one f32 accumulator: one bf16
//     rounding of every weight (2^-9) exceeds the two-ulp limit the
//     gradients are held to (ops.gradient_limit) over millions of
//     elements. f16 keeps 11 bits and is issued once.
//   * Registers: 384 threads, one block an SM. At that size ptxas gives a
//     thread 168 registers, too few for (b)'s dK and dV accumulators (Dh
//     registers a thread together) beside the scores and the hi/lo
//     fragments: with a producer warp (288 threads, the same 168) the
//     kernel spilled 684 bytes a thread. So the producer is a warpgroup
//     that gives registers back (setmaxnreg, 40 a thread) and the
//     consumers take them (232). chip_smoke.py's build phase prints what
//     ptxas reports.
//
// f32 design: scalar FMAs (no TF32): (a) one block a (batch, query head,
// 64-row query block), 4 warps of 16 rows, 32-row KV steps; (b) one block a
// (batch, KV head, 64-row KV block), 32-row query steps; tiles converted
// to f32 in shared memory. The tests and the float32 gradient checks use
// it; the training path runs 16-bit.
//
// q, k, v, o, dO, dQ, dK, dV are read and written through the (batch, seq,
// head) strides given, head dimension contiguous. The kernel allocates
// nothing: Di is a workspace the wrapper allocates. It launches on the
// caller's stream, and the C entry point returns cudaGetLastError().
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "attention_tc.cuh"   // tile helpers shared with the forward

namespace {

constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q; const void* k; const void* v; const void* o; const void* dout;
  const float* lse; float* di;
  void* dq; void* dk; void* dv;
  // (batch, seq, head) strides in elements, in the order
  // q, k, v, o, dout, dq, dk, dv
  int64_t st[8][3];
  int batch, hq, hkv, sq, skv, group, q_offset, causal;
  int vec;    // f32: every view 16-byte aligned: 16-byte tile loads
  int tma;    // 16-bit: q, k, v, dout readable by TMA
  int od16;   // 16-bit: o and dout 16-byte aligned: Di by 16-byte loads
  int pair;   // 16-bit: dq, dk, dv 4-byte aligned: paired stores
  float scale, scale_log2;
};
enum { SQ = 0, SK, SV, SO, SDO, SDQ, SDK, SDV };

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kvpos) {
  return qpos < p.sq && kvpos < p.skv &&
         (!p.causal || kvpos <= qpos + p.q_offset);
}

template <typename T>
__device__ __forceinline__ const T* row_ptr(const Params& p, int view,
                                            const void* base, int b, int row,
                                            int h) {
  return static_cast<const T*>(base) + b * p.st[view][0] +
         static_cast<int64_t>(row) * p.st[view][1] + h * p.st[view][2];
}

// ===========================================================================
// 16-bit instances: wgmma
// ===========================================================================
constexpr int TC_CONSUMERS = 256;   // two consumer warpgroups
constexpr int TC_THREADS = TC_CONSUMERS + 128;  // and a producer warpgroup
// registers a thread after setmaxnreg: the launch gives each of the 384
// threads 168 (65536 / 384, rounded down to 8); the producer warpgroup,
// one warp of which works, returns 128 each, which the consumers take
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int TC_BAR_BYTES = 128;   // the ring's mbarriers, ahead of the tiles
constexpr int DQ_BQ = 128;          // (a): query rows a block
constexpr int DQ_BK = 64;           // (a): KV rows a tile
constexpr int DQ_STAGES = 4;        // (a): K/V ring depth
constexpr int KV_BK = 128;          // (b): KV rows a block
constexpr int KV_BQ = 64;           // (b): query rows a tile
constexpr int KV_STAGES = 3;        // (b): Q/dO ring depth

// barriers, up to 1023 bytes to align the tiles, Q and dO, the K/V ring
template <int DH>
constexpr int dq_tc_smem_bytes() {
  return TC_BAR_BYTES + 1024 +
         (2 * DQ_BQ + DQ_STAGES * 2 * DQ_BK) * kHalves<DH> * 128;
}
// barriers, alignment, K and V, the Q/dO ring, the ring's lse and Di rows
template <int DH>
constexpr int dkdv_tc_smem_bytes() {
  return TC_BAR_BYTES + 1024 +
         (2 * KV_BK + KV_STAGES * 2 * KV_BQ) * kHalves<DH> * 128 +
         KV_STAGES * 2 * KV_BQ * static_cast<int>(sizeof(float));
}

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty,
                                          int stages, uint64_t* once) {
  for (int s = 0; s < stages; ++s) {
    mbar_init(&full[s], 1);                   // the producer
    mbar_init(&empty[s], TC_CONSUMERS);       // every consumer thread
  }
  mbar_init(once, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Di = rowsum(dO o O) of one query row, by the 4 lanes of a quad (t = lane
// % 4): 16-byte chunks t, t + 4, ... (element loads in the same order when
// o or dout is not 16-byte aligned), summed in f32 and reduced over the
// quad. Every lane of the warp calls it.
template <typename T, int DH>
__device__ __forceinline__ float row_di(const Params& p, int b, int h, int row,
                                        int t) {
  float s = 0.f;
  if (row < p.sq) {
    const T* o = row_ptr<T>(p, SO, p.o, b, row, h);
    const T* d = row_ptr<T>(p, SDO, p.dout, b, row, h);
    if (p.od16) {
      for (int c = 8 * t; c < DH; c += 32) {
        const uint4 a = *reinterpret_cast<const uint4*>(o + c);
        const uint4 g = *reinterpret_cast<const uint4*>(d + c);
        const T* ae = reinterpret_cast<const T*>(&a);
        const T* ge = reinterpret_cast<const T*>(&g);
#pragma unroll
        for (int e = 0; e < 8; ++e) s += to_f32(ae[e]) * to_f32(ge[e]);
      }
    } else {                            // the same order, element by element
      for (int c = 8 * t; c < DH; c += 32)
#pragma unroll
        for (int e = 0; e < 8; ++e) s += to_f32(o[c + e]) * to_f32(d[c + e]);
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  return s;
}

// (a)'s scores of one 64 x 64 tile in place: P = 2^(S c - lse2) with
// c = scale log2(e), then dS = P (dP - Di) into dp. s[4j + 2i + e] is query
// qrow + 8i, KV position k0 + 8j + 2 (lane % 4) + e.
// EDGE: the tile holds masked pairs (past Sq, Skv or the causal edge); the
// test is made once a tile, not once a score
template <bool EDGE>
__device__ __forceinline__ void dq_scores_t(float (&s)[32], float (&dp)[32],
                                            const Params& p, int k0, int qrow,
                                            const float (&lse2)[2],
                                            const float (&di)[2], int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * j + 2 * i + e;
        float pe = exp2f(fmaf(s[x], p.scale_log2, -lse2[i]));
        if (EDGE && !visible(p, qrow + 8 * i, k0 + 8 * j + 2 * (lane & 3) + e))
          pe = 0.f;
        dp[x] = pe * (dp[x] - di[i]);
      }
    }
  }
}
__device__ __forceinline__ void dq_scores(float (&s)[32], float (&dp)[32],
                                          const Params& p, int k0, int qrow,
                                          int row_lo, const float (&lse2)[2],
                                          const float (&di)[2], int lane) {
  const bool edge = k0 + DQ_BK > p.skv || row_lo + 64 > p.sq ||
                    (p.causal && k0 + DQ_BK - 1 > row_lo + p.q_offset);
  if (edge) dq_scores_t<true>(s, dp, p, k0, qrow, lse2, di, lane);
  else dq_scores_t<false>(s, dp, p, k0, qrow, lse2, di, lane);
}

// (b)'s scores of one 64 (KV) x 64 (query) tile in place: P^T into s,
// dS^T into dp. s[4j + 2i + e] is KV position kvrow + 8i, query
// q0 + 8j + 2 (lane % 4) + e; lse2 and di are the tile's 64 query rows.
template <bool EDGE>
__device__ __forceinline__ void kv_scores_t(float (&s)[32], float (&dp)[32],
                                            const Params& p, int q0, int kvrow,
                                            const float* lse2,
                                            const float* di, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    const float2 l = *reinterpret_cast<const float2*>(lse2 + c);
    const float2 d = *reinterpret_cast<const float2*>(di + c);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * j + 2 * i + e;
        float pe = exp2f(fmaf(s[x], p.scale_log2, -(e ? l.y : l.x)));
        if (EDGE && !visible(p, q0 + c + e, kvrow + 8 * i)) pe = 0.f;
        s[x] = pe;
        dp[x] = pe * (dp[x] - (e ? d.y : d.x));
      }
    }
  }
}
__device__ __forceinline__ void kv_scores(float (&s)[32], float (&dp)[32],
                                          const Params& p, int q0, int kvrow,
                                          int kv_lo, const float* lse2,
                                          const float* di, int lane) {
  const bool edge = q0 + KV_BQ > p.sq || kv_lo + 64 > p.skv ||
                    (p.causal && kv_lo + 63 > q0 + p.q_offset);
  if (edge) kv_scores_t<true>(s, dp, p, q0, kvrow, lse2, di, lane);
  else kv_scores_t<false>(s, dp, p, q0, kvrow, lse2, di, lane);
}

// A 64 x Dh accumulator (rows row0 + 8i as s[] above, scaled by `mul`)
// into rows below `limit` of a [rows, Dh] view (row stride rs): pairs of
// columns by one store where `pair`.
template <typename T, int DH>
__device__ __forceinline__ void store_rows(T* base, int64_t rs, int row0,
                                           int limit, const float (&d)[DH / 2],
                                           float mul, bool pair, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= limit) continue;
    T* r = base + static_cast<int64_t>(row) * rs + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const float a = d[4 * j + 2 * i] * mul, c = d[4 * j + 2 * i + 1] * mul;
      if (pair) {
        store2<T>(r + 8 * j, a, c);
      } else {
        r[8 * j] = from_f32<T>(a);
        r[8 * j + 1] = from_f32<T>(c);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// (a) Di and dQ: one block a (b, query head, 128-row query block)
// ---------------------------------------------------------------------------
template <typename T, int DH>
__global__ void __launch_bounds__(TC_THREADS, 1) attn_bwd_dq_tc(
    const Params p, const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv) {
  constexpr int NH = kHalves<DH>;
  constexpr uint32_t Q_BYTES = NH * DQ_BQ * 128;    // Q, and dO
  constexpr uint32_t KV_BYTES = NH * DQ_BK * 128;   // K, and V, of a stage
  constexpr int ND = DH / 2;                        // dQ accumulators a thread
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);   // [DQ_STAGES]
  uint64_t* empty = full + DQ_STAGES;                        // [DQ_STAGES]
  uint64_t* q_full = empty + DQ_STAGES;
  unsigned char* tiles = smem_raw + ((smem_u32(smem_raw) + TC_BAR_BYTES +
                                      1023) & ~1023u) - smem_u32(smem_raw);
  unsigned char* qs = tiles;
  unsigned char* dos = tiles + Q_BYTES;
  unsigned char* kvs = tiles + 2 * Q_BYTES;          // stages: K, then V

  const int n_qt = (p.sq + DQ_BQ - 1) / DQ_BQ;
  // (batch, head) slowest: the blocks on the card at one time share their
  // K and V tiles in L2; within a head the longest causal blocks first
  int qt = blockIdx.x % n_qt;
  if (p.causal) qt = n_qt - 1 - qt;
  const int h = (blockIdx.x / n_qt) % p.hq;
  const int b = (blockIdx.x / n_qt) / p.hq;
  const int hk = h / p.group;
  const int q0 = qt * DQ_BQ;
  int kv_end = p.skv;                           // what the live rows can see
  if (p.causal) kv_end = min(kv_end, min(p.sq, q0 + DQ_BQ) + p.q_offset);
  const int n_kt = (kv_end + DQ_BK - 1) / DQ_BK;
  const int tid = threadIdx.x;

  if (tid == 0) init_ring(full, empty, DQ_STAGES, q_full);
  __syncthreads();

  if (tid >= TC_CONSUMERS) {
    // ---- producer warp: Q and dO, then the K/V ring ----
    reg_dealloc<PRODUCER_REGS>();
    if (tid >= TC_CONSUMERS + 32) return;
    const int lane = tid % 32;
    if (p.tma) {                        // TMA, issued by one lane
      if (lane != 0) return;
      mbar_expect_tx(q_full, 2 * Q_BYTES);
      for (int c = 0; c < NH; ++c) {
        tma_load(qs + c * DQ_BQ * 128, &tq, q_full, 64 * c, q0, h, b);
        tma_load(dos + c * DQ_BQ * 128, &tdo, q_full, 64 * c, q0, h, b);
      }
      for (int t = 0; t < n_kt; ++t) {
        const int st = t % DQ_STAGES;
        if (t >= DQ_STAGES)             // tile t - STAGES released
          mbar_wait(&empty[st], ((t / DQ_STAGES) - 1) & 1);
        unsigned char* ks = kvs + st * 2 * KV_BYTES;
        mbar_expect_tx(&full[st], 2 * KV_BYTES);
        for (int c = 0; c < NH; ++c) {
          tma_load(ks + c * DQ_BK * 128, &tk, &full[st], 64 * c, t * DQ_BK,
                   hk, b);
          tma_load(ks + KV_BYTES + c * DQ_BK * 128, &tv, &full[st], 64 * c,
                   t * DQ_BK, hk, b);
        }
      }
      return;
    }
    // element loads by the whole warp; lane 0 signals
    stage_elements<T, DQ_BQ, DH>(qs, row_ptr<T>(p, SQ, p.q, b, 0, h),
                                 p.st[SQ][1], q0, p.sq, lane);
    stage_elements<T, DQ_BQ, DH>(dos, row_ptr<T>(p, SDO, p.dout, b, 0, h),
                                 p.st[SDO][1], q0, p.sq, lane);
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(q_full);
    const T* kg = row_ptr<T>(p, SK, p.k, b, 0, hk);
    const T* vg = row_ptr<T>(p, SV, p.v, b, 0, hk);
    for (int t = 0; t < n_kt; ++t) {
      const int st = t % DQ_STAGES;
      if (t >= DQ_STAGES)
        mbar_wait(&empty[st], ((t / DQ_STAGES) - 1) & 1);
      unsigned char* ks = kvs + st * 2 * KV_BYTES;
      stage_elements<T, DQ_BK, DH>(ks, kg, p.st[SK][1], t * DQ_BK, p.skv,
                                   lane);
      stage_elements<T, DQ_BK, DH>(ks + KV_BYTES, vg, p.st[SV][1], t * DQ_BK,
                                   p.skv, lane);
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[st]);
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----
  reg_alloc<CONSUMER_REGS>();
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int row_lo = q0 + 64 * wg;      // the warpgroup's first query
  const int qrow = row_lo + 16 * ((tid % 128) / 32) + lane / 4;  // and +8
  const int64_t row_at = (static_cast<int64_t>(b) * p.hq + h) * p.sq;
  float di[2], lse2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qrow + 8 * i;
    di[i] = row_di<T, DH>(p, b, h, row, lane & 3);
    lse2[i] = row < p.sq ? p.lse[row_at + row] * LOG2E : 0.f;
    if (row < p.sq && (lane & 3) == 0) p.di[row_at + row] = di[i];
  }
  // tiles [0, n_live) reach the warpgroup's rows; later ones (past its
  // causal edge) are only released
  int n_live = 0;
  if (row_lo < p.sq) {
    n_live = n_kt;
    if (p.causal)
      n_live = min(n_kt, (row_lo + 63 + p.q_offset) / DQ_BK + 1);
  }

  float dq[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) dq[j] = 0.f;
  float s[32], dp[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.f;
  uint32_t fh[16], fl[16];              // dS as A fragments (bf16: hi, lo)
  const uint32_t q_at = smem_u32(qs) + wg * 64 * 128;   // the warpgroup's Q
  const uint32_t do_at = smem_u32(dos) + wg * 64 * 128;
  const uint32_t kv_at = smem_u32(kvs);

  if (n_live > 0) {
    mbar_wait(q_full, 0);
    mbar_wait(&full[0], 0);
    __syncwarp();
    pin(s);
    pin(dp);
    wg_fence();
    issue_nt<T, DH, DQ_BQ * 128, DQ_BK * 128>(s, q_at, kv_at);
    issue_nt<T, DH, DQ_BQ * 128, DQ_BK * 128>(dp, do_at, kv_at + KV_BYTES);
    wg_commit();
    wg_wait<0>();
    pin(s);
    pin(dp);
    dq_scores(s, dp, p, 0, qrow, row_lo, lse2, di, lane);
    a_fragments<T>(dp, fh, fl);
    // Tile t's S and dP go to the tensor cores ahead of tile t-1's dS.K;
    // the scores of tile t are computed while that product is in flight.
    for (int t = 1; t < n_live; ++t) {
      const int st = t % DQ_STAGES;
      const int sp = (t - 1) % DQ_STAGES;
      const uint32_t at = kv_at + st * 2 * KV_BYTES;
      mbar_wait(&full[st], (t / DQ_STAGES) & 1);
      __syncwarp();
      pin(s);
      pin(dp);
      pin(dq);
      pin(fh);
      pin(fl);
      wg_fence();
      issue_nt<T, DH, DQ_BQ * 128, DQ_BK * 128>(s, q_at, at);
      issue_nt<T, DH, DQ_BQ * 128, DQ_BK * 128>(dp, do_at, at + KV_BYTES);
      wg_commit();
      issue_rs<T, DH, DQ_BK>(dq, fh, fl, kv_at + sp * 2 * KV_BYTES);
      wg_commit();
      wg_wait<1>();                      // S and dP of tile t
      pin(s);
      pin(dp);
      dq_scores(s, dp, p, t * DQ_BK, qrow, row_lo, lse2, di, lane);
      wg_wait<0>();                      // dS.K of tile t-1
      pin(dq);
      pin(fh);
      pin(fl);
      mbar_arrive(&empty[sp]);
      a_fragments<T>(dp, fh, fl);
    }
    const int sl = (n_live - 1) % DQ_STAGES;
    pin(dq);
    pin(fh);
    pin(fl);
    wg_fence();
    issue_rs<T, DH, DQ_BK>(dq, fh, fl, kv_at + sl * 2 * KV_BYTES);
    wg_commit();
    wg_wait<0>();
    pin(dq);
    pin(fh);
    pin(fl);
    mbar_arrive(&empty[sl]);
  }
  for (int t = n_live; t < n_kt; ++t) {   // release what these rows skip
    mbar_wait(&full[t % DQ_STAGES], (t / DQ_STAGES) & 1);
    mbar_arrive(&empty[t % DQ_STAGES]);
  }
  if (row_lo >= p.sq) return;
  store_rows<T, DH>(static_cast<T*>(p.dq) + b * p.st[SDQ][0] +
                        h * p.st[SDQ][2],
                    p.st[SDQ][1], qrow, p.sq, dq, p.scale, p.pair, lane);
}

// ---------------------------------------------------------------------------
// (b) dK, dV: one block a (b, KV head, 128-row KV block)
// ---------------------------------------------------------------------------
template <typename T, int DH>
__global__ void __launch_bounds__(TC_THREADS, 1) attn_bwd_dkdv_tc(
    const Params p, const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv) {
  constexpr int NH = kHalves<DH>;
  constexpr uint32_t KV_BYTES = NH * KV_BK * 128;   // K, and V
  constexpr uint32_t Q_BYTES = NH * KV_BQ * 128;    // Q, and dO, of a stage
  constexpr int ND = DH / 2;                        // dK (dV) accumulators
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);   // [KV_STAGES]
  uint64_t* empty = full + KV_STAGES;                        // [KV_STAGES]
  uint64_t* kv_full = empty + KV_STAGES;
  unsigned char* tiles = smem_raw + ((smem_u32(smem_raw) + TC_BAR_BYTES +
                                      1023) & ~1023u) - smem_u32(smem_raw);
  unsigned char* ks = tiles;
  unsigned char* vs = tiles + KV_BYTES;
  unsigned char* qdo = tiles + 2 * KV_BYTES;         // stages: Q, then dO
  float* lse2_s = reinterpret_cast<float*>(qdo + KV_STAGES * 2 * Q_BYTES);
  float* di_s = lse2_s + KV_STAGES * KV_BQ;          // [KV_STAGES][KV_BQ]

  const int n_kb = (p.skv + KV_BK - 1) / KV_BK;
  // (batch, KV head) slowest, as (a); the first KV blocks, the longest
  // under the causal mask, first
  const int kb = blockIdx.x % n_kb;
  const int hk = (blockIdx.x / n_kb) % p.hkv;
  const int b = (blockIdx.x / n_kb) / p.hkv;
  const int kv0 = kb * KV_BK;
  int q_start = 0;                      // the first query tile that sees it
  if (p.causal) q_start = max(0, kv0 - p.q_offset) / KV_BQ * KV_BQ;
  const int n_qt = q_start < p.sq ? (p.sq - q_start + KV_BQ - 1) / KV_BQ : 0;
  const int n_steps = p.group * n_qt;   // (head, query tile), heads slowest
  const int tid = threadIdx.x;

  if (tid == 0) init_ring(full, empty, KV_STAGES, kv_full);
  __syncthreads();

  if (tid >= TC_CONSUMERS) {
    // ---- producer warp: K and V, then the Q/dO ring with lse and Di ----
    reg_dealloc<PRODUCER_REGS>();
    if (tid >= TC_CONSUMERS + 32) return;
    const int lane = tid % 32;
    if (n_steps == 0) return;
    if (p.tma) {
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * KV_BYTES);
        for (int c = 0; c < NH; ++c) {
          tma_load(ks + c * KV_BK * 128, &tk, kv_full, 64 * c, kv0, hk, b);
          tma_load(vs + c * KV_BK * 128, &tv, kv_full, 64 * c, kv0, hk, b);
        }
      }
    } else {
      stage_elements<T, KV_BK, DH>(ks, row_ptr<T>(p, SK, p.k, b, 0, hk),
                                   p.st[SK][1], kv0, p.skv, lane);
      stage_elements<T, KV_BK, DH>(vs, row_ptr<T>(p, SV, p.v, b, 0, hk),
                                   p.st[SV][1], kv0, p.skv, lane);
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_full);
    }
    for (int i = 0; i < n_steps; ++i) {
      const int st = i % KV_STAGES;
      const int h = hk * p.group + i / n_qt;
      const int q0 = q_start + (i % n_qt) * KV_BQ;
      if (i >= KV_STAGES)               // step i - STAGES released
        mbar_wait(&empty[st], ((i / KV_STAGES) - 1) & 1);
      const int64_t row_at = (static_cast<int64_t>(b) * p.hq + h) * p.sq;
      for (int r = lane; r < KV_BQ; r += 32) {
        const int q = q0 + r;
        lse2_s[st * KV_BQ + r] = q < p.sq ? p.lse[row_at + q] * LOG2E : 0.f;
        di_s[st * KV_BQ + r] = q < p.sq ? p.di[row_at + q] : 0.f;
      }
      unsigned char* qst = qdo + st * 2 * Q_BYTES;
      if (p.tma) {
        __syncwarp();                   // lse and Di stored before the signal
        if (lane == 0) {
          mbar_expect_tx(&full[st], 2 * Q_BYTES);
          for (int c = 0; c < NH; ++c) {
            tma_load(qst + c * KV_BQ * 128, &tq, &full[st], 64 * c, q0, h, b);
            tma_load(qst + Q_BYTES + c * KV_BQ * 128, &tdo, &full[st],
                     64 * c, q0, h, b);
          }
        }
      } else {
        stage_elements<T, KV_BQ, DH>(qst, row_ptr<T>(p, SQ, p.q, b, 0, h),
                                     p.st[SQ][1], q0, p.sq, lane);
        stage_elements<T, KV_BQ, DH>(qst + Q_BYTES,
                                     row_ptr<T>(p, SDO, p.dout, b, 0, h),
                                     p.st[SDO][1], q0, p.sq, lane);
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[st]);
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 KV rows each ----
  reg_alloc<CONSUMER_REGS>();
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int kv_lo = kv0 + 64 * wg;      // the warpgroup's first KV row
  const int kvrow = kv_lo + 16 * ((tid % 128) / 32) + lane / 4;  // and +8
  float dk[ND], dv[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) dk[j] = dv[j] = 0.f;
  float s[32], dp[32];
  uint32_t ph[16], pl[16], fh[16], fl[16];   // P^T and dS^T as A fragments
  const uint32_t k_at = smem_u32(ks) + wg * 64 * 128;   // the warpgroup's K
  const uint32_t v_at = smem_u32(vs) + wg * 64 * 128;
  bool kv_ready = false;

  for (int i = 0; i < n_steps; ++i) {
    const int st = i % KV_STAGES;
    const int q0 = q_start + (i % n_qt) * KV_BQ;
    mbar_wait(&full[st], (i / KV_STAGES) & 1);
    // tiles wholly before the warpgroup's causal edge are only released
    if (kv_lo < p.skv && (!p.causal || kv_lo <= q0 + KV_BQ - 1 + p.q_offset)) {
      if (!kv_ready) {
        mbar_wait(kv_full, 0);
        kv_ready = true;
      }
      __syncwarp();
      const uint32_t q_at = smem_u32(qdo) + st * 2 * Q_BYTES;
      const uint32_t do_at = q_at + Q_BYTES;
      // fresh accumulators: the last tile's scores are dead during its
      // dK and dV products, so they hold no registers there
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.f;
      pin(s);
      pin(dp);
      wg_fence();
      issue_nt<T, DH, KV_BK * 128, KV_BQ * 128>(s, k_at, q_at);
      issue_nt<T, DH, KV_BK * 128, KV_BQ * 128>(dp, v_at, do_at);
      wg_commit();
      wg_wait<0>();
      pin(s);
      pin(dp);
      kv_scores(s, dp, p, q0, kvrow, kv_lo, lse2_s + st * KV_BQ,
                di_s + st * KV_BQ, lane);
      a_fragments<T>(s, ph, pl);
      a_fragments<T>(dp, fh, fl);
      pin(dk);
      pin(dv);
      pin(ph);
      pin(pl);
      pin(fh);
      pin(fl);
      wg_fence();
      issue_rs<T, DH, KV_BQ>(dv, ph, pl, do_at);
      issue_rs<T, DH, KV_BQ>(dk, fh, fl, q_at);
      wg_commit();
      wg_wait<0>();
      pin(dk);
      pin(dv);
      pin(ph);
      pin(pl);
      pin(fh);
      pin(fl);
    }
    mbar_arrive(&empty[st]);
  }
  if (kv_lo >= p.skv) return;
  store_rows<T, DH>(static_cast<T*>(p.dk) + b * p.st[SDK][0] +
                        hk * p.st[SDK][2],
                    p.st[SDK][1], kvrow, p.skv, dk, p.scale, p.pair, lane);
  store_rows<T, DH>(static_cast<T*>(p.dv) + b * p.st[SDV][0] +
                        hk * p.st[SDV][2],
                    p.st[SDV][1], kvrow, p.skv, dv, 1.f, p.pair, lane);
}

// ===========================================================================
// f32 instance: scalar FMAs
// ===========================================================================
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int KB = 64;    // (b): KV rows per block, 16 a warp
constexpr int QB = 32;    // (b): query rows per step
constexpr int QB2 = 64;   // (a): query rows per block, 16 a warp
constexpr int KB2 = 32;   // (a): KV rows per step
constexpr int PLD = 40;   // row stride of the P / dS tiles (32 + 8)

// C[16 x 8 NT] += A[16 x K] B[K x 8 NT] for one warp by scalar FMAs. A in
// shared memory row-major (row stride lda, k contiguous). B(k, n) at
// bs[n ldb + k] when KC (k contiguous), else at bs[k ldb + n]. c[nt][e] is
// row g + 8 (e >> 1), column 8 nt + 2 t + (e & 1), with g = lane / 4,
// t = lane % 4.
template <int NT, int K, bool KC>
__device__ __forceinline__ void warp_mm(float (&c)[NT][4], const float* as,
                                        int lda, const float* bs, int ldb,
                                        int lane) {
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
}

// Rows [row0, row0 + ROWS) of a [rows, DH] view (row stride rs elements)
// into shared memory at row stride ld, rows at or past `limit` as zeros; by
// the block's THREADS threads, 16 bytes at a time when `vec`.
template <int ROWS, int DH>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          int64_t rs, int row0, int limit,
                                          bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < ROWS * (DH / 4); i += THREADS) {
      const int r = i / (DH / 4), c = (i % (DH / 4)) * 4;
      float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < limit)
        w = *reinterpret_cast<const float4*>(src + (row0 + r) * rs + c);
      *reinterpret_cast<float4*>(dst + r * ld + c) = w;
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DH; i += THREADS) {
      const int r = i / DH, c = i % DH;
      dst[r * ld + c] = row0 + r < limit ? src[(row0 + r) * rs + c] : 0.f;
    }
  }
}

// c[nt][e] of one warp's [16 x 8 NT] tile into shared memory at row stride
// PLD
template <int NT>
__device__ __forceinline__ void store_tile(float* dst, const float (&c)[NT][4],
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dst[(g + 8 * (e >> 1)) * PLD + 8 * nt + 2 * t + (e & 1)] = c[nt][e];
}

// ---------------------------------------------------------------------------
// (a) Di and dQ: one block a (b, query head, 64-row query block)
// ---------------------------------------------------------------------------
template <int DH>
constexpr int dq_smem_bytes() {
  constexpr int LD = DH + 8;
  return (2 * QB2 * LD + 2 * KB2 * LD + QB2 * PLD + 2 * QB2) *
         static_cast<int>(sizeof(float));
}

template <int DH>
__global__ void __launch_bounds__(THREADS) attn_bwd_dq(const Params p) {
  constexpr int LD = DH + 8;
  constexpr int ND = DH / 8;
  extern __shared__ __align__(16) float smem_f[];
  float* qs = smem_f;
  float* ds = qs + QB2 * LD;                  // dO
  float* ks = ds + QB2 * LD;
  float* vs = ks + KB2 * LD;
  float* sh = vs + KB2 * LD;                  // dS [QB2 x KB2]
  float* lse_s = sh + QB2 * PLD;
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

  load_tile<QB2, DH>(qs, LD, row_ptr<float>(p, SQ, p.q, b, 0, h),
                     p.st[SQ][1], q0, p.sq, p.vec);
  load_tile<QB2, DH>(ds, LD, row_ptr<float>(p, SDO, p.dout, b, 0, h),
                     p.st[SDO][1], q0, p.sq, p.vec);
  const int64_t row_at = (static_cast<int64_t>(b) * p.hq + h) * p.sq;
  {                 // Di of the block's rows, two threads a row, for (b) too
    const int r = threadIdx.x / 2, q = q0 + r;
    float d = 0.f;
    if (q < p.sq) {
      const float* orow = row_ptr<float>(p, SO, p.o, b, q, h);
      const float* grow = row_ptr<float>(p, SDO, p.dout, b, q, h);
      for (int c = threadIdx.x % 2; c < DH; c += 2) d += orow[c] * grow[c];
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (threadIdx.x % 2 == 0) {
      di_s[r] = d;
      lse_s[r] = q < p.sq ? p.lse[row_at + q] * LOG2E : 0.f;
      if (q < p.sq) p.di[row_at + q] = d;
    }
  }

  float dq[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  int kv_end = p.skv;
  if (p.causal) kv_end = min(kv_end, min(p.sq, q0 + QB2) + p.q_offset);
  const float* kg = row_ptr<float>(p, SK, p.k, b, 0, hk);
  const float* vg = row_ptr<float>(p, SV, p.v, b, 0, hk);
  for (int k0 = 0; k0 < kv_end; k0 += KB2) {
    __syncthreads();
    load_tile<KB2, DH>(ks, LD, kg, p.st[SK][1], k0, p.skv, p.vec);
    load_tile<KB2, DH>(vs, LD, vg, p.st[SV][1], k0, p.skv, p.vec);
    __syncthreads();
    float s[KB2 / 8][4], dp[KB2 / 8][4];
#pragma unroll
    for (int j = 0; j < KB2 / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    warp_mm<KB2 / 8, DH, true>(s, qs + r0 * LD, LD, ks, LD, lane);
    warp_mm<KB2 / 8, DH, true>(dp, ds + r0 * LD, LD, vs, LD, lane);
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
    store_tile<KB2 / 8>(sh + r0 * PLD, dp, lane);
    __syncwarp();
    warp_mm<ND, KB2, false>(dq, sh + r0 * PLD, PLD, ks, LD, lane);
  }

  float* dqg = static_cast<float*>(p.dq) + b * p.st[SDQ][0] + h * p.st[SDQ][2];
#pragma unroll
  for (int j = 0; j < ND; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = q0 + r0 + g + 8 * (e >> 1);
      if (q >= p.sq) continue;
      dqg[q * p.st[SDQ][1] + 8 * j + 2 * t + (e & 1)] = dq[j][e] * p.scale;
    }
  }
}

// ---------------------------------------------------------------------------
// (b) dK, dV: one block a (b, KV head, 64-row KV block)
// ---------------------------------------------------------------------------
template <int DH>
constexpr int dkdv_smem_bytes() {
  constexpr int LD = DH + 8;
  return (2 * KB * LD + 2 * QB * LD + 2 * KB * PLD + 2 * QB) *
         static_cast<int>(sizeof(float));
}

template <int DH>
__global__ void __launch_bounds__(THREADS) attn_bwd_dkdv(const Params p) {
  constexpr int LD = DH + 8;
  constexpr int ND = DH / 8;
  extern __shared__ __align__(16) float smem_f[];
  float* ks = smem_f;
  float* vs = ks + KB * LD;
  float* qs = vs + KB * LD;
  float* ds = qs + QB * LD;                   // dO
  float* ph = ds + QB * LD;                   // P^T  [KB x QB]
  float* sh = ph + KB * PLD;                  // dS^T
  float* lse_s = sh + KB * PLD;
  float* di_s = lse_s + QB;

  const int n_kb = (p.skv + KB - 1) / KB;
  const int kb = blockIdx.x % n_kb;
  const int hk = (blockIdx.x / n_kb) % p.hkv;
  const int b = blockIdx.x / (n_kb * p.hkv);
  const int kv0 = kb * KB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  load_tile<KB, DH>(ks, LD, row_ptr<float>(p, SK, p.k, b, 0, hk), p.st[SK][1],
                    kv0, p.skv, p.vec);
  load_tile<KB, DH>(vs, LD, row_ptr<float>(p, SV, p.v, b, 0, hk), p.st[SV][1],
                    kv0, p.skv, p.vec);

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
    const float* qg = row_ptr<float>(p, SQ, p.q, b, 0, h);
    const float* dg = row_ptr<float>(p, SDO, p.dout, b, 0, h);
    const int64_t row_at = (static_cast<int64_t>(b) * p.hq + h) * p.sq;
    for (int q0 = q_start; q0 < p.sq; q0 += QB) {
      __syncthreads();              // the previous step's reads are done
      load_tile<QB, DH>(qs, LD, qg, p.st[SQ][1], q0, p.sq, p.vec);
      load_tile<QB, DH>(ds, LD, dg, p.st[SDO][1], q0, p.sq, p.vec);
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
      warp_mm<QB / 8, DH, true>(s, ks + r0 * LD, LD, qs, LD, lane);
      warp_mm<QB / 8, DH, true>(dp, vs + r0 * LD, LD, ds, LD, lane);
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
      store_tile<QB / 8>(ph + r0 * PLD, s, lane);
      store_tile<QB / 8>(sh + r0 * PLD, dp, lane);
      __syncwarp();
      warp_mm<ND, QB, false>(dv, ph + r0 * PLD, PLD, ds, LD, lane);
      warp_mm<ND, QB, false>(dk, sh + r0 * PLD, PLD, qs, LD, lane);
    }
  }

  float* dkg = static_cast<float*>(p.dk) + b * p.st[SDK][0] + hk * p.st[SDK][2];
  float* dvg = static_cast<float*>(p.dv) + b * p.st[SDV][0] + hk * p.st[SDV][2];
#pragma unroll
  for (int j = 0; j < ND; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kvpos = kv0 + r0 + g + 8 * (e >> 1);
      if (kvpos >= p.skv) continue;
      const int c = 8 * j + 2 * t + (e & 1);
      dkg[kvpos * p.st[SDK][1] + c] = dk[j][e] * p.scale;
      dvg[kvpos * p.st[SDV][1] + c] = dv[j][e];
    }
  }
}

// ===========================================================================
// launch
// ===========================================================================
template <typename K>
cudaError_t opt_in(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int DH>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const long long q_blocks = static_cast<long long>(p.batch) * p.hq *
                             ((p.sq + QB2 - 1) / QB2);
  const long long kv_blocks = static_cast<long long>(p.batch) * p.hkv *
                              ((p.skv + KB - 1) / KB);
  if (q_blocks > INT_MAX || kv_blocks > INT_MAX) return cudaErrorInvalidValue;
  constexpr int b1 = dq_smem_bytes<DH>();
  static const cudaError_t a1 = opt_in(attn_bwd_dq<DH>, b1);
  if (a1 != cudaSuccess) return a1;
  attn_bwd_dq<DH><<<static_cast<unsigned>(q_blocks), THREADS, b1, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  constexpr int b2 = dkdv_smem_bytes<DH>();
  static const cudaError_t a2 = opt_in(attn_bwd_dkdv<DH>, b2);
  if (a2 != cudaSuccess) return a2;
  attn_bwd_dkdv<DH><<<static_cast<unsigned>(kv_blocks), THREADS, b2,
                      stream>>>(p);
  return cudaGetLastError();
}

// the tensor map of view `i` of p in boxes of `rows` rows
template <typename T, int DH>
bool map_view(CUtensorMap* map, const Params& p, int i, const void* ptr,
              int rows) {
  const bool q_side = i == SQ || i == SDO;
  return encode_view<T>(map, ptr, DH, q_side ? p.sq : p.skv,
                        q_side ? p.hq : p.hkv, p.batch, p.st[i][1],
                        p.st[i][2], p.st[i][0], rows);
}

template <typename T, int DH>
cudaError_t launch_tc(const Params& p, cudaStream_t stream) {
  constexpr int b1 = dq_tc_smem_bytes<DH>();
  constexpr int b2 = dkdv_tc_smem_bytes<DH>();
  static const cudaError_t a1 = opt_in(attn_bwd_dq_tc<T, DH>, b1);
  if (a1 != cudaSuccess) return a1;
  static const cudaError_t a2 = opt_in(attn_bwd_dkdv_tc<T, DH>, b2);
  if (a2 != cudaSuccess) return a2;
  const long long q_blocks = static_cast<long long>(p.batch) * p.hq *
                             ((p.sq + DQ_BQ - 1) / DQ_BQ);
  const long long kv_blocks = static_cast<long long>(p.batch) * p.hkv *
                              ((p.skv + KV_BK - 1) / KV_BK);
  if (q_blocks > INT_MAX || kv_blocks > INT_MAX) return cudaErrorInvalidValue;
  // (a) reads Q, dO in 128-row boxes and K, V in 64-row ones; (b) the other
  // way round. Unused on the element path.
  CUtensorMap q128 = {}, do128 = {}, k64 = {}, v64 = {};
  CUtensorMap q64 = {}, do64 = {}, k128 = {}, v128 = {};
  if (p.tma &&
      !(map_view<T, DH>(&q128, p, SQ, p.q, DQ_BQ) &&
        map_view<T, DH>(&do128, p, SDO, p.dout, DQ_BQ) &&
        map_view<T, DH>(&k64, p, SK, p.k, DQ_BK) &&
        map_view<T, DH>(&v64, p, SV, p.v, DQ_BK) &&
        map_view<T, DH>(&q64, p, SQ, p.q, KV_BQ) &&
        map_view<T, DH>(&do64, p, SDO, p.dout, KV_BQ) &&
        map_view<T, DH>(&k128, p, SK, p.k, KV_BK) &&
        map_view<T, DH>(&v128, p, SV, p.v, KV_BK)))
    return cudaErrorInvalidValue;
  attn_bwd_dq_tc<T, DH><<<static_cast<unsigned>(q_blocks), TC_THREADS, b1,
                          stream>>>(p, q128, do128, k64, v64);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_bwd_dkdv_tc<T, DH><<<static_cast<unsigned>(kv_blocks), TC_THREADS, b2,
                            stream>>>(p, q64, do64, k128, v128);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_one(const Params& p, cudaStream_t stream) {
  if constexpr (sizeof(T) == 4) return launch_f32<DH>(p, stream);
  else return launch_tc<T, DH>(p, stream);
}

template <typename T>
cudaError_t launch_t(const Params& p, int dh, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch_one<T, 32>(p, stream);
    case 64: return launch_one<T, 64>(p, stream);
    case 112: return launch_one<T, 112>(p, stream);
    case 128: return launch_one<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The VJP of flash_attention_launch. Pointers: q, k, v, o, dout (inputs), lse
// [B, Hq, Sq] f32 (the forward's), di [B, Hq, Sq] f32 (workspace), dq, dk,
// dv (outputs; dk and dv [B, Skv, Hkv, Dh]). `strides` holds 24 int64: the
// (batch, seq, head) strides in elements of q, k, v, o, dout, dq, dk, dv in
// that order, each view's last dimension contiguous. dtype: 0 = float32,
// 1 = float16, 2 = bfloat16. Two launches; returns a cudaError_t (0 =
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
  const void* ptrs[8] = {q, k, v, o, dout, dq, dk, dv};
  const int isz = dtype == 0 ? 4 : 2;
  p.vec = 1;
  p.pair = 1;
  for (int i = 0; i < 8; ++i) {
    for (int j = 0; j < 3; ++j) {
      p.st[i][j] = strides[3 * i + j];
      if (p.st[i][j] % (16 / isz) != 0) p.vec = 0;
      if (i >= SDQ && p.st[i][j] % 2 != 0) p.pair = 0;
    }
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) p.vec = 0;
    if (i >= SDQ && reinterpret_cast<uintptr_t>(ptrs[i]) % 4 != 0) p.pair = 0;
  }
  auto a16 = [&](int i, int s, int h) {
    return aligned16(ptrs[i], batch, p.st[i][0], s, p.st[i][1], h,
                     p.st[i][2]);
  };
  p.tma = a16(SQ, sq, hq) && a16(SK, skv, hkv) && a16(SV, skv, hkv) &&
          a16(SDO, sq, hq);
  p.od16 = a16(SO, sq, hq) && a16(SDO, sq, hq);
  p.batch = batch; p.hq = hq; p.hkv = hkv; p.sq = sq; p.skv = skv;
  p.group = hq / hkv; p.q_offset = q_offset; p.causal = causal ? 1 : 0;
  const double scale = 1.0 / sqrt(static_cast<double>(dh));
  p.scale = static_cast<float>(scale);
  p.scale_log2 = static_cast<float>(scale * 1.4426950408889634);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_t<float>(p, dh, s));
    case 1: return static_cast<int>(launch_t<__half>(p, dh, s));
    case 2: return static_cast<int>(launch_t<__nv_bfloat16>(p, dh, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
