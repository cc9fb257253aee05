// Flash attention (forward) for Hopper (sm_90a): GQA, causal or bidirectional.
//
// Replaces repro/kernels/flash_attention/kernel.py::_attn_kernel (the Pallas
// TPU kernel launched by flash_attention_kernel). Same arithmetic: scores
// q.k^T in f32 times 1/sqrt(Dh); KV positions at or past `skv`, and (causal)
// past the query's absolute position q + q_offset, are set to -1e30 (not
// -inf); an online softmax over KV tiles keeps the running max, the running
// sum and the output accumulator in f32; the result is acc / max(l, 1e-30),
// written in the input type. Query head h reads KV head h / (Hq / Hkv).
//
// Bound. At the serving prefill's shape (B=8, H=32, S=768, Dh=128, causal,
// bf16) the call needs 3.87e10 operations (0.039 ms at 989 TFLOP/s) and moves
// 201 MB (0.060 ms at 3.35 TB/s): it sits at the ridge, bound by bytes; at
// zamba2-7b's shared block (B=2, H=32, S=8192, Dh=112) 9.62e11 operations
// (0.97 ms) and 235 MB (0.07 ms): bound by operations. Both products have
// to run on the tensor cores for the kernel to approach either bound, so
// the 16-bit instances are built on wgmma, and the bf16 split of P (below)
// makes the tensor-core work 1.5x the function's. Measured on an H100 80GB
// HBM3 at 700 W (chip_smoke.py, PERF.md): 0.2049 ms and 2.9763 ms, 0.29 and
// 0.33 of those bounds.
//
// 16-bit design (bf16, f16; head sizes 32, 64, 112, 128):
//   * One block per (b, query head, 128-row q tile): two consumer
//     warpgroups of 64 query rows each and one producer warp. The grid is
//     one-dimensional with the q tile slowest and, when causal, the last
//     (longest) q tiles first.
//   * The producer stages Q once and K, V tiles of 64 rows through a
//     4-stage ring in shared memory, in the input type, by TMA: one lane
//     issues each tile's boxes, an mbarrier per stage counts their bytes
//     ("full"), and the consumers release a stage after their last product
//     on it ("empty"), so copies run ahead of the products and the two
//     warpgroups drift apart instead of meeting at a block barrier each
//     tile. The tensor maps cut a [B, S, H, Dh] view into boxes of 64
//     channels x 64 (or 128) rows with TMA's 128-byte swizzle, the layout
//     wgmma reads: Dh 112 is two boxes, 0-63 and 64-127, and TMA fills
//     channels 112-127 (out of the map) with zeros without reading them, so
//     nothing past Dh is read; Q.K^T takes Dh / 16 = 7 k-steps and P.V an
//     N of Dh, so the zeros are never multiplied either. Rows past Sq or
//     Skv arrive as zeros the same way. A view whose pointer or strides
//     are not 16-byte aligned (TMA's rule) is staged instead by the
//     producer warp's element loads into the same swizzled layout, so both
//     paths give the same bytes.
//   * S = Q.K^T by wgmma m64n64k16 (Q and K K-major in shared memory) into
//     32 f32 registers a thread. Mask, scale and online softmax run on that
//     fragment: each row lives in the 4 lanes of a quad, so its max is two
//     shuffles away. The sum l is kept per lane over the f32 P and reduced
//     across the quad once, at the end.
//   * O += P.V by wgmma m64n{Dh}k16 with P from registers (the accumulator
//     fragment of S is, column pair for column pair, the A fragment) and V
//     MN-major ("transposed") from shared memory. Rounding P once to bf16
//     costs ~2^-9 of every weight, and over a row of a few hundred keys
//     that exceeds the two-ulp limit the port holds attention outputs to
//     (ops.attention_limit; tests/test_torch_flash_attention.py emulates
//     both); so in bf16 P is issued as hi = bf16(P) plus lo = bf16(P - hi),
//     two products into the same f32 accumulator (~16 bits of P). That is
//     one product more per tile: 1.5x the tensor-core operations of the
//     call. f16 keeps 11 bits and is issued once.
//   * Within a warpgroup, tile t's Q.K^T is issued ahead of tile t-1's P.V,
//     and the softmax of tile t runs while that P.V is in flight.
//   * Tiles wholly past Skv or past the causal edge of the block's last
//     live row are not loaded; a warpgroup skips those past its own causal
//     edge. Skipped and fully masked tiles leave (m, l, acc) exactly as they
//     were, so a row's result depends only on its own (b, h, row), Skv and
//     q_offset: the KV tile order is fixed, there is no split of the KV axis
//     and no atomic, and nothing depends on B, Sq or the grid (batch
//     invariance).
//   * Registers (ptxas, sm_90a): 144-166 a thread at Dh 112-128, no spill;
//     one block of 288 threads and ~165 KB of shared memory per SM.
//
// With a non-null `lse`, both instances also write each row's log-sum-exp
// m scale + log(l) at the end of the row: the backward's
// (flash_attention_bwd.cu) input, 4 bytes a row; serving passes null.
//
// f32 design: scalar FMAs (no TF32, which would break the f32 tolerance).
// One block owns one (b, query head, 64-row q tile) and loops over 32-row
// KV tiles converted to f32 in shared memory; 4 threads per query row,
// each holding Dh/4 accumulator columns. The tests and the float32 decode
// check use it; the model paths run 16-bit.
//
// q, k, v are read, and o written, through the (batch, seq, head) strides
// given, with the head dimension contiguous: the [B, S, H, Dh] projections
// need no transpose and the ragged edges no padding copy. The kernel
// allocates nothing and launches on the caller's stream. The C entry point
// returns cudaGetLastError() so that the Python wrapper can raise on a
// refused launch.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "attention_tc.cuh"   // tile helpers shared with the backward

namespace {

constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;   // [B, Hq, Sq] f32 log-sum-exp of each row's scaled scores,
                // for the backward; null: not written
  // strides in elements of (batch, seq, head); the head dimension is contiguous
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int batch, hq, sq, skv, group, q_offset, causal;
  int tma;      // q, k, v 16-byte aligned (pointers and strides): TMA
  int o_pair;   // o 4-byte aligned (pointer and strides): paired stores
  float scale;        // 1 / sqrt(Dh)
  float scale_log2;   // scale * log2(e)
};

// --------------------------------------------------------------------------
// 16-bit instances: wgmma
// --------------------------------------------------------------------------
constexpr int TC_BQ = 128;          // query rows per block (two warpgroups)
constexpr int TC_BK = 64;           // KV rows per tile
constexpr int TC_CONSUMERS = 256;   // two consumer warpgroups
constexpr int TC_THREADS = TC_CONSUMERS + 32;   // and one producer warp
constexpr int TC_STAGES = 4;        // K/V ring depth
constexpr int TC_BAR_BYTES = 128;   // the ring's mbarriers, ahead of Q

// barriers, up to 1023 bytes to align the tiles, Q and the K/V ring
template <int DH>
constexpr int tc_smem_bytes() {
  return TC_BAR_BYTES + 1024 +
         (TC_BQ + TC_STAGES * 2 * TC_BK) * ((DH + 63) / 64) * 128;
}

// Masks and exponentiates one S tile in place (P in f32), and updates the
// row state: m (running max of the unscaled scores), l (this lane's share
// of the running sum); corr = e^(scale (m_old - m_new)) rescales the
// accumulator. The scale is folded into the exponent: p = 2^(s c - m c)
// with c = scale log2(e), one FFMA and one ex2 a score.
// s[4j + 2i + e] is row qrow + 8i, column k0 + 8j + 2 (lane % 4) + e.
__device__ __forceinline__ void online_softmax(
    float (&s)[32], float (&m)[2], float (&l)[2], float (&corr)[2],
    const Params& p, int k0, int qrow, int row_lo, int lane) {
  const bool edge = k0 + TC_BK > p.skv ||
                    (p.causal && k0 + TC_BK - 1 > row_lo + p.q_offset);
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = s[4 * j + 2 * i + e];
        if (edge) {
          const int col = k0 + 8 * j + 2 * (lane & 3) + e;
          if (col >= p.skv || (p.causal && col > qrow + 8 * i + p.q_offset))
            x = NEG_INF;
        }
        s[4 * j + 2 * i + e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    corr[i] = exp2f((m[i] - m_new) * p.scale_log2);
    m[i] = m_new;
    l[i] *= corr[i];
  }
  const float mc[2] = {m[0] * p.scale_log2, m[1] * p.scale_log2};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pe = exp2f(fmaf(s[4 * j + 2 * i + e], p.scale_log2,
                                    -mc[i]));
        s[4 * j + 2 * i + e] = pe;
        l[i] += pe;
      }
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(TC_THREADS, 1) attn_fwd_tc(
    const Params p, const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv) {
  constexpr int NH = kHalves<DH>;
  constexpr uint32_t Q_BYTES = NH * TC_BQ * 128;
  constexpr uint32_t KV_BYTES = NH * TC_BK * 128;   // K, and V, of a stage
  constexpr int ND = DH / 2;            // O accumulators per thread
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);   // [TC_STAGES]
  uint64_t* empty = full + TC_STAGES;                        // [TC_STAGES]
  uint64_t* q_full = empty + TC_STAGES;
  // swizzled tiles start on 1024-byte boundaries
  unsigned char* tiles = smem_raw + ((smem_u32(smem_raw) + TC_BAR_BYTES +
                                      1023) & ~1023u) - smem_u32(smem_raw);
  unsigned char* qs = tiles;                         // Q
  unsigned char* kvs = tiles + Q_BYTES;              // stages: K, then V

  const int per_qt = p.hq * p.batch;
  const int n_qt = (p.sq + TC_BQ - 1) / TC_BQ;
  int qt = blockIdx.x / per_qt;
  if (p.causal) qt = n_qt - 1 - qt;             // longest causal tiles first
  const int h = (blockIdx.x % per_qt) % p.hq;
  const int b = (blockIdx.x % per_qt) / p.hq;
  const int q0 = qt * TC_BQ;
  // KV positions the block's live rows can see: [0, kv_end)
  int kv_end = p.skv;
  if (p.causal)
    kv_end = min(kv_end, min(p.sq, q0 + TC_BQ) + p.q_offset);
  const int n_kt = (kv_end + TC_BK - 1) / TC_BK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(&full[s], 1);                   // the producer
      mbar_init(&empty[s], TC_CONSUMERS);       // every consumer thread
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= TC_CONSUMERS) {
    // ---- producer warp: Q, then the K/V ring ----
    const int lane = tid % 32;
    const int hk = h / p.group;
    if (p.tma) {                        // TMA, issued by one lane
      if (lane != 0) return;
      mbar_expect_tx(q_full, Q_BYTES);
      for (int c = 0; c < NH; ++c)
        tma_load(qs + c * TC_BQ * 128, &tq, q_full, 64 * c, q0, h, b);
      for (int t = 0; t < n_kt; ++t) {
        const int st = t % TC_STAGES;
        if (t >= TC_STAGES)             // tile t - STAGES released
          mbar_wait(&empty[st], ((t / TC_STAGES) - 1) & 1);
        unsigned char* ks = kvs + st * 2 * KV_BYTES;
        mbar_expect_tx(&full[st], 2 * KV_BYTES);
        for (int c = 0; c < NH; ++c) {
          tma_load(ks + c * TC_BK * 128, &tk, &full[st], 64 * c, t * TC_BK,
                   hk, b);
          tma_load(ks + KV_BYTES + c * TC_BK * 128, &tv, &full[st], 64 * c,
                   t * TC_BK, hk, b);
        }
      }
      return;
    }
    // element loads by the whole warp; lane 0 signals
    const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
    const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
    stage_elements<T, TC_BQ, DH>(qs, qg, p.q_ss, q0, p.sq, lane);
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(q_full);
    for (int t = 0; t < n_kt; ++t) {
      const int st = t % TC_STAGES;
      if (t >= TC_STAGES)
        mbar_wait(&empty[st], ((t / TC_STAGES) - 1) & 1);
      unsigned char* ks = kvs + st * 2 * KV_BYTES;
      stage_elements<T, TC_BK, DH>(ks, kg, p.k_ss, t * TC_BK, p.skv, lane);
      stage_elements<T, TC_BK, DH>(ks + KV_BYTES, vg, p.v_ss, t * TC_BK,
                                   p.skv, lane);
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[st]);
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int row_lo = q0 + 64 * wg;      // the warpgroup's first query
  const int qrow = row_lo + 16 * ((tid % 128) / 32) + lane / 4;  // and +8
  // tiles [0, n_live) reach the warpgroup's rows; later ones (past its
  // causal edge) are only released
  int n_live = 0;
  if (row_lo < p.sq) {
    n_live = n_kt;
    if (p.causal)
      n_live = min(n_kt, (row_lo + 63 + p.q_offset) / TC_BK + 1);
  }

  float o[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) o[j] = 0.f;
  float s[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) s[j] = 0.f;
  uint32_t ph[16], pl[16];
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};               // this lane's share of the row sums
  float corr[2];
  const uint32_t q_at = smem_u32(qs) + wg * 64 * 128;   // the warpgroup's Q
  const uint32_t kv_at = smem_u32(kvs);

  if (n_live > 0) {
    mbar_wait(q_full, 0);
    mbar_wait(&full[0], 0);
    __syncwarp();
    pin(s);
    wg_fence();
    issue_nt<T, DH, TC_BQ * 128, TC_BK * 128>(s, q_at, kv_at);
    wg_commit();
    wg_wait<0>();
    pin(s);
    online_softmax(s, m, l, corr, p, 0, qrow, row_lo, lane);
    a_fragments<T>(s, ph, pl);
    // Tile t's scores go to the tensor cores ahead of tile t-1's P.V; the
    // softmax of tile t then runs while P.V of tile t-1 is in flight.
    for (int t = 1; t < n_live; ++t) {
      const int st = t % TC_STAGES;
      const int sp = (t - 1) % TC_STAGES;
      mbar_wait(&full[st], (t / TC_STAGES) & 1);
      __syncwarp();
      pin(s);
      pin(o);
      pin(ph);
      pin(pl);
      wg_fence();
      issue_nt<T, DH, TC_BQ * 128, TC_BK * 128>(s, q_at, kv_at + st * 2 * KV_BYTES);
      wg_commit();
      issue_rs<T, DH, TC_BK>(o, ph, pl, kv_at + sp * 2 * KV_BYTES + KV_BYTES);
      wg_commit();
      wg_wait<1>();                      // the scores of tile t
      pin(s);
      online_softmax(s, m, l, corr, p, t * TC_BK, qrow, row_lo, lane);
      wg_wait<0>();                      // P.V of tile t-1
      pin(o);
      pin(ph);
      pin(pl);
      mbar_arrive(&empty[sp]);
#pragma unroll
      for (int j = 0; j < ND / 4; ++j) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          o[4 * j + 2 * i] *= corr[i];
          o[4 * j + 2 * i + 1] *= corr[i];
        }
      }
      a_fragments<T>(s, ph, pl);
    }
    const int sl = (n_live - 1) % TC_STAGES;
    pin(o);
    pin(ph);
    pin(pl);
    wg_fence();
    issue_rs<T, DH, TC_BK>(o, ph, pl, kv_at + sl * 2 * KV_BYTES + KV_BYTES);
    wg_commit();
    wg_wait<0>();
    pin(o);
    pin(ph);
    pin(pl);
    mbar_arrive(&empty[sl]);
  }
  for (int t = n_live; t < n_kt; ++t) {   // release what these rows skip
    mbar_wait(&full[t % TC_STAGES], (t / TC_STAGES) & 1);
    mbar_arrive(&empty[t % TC_STAGES]);
  }

  if (row_lo >= p.sq) return;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int row = qrow + 8 * i;
    if (row >= p.sq) continue;
    const float den = fmaxf(li, 1e-30f);
    if (p.lse != nullptr && (lane & 3) == 0)
      p.lse[(static_cast<int64_t>(b) * p.hq + h) * p.sq + row] =
          m[i] * p.scale + logf(den);
    T* orow = og + static_cast<int64_t>(row) * p.o_ss + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < ND / 4; ++j) {
      const float a = o[4 * j + 2 * i] / den;
      const float c = o[4 * j + 2 * i + 1] / den;
      if (p.o_pair) {        // half the store instructions
        store2<T>(orow + 8 * j, a, c);
      } else {
        orow[8 * j] = from_f32<T>(a);
        orow[8 * j + 1] = from_f32<T>(c);
      }
    }
  }
}

// --------------------------------------------------------------------------
// f32 instance: scalar FMAs
// --------------------------------------------------------------------------
constexpr int BQ = 64;              // query rows per block
constexpr int BK = 32;              // KV rows per tile
constexpr int THREADS = 256;
constexpr int TPR = THREADS / BQ;   // threads per query row
constexpr int PSTRIDE = BK + 4;     // probability row stride (bank spread)

template <int DH>
constexpr int smem_floats() {
  return BQ * (DH + 1) + BK * (DH + 1) + BK * DH + BQ * PSTRIDE;
}

// Thread (r, c) holds row r's running max and sum and the accumulator
// columns c, c+4, ... (Dh/4 floats) in registers, and computes the tile's
// scores of columns c, c+4, ... . Q and K rows are padded by one float so
// that the four threads of a row and the eight rows of a warp hit distinct
// banks; the row max and sum are reduced over the row's 4 lanes with
// shuffles, and the probabilities go through shared memory to the same 4
// threads (one __syncwarp, no block barrier) for the P.V product.
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS) attn_fwd(const Params p) {
  extern __shared__ float smem[];
  float* qs = smem;                    // [BQ][DH + 1]
  float* ks = qs + BQ * (DH + 1);      // [BK][DH + 1]
  float* vs = ks + BK * (DH + 1);      // [BK][DH]
  float* ps = vs + BK * DH;            // [BQ][PSTRIDE]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.group;
  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int c = tid % TPR;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int i = tid; i < BQ * DH; i += THREADS) {
    const int row = i / DH, d = i % DH;
    const int qi = q0 + row;
    qs[row * (DH + 1) + d] =
        qi < p.sq ? qg[static_cast<int64_t>(qi) * p.q_ss + d] : 0.f;
  }

  // KV positions this q tile can see: [0, kv_end)
  int kv_end = p.skv;
  if (p.causal) {
    const int last = q0 + BQ - 1 + p.q_offset;
    if (last + 1 < kv_end) kv_end = last + 1;
  }

  constexpr int NS = BK / TPR;   // scores per thread per tile
  constexpr int ND = DH / TPR;   // accumulator columns per thread
  float acc[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j] = 0.f;
  float m = NEG_INF, l = 0.f;
  const int qpos = q0 + r + p.q_offset;
  const float* qrow = qs + r * (DH + 1);
  float* prow = ps + r * PSTRIDE;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();   // Q staged; the previous tile's K/V reads are done
    for (int i = tid; i < BK * DH; i += THREADS) {
      const int row = i / DH, d = i % DH;
      const int kj = k0 + row;
      const bool ok = kj < p.skv;
      ks[row * (DH + 1) + d] =
          ok ? kg[static_cast<int64_t>(kj) * p.k_ss + d] : 0.f;
      vs[row * DH + d] = ok ? vg[static_cast<int64_t>(kj) * p.v_ss + d] : 0.f;
    }
    __syncthreads();

    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int i = 0; i < NS; ++i)
        s[i] = fmaf(qd, ks[(c + TPR * i) * (DH + 1) + d], s[i]);
    }

    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int kj = k0 + c + TPR * i;
      const bool ok = kj < p.skv && (!p.causal || kj <= qpos);
      s[i] = ok ? s[i] * p.scale : NEG_INF;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const float e = expf(s[i] - m_new);
      sum += e;
      prow[c + TPR * i] = e;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l = l * corr + sum;
    m = m_new;
    __syncwarp();      // the row's probabilities are visible to its 4 lanes

#pragma unroll
    for (int j = 0; j < ND; ++j) acc[j] *= corr;
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float pk = prow[kk];
      const float* vrow = vs + kk * DH + c;
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[j] = fmaf(pk, vrow[TPR * j], acc[j]);
    }
    __syncwarp();      // reads of prow done before the next tile writes it
  }

  const int qi = q0 + r;
  if (qi < p.sq) {
    const float den = fmaxf(l, 1e-30f);
    if (p.lse != nullptr && c == 0)
      p.lse[(static_cast<int64_t>(b) * p.hq + h) * p.sq + qi] = m + logf(den);
    T* og = static_cast<T*>(p.o) + b * p.o_sb + static_cast<int64_t>(qi) * p.o_ss +
            h * p.o_sh;
#pragma unroll
    for (int j = 0; j < ND; ++j) og[c + TPR * j] = from_f32<T>(acc[j] / den);
  }
}

// --------------------------------------------------------------------------
// launch
// --------------------------------------------------------------------------
template <int DH>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  constexpr int bytes = smem_floats<DH>() * static_cast<int>(sizeof(float));
  // above 48 KB a block's shared memory must be opted into, once per kernel
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_fwd<float, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  if (p.batch > 65535 || p.hq > 65535) return cudaErrorInvalidValue;
  const dim3 grid((p.sq + BQ - 1) / BQ, p.hq, p.batch);
  attn_fwd<float, DH><<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_tc(const Params& p, cudaStream_t stream) {
  constexpr int bytes = tc_smem_bytes<DH>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_fwd_tc<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  const long long blocks = static_cast<long long>((p.sq + TC_BQ - 1) / TC_BQ)
                         * p.hq * p.batch;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  CUtensorMap tq = {}, tk = {}, tv = {};   // unused on the element path
  const int hkv = p.hq / p.group;
  if (p.tma &&
      !(encode_view<T>(&tq, p.q, DH, p.sq, p.hq, p.batch, p.q_ss, p.q_sh,
                       p.q_sb, TC_BQ) &&
        encode_view<T>(&tk, p.k, DH, p.skv, hkv, p.batch, p.k_ss, p.k_sh,
                       p.k_sb, TC_BK) &&
        encode_view<T>(&tv, p.v, DH, p.skv, hkv, p.batch, p.v_ss, p.v_sh,
                       p.v_sb, TC_BK)))
    return cudaErrorInvalidValue;
  attn_fwd_tc<T, DH><<<static_cast<unsigned>(blocks), TC_THREADS, bytes,
                       stream>>>(p, tq, tk, tv);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_one(const Params& p, cudaStream_t stream) {
  if constexpr (sizeof(T) == 4) return launch_f32<DH>(p, stream);
  else return launch_tc<T, DH>(p, stream);
}

template <typename T>
cudaError_t launch_dh(const Params& p, int dh, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch_one<T, 32>(p, stream);
    case 64: return launch_one<T, 64>(p, stream);
    case 112: return launch_one<T, 112>(p, stream);   // zamba2-7b
    case 128: return launch_one<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, Sq, Hq, Dh], k/v [B, Skv, Hkv, Dh], o [B, Sq, Hq, Dh]; each given by
// its pointer and (batch, seq, head) strides in elements, the last dimension
// contiguous. lse, when not null, receives each row's log-sum-exp of its
// scaled, masked scores, f32 [B, Hq, Sq] contiguous (the backward's input). dtype: 0 = float32 (scalar instance), 1 = float16, 2 =
// bfloat16 (wgmma instances). Dh is 32, 64, 112 or 128. Returns a
// cudaError_t (0 = launched).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int batch, int sq, int skv, int hq, int hkv, int dh, int q_offset,
    int causal, int dtype, void* stream) {
  if (batch <= 0 || sq <= 0 || skv <= 0 || hq <= 0 || hkv <= 0 ||
      hq % hkv != 0 || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.lse = lse;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.batch = batch; p.hq = hq;
  p.sq = sq; p.skv = skv; p.group = hq / hkv; p.q_offset = q_offset;
  p.causal = causal ? 1 : 0;
  const double scale = 1.0 / sqrt(static_cast<double>(dh));
  p.scale = static_cast<float>(scale);
  p.scale_log2 = static_cast<float>(scale * 1.4426950408889634);
  p.tma = aligned16(q, batch, q_sb, sq, q_ss, hq, q_sh) &&
          aligned16(k, batch, k_sb, skv, k_ss, hkv, k_sh) &&
          aligned16(v, batch, v_sb, skv, v_ss, hkv, v_sh);
  p.o_pair = reinterpret_cast<uintptr_t>(o) % 4 == 0 && o_sb % 2 == 0 &&
             o_ss % 2 == 0 && o_sh % 2 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_dh<float>(p, dh, s));
    case 1: return static_cast<int>(launch_dh<__half>(p, dh, s));
    case 2: return static_cast<int>(launch_dh<__nv_bfloat16>(p, dh, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
