// RWKV-6 chunked WKV (forward) for Hopper (sm_90a).
//
// Replaces repro/kernels/rwkv6/kernel.py::_wkv6_kernel (the Pallas TPU
// kernel launched by wkv6_kernel). Same function, per (batch, head), from a
// zero f32 state S [P, P], in chunks of c rows:
//   lcw = cumsum(lw) over the chunk, prev_t = lcw_{t-1} (0 at t = 0);
//   A[t,s] = sum_p r_t k_s exp(prev_t - lcw_s)  for s < t,
//   A[t,t] = sum_p r_t u k_t                     (the bonus);
//   y_t = sum_{s<=t} A[t,s] v_s + (r_t * exp(prev_t)) S;
//   S <- exp(lcw_last) * S + (k * exp(lcw_last - lcw))^T v.
// Every exponent is <= 0: no ratio of decays, which would overflow where
// lw reaches -20 a step.
//
// Bound. At rwkv6-7b's main-path shape (B 2, S 8192, H 64, P 64, chunk 32,
// f32) the call moves r, k, v, lw in and y out, 1.34 GB (0.40 ms at 3.35
// TB/s). By the reference's formula it does ~24 G operations (0.36 ms at
// 67 TFLOP/s f32), 1.04 G of them exponentials: it is bound by bytes.
//
// Design. Only the state couples the chunks, and its recurrence is
// S <- diag(exp(lcw_last)) S + U_c, with U_c = (k * exp(lcw_last - lcw))^T v
// independent of S. So the scan is three launches on the caller's stream,
// through an f32 workspace the wrapper allocates: [B, H, ng, P, P] states
// and [B, H, ng, P] decays, ng = ceil(n_chunks / G) groups of G chunks
// (34 MB at the main shape with the wrapper's G = 16). The passes move
// ~2.3 GB in all there: k, v, lw twice, r and y once, the states four
// times (written, read and rewritten, read).
//   1. wkv6_states, one block per (b, group, h): walks the group's chunks
//      in order from a zero state, S_g <- d_c S_g + U_c, and the group's
//      decay D_g = prod_c d_c, d_c = exp(lcw_last) per channel. No
//      cumulative sum spans more than one chunk, so no exponent's argument
//      does either. (The last group's state is never read: its block
//      returns at once.)
//   2. wkv6_carry, one thread per (b, h, 4 state elements): walks the
//      groups in order and overwrites each S_g with the state entering
//      group g, h <- D_g h + S_g. Elementwise, bound by bytes.
//   3. wkv6_out, one block per (b, group, h): loads the state entering the
//      group and walks its chunks: y = A v + (r exp(prev)) S, stored once,
//      then S <- d S + U in shared memory (not after the group's last).
// Two calls on the same inputs give the same bytes: no atomics, no split
// across blocks, every sum in a fixed order.
//
// The exponentials. The reference forms exp(prev_t - lcw_s) for every
// (t, s, p): 1.04 G a call. Here, for s before the 8-row sub-block of t
// (a0 its first row, b0 + 7 the last row of s's sub-block),
//   exp(prev_t - lcw_s) = exp(prev_t - lcw_{a0-1}) exp(lcw_{a0-1} - lcw_{b0+7})
//                         exp(lcw_{b0+7} - lcw_s),
// three factors <= 1 (nothing overflows; a product that underflows is one
// whose exact value underflows too): a per-row rescaled r, a per-(sub-block
// pair, channel) factor and a per-row rescaled k, so A outside the diagonal
// 8 x 8 blocks is a plain product. Per-pair exponentials remain inside the
// diagonal blocks. With the rescaled rows that is ~16 K exponentials a
// 32-row chunk in pass 3 (the reference's 31.7 K), and each factor of a
// chunk constant (exp(lcw_last)) is taken once per channel.
//
// Layout of pass 3. Per chunk, f32 tiles in shared memory with rows of 64
// channels: r, k, v, lw and lcw; r and k rescaled for A; k * exp(lcw_last -
// lcw) for the state update; r * exp(prev) and A transposed (so that a
// thread reads 8 rows of one column as 16-byte vectors); S [P][P]: ~98 KB,
// two blocks of 256 threads a SM. Phases per chunk, a barrier between each:
//   * the column scans (thread p sums its channel's lw in row order, so
//     every thread of a channel has the same lcw) and the rescaled rows;
//   * A: one warp per off-diagonal 8 x 8 block (4 x 4 outputs a lane, the
//     channels split over 8 lanes and summed by shuffles), and per half-row
//     of the diagonal blocks (over 16 lanes);
//   * y = [r exp(prev) | A] [S ; v] on warps 0-3, 8 x 8 outputs a lane and
//     the 64 + 32 terms split in four; the parts past the first leave their
//     sums in the lcw and rescaled tiles and the first adds them in order.
//     Meanwhile warps 4-7 form U, 8 x 4 outputs a lane;
//   * S <- d S + U in place.
// A chunk's lw, r and k, and v go to their tiles by cp.async (16-byte rows)
// as soon as the chunk before has last read each tile, so that the loads
// overlap that chunk's later phases; pass 1 double-buffers its k, v, lw.
// Rows past S are zero (lw = 0, r = k = v = 0): they leave the state
// unchanged and are not written, as the reference wrapper's padding.
//
// Numbers. The recurrences round as the plain version writes them:
// exp(lcw_last) * S + U (no fused multiply-add across them). The
// exponentials are __expf (ex2.approx of the argument scaled by log2 e):
// for arguments in [-10, 0] ~1e-6 relative, far below the float32 rule
// (1e-3). The products stay on the f32 FMA units: one rounding to TF32
// breaks the float32 rule, and 3xTF32 on mma.sync kept it but was no
// faster here (tests/test_torch_wkv6.py emulates the passes and both).
//
// Each kernel allocates nothing and launches on the caller's stream, so
// the workspace's write by pass 1, its overwrite by pass 2 and its read by
// pass 3 are ordered by the stream. The C entry point returns the first
// cudaGetLastError() that is not 0 so that the Python wrapper can raise on
// a refused launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int MAX_P = 64;       // head size: the tiles' row width
constexpr int MAX_C = 64;       // chunk
constexpr int SB = 8;           // rows of a sub-block (the anchors' spacing)
constexpr int THREADS = 256;
constexpr int PASS_THREADS = 256;
constexpr int PASS_AHEAD = 8;   // group states loaded ahead in pass 2
constexpr int Q4 = MAX_P / 4;   // float4s in a tile row

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// four neighbouring elements as one vector load or store
template <typename T> __device__ __forceinline__ float4 ld4(const T* p);
template <> __device__ __forceinline__ float4 ld4<float>(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
template <> __device__ __forceinline__ float4 ld4<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <typename T> __device__ __forceinline__ void st4(T* p, float4 v);
template <> __device__ __forceinline__ void st4<float>(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
template <> __device__ __forceinline__ void st4<__nv_bfloat16>(
    __nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// elements q..q+3 of a row of P (zero past P); `vec`: P % 4 == 0 and the
// rows are aligned for 4-element vectors
template <typename T>
__device__ __forceinline__ float4 load_q4(const T* row, int q, int P,
                                          bool vec) {
  if (q >= P) return make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec) return ld4(row + q);
  float e[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = q + i < P ? to_f32(row[q + i]) : 0.f;
  return make_float4(e[0], e[1], e[2], e[3]);
}

template <typename T>
__device__ __forceinline__ void store_q4(T* row, int q, int P, bool vec,
                                         float4 v) {
  if (q >= P) return;
  if (vec) {
    st4(row + q, v);
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (q + i < P) row[q + i] = from_f32<T>(e[i]);
}

struct Params {
  const void* r;     // [B, S, H, P]
  const void* k;
  const void* v;
  const void* lw;
  const float* u;    // [H, P] f32
  void* y;           // [B, S, H, P]
  float* states;     // [B, H, ng, P, P]
  float* decays;     // [B, H, ng, P]
  int batch, seq, heads, p, chunk, nc, group, ng, vec;
};

// a block's (b, group, h), h fastest: neighbouring blocks read neighbouring
// heads of the same rows
struct BlockPos {
  int b, g, h;
  __device__ BlockPos(const Params& prm) {
    h = blockIdx.x % prm.heads;
    const int rest = blockIdx.x / prm.heads;
    g = rest % prm.ng;
    b = rest / prm.ng;
  }
};

// ---------------------------------------------------------------------------
// Staging: one tensor's rows of a chunk into an f32 tile [MC][64]. f32 rows
// that are 16-byte vectors go by cp.async (zero-filled past the chunk's
// rows and past P), the rest by loads through registers, converted.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

template <typename T, int MC>
__device__ __forceinline__ void stage(float* tile, const T* src, int64_t rs,
                                      int n, int P, bool vec, int tid) {
  constexpr int PER = MC * Q4 / THREADS;   // float4s a thread
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int i = tid + k * THREADS, t = i / Q4, q = (i % Q4) * 4;
        const bool ok = t < n && q < P;
        cp_async16(tile + 4 * i, ok ? src + t * rs + q : src, ok);
      }
      return;
    }
  }
  float4 reg[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = tid + k * THREADS, t = i / Q4, q = (i % Q4) * 4;
    reg[k] = t < n ? load_q4(src + t * rs, q, P, vec)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int k = 0; k < PER; ++k)
    reinterpret_cast<float4*>(tile)[tid + k * THREADS] = reg[k];
}

// The column scan: thread (p, sg0) sums channel p's lw over the chunk in row
// order. `own[o]` are lcw of rows SB * (sg0 + 4 o) + r, `start[o]` lcw before
// that sub-block, `fin[o]` after it; `anc[a]` lcw before sub-block a.
template <int MC>
struct Scan {
  static constexpr int NSB = MC / SB, NO = MC / 32;
  float own[NO][SB], start[NO], fin[NO], anc[NSB], last;

  __device__ __forceinline__ Scan(const float* L, int p, int sg0) {
    float run = 0.f;
#pragma unroll
    for (int t = 0; t < MC; ++t) {
      const int s = t / SB, r = t % SB;
      if (r == 0) anc[s] = run;
      run += L[t * MAX_P + p];
#pragma unroll
      for (int o = 0; o < NO; ++o) {
        if (s == sg0 + 4 * o) {
          own[o][r] = run;
          if (r == 0) start[o] = anc[s];
          if (r == SB - 1) fin[o] = run;
        }
      }
    }
    last = run;
  }
};

// Sum 16 partial values over 2^STEPS neighbouring lanes: afterwards lane l
// holds the sums of entries base .. base + (16 >> STEPS) - 1 in v[0..],
// base = 8 (l & 1) + 4 ((l >> 1) & 1) + 2 ((l >> 2) & 1) + ((l >> 3) & 1),
// as far as STEPS reaches.
template <int STEPS>
__device__ __forceinline__ void reduce_scatter(float (&v)[16], int lane) {
#pragma unroll
  for (int st = 0; st < STEPS; ++st) {
    const int off = 1 << st, half = 16 >> (st + 1);
    const bool up = lane & off;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = up ? v[i] : v[i + half];
      const float keep = up ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
}

template <int STEPS>
__device__ __forceinline__ int scatter_base(int lane) {
  int base = 0;
#pragma unroll
  for (int st = 0; st < STEPS; ++st)
    if (lane & (1 << st)) base += 16 >> (st + 1);
  return base;
}

// rows of the chunk starting at row t0 that lie inside S
__device__ __forceinline__ int rows_in(int seq, int64_t t0, int c) {
  const int64_t left = seq - t0;
  return left < c ? static_cast<int>(left) : c;
}

__device__ __forceinline__ float4 f4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// ---------------------------------------------------------------------------
// Pass 1: each group's own state S_g [P, P] and decay D_g [P].
// ---------------------------------------------------------------------------
template <int MC> constexpr int states_smem_floats() {
  // two buffers of k (then k * tail), v, lw [MC][64] and d [64]
  return 2 * (3 * MC * MAX_P + MAX_P);
}

template <typename T, int MC>
__global__ void __launch_bounds__(THREADS, MC == 32 ? 3 : 2)
wkv6_states(const Params prm) {
  extern __shared__ __align__(16) float sm[];
  constexpr int BUF = 3 * MC * MAX_P + MAX_P;
  const BlockPos pos(prm);
  if (pos.g == prm.ng - 1) return;        // its state enters no group
  const int P = prm.p, C = prm.chunk, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int64_t rs = static_cast<int64_t>(prm.heads) * P;   // one time step
  const int c0 = pos.g * prm.group;
  const int nj = min(prm.group, prm.nc - c0);
  const int64_t head0 = static_cast<int64_t>(pos.b) * prm.seq * rs +
                        static_cast<int64_t>(pos.h) * P;
  const bool vec = prm.vec;

  // chunk j's k, v, lw into buffer j % 2, as one cp.async group
  auto fetch = [&](int j) {
    float* buf = sm + (j % 2) * BUF;
    const int64_t t0 = static_cast<int64_t>(c0 + j) * C;
    const int n = rows_in(prm.seq, t0, C);
    const int64_t off = head0 + t0 * rs;
    stage<T, MC>(buf, static_cast<const T*>(prm.k) + off, rs, n, P, vec, tid);
    stage<T, MC>(buf + MC * MAX_P, static_cast<const T*>(prm.v) + off, rs, n,
                 P, vec, tid);
    stage<T, MC>(buf + 2 * MC * MAX_P, static_cast<const T*>(prm.lw) + off,
                 rs, n, P, vec, tid);
    cp_commit();
  };
  fetch(0);
  // S rows p0..p0+3, columns q0..q0+3
  const int p0 = 8 * warp + 4 * (lane / 16), q0 = 4 * (lane % 16);
  float S[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) S[i][j] = 0.f;
  float dg = 1.f;                         // D_g of channel tid (tid < 64)
  const int cp = tid % MAX_P, sg0 = tid / MAX_P;

  for (int j = 0; j < nj; ++j) {
    cp_wait<0>();
    __syncthreads();   // chunk j has landed; chunk j - 1's buffer is read
    if (j + 1 < nj) fetch(j + 1);
    float* K = sm + (j % 2) * BUF;
    const float* V = K + MC * MAX_P;
    const float* L = V + MC * MAX_P;
    float* ds = K + 3 * MC * MAX_P;
    {  // k * exp(lcw_last - lcw) in place, and d = exp(lcw_last)
      const Scan<MC> sc(L, cp, sg0);
#pragma unroll
      for (int o = 0; o < Scan<MC>::NO; ++o)
#pragma unroll
        for (int r = 0; r < SB; ++r) {
          const int t = SB * (sg0 + 4 * o) + r;
          K[t * MAX_P + cp] *= __expf(sc.last - sc.own[o][r]);
        }
      if (sg0 == 0) {
        const float d = __expf(sc.last);
        ds[cp] = d;
        dg = __fmul_rn(dg, d);
      }
    }
    __syncthreads();
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;
#pragma unroll 4
    for (int s = 0; s < C; ++s) {
      const float4 a = f4(K + s * MAX_P + p0);
      const float4 b = f4(V + s * MAX_P + q0);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float d = ds[p0 + i];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        S[i][jj] = __fadd_rn(__fmul_rn(d, S[i][jj]), acc[i][jj]);
    }
  }
  const int64_t slot = (static_cast<int64_t>(pos.b) * prm.heads + pos.h) *
                           prm.ng + pos.g;
  float* out = prm.states + slot * P * P;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      if (p0 + i < P && q0 + jj < P) out[(p0 + i) * P + q0 + jj] = S[i][jj];
  if (tid < P) prm.decays[slot * P + tid] = dg;
}

// ---------------------------------------------------------------------------
// Pass 2: the states entering each group, in place over S_g.
// ---------------------------------------------------------------------------
// Each thread carries V neighbouring state elements of one row p (V = 4:
// 16-byte loads and stores, when P is a multiple of 4).
template <int V>
__global__ void __launch_bounds__(PASS_THREADS) wkv6_carry(const Params prm) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const int P = prm.p;
  const int64_t pp = static_cast<int64_t>(P) * P;
  const int64_t i = (static_cast<int64_t>(blockIdx.y) * PASS_THREADS +
                     threadIdx.x) * V;
  if (i >= pp) return;
  const int64_t bh = blockIdx.x;
  Vec* st = reinterpret_cast<Vec*>(prm.states + bh * prm.ng * pp + i);
  const int64_t step = pp / V;              // one group's states, in Vecs
  const float* dec = prm.decays + bh * prm.ng * P + i / P;
  float h[V];
#pragma unroll
  for (int j = 0; j < V; ++j) h[j] = 0.f;
  for (int g0 = 0; g0 < prm.ng; g0 += PASS_AHEAD) {
    Vec s[PASS_AHEAD];
    float d[PASS_AHEAD];
#pragma unroll
    for (int k = 0; k < PASS_AHEAD; ++k) {
      if (g0 + k < prm.ng - 1) {            // the last group's is not read
        s[k] = st[(g0 + k) * step];
        d[k] = dec[static_cast<int64_t>(g0 + k) * P];
      }
    }
#pragma unroll
    for (int k = 0; k < PASS_AHEAD; ++k) {
      if (g0 + k < prm.ng) {
        Vec out;
        float* ov = reinterpret_cast<float*>(&out);
#pragma unroll
        for (int j = 0; j < V; ++j) ov[j] = h[j];
        if (g0 + k < prm.ng - 1) {
          const float* sv = reinterpret_cast<const float*>(&s[k]);
#pragma unroll
          for (int j = 0; j < V; ++j)
            h[j] = __fadd_rn(__fmul_rn(d[k], h[j]), sv[j]);
        }
        st[(g0 + k) * step] = out;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 3: the outputs of one (b, group, h).
// ---------------------------------------------------------------------------
template <int MC> struct OutTiles {
  static constexpr int NSB = MC / SB;
  static constexpr int NOFF = NSB * (NSB - 1) / 2;   // off-diagonal blocks
  static constexpr int AS = MC + 4;   // row stride of the transposed tiles:
                                      // 16-byte rows, their stores spread
                                      // over the banks
  static constexpr int TILE = MC * MAX_P;
  // r, k, v, lw, lcw, r rescaled, k rescaled, k * tail [MC][64];
  // (r exp(prev))^T [64][AS]; A^T [MC][AS]; S [64][64]; M [NOFF][64];
  // u [64]; d [64]
  static constexpr int FLOATS = 8 * TILE + MAX_P * AS + MC * AS +
                                MAX_P * MAX_P + NOFF * MAX_P + 2 * MAX_P;
};

template <typename T, int MC>
__global__ void __launch_bounds__(THREADS, MC == 32 ? 2 : 1)
wkv6_out(const Params prm) {
  using Tl = OutTiles<MC>;
  constexpr int NSB = Tl::NSB, NOFF = Tl::NOFF, AS = Tl::AS;
  extern __shared__ __align__(16) float sm[];
  float* R = sm;                     // r
  float* K = R + Tl::TILE;           // k
  float* V = K + Tl::TILE;           // v
  float* L = V + Tl::TILE;           // lw
  float* LC = L + Tl::TILE;          // lcw
  float* RH = LC + Tl::TILE;         // r exp(prev - lcw before its sub-block)
  float* KH = RH + Tl::TILE;         // k exp(lcw after its sub-block - lcw)
  float* KT = KH + Tl::TILE;         // k exp(lcw_last - lcw)
  float* RET = KT + Tl::TILE;        // (r exp(prev))^T [64][AS]
  float* AT = RET + MAX_P * AS;      // A^T [MC][AS]: [s][t]
  float* Ssm = AT + MC * AS;         // S [64][64]
  float* M = Ssm + MAX_P * MAX_P;    // [pair(a, b)][64]
  float* us = M + NOFF * MAX_P;      // u
  float* ds = us + MAX_P;            // exp(lcw_last)

  const BlockPos pos(prm);
  const int P = prm.p, C = prm.chunk, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int64_t rs = static_cast<int64_t>(prm.heads) * P;
  const int c0 = pos.g * prm.group;
  const int nj = min(prm.group, prm.nc - c0);
  const int64_t head0 = static_cast<int64_t>(pos.b) * prm.seq * rs +
                        static_cast<int64_t>(pos.h) * P;
  const bool vec = prm.vec;

  // chunk j's lw, then r and k, then v, each as one cp.async group, each
  // started once the tile it lands in is no longer read (an empty group
  // past the last chunk keeps the count)
  auto fetch = [&](int j, int what) {
    if (j < nj) {
      const int64_t t0 = static_cast<int64_t>(c0 + j) * C;
      const int n = rows_in(prm.seq, t0, C);
      const int64_t off = head0 + t0 * rs;
      if (what == 0) {
        stage<T, MC>(L, static_cast<const T*>(prm.lw) + off, rs, n, P, vec,
                     tid);
      } else if (what == 1) {
        stage<T, MC>(R, static_cast<const T*>(prm.r) + off, rs, n, P, vec,
                     tid);
        stage<T, MC>(K, static_cast<const T*>(prm.k) + off, rs, n, P, vec,
                     tid);
      } else {
        stage<T, MC>(V, static_cast<const T*>(prm.v) + off, rs, n, P, vec,
                     tid);
      }
    }
    cp_commit();
  };
  fetch(0, 0);
  fetch(0, 1);
  fetch(0, 2);
  {  // the state entering the group; A^T zero (its upper part stays so)
    const int64_t slot = (static_cast<int64_t>(pos.b) * prm.heads + pos.h) *
                             prm.ng + pos.g;
    const float* in = prm.states + slot * P * P;
    for (int i = tid; i < MAX_P * MAX_P; i += THREADS) {
      const int p = i / MAX_P, q = i % MAX_P;
      Ssm[i] = p < P && q < P ? in[p * P + q] : 0.f;
    }
    for (int i = tid; i < MC * AS; i += THREADS) AT[i] = 0.f;
    if (tid < MAX_P) us[tid] = tid < P ? prm.u[pos.h * P + tid] : 0.f;
  }
  const int cp = tid % MAX_P, sg0 = tid / MAX_P;

  for (int j = 0; j < nj; ++j) {
    const int n = rows_in(prm.seq, static_cast<int64_t>(c0 + j) * C, C);
    cp_wait<1>();      // lw, r, k of chunk j (v may be in flight)
    __syncthreads();

    // --- the column scans and the rescaled rows -----------------------------
    {
      const Scan<MC> sc(L, cp, sg0);
#pragma unroll
      for (int o = 0; o < Scan<MC>::NO; ++o) {
        const int sg = sg0 + 4 * o;
        float ret[SB];
#pragma unroll
        for (int r = 0; r < SB; ++r) {
          const int t = SB * sg + r, e = t * MAX_P + cp;
          const float lc = sc.own[o][r];
          const float prev = r == 0 ? sc.start[o] : sc.own[o][r - 1];
          const float rv = R[e], kv = K[e];
          LC[e] = lc;
          RH[e] = rv * __expf(prev - sc.start[o]);
          KH[e] = kv * __expf(sc.fin[o] - lc);
          KT[e] = kv * __expf(sc.last - lc);
          ret[r] = rv * __expf(prev);
        }
        float4* rt = reinterpret_cast<float4*>(RET + cp * AS + SB * sg);
        rt[0] = make_float4(ret[0], ret[1], ret[2], ret[3]);
        rt[1] = make_float4(ret[4], ret[5], ret[6], ret[7]);
#pragma unroll
        for (int a = 1; a < NSB; ++a)
          if (a > sg)
            M[(a * (a - 1) / 2 + sg) * MAX_P + cp] = __expf(sc.anc[a] - sc.fin[o]);
      }
      if (sg0 == 0) ds[cp] = __expf(sc.last);
    }
    __syncthreads();
    fetch(j + 1, 0);

    // --- A^T ------------------------------------------------------------------
    // warp tasks: NSB / 2 of full 4 x 4 tiles below the diagonal inside the
    // diagonal blocks, NOFF off-diagonal blocks, NSB of diagonal 4 x 4 tiles
    // (numbered after NSB / 2 skipped slots, so that they do not fall to the
    // warps of the full tiles, the longest)
    {
      constexpr int NF = NSB / 2;
      for (int wt = warp; wt < 2 * NF + NOFF + NSB; wt += THREADS / 32) {
        if (wt >= NF + NOFF && wt < 2 * NF + NOFF) continue;
        float acc[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[i] = 0.f;
        if (wt >= NF && wt < NF + NOFF) {
          // off-diagonal block (a, b): sum_p (rh_t m_ab) kh_s; lane: 4 x 4
          // tile tau, channels 4 (part + 8 it) .. + 3
          const int pi = wt - NF;
          int a = 1;
          while (a * (a + 1) / 2 <= pi) ++a;
          const int b = pi - a * (a - 1) / 2;
          const int tau = lane / 8, part = lane % 8;
          const int t0 = SB * a + 4 * (tau / 2), s0 = SB * b + 4 * (tau % 2);
#pragma unroll
          for (int it = 0; it < 2; ++it) {
            const int c4 = part + 8 * it;
            const float4 m = f4(M + pi * MAX_P + 4 * c4);
            float4 kh[4];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) kh[jj] = f4(KH + (s0 + jj) * MAX_P + 4 * c4);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float4 rh = f4(RH + (t0 + i) * MAX_P + 4 * c4);
              const float4 rm = make_float4(rh.x * m.x, rh.y * m.y, rh.z * m.z,
                                            rh.w * m.w);
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) {
                float x = acc[i * 4 + jj];
                x = fmaf(rm.x, kh[jj].x, x);
                x = fmaf(rm.y, kh[jj].y, x);
                x = fmaf(rm.z, kh[jj].z, x);
                x = fmaf(rm.w, kh[jj].w, x);
                acc[i * 4 + jj] = x;
              }
            }
          }
          reduce_scatter<3>(acc, lane);
          const int base = scatter_base<3>(lane);
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int idx = base + x, i = idx / 4, jj = idx % 4;
            AT[(s0 + jj) * AS + t0 + i] = acc[x];
          }
        } else {
          // inside a diagonal block: per-pair exponentials; lane: one
          // 4 x 4 tile (z), channels 4 part .. + 3
          const bool full = wt < NF;
          const int z = 2 * (full ? wt : wt - 2 * NF - NOFF) + lane / 16;
          const int part = lane % 16;
          const int t0 = full ? SB * z + 4 : SB * (z / 2) + 4 * (z % 2);
          const int s0 = full ? SB * z : t0;
          float4 kk[4], ll[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            kk[jj] = f4(K + (s0 + jj) * MAX_P + 4 * part);
            ll[jj] = f4(LC + (s0 + jj) * MAX_P + 4 * part);
          }
          const float4 uu = f4(us + 4 * part);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int t = t0 + i;
            const float4 rr = f4(R + t * MAX_P + 4 * part);
            // prev_t = lcw_{t-1}; t = 0 (i = 0 of a diagonal tile) needs none
            const float4 pv = (full || i > 0)
                ? f4(LC + (t - 1) * MAX_P + 4 * part)
                : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              float x = 0.f;
              if (full || jj < i) {
                x = fmaf(rr.x * __expf(pv.x - ll[jj].x), kk[jj].x, x);
                x = fmaf(rr.y * __expf(pv.y - ll[jj].y), kk[jj].y, x);
                x = fmaf(rr.z * __expf(pv.z - ll[jj].z), kk[jj].z, x);
                x = fmaf(rr.w * __expf(pv.w - ll[jj].w), kk[jj].w, x);
              } else if (jj == i) {   // the bonus
                x = fmaf(rr.x * uu.x, kk[jj].x, x);
                x = fmaf(rr.y * uu.y, kk[jj].y, x);
                x = fmaf(rr.z * uu.z, kk[jj].z, x);
                x = fmaf(rr.w * uu.w, kk[jj].w, x);
              }
              acc[i * 4 + jj] = x;
            }
          }
          reduce_scatter<4>(acc, lane);
          const int idx = scatter_base<4>(lane), i = idx / 4, jj = idx % 4;
          if (full || jj <= i) AT[(s0 + jj) * AS + t0 + i] = acc[0];
        }
      }
    }
    cp_wait<1>();      // v of chunk j
    __syncthreads();
    fetch(j + 1, 1);

    // --- y (warps 0-3) and the chunk's state update U (warps 4-7) -------------
    // y = [r exp(prev) | A] [S ; v]: 8 x 8 outputs a lane (rows r0.., columns
    // ca.. and cb..), the 64 + MC terms split in KP parts over the warps; a
    // part past the first leaves its sums in the lcw and rescaled tiles (no
    // longer read this chunk), and the first adds them in order. U = (k
    // tail)^T v: 8 x 4 outputs a lane.
    const bool update = j + 1 < nj;       // the group's last chunk needs none
    constexpr int KP = 128 / MC;          // y's parts: 4 or 2
    constexpr int KLEN = (MAX_P + MC) / KP;   // terms a part: 24 or 64
    float* YP = LC;                       // [KP - 1][MC][64]
    const int part = warp / (MC / 32);
    const int tile = (warp % (MC / 32)) * 32 + lane;
    const int r0 = 8 * (tile / 8), ca = 4 * (tile % 8), cb = 32 + ca;
    const int up0 = 8 * ((warp - 4) * 2 + lane / 16), uq0 = 4 * (lane % 16);
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) acc[i][jj] = 0.f;
    if (warp < 4) {
      const int lo = part * KLEN, hi = lo + KLEN;
#pragma unroll 2
      for (int p = lo; p < min(hi, MAX_P); ++p) {
        const float4 a0 = f4(RET + p * AS + r0), a1 = f4(RET + p * AS + r0 + 4);
        const float4 b0 = f4(Ssm + p * MAX_P + ca);
        const float4 b1 = f4(Ssm + p * MAX_P + cb);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
      }
#pragma unroll 2
      for (int s = max(lo, MAX_P) - MAX_P; s < hi - MAX_P; ++s) {
        const float4 a0 = f4(AT + s * AS + r0), a1 = f4(AT + s * AS + r0 + 4);
        const float4 b0 = f4(V + s * MAX_P + ca);
        const float4 b1 = f4(V + s * MAX_P + cb);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
      }
      if (part > 0) {
        float* yp = YP + (part - 1) * MC * MAX_P;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          *reinterpret_cast<float4*>(yp + (r0 + i) * MAX_P + ca) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          *reinterpret_cast<float4*>(yp + (r0 + i) * MAX_P + cb) =
              make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        }
      }
    } else if (update) {
#pragma unroll 2
      for (int s = 0; s < C; ++s) {
        const float4 a0 = f4(KT + s * MAX_P + up0);
        const float4 a1 = f4(KT + s * MAX_P + up0 + 4);
        const float4 b = f4(V + s * MAX_P + uq0);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
      }
    }
    __syncthreads();   // y has read S and v; the parts' sums are in place
    fetch(j + 1, 2);
    if (warp < 4 && part == 0) {
#pragma unroll
      for (int k = 1; k < KP; ++k) {
        const float* yp = YP + (k - 1) * MC * MAX_P;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 x0 = f4(yp + (r0 + i) * MAX_P + ca);
          const float4 x1 = f4(yp + (r0 + i) * MAX_P + cb);
          acc[i][0] += x0.x; acc[i][1] += x0.y; acc[i][2] += x0.z; acc[i][3] += x0.w;
          acc[i][4] += x1.x; acc[i][5] += x1.y; acc[i][6] += x1.z; acc[i][7] += x1.w;
        }
      }
      T* yg = static_cast<T*>(prm.y) + head0 +
              static_cast<int64_t>(c0 + j) * C * rs;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = r0 + i;
        if (t < n) {
          store_q4(yg + t * rs, ca, P, vec,
                   make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
          store_q4(yg + t * rs, cb, P, vec,
                   make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
        }
      }
    }
    if (warp >= 4 && update) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float d = ds[up0 + i];
        float4* row = reinterpret_cast<float4*>(Ssm + (up0 + i) * MAX_P + uq0);
        const float4 o = *row;
        *row = make_float4(__fadd_rn(__fmul_rn(d, o.x), acc[i][0]),
                           __fadd_rn(__fmul_rn(d, o.y), acc[i][1]),
                           __fadd_rn(__fmul_rn(d, o.z), acc[i][2]),
                           __fadd_rn(__fmul_rn(d, o.w), acc[i][3]));
      }
    }
  }
}

template <typename T, int MC>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int st_bytes = states_smem_floats<MC>() * 4;
  constexpr int out_bytes = OutTiles<MC>::FLOATS * 4;
  // opted in once per instance
  static const cudaError_t attr1 = cudaFuncSetAttribute(
      wkv6_states<T, MC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      st_bytes);
  static const cudaError_t attr3 = cudaFuncSetAttribute(
      wkv6_out<T, MC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      out_bytes);
  if (attr1 != cudaSuccess) return attr1;
  if (attr3 != cudaSuccess) return attr3;
  const int64_t blocks = static_cast<int64_t>(p.batch) * p.heads * p.ng;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  wkv6_states<T, MC><<<static_cast<unsigned>(blocks), THREADS, st_bytes,
                       stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t pp = static_cast<int64_t>(p.p) * p.p;
  const int v = p.p % 4 == 0 ? 4 : 1;
  const dim3 pass_grid(static_cast<unsigned>(p.batch * p.heads),
                       static_cast<unsigned>((pp / v + PASS_THREADS - 1) /
                                             PASS_THREADS));
  if (v == 4) wkv6_carry<4><<<pass_grid, PASS_THREADS, 0, stream>>>(p);
  else wkv6_carry<1><<<pass_grid, PASS_THREADS, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv6_out<T, MC><<<static_cast<unsigned>(blocks), THREADS, out_bytes,
                    stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const Params& p, cudaStream_t stream) {
  return p.chunk <= 32 ? launch<T, 32>(p, stream) : launch<T, 64>(p, stream);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// r, k, v, lw [B, S, H, P] contiguous, all of one dtype (0 = float32,
// 1 = bfloat16); u [H, P] contiguous float32; y [B, S, H, P] contiguous in
// the inputs' dtype; work: f32 scratch of B * H * ng * (P * P + P) floats,
// ng = ceil(ceil(S / chunk) / group). 1 <= P <= 64, 1 <= chunk <= 64,
// group >= 1. Three launches on `stream`. Returns a cudaError_t
// (0 = launched).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* lw, const void* u, void* y, void* work,
                           int batch, int seq, int heads, int p, int chunk,
                           int group, int dtype, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || p <= 0 || p > MAX_P ||
      chunk <= 0 || chunk > MAX_C || group <= 0 ||
      static_cast<int64_t>(batch) * heads > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  Params prm;
  prm.r = r; prm.k = k; prm.v = v; prm.lw = lw;
  prm.u = static_cast<const float*>(u);
  prm.y = y;
  prm.batch = batch; prm.seq = seq; prm.heads = heads; prm.p = p;
  prm.chunk = chunk; prm.group = group;
  prm.nc = (seq + chunk - 1) / chunk;
  prm.ng = (prm.nc + group - 1) / group;
  prm.states = static_cast<float*>(work);
  prm.decays = prm.states +
      static_cast<int64_t>(batch) * heads * prm.ng * p * p;
  const int es = dtype == 0 ? 4 : 2;
  prm.vec = p % 4 == 0 && aligned(r, 4 * es) && aligned(k, 4 * es) &&
            aligned(v, 4 * es) && aligned(lw, 4 * es) && aligned(y, 4 * es);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_t<float>(prm, s));
    case 1: return static_cast<int>(launch_t<__nv_bfloat16>(prm, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
