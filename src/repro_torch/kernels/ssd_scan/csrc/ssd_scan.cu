// Mamba2 SSD chunked scan (forward) for Hopper (sm_90a).
//
// Replaces repro/kernels/ssd_scan/kernel.py::_ssd_kernel (the Pallas TPU
// kernel launched by ssd_scan_kernel). Same arithmetic, per (batch, head),
// with the f32 state h [P, N] carried from chunk to chunk, from zero:
//   seg = cumsum(dt * a) over the chunk (a < 0, the head's decay rate);
//   y_t = sum_{s<=t} (C_t . B_s) exp(seg_t - seg_s) dt_s x_s
//         + exp(seg_t) sum_n C_t[n] h[:, n];
//   h <- exp(seg_last) h + sum_s x_s (exp(seg_last - seg_s) dt_s) B_s^T.
// B and C are shared by all heads. The exponent is taken only where s <= t:
// the masked differences are positive and would overflow.
//
// Bound. At zamba2-7b's main-path shape (B 2, S 8192, H 112, P 64, N 64,
// chunk 128, f32) the call moves x, dt, B, C in and y out, ~0.96 GB (0.29 ms
// at 3.35 TB/s), and does ~46 GFLOP (0.68 ms at 67 TFLOP/s f32): it is
// bound by operations. The products stay on the f32 FMA units: rounding
// them once to TF32 breaks the float32 tolerance (tests/
// test_torch_ssd_scan.py emulates it), and 3xTF32 would triple the
// tensor-core work to gain what the FMA units already reach.
//
// Design. The TPU grid (b, h, chunk) runs the chunks in order and keeps h
// in VMEM scratch. Only the state couples the chunks, so here the scan is
// the SSD decomposition in three launches on the caller's stream, through
// an f32 workspace of [B, H, n_chunks, P, N] states and [B, H, n_chunks]
// decays that the wrapper allocates:
//   1. ssd_states, one block per (b, h, chunk): the chunk's own state
//      S_c = sum_s x_s (exp(seg_last - seg_s) dt_s) B_s^T, a [P, c] x [c, N]
//      product with 4 x 4 outputs a thread, and exp(seg_last).
//   2. ssd_pass, one thread per (b, h, 4 state elements): walks the chunks
//      in order and overwrites each S_c with the state entering chunk c,
//      h <- exp(seg_last) h + S_c. Elementwise, bound by bytes.
//   3. ssd_out, one block of 512 threads per (b, chunk, group of 8 heads):
//      C.B^T of the chunk once for the group (below the diagonal, 8 x 4
//      outputs a thread), then per head W = C.B^T * exp(seg_t - seg_s) *
//      dt_s below the diagonal and y = W x + (C h_c^T) exp(seg_t), 8 x 2
//      outputs a thread, written once. A warp's 8 rows take t <= row steps
//      of W x, and the four warps of each scheduler take row groups k,
//      7 - k, 8 + k and 15 - k, so each scheduler gets the same share of
//      the triangle.
// Tiles live in shared memory as f32, C and B transposed so that a thread
// reads its rows of C, B and W as 16-byte vectors: ~224 KB in pass 3 (one
// block of 16 warps per SM), ~68 KB in pass 1 (three blocks per SM). Global
// loads go to registers first, all of a tile's in flight together, so that
// a block does not wait out one memory latency per element it stages.
//
// Numbers. The per-element formulas are the plain version's (ops.py):
// W as (cb * decay) * dt, the state term as (C.h^T) * exp(seg), the state
// recurrence as exp(seg_last) * h + S, each rounded as written (no fused
// multiply-add across them). seg is summed in f64 and each exponent takes
// its difference in f64 before rounding to f32: the CPU's f32 cumsum also
// accumulates in f64, and on zamba2-7b's ranges (seg ~ -10^3 within a
// chunk) a difference of two rounded f32 sums loses ~1e-4 of
// exp(seg_t - seg_s). Rows past S are zero (dt = x = B = C = 0): they
// leave the state unchanged and are not written.
//
// Backward (ssd_scan_bwd_launch), the VJP for x, dt, A, B and C; the
// reference has no backward kernel (its models differentiate _ssd_chunked
// in XLA). The chunk states are not saved by the forward (at 2 x 8192 they
// take 235 MB a call): six launches recompute what they need at the
// backward's chunk c <= 64 (its tiles; the scan's value does not depend on
// the chunking, only its rounding does):
//   1-2. the forward's passes: the state h_c entering each chunk;
//   3. ssd_states<GRAD>: each chunk's own state gradient
//      G_c = sum_t exp(seg_t) dy_t C_t^T;
//   4. ssd_pass<REV>: the chunks in reverse, G_c overwritten by g_c, the
//      gradient of the state leaving chunk c;
//   5. ssd_bwd_chunk, one block per (b, chunk, 8 heads): per head dx, ddt
//      and dseg (ssd_bwd_chunk's comment has the formulas), seg and the
//      reverse cumulative sum of dseg in f64, dA's partial; the group's dB
//      and dC partials, the C.B^T terms summed over its heads first;
//   6. ssd_bwd_reduce: dB and dC over the groups and dA over (b, chunk),
//      each in a fixed order: no atomics, two calls give the same bytes.
// At SSD_MAIN it needs ~92 GFLOP (1.37 ms at 67 TFLOP/s f32, ssd_bwd_ops):
// bound by operations. The products stay on the f32 FMA units, as the
// forward's.
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

constexpr int MAX_P = 64;    // head size
constexpr int MAX_N = 64;    // state size
constexpr int MC = 128;      // chunk, the tiles' row count
constexpr int G = 8;         // heads per pass-3 block
constexpr int CS = MC + 4;   // row stride of C^T and B^T (16-byte rows,
                             // 4-way bank spread on the transposed stores)
constexpr int HS = MAX_P + 4;   // row stride of h^T
constexpr int ST_THREADS = 256;
constexpr int PASS_THREADS = 256;
constexpr int OUT_THREADS = 512;

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

struct Params {
  const void* x;    // [B, S, H, P]
  const void* dt;   // [B, S, H]
  const float* a;   // [H] f32
  const void* bm;   // [B, S, N]
  const void* cm;   // [B, S, N]
  void* y;          // [B, S, H, P]
  float* states;    // [B, H, nc, P, N]
  float* decay;     // [B, H, nc]
  int batch, seq, heads, p, n, chunk, nc;
  // the backward's (ssd_scan_bwd_launch); unused by the forward
  const void* dy;   // [B, S, H, P]
  float* gstates;   // [B, H, nc, P, N]: G_c, then the state gradients
};

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n"
               :: "l"(__cvta_generic_to_global(p)));
}

// seg of one head's chunk, by one warp: seg[t] = sum_{i<=t} f32(dt_i * a)
// in f64 for the chunk's c <= 128 rows (dt is zero past the rows in S).
// Each lane sums a run of rows, then a warp scan adds the runs before it:
// in f64 the order of the sum moves seg by ~1e-16 of |seg|, far below the
// one rounding to f32 that each exponent's argument takes.
__device__ __forceinline__ void chunk_seg(double* seg, const float* dts,
                                          float a, int c, int lane) {
  const int per = (c + 31) / 32;
  double part[MC / 32];
  double run = 0.0;
#pragma unroll
  for (int j = 0; j < MC / 32; ++j) {
    const int t = lane * per + j;
    if (j < per && t < c) run += static_cast<double>(dts[t] * a);
    part[j] = run;
  }
  double incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  const double before = incl - run;
#pragma unroll
  for (int j = 0; j < MC / 32; ++j) {
    const int t = lane * per + j;
    if (j < per && t < c) seg[t] = before + part[j];
  }
}

// ---------------------------------------------------------------------------
// Pass 1: the chunk's own state S_c [P, N] and its decay exp(seg_last).
// ---------------------------------------------------------------------------
constexpr int st_smem_bytes() {
  // x then x * tail [MC][MAX_P], B [MC][MAX_N], dt, tail [MC]; seg f64 [MC]
  return (2 * MC * MAX_P + 2 * MC) * 4 + MC * 8;
}

// GRAD (the backward's pass 3): the same product with x -> dy, B -> C and
// the row weights exp(seg_t): G_c = sum_t exp(seg_t) dy_t C_t^T, written to
// gstates; no decay.
template <typename T, bool GRAD>
__global__ void __launch_bounds__(ST_THREADS, 3) ssd_states(const Params prm) {
  extern __shared__ __align__(16) float sm[];
  float* xs = sm;                  // [MC][MAX_P]
  float* bs = xs + MC * MAX_P;     // [MC][MAX_N]
  float* dts = bs + MC * MAX_N;    // [MC]
  float* tail = dts + MC;          // [MC]
  double* seg = reinterpret_cast<double*>(tail + MC);   // [MC]
  const int P = prm.p, N = prm.n, H = prm.heads, C = prm.chunk;
  const int ci = blockIdx.x % prm.nc;
  const int bh = blockIdx.x / prm.nc;
  const int h = bh % H, b = bh / H;
  const int t0 = ci * C;
  const int nv = min(C, prm.seq - t0);      // rows of the chunk inside S
  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(b) * prm.seq + t0;
  const T* xg = static_cast<const T*>(GRAD ? prm.dy : prm.x);
  const T* bg = static_cast<const T*>(GRAD ? prm.cm : prm.bm);
  const T* dg = static_cast<const T*>(prm.dt);

  // loads in batches of 16 a thread, then the shared stores
  constexpr int PER = MC * MAX_P / ST_THREADS;
  constexpr int BATCH = 16;
  if (tid < MC)
    dts[tid] = tid < nv ? to_f32(dg[(row0 + tid) * H + h]) : 0.f;
#pragma unroll
  for (int k0 = 0; k0 < PER; k0 += BATCH) {
    float r[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = tid + (k0 + k) * ST_THREADS, t = i / MAX_P, q = i % MAX_P;
      r[k] = t < nv && q < P ? to_f32(xg[((row0 + t) * H + h) * P + q]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) xs[tid + (k0 + k) * ST_THREADS] = r[k];
  }
#pragma unroll
  for (int k0 = 0; k0 < PER; k0 += BATCH) {
    float r[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = tid + (k0 + k) * ST_THREADS, t = i / MAX_N, q = i % MAX_N;
      r[k] = t < nv && q < N ? to_f32(bg[(row0 + t) * N + q]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) bs[tid + (k0 + k) * ST_THREADS] = r[k];
  }
  __syncthreads();
  if (tid < 32) chunk_seg(seg, dts, prm.a[h], C, tid);
  __syncthreads();
  const double seg_last = seg[C - 1];
  if (tid < MC) {
    if (GRAD)
      tail[tid] = tid < C ? expf(static_cast<float>(seg[tid])) : 0.f;
    else
      tail[tid] = tid < C
          ? expf(static_cast<float>(seg_last - seg[tid])) * dts[tid] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int i = tid + r * ST_THREADS;
    xs[i] *= tail[i / MAX_P];
  }
  __syncthreads();

  // S[p][n] = sum_t xt[t][p] B[t][n]: rows p0..p0+3, columns n0..n0+3
  const int p0 = (tid / 16) * 4, n0 = (tid % 16) * 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  if (p0 < P && n0 < N) {
#pragma unroll 4
    for (int t = 0; t < C; ++t) {
      const float4 xv = *reinterpret_cast<const float4*>(xs + t * MAX_P + p0);
      const float4 bv = *reinterpret_cast<const float4*>(bs + t * MAX_N + n0);
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
      const float ba[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xa[i], ba[j], acc[i][j]);
    }
    float* out = (GRAD ? prm.gstates : prm.states) +
                 (static_cast<int64_t>(bh) * prm.nc + ci) * P * N;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (p0 + i < P && n0 + j < N) out[(p0 + i) * N + n0 + j] = acc[i][j];
  }
  if (!GRAD && tid == 0)
    prm.decay[static_cast<int64_t>(bh) * prm.nc + ci] =
        expf(static_cast<float>(seg_last));
}

// ---------------------------------------------------------------------------
// Pass 2: the states entering each chunk, in place over S_c.
// ---------------------------------------------------------------------------
constexpr int PASS_AHEAD = 8;    // chunk states loaded ahead of the recurrence

// Each thread carries V neighbouring state elements (V = 4: 16-byte loads
// and stores, when P * N is a multiple of 4). REV (the backward's pass 4):
// the chunks in reverse order over gstates, each G_c overwritten by the
// gradient of the state leaving chunk c, g <- exp(seg_last,c) g + G_c.
template <int V, bool REV>
__global__ void __launch_bounds__(PASS_THREADS) ssd_pass(const Params prm) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const int64_t pn = static_cast<int64_t>(prm.p) * prm.n;
  const int64_t i = (static_cast<int64_t>(blockIdx.y) * PASS_THREADS +
                     threadIdx.x) * V;
  if (i >= pn) return;
  const int64_t bh = blockIdx.x;
  Vec* st = reinterpret_cast<Vec*>((REV ? prm.gstates : prm.states) +
                                    bh * prm.nc * pn + i);
  const int64_t step = pn / V;             // one chunk's states, in Vecs
  const float* dec = prm.decay + bh * prm.nc;
  float h[V];
#pragma unroll
  for (int j = 0; j < V; ++j) h[j] = 0.f;
  for (int c0 = 0; c0 < prm.nc; c0 += PASS_AHEAD) {
    Vec s[PASS_AHEAD];
    float d[PASS_AHEAD];
#pragma unroll
    for (int k = 0; k < PASS_AHEAD; ++k) {
      const int c = REV ? prm.nc - 1 - (c0 + k) : c0 + k;
      if (c0 + k < prm.nc) {
        s[k] = st[c * step];
        d[k] = dec[c];
      }
    }
#pragma unroll
    for (int k = 0; k < PASS_AHEAD; ++k) {
      const int c = REV ? prm.nc - 1 - (c0 + k) : c0 + k;
      if (c0 + k < prm.nc) {
        float* sv = reinterpret_cast<float*>(&s[k]);
        Vec out;
        float* ov = reinterpret_cast<float*>(&out);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          ov[j] = h[j];
          h[j] = __fadd_rn(__fmul_rn(d[k], h[j]), sv[j]);
        }
        st[c * step] = out;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 3: the outputs of one (b, chunk) for a group of G heads.
// ---------------------------------------------------------------------------
constexpr int CBS = MC + 1;   // row stride of (C.B^T)^T: its transposed
                              // stores spread over 8 banks
constexpr int out_smem_bytes() {
  // C^T, B^T (then x) [MAX_N][CS]; (C.B^T)^T [MC][CBS]; W^T [MC][MC]; h^T
  // [MAX_N][HS]; dt [G][MC]; seg f64 [G][MC]
  return (2 * MAX_N * CS + MC * CBS + MC * MC + MAX_N * HS + G * MC) * 4 +
         G * MC * 8;
}

template <typename T>
__global__ void __launch_bounds__(OUT_THREADS, 1) ssd_out(const Params prm) {
  extern __shared__ __align__(16) float sm[];
  float* ct = sm;                      // C^T [MAX_N][CS]
  float* bx = ct + MAX_N * CS;         // B^T [MAX_N][CS], then x [MC][MAX_P]
  float* wt = bx + MAX_N * CS;         // W^T [MC][MC]: [s][t]
  float* cbt = wt + MC * MC;           // (C.B^T)^T [MC][CBS]: [s][t]
  float* ht = cbt + MC * CBS;          // h^T [MAX_N][HS]
  float* dts = ht + MAX_N * HS;        // dt [G][MC]
  double* segs = reinterpret_cast<double*>(dts + G * MC);   // [G][MC]
  const int P = prm.p, N = prm.n, H = prm.heads, C = prm.chunk;
  const int groups = (H + G - 1) / G;
  const int g = blockIdx.x % groups;
  const int ci = (blockIdx.x / groups) % prm.nc;
  const int b = blockIdx.x / groups / prm.nc;
  const int h0 = g * G, hn = min(G, H - h0);
  const int t0c = ci * C;
  const int nv = min(C, prm.seq - t0c);
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int64_t row0 = static_cast<int64_t>(b) * prm.seq + t0c;
  const T* xg = static_cast<const T*>(prm.x);
  const T* dg = static_cast<const T*>(prm.dt);
  const T* bg = static_cast<const T*>(prm.bm);
  const T* cg = static_cast<const T*>(prm.cm);
  T* yg = static_cast<T*>(prm.y);

  // Global loads go to registers first, every load of a tile in flight at
  // once, then to shared memory.
  constexpr int PER_C = MC * MAX_N / OUT_THREADS;   // C (and B) a thread
  constexpr int PER_X = MC * MAX_P / OUT_THREADS;   // x a thread
  constexpr int PER_H = MAX_P * MAX_N / OUT_THREADS;   // h_c a thread
  constexpr int PER_D = G * MC / OUT_THREADS;       // dt a thread
  {
    float cr[PER_C], br[PER_C], dr[PER_D];
#pragma unroll
    for (int r = 0; r < PER_C; ++r) {
      const int i = tid + r * OUT_THREADS, t = i / MAX_N, n = i % MAX_N;
      const bool ok = t < nv && n < N;
      cr[r] = ok ? to_f32(cg[(row0 + t) * N + n]) : 0.f;
      br[r] = ok ? to_f32(bg[(row0 + t) * N + n]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < PER_D; ++r) {
      const int i = tid + r * OUT_THREADS, k = i / MC, t = i % MC;
      dr[r] = k < hn && t < nv ? to_f32(dg[(row0 + t) * H + h0 + k]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < PER_C; ++r) {
      const int i = tid + r * OUT_THREADS, t = i / MAX_N, n = i % MAX_N;
      ct[n * CS + t] = cr[r];
      bx[n * CS + t] = br[r];
    }
#pragma unroll
    for (int r = 0; r < PER_D; ++r) dts[tid + r * OUT_THREADS] = dr[r];
  }
  __syncthreads();
  if (w < hn) chunk_seg(segs + w * MC, dts + w * MC, prm.a[h0 + w], C, lane);

  {  // C.B^T below the diagonal: warp w's rows t0.., lane's columns s0..
    const int t0 = 8 * w, s0 = 4 * lane;
    if (s0 < t0 + 8 && t0 < C) {
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float4 c0 = *reinterpret_cast<const float4*>(ct + n * CS + t0);
        const float4 c1 =
            *reinterpret_cast<const float4*>(ct + n * CS + t0 + 4);
        const float4 bv = *reinterpret_cast<const float4*>(bx + n * CS + s0);
        const float ca[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
        const float ba[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ca[i], ba[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) cbt[(s0 + j) * CBS + t0 + i] = acc[i][j];
    }
  }
  __syncthreads();   // C.B^T and every head's seg are ready; B^T is free

  // y: warp w takes the 8 rows t0 = 8 tg(w) and columns 2 lane, +1. The
  // four warps of a scheduler (w, w + 4, w + 8, w + 12) take row groups
  // k, 7 - k, 8 + k and 15 - k, so that each has the same share of the
  // triangle s <= t.
  const int k4 = w % 4, j4 = w / 4;
  const int tg = j4 == 0 ? k4 : j4 == 1 ? 7 - k4 : j4 == 2 ? 8 + k4 : 15 - k4;
  const int t0 = 8 * tg, p0 = 2 * lane;
  const int s_end = min(t0 + 8, C);        // W is zero past the diagonal
  for (int k = 0; k < hn; ++k) {
    const int h = h0 + k;
    const double* seg = segs + k * MC;
    const float* dh = dts + k * MC;
    // the state entering this chunk for head h ([B, H, nc, P, N]: head
    // h + 1's lies nc * P * N floats further)
    const float* hs = prm.states +
        ((static_cast<int64_t>(b) * H + h) * prm.nc + ci) * P * N;
    {
      float xr[PER_X], hr[PER_H];
#pragma unroll
      for (int r = 0; r < PER_X; ++r) {
        const int i = tid + r * OUT_THREADS, t = i / MAX_P, q = i % MAX_P;
        xr[r] = t < nv && q < P
            ? to_f32(xg[((row0 + t) * H + h) * P + q]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < PER_H; ++r) {
        const int i = tid + r * OUT_THREADS, q = i / MAX_N, n = i % MAX_N;
        hr[r] = q < P && n < N ? hs[q * N + n] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < PER_X; ++r) bx[tid + r * OUT_THREADS] = xr[r];
#pragma unroll
      for (int r = 0; r < PER_H; ++r) {
        const int i = tid + r * OUT_THREADS;
        ht[(i % MAX_N) * HS + i / MAX_N] = hr[r];
      }
    }
#pragma unroll 4
    for (int i = tid; i < MC * MC; i += OUT_THREADS) {
      const int s = i / MC, t = i % MC;
      float v = 0.f;
      if (s <= t && t < C)
        v = __fmul_rn(__fmul_rn(cbt[s * CBS + t],
                                expf(static_cast<float>(seg[t] - seg[s]))),
                      dh[s]);
      wt[i] = v;
    }
    __syncthreads();
    if (k + 1 < hn) {          // the next head's x rows and h_c, into L2
      const int row_lines = (P * static_cast<int>(sizeof(T)) + 127) / 128;
      const int h_lines = (P * N * 4 + 127) / 128;
      if (tid < MC * row_lines) {
        const int t = tid / row_lines, l = tid % row_lines;
        if (t < nv)
          prefetch_l2(reinterpret_cast<const char*>(
                          xg + ((row0 + t) * H + h + 1) * P) + 128 * l);
      } else if (tid < MC * row_lines + h_lines) {
        prefetch_l2(reinterpret_cast<const char*>(
                        hs + static_cast<int64_t>(prm.nc) * P * N) +
                    128 * (tid - MC * row_lines));
      }
    }

    if (t0 < nv && p0 < P) {
      float acc[8][2], hy[8][2];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][0] = acc[i][1] = 0.f;
        hy[i][0] = hy[i][1] = 0.f;
      }
#pragma unroll 4
      for (int s = 0; s < s_end; ++s) {
        const float2 xv = *reinterpret_cast<const float2*>(bx + s * MAX_P + p0);
        const float4 w0 = *reinterpret_cast<const float4*>(wt + s * MC + t0);
        const float4 w1 =
            *reinterpret_cast<const float4*>(wt + s * MC + t0 + 4);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][0] = fmaf(wv[i], xv.x, acc[i][0]);
          acc[i][1] = fmaf(wv[i], xv.y, acc[i][1]);
        }
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float2 hv = *reinterpret_cast<const float2*>(ht + n * HS + p0);
        const float4 c0 = *reinterpret_cast<const float4*>(ct + n * CS + t0);
        const float4 c1 =
            *reinterpret_cast<const float4*>(ct + n * CS + t0 + 4);
        const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          hy[i][0] = fmaf(cv[i], hv.x, hy[i][0]);
          hy[i][1] = fmaf(cv[i], hv.y, hy[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = t0 + i;
        if (t >= nv) break;
        const float e = expf(static_cast<float>(seg[t]));
        T* yrow = yg + ((row0 + t) * H + h) * P;
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (p0 + j < P)
            yrow[p0 + j] =
                from_f32<T>(__fadd_rn(acc[i][j], __fmul_rn(hy[i][j], e)));
      }
    }
    __syncthreads();   // x, h^T and W are read before the next head's
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  // opted in once per type, at the largest chunk, head and state size
  static const cudaError_t attr1 = cudaFuncSetAttribute(
      ssd_states<T, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      st_smem_bytes());
  static const cudaError_t attr3 = cudaFuncSetAttribute(
      ssd_out<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      out_smem_bytes());
  if (attr1 != cudaSuccess) return attr1;
  if (attr3 != cudaSuccess) return attr3;
  const int64_t bh = static_cast<int64_t>(p.batch) * p.heads;
  const int64_t groups = (p.heads + G - 1) / G;
  const int64_t pn = static_cast<int64_t>(p.p) * p.n;
  if (bh * p.nc > INT_MAX || p.batch * groups * p.nc > INT_MAX)
    return cudaErrorInvalidValue;
  ssd_states<T, false><<<static_cast<unsigned>(bh * p.nc), ST_THREADS,
                         st_smem_bytes(), stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int v = pn % 4 == 0 ? 4 : 1;
  const dim3 pass_grid(static_cast<unsigned>(bh),
                       static_cast<unsigned>((pn / v + PASS_THREADS - 1) /
                                             PASS_THREADS));
  if (v == 4) ssd_pass<4, false><<<pass_grid, PASS_THREADS, 0, stream>>>(p);
  else ssd_pass<1, false><<<pass_grid, PASS_THREADS, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_out<T><<<static_cast<unsigned>(p.batch * groups * p.nc), OUT_THREADS,
               out_smem_bytes(), stream>>>(p);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The backward (ssd_scan_bwd_launch): six launches at the backward's chunk
// c <= BC, through the f32 workspace the wrapper allocates.
// ---------------------------------------------------------------------------
constexpr int BC = 64;          // the backward's largest chunk: its tiles
constexpr int BG = 8;           // heads a per-chunk block takes in turn
constexpr int BLD = BC + 1;     // row stride of the [64][64] tiles
constexpr int BWD_THREADS = 256;    // 16 x 16 threads, 4 x 4 outputs each
constexpr int RED_THREADS = 256;

struct BwdParams {
  Params f;         // the forward's, at chunk c (passes 1-4)
  void* dx;         // [B, S, H, P]
  void* ddt;        // [B, S, H]
  float* da;        // [H] f32
  void* dbm;        // [B, S, N]
  void* dcm;        // [B, S, N]
  double* da_part;  // [B, nc, H]
  float* db_part;   // [groups, B, S, N]
  float* dc_part;   // [groups, B, S, N]
  int groups;
};

// acc[i][j] (+)= sum_{k in [k0, k1)} a(i0 + i, k) b(k, j0 + j): one thread's
// 4 x 4 outputs of a product of shared tiles.
template <class FA, class FB>
__device__ __forceinline__ void mm44(float (&acc)[4][4], int i0, int j0,
                                     int k0, int k1, FA a, FB b) {
  for (int k = k0; k < k1; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = a(i0 + i, k);
      bv[i] = b(k, j0 + i);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero44(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// a [64][BLD] tile from rows [row0, row0 + nv) of a [.., stride] tensor,
// columns [0, w); zeros elsewhere
template <typename T>
__device__ __forceinline__ void load_tile(float* tile, const T* src,
                                          int64_t row0, int64_t stride,
                                          int nv, int w, int tid) {
  for (int i = tid; i < BC * BC; i += BWD_THREADS) {
    const int t = i / BC, q = i % BC;
    tile[t * BLD + q] =
        t < nv && q < w ? to_f32(src[(row0 + t) * stride + q]) : 0.f;
  }
}

constexpr int bwd_smem_bytes() {
  // C, B, C.B^T, sum_h dCB, x, dy, h_c, g_c, two scratch tiles [64][BLD];
  // per-row f32 dt, exp(seg), exp(seg_last - seg), tail, colsum, rowsum,
  // dtail, ddt; f64 seg, dseg; a reduction line
  return 10 * BC * BLD * 4 + 8 * BC * 4 + 2 * BC * 8 + BWD_THREADS * 8;
}

// Pass 5: one (b, chunk, group of BG heads). For each head in turn:
//   dWE[t,s] = (dy_t . x_s) exp(seg_t - seg_s), s <= t; Q = dWE * CB;
//   W = (CB * exp(seg_t - seg_s)) * dt_s, the forward's weights;
//   sum_h dCB += dWE * dt_s (for dB and dC once per group);
//   dx_s = sum_{t>=s} W[t,s] dy_t + tail_s (g_c B_s);
//   dC_t += exp(seg_t) h_c^T dy_t;  dB_s += tail_s g_c^T x_s;
//   ddt_s = sum_t Q[t,s] + dtail_s exp(seg_last - seg_s) + dDA_s a;
//   dseg_t = sum_s Q[t,s] dt_s - dt_t sum_s Q[s,t] + C_t . dC_t(state)
//            - dtail_t tail_t, and at the chunk's last row + sum_s dtail_s
//            tail_s + exp(seg_last) sum g_c h_c;
//   dDA = the reverse cumulative sum of dseg, in f64; dA's partial
//   sum_t dDA_t dt_t, in f64.
// Then dC_t += sum_s dCB[t,s] B_s and dB_s += sum_t dCB[t,s] C_t, the
// group's partials.
template <typename T>
__global__ void __launch_bounds__(BWD_THREADS, 1) ssd_bwd_chunk(
    const BwdParams bp) {
  extern __shared__ __align__(16) float sm[];
  const Params& prm = bp.f;
  float* Cs = sm;                    // C [t][n]
  float* Bs = Cs + BC * BLD;         // B [s][n]
  float* CB = Bs + BC * BLD;         // C.B^T [t][s], zero above the diagonal
  float* dCB = CB + BC * BLD;        // sum over the group's heads [t][s]
  float* X = dCB + BC * BLD;         // x [s][p]
  float* DY = X + BC * BLD;          // dy [t][p]
  float* Hs = DY + BC * BLD;         // h_c [p][n]
  float* Gs = Hs + BC * BLD;         // g_c [p][n]
  float* T1 = Gs + BC * BLD;         // Q [t][s], then g_c B [s][p]
  float* T2 = T1 + BC * BLD;         // W [t][s], then dC(state) [t][n]
  float* dts = T2 + BC * BLD;        // [BC] each
  float* es = dts + BC;
  float* etl = es + BC;
  float* tail = etl + BC;
  float* colsum = tail + BC;
  float* rowsum = colsum + BC;
  float* dtail = rowsum + BC;
  float* ddt = dtail + BC;
  double* seg = reinterpret_cast<double*>(ddt + BC);   // [BC]
  double* dseg = seg + BC;                             // [BC]
  double* red = dseg + BC;                             // [BWD_THREADS]

  const int P = prm.p, N = prm.n, H = prm.heads, C = prm.chunk;
  const int g = blockIdx.x % bp.groups;
  const int ci = (blockIdx.x / bp.groups) % prm.nc;
  const int b = blockIdx.x / bp.groups / prm.nc;
  const int h0 = g * BG, hn = min(BG, H - h0);
  const int t0c = ci * C;
  const int nv = min(C, prm.seq - t0c);
  const int tid = threadIdx.x;
  const int i0 = 4 * (tid / 16), j0 = 4 * (tid % 16);
  const int64_t row0 = static_cast<int64_t>(b) * prm.seq + t0c;
  const T* xg = static_cast<const T*>(prm.x);
  const T* dyg = static_cast<const T*>(prm.dy);
  const T* dg = static_cast<const T*>(prm.dt);
  T* dxg = static_cast<T*>(bp.dx);
  T* ddtg = static_cast<T*>(bp.ddt);

  load_tile(Cs, static_cast<const T*>(prm.cm), row0, N, nv, N, tid);
  load_tile(Bs, static_cast<const T*>(prm.bm), row0, N, nv, N, tid);
  __syncthreads();
  {  // C.B^T below the diagonal; sum_h dCB zero
    float acc[4][4];
    zero44(acc);
    mm44(acc, i0, j0, 0, N, [&](int i, int k) { return Cs[i * BLD + k]; },
         [&](int k, int j) { return Bs[j * BLD + k]; });
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = i0 + i, s = j0 + j;
        CB[t * BLD + s] = s <= t && t < C ? acc[i][j] : 0.f;
        dCB[t * BLD + s] = 0.f;
      }
  }
  float accB[4][4], accC[4][4];      // dB [s][n], dC [t][n] of the group
  zero44(accB);
  zero44(accC);

  for (int k = 0; k < hn; ++k) {
    const int h = h0 + k;
    const int64_t slot = ((static_cast<int64_t>(b) * H + h) * prm.nc + ci);
    load_tile(X, xg + static_cast<int64_t>(h) * P, row0, H * P, nv, P, tid);
    load_tile(DY, dyg + static_cast<int64_t>(h) * P, row0, H * P, nv, P,
              tid);
    for (int i = tid; i < BC * BC; i += BWD_THREADS) {
      const int q = i / BC, n = i % BC;
      const bool ok = q < P && n < N;
      Hs[q * BLD + n] = ok ? prm.states[slot * P * N + q * N + n] : 0.f;
      Gs[q * BLD + n] = ok ? prm.gstates[slot * P * N + q * N + n] : 0.f;
    }
    if (tid < BC)
      dts[tid] = tid < nv ? to_f32(dg[(row0 + tid) * H + h]) : 0.f;
    __syncthreads();
    if (tid < 32) chunk_seg(seg, dts, prm.a[h], C, tid);
    __syncthreads();
    const double seg_last = seg[C - 1];
    if (tid < BC) {
      const bool in = tid < C;
      es[tid] = in ? expf(static_cast<float>(seg[tid])) : 0.f;
      etl[tid] = in ? expf(static_cast<float>(seg_last - seg[tid])) : 0.f;
      tail[tid] = in ? etl[tid] * dts[tid] : 0.f;
    }
    __syncthreads();

    {  // dWE, Q, W; sum_h dCB
      float acc[4][4];
      zero44(acc);
      mm44(acc, i0, j0, 0, P, [&](int i, int q) { return DY[i * BLD + q]; },
           [&](int q, int j) { return X[j * BLD + q]; });
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = i0 + i, s = j0 + j;
          float q = 0.f, w = 0.f;
          if (s <= t && t < C) {
            const float e = expf(static_cast<float>(seg[t] - seg[s]));
            const float cb = CB[t * BLD + s];
            const float dwe = __fmul_rn(acc[i][j], e);
            q = __fmul_rn(dwe, cb);
            w = __fmul_rn(__fmul_rn(cb, e), dts[s]);
            dCB[t * BLD + s] += __fmul_rn(dwe, dts[s]);
          }
          T1[t * BLD + s] = q;
          T2[t * BLD + s] = w;
        }
    }
    __syncthreads();
    if (tid < BC) {             // sum_t Q[t, s] (s = tid)
      float cs = 0.f;
      for (int t = tid; t < C; ++t) cs += T1[t * BLD + tid];
      colsum[tid] = cs;
    } else if (tid < 2 * BC) {  // sum_s Q[t, s] dt_s (t = tid - 64)
      const int t = tid - BC;
      float rs = 0.f;
      for (int s = 0; s <= t && s < C; ++s)
        rs = fmaf(T1[t * BLD + s], dts[s], rs);
      rowsum[t] = rs;
    }
    __syncthreads();
    {  // dx = W^T dy + tail (g_c B); g_c B to T1
      float acc[4][4], gb[4][4];
      zero44(acc);
      zero44(gb);
      mm44(acc, i0, j0, i0, C, [&](int s, int t) { return T2[t * BLD + s]; },
           [&](int t, int q) { return DY[t * BLD + q]; });
      mm44(gb, i0, j0, 0, N, [&](int s, int n) { return Bs[s * BLD + n]; },
           [&](int n, int q) { return Gs[q * BLD + n]; });
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = i0 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = j0 + j;
          T1[s * BLD + q] = gb[i][j];
          if (s < nv && q < P)
            dxg[((row0 + s) * H + h) * P + q] = from_f32<T>(
                __fadd_rn(acc[i][j], __fmul_rn(tail[s], gb[i][j])));
        }
      }
    }
    __syncthreads();
    {  // dC(state) = exp(seg_t) dy_t h_c to T2 and dC; dB += tail g_c^T x
      float acc[4][4], xb[4][4];
      zero44(acc);
      zero44(xb);
      mm44(acc, i0, j0, 0, P, [&](int t, int q) { return DY[t * BLD + q]; },
           [&](int q, int n) { return Hs[q * BLD + n]; });
      mm44(xb, i0, j0, 0, P, [&](int s, int q) { return X[s * BLD + q]; },
           [&](int q, int n) { return Gs[q * BLD + n]; });
      float gh = 0.f;           // this thread's share of sum g_c h_c
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i0 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float dci = __fmul_rn(acc[i][j], es[r]);
          T2[r * BLD + j0 + j] = dci;
          accC[i][j] += dci;
          accB[i][j] += __fmul_rn(tail[r], xb[i][j]);
          gh = fmaf(Gs[r * BLD + j0 + j], Hs[r * BLD + j0 + j], gh);
        }
      }
      red[tid] = gh;
    }
    __syncthreads();
    if (tid < BC) {             // the row terms of dseg and ddt (r = tid)
      const int r = tid;
      float dtl = 0.f, cdc = 0.f;
      for (int q = 0; q < BC; ++q) {
        dtl = fmaf(X[r * BLD + q], T1[r * BLD + q], dtl);
        cdc = fmaf(Cs[r * BLD + q], T2[r * BLD + q], cdc);
      }
      dtail[r] = dtl;
      ddt[r] = __fadd_rn(colsum[r], __fmul_rn(dtl, etl[r]));
      dseg[r] = r < C ? static_cast<double>(rowsum[r]) -
                        static_cast<double>(__fmul_rn(dts[r], colsum[r])) +
                        static_cast<double>(cdc) -
                        static_cast<double>(__fmul_rn(dtl, tail[r]))
                      : 0.0;
    }
    __syncthreads();
    if (tid == 0) {             // the last row's terms, then dDA and dA
      double end = 0.0, gh = 0.0;
      for (int s = 0; s < C; ++s)
        end += static_cast<double>(__fmul_rn(dtail[s], tail[s]));
      for (int i = 0; i < BWD_THREADS; ++i) gh += red[i];
      end += static_cast<double>(expf(static_cast<float>(seg_last))) * gh;
      dseg[C - 1] += end;
      double run = 0.0, da = 0.0;
      for (int t = C - 1; t >= 0; --t) {
        run += dseg[t];
        dseg[t] = run;             // dDA_t
        da += run * static_cast<double>(dts[t]);
      }
      bp.da_part[(static_cast<int64_t>(b) * prm.nc + ci) * H + h] = da;
    }
    __syncthreads();
    if (tid < nv)
      ddtg[(row0 + tid) * H + h] = from_f32<T>(__fadd_rn(
          ddt[tid], static_cast<float>(dseg[tid] * static_cast<double>(
                                           prm.a[h]))));
    __syncthreads();   // the tiles are read before the next head's
  }

  {  // the group's dC and dB: + sum_h dCB B and + sum_h dCB^T C
    mm44(accC, i0, j0, 0, C, [&](int t, int s) { return dCB[t * BLD + s]; },
         [&](int s, int n) { return Bs[s * BLD + n]; });
    mm44(accB, i0, j0, i0, C, [&](int s, int t) { return dCB[t * BLD + s]; },
         [&](int t, int n) { return Cs[t * BLD + n]; });
    const int64_t base = (static_cast<int64_t>(g) * prm.batch + b) * prm.seq +
                         t0c;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i0 + i;
      if (r >= nv) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = j0 + j;
        if (n >= N) continue;
        bp.dc_part[(base + r) * N + n] = accC[i][j];
        bp.db_part[(base + r) * N + n] = accB[i][j];
      }
    }
  }
}

// Pass 6: the fixed-order sums. dB and dC: one thread per (b, t, n) over
// the groups in order; dA: one thread per head over (b, chunk) in order,
// in f64.
template <typename T>
__global__ void __launch_bounds__(RED_THREADS) ssd_bwd_reduce(
    const BwdParams bp) {
  const Params& prm = bp.f;
  const int64_t total = static_cast<int64_t>(prm.batch) * prm.seq * prm.n;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * RED_THREADS +
                    threadIdx.x;
  if (i < total) {
    float sb = 0.f, sc = 0.f;
    for (int g = 0; g < bp.groups; ++g) {
      sb += bp.db_part[g * total + i];
      sc += bp.dc_part[g * total + i];
    }
    static_cast<T*>(bp.dbm)[i] = from_f32<T>(sb);
    static_cast<T*>(bp.dcm)[i] = from_f32<T>(sc);
  }
  if (i < prm.heads) {
    double s = 0.0;
    const int64_t parts = static_cast<int64_t>(prm.batch) * prm.nc;
    for (int64_t j = 0; j < parts; ++j) s += bp.da_part[j * prm.heads + i];
    bp.da[i] = static_cast<float>(s);
  }
}

template <typename T>
cudaError_t launch_bwd(const BwdParams& bp, cudaStream_t stream) {
  static const cudaError_t attr1 = cudaFuncSetAttribute(
      ssd_states<T, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      st_smem_bytes());
  static const cudaError_t attr3 = cudaFuncSetAttribute(
      ssd_states<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      st_smem_bytes());
  static const cudaError_t attr5 = cudaFuncSetAttribute(
      ssd_bwd_chunk<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bwd_smem_bytes());
  if (attr1 != cudaSuccess) return attr1;
  if (attr3 != cudaSuccess) return attr3;
  if (attr5 != cudaSuccess) return attr5;
  const Params& p = bp.f;
  const int64_t bh = static_cast<int64_t>(p.batch) * p.heads;
  const int64_t pn = static_cast<int64_t>(p.p) * p.n;
  const int64_t red = static_cast<int64_t>(p.batch) * p.seq * p.n;
  const int64_t red_blocks =
      ((red > p.heads ? red : p.heads) + RED_THREADS - 1) / RED_THREADS;
  if (bh * p.nc > INT_MAX || p.batch * bp.groups * p.nc > INT_MAX ||
      red_blocks > INT_MAX)
    return cudaErrorInvalidValue;
  const int v = pn % 4 == 0 ? 4 : 1;
  const dim3 pass_grid(static_cast<unsigned>(bh),
                       static_cast<unsigned>((pn / v + PASS_THREADS - 1) /
                                             PASS_THREADS));
  // 1-2: the states entering each chunk (the forward's passes)
  ssd_states<T, false><<<static_cast<unsigned>(bh * p.nc), ST_THREADS,
                         st_smem_bytes(), stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (v == 4) ssd_pass<4, false><<<pass_grid, PASS_THREADS, 0, stream>>>(p);
  else ssd_pass<1, false><<<pass_grid, PASS_THREADS, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 3-4: each chunk's own state gradient, then the reverse carry
  ssd_states<T, true><<<static_cast<unsigned>(bh * p.nc), ST_THREADS,
                        st_smem_bytes(), stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (v == 4) ssd_pass<4, true><<<pass_grid, PASS_THREADS, 0, stream>>>(p);
  else ssd_pass<1, true><<<pass_grid, PASS_THREADS, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 5: the per-chunk gradients; 6: the fixed-order sums
  ssd_bwd_chunk<T><<<static_cast<unsigned>(p.batch * bp.groups * p.nc),
                     BWD_THREADS, bwd_smem_bytes(), stream>>>(bp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_bwd_reduce<T><<<static_cast<unsigned>(red_blocks), RED_THREADS, 0,
                      stream>>>(bp);
  return cudaGetLastError();
}

}  // namespace

// x [B, S, H, P], dt [B, S, H], B and C [B, S, N], all contiguous and of one
// dtype (0 = float32, 1 = bfloat16); a [H] contiguous float32;
// y [B, S, H, P] contiguous in the inputs' dtype; work: f32 scratch of
// B * H * ceil(S / chunk) * (P * N + 1) floats. 1 <= P <= 64, 1 <= N <= 64,
// 1 <= chunk <= 128. Three launches on `stream`. Returns a cudaError_t
// (0 = launched).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* bm, const void* cm, void* y,
                               void* work, int batch, int seq, int heads,
                               int p, int n, int chunk, int dtype,
                               void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || p <= 0 || p > MAX_P || n <= 0 ||
      n > MAX_N || chunk <= 0 || chunk > MC)
    return static_cast<int>(cudaErrorInvalidValue);
  Params prm;
  prm.x = x; prm.dt = dt; prm.a = static_cast<const float*>(a);
  prm.bm = bm; prm.cm = cm; prm.y = y;
  prm.batch = batch; prm.seq = seq; prm.heads = heads; prm.p = p; prm.n = n;
  prm.chunk = chunk; prm.nc = (seq + chunk - 1) / chunk;
  prm.states = static_cast<float*>(work);
  prm.decay = prm.states +
      static_cast<int64_t>(batch) * heads * prm.nc * p * n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch<float>(prm, s));
    case 1: return static_cast<int>(launch<__nv_bfloat16>(prm, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The VJP of ssd_scan_launch's function at dy: x, dt, B, C, dy [B, S, H, P]
// etc. contiguous and of one dtype (0 = float32, 1 = bfloat16), a [H]
// contiguous float32; dx, ddt, dB, dC in the inputs' dtype and layout, dA
// [H] float32. chunk: the backward's, 1 <= chunk <= 64 (the wrapper's
// min(chunk, S, 64)). work: 16-byte aligned f32 scratch of r4(2 B nc H)
// (dA's f64 partials) + B H nc P N + r4(B H nc) + B H nc P N (the states
// entering each chunk, the decays, the state gradients) + 2 groups B S N
// (dB's and dC's partials) floats, r4 rounding up to a multiple of 4,
// nc = ceil(S / chunk), groups = ceil(H / 8) (ops.py's ssd_bwd_work). Six
// launches on `stream`. Returns a cudaError_t (0 = launched).
extern "C" int ssd_scan_bwd_launch(const void* x, const void* dt,
                                   const void* a, const void* bm,
                                   const void* cm, const void* dy, void* dx,
                                   void* ddt, void* da, void* dbm, void* dcm,
                                   void* work, int batch, int seq, int heads,
                                   int p, int n, int chunk, int dtype,
                                   void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || p <= 0 || p > MAX_P || n <= 0 ||
      n > MAX_N || chunk <= 0 || chunk > BC)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams bp;
  Params& prm = bp.f;
  prm.x = x; prm.dt = dt; prm.a = static_cast<const float*>(a);
  prm.bm = bm; prm.cm = cm; prm.y = nullptr; prm.dy = dy;
  prm.batch = batch; prm.seq = seq; prm.heads = heads; prm.p = p; prm.n = n;
  prm.chunk = chunk; prm.nc = (seq + chunk - 1) / chunk;
  const int64_t bhc = static_cast<int64_t>(batch) * heads * prm.nc;
  bp.groups = (heads + BG - 1) / BG;
  auto r4 = [](int64_t f) { return (f + 3) / 4 * 4; };   // 16-byte steps
  bp.da_part = static_cast<double*>(work);
  prm.states = static_cast<float*>(work) + r4(2 * bhc);
  prm.decay = prm.states + bhc * p * n;
  prm.gstates = prm.decay + r4(bhc);
  bp.db_part = prm.gstates + bhc * p * n;
  bp.dc_part = bp.db_part + static_cast<int64_t>(bp.groups) * batch * seq * n;
  bp.dx = dx; bp.ddt = ddt; bp.da = static_cast<float*>(da);
  bp.dbm = dbm; bp.dcm = dcm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_bwd<float>(bp, s));
    case 1: return static_cast<int>(launch_bwd<__nv_bfloat16>(bp, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
