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
// take 235 MB a call): five launches recompute what they need at the
// backward's chunk c <= 64 (its tiles; the scan's value does not depend on
// the chunking, only its rounding does):
//   1. ssd_bwd_states, one block per (b, chunk, 8 heads): each chunk's own
//      state S_c and decay, as the forward's pass 1, and its own state
//      gradient G_c = sum_t exp(seg_t) dy_t C_t^T;
//   2. ssd_pass: the chunks in order, S_c overwritten by h_c, the state
//      entering chunk c (the forward's pass 2);
//   3. ssd_pass<REV>: the chunks in reverse, G_c overwritten by g_c, the
//      gradient of the state leaving chunk c;
//   4. ssd_bwd_chunk, one block per (b, chunk, 8 heads): per head dx, ddt
//      and dseg (ssd_bwd_chunk's comment has the formulas), the reverse
//      cumulative sum of dseg in f64, dA's partial; the group's dB and dC
//      partials, the C.B^T terms summed over its heads first;
//   5. ssd_bwd_reduce: dB and dC over the groups and dA over (b, chunk),
//      each in a fixed order: no atomics, two calls give the same bytes.
// At SSD_MAIN it needs ~92 GFLOP (ssd_bwd_ops_split), 90.6 of them in
// products: at 165 TFLOP/s for those (float32-accurate on the tensor
// cores, 3xTF32 at a third of the TF32 rate) and 67 TFLOP/s f32 for the
// rest, 0.56 ms, above the 0.43 ms of its bytes: bound by operations.
// Passes 1 and 4 run their products on the tensor cores, as 3xTF32 MMAs
// (mma.sync m16n8k8; split_tf32 and warp_mm say how close to an f32
// FMA's rounding they stay): as f32 FMAs from shared memory, every float
// a thread reads costs a warp a wavefront whether or not its lanes share
// it, so a 4 x 4 or 4 x 2 register tile (one float read for 2 or 1.3
// FMAs) held pass 4 to ~30% of the f32 rate. Measured on an H100 80GB
// HBM3 at 700 W, at SSD_MAIN: 4.15-4.28 ms a call (CUDA events, L2
// flushed; 0.13-0.14 of the bound), of which pass 4 2.40, pass 1 1.04,
// passes 2 and 3 0.34 each, pass 5 0.07 (profiler); a design of six
// launches whose pass 4 ran f32 FMAs in one block of 8 warps an SM took
// 9.85.
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

template <typename T>
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
  const T* xg = static_cast<const T*>(prm.x);
  const T* bg = static_cast<const T*>(prm.bm);
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
  if (tid < MC)
    tail[tid] = tid < C
        ? expf(static_cast<float>(seg_last - seg[tid])) * dts[tid] : 0.f;
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
    float* out = prm.states + (static_cast<int64_t>(bh) * prm.nc + ci) * P * N;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (p0 + i < P && n0 + j < N) out[(p0 + i) * N + n0 + j] = acc[i][j];
  }
  if (tid == 0)
    prm.decay[static_cast<int64_t>(bh) * prm.nc + ci] =
        expf(static_cast<float>(seg_last));
}

// ---------------------------------------------------------------------------
// Pass 2: the states entering each chunk, in place over S_c.
// ---------------------------------------------------------------------------
constexpr int PASS_AHEAD = 8;    // chunk states loaded ahead of the recurrence

// Each thread carries V neighbouring state elements (V = 4: 16-byte loads
// and stores, when P * N is a multiple of 4). REV (the backward's pass 3):
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
      ssd_states<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  ssd_states<T><<<static_cast<unsigned>(bh * p.nc), ST_THREADS,
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
// The backward (ssd_scan_bwd_launch): five launches at the backward's chunk
// c <= BC, through the f32 workspace the wrapper allocates.
// ---------------------------------------------------------------------------
constexpr int BC = 64;          // the backward's largest chunk: its tiles
constexpr int BG = 8;           // heads a per-chunk block takes in turn
constexpr int BWD_THREADS = 512;    // 16 warps, each a 16 x 16 output tile
constexpr int RED_THREADS = 256;
// Row strides of the [64][64] f32 tiles: LDA for tiles read along their
// rows by the MMA fragments (8 rows x 4 columns a load, 4 banks apart),
// LDK for tiles read down their columns (4 rows x 8 columns, 8 banks
// apart); both keep 16-byte rows for cp.async.
constexpr int LDA = BC + 4;
constexpr int LDK = BC + 8;
constexpr int TA = BC * LDA, TK = BC * LDK;   // floats of a tile

struct BwdParams {
  Params f;         // the forward's, at chunk c (passes 1-3)
  void* dx;         // [B, S, H, P]
  void* ddt;        // [B, S, H]
  float* da;        // [H] f32
  void* dbm;        // [B, S, N]
  void* dcm;        // [B, S, N]
  double* da_part;  // [B, nc, H]
  float* db_part;   // [groups, B, S, N]
  float* dc_part;   // [groups, B, S, N]
  int groups;
  bool vec;         // f32 inputs in 16-byte rows: staged by cp.async
};

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

// rows [0, rows) x columns [0, cols) of a row-major tensor (row stride rs)
// into a [64][64] tile of row stride ld, zeros elsewhere: by cp.async when
// `vec` (f32, 16-byte rows; the caller commits the group), else through
// registers
template <typename T>
__device__ __forceinline__ void stage(float* tile, int ld, const T* src,
                                      int64_t rs, int rows, int cols,
                                      bool vec, int tid) {
  constexpr int PER = BC * 16 / BWD_THREADS;     // 16-byte chunks a thread
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int i = tid + k * BWD_THREADS, r = i / 16, q = 4 * (i % 16);
        const bool ok = r < rows && q < cols;
        cp_async16(tile + r * ld + q, ok ? src + r * rs + q : src, ok);
      }
      return;
    }
  }
  float4 v[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = tid + k * BWD_THREADS, r = i / 16, c = 4 * (i % 16);
    float e[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      e[u] = r < rows && c + u < cols ? to_f32(src[r * rs + c + u]) : 0.f;
    v[k] = make_float4(e[0], e[1], e[2], e[3]);
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = tid + k * BWD_THREADS;
    *reinterpret_cast<float4*>(tile + (i / 16) * ld + 4 * (i % 16)) = v[k];
  }
}

// The 3xTF32 split, v = hi + lo: hi is v rounded to TF32 (a 10-bit
// mantissa; half an ulp added to the magnitude, the low 13 bits cleared),
// lo = v - hi exactly, handed to the MMA as it is (the tensor cores read a
// TF32 operand's top 19 bits: lo loses what lies below 2^-10 of it, ~2^-21
// of v). Integer and add instructions only: cvt.rna.tf32 runs on the
// conversion pipe, which held the products to ~15% of the TF32 rate.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's 16 x 16 output tile: rows R0 + g + 8 i (i < 2), columns C0 +
// 8 nt + 2 q + e (nt, e < 2), g = lane / 4 and q = lane % 4; the MMA
// accumulator layout, held as acc[nt][2 i + e].
struct Place {
  int R0, C0, g, q, bt, bs;
};
using Acc = float[2][4];

// acc += A B over k in [8 k0, 8 k1), A [rows][k] and B [k][cols] f32 tiles
// in shared memory read as MMA fragments: A stored [row][k] (row stride
// lda) or, AK, [k][row]; B stored [col][k] or, BK, [k][col]. Each 16 x 8
// x 8 step runs as three TF32 MMAs, hi*hi + hi*lo + lo*hi (3xTF32): the
// products keep about the float32 rounding of an FMA (lo*lo, ~2^-22 of a
// product, is dropped).
template <bool AK, bool BK>
__device__ __forceinline__ void warp_mm(Acc& acc, const float* A, int lda,
                                        const float* B, int ldb,
                                        const Place& pl, int k0, int k1) {
  const int g = pl.g, q = pl.q;
#pragma unroll 2
  for (int kb = k0; kb < k1; ++kb) {
    const int k = 8 * kb;
    float av[4];
    if (AK) {
      av[0] = A[(k + q) * lda + pl.R0 + g];
      av[1] = A[(k + q) * lda + pl.R0 + g + 8];
      av[2] = A[(k + q + 4) * lda + pl.R0 + g];
      av[3] = A[(k + q + 4) * lda + pl.R0 + g + 8];
    } else {
      av[0] = A[(pl.R0 + g) * lda + k + q];
      av[1] = A[(pl.R0 + g + 8) * lda + k + q];
      av[2] = A[(pl.R0 + g) * lda + k + q + 4];
      av[3] = A[(pl.R0 + g + 8) * lda + k + q + 4];
    }
    uint32_t ah[4], al[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) split_tf32(av[r], ah[r], al[r]);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int n = pl.C0 + 8 * nt + g;
      const float b0 = BK ? B[(k + q) * ldb + n] : B[n * ldb + k + q];
      const float b1 = BK ? B[(k + q + 4) * ldb + n] : B[n * ldb + k + q + 4];
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(b0, bh0, bl0);
      split_tf32(b1, bh1, bl1);
      mma_tf32(acc[nt], al, bh0, bh1);
      mma_tf32(acc[nt], ah, bl0, bl1);
      mma_tf32(acc[nt], ah, bh0, bh1);
    }
  }
}

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nt][r] = 0.f;
}

// the warp's row r (i) and column c (nt, e) of acc[nt][2 i + e]
__device__ __forceinline__ int row_of(const Place& pl, int i) {
  return pl.R0 + pl.g + 8 * i;
}
__device__ __forceinline__ int col_of(const Place& pl, int nt, int e) {
  return pl.C0 + 8 * nt + 2 * pl.q + e;
}

// sums over the lanes of a row (q: 4 lanes) or of a column (g: 8 lanes),
// the same tree in every lane
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float col_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Warp w's output tile (bt, bs) = (w / 4, BS[w]) of the 4 x 4 grid of
// 16 x 16 tiles: the warps of one scheduler (w % 4) hold every row block
// and every column block once (a Latin square), and 2 or 3 of the 10
// tiles with bs <= bt, where the triangles s <= t lie.
__constant__ int BS[16] = {0, 1, 2, 3, 2, 0, 3, 1, 3, 2, 1, 0, 1, 3, 0, 2};

__device__ __forceinline__ Place place_of(int tid) {
  Place pl;
  const int w = tid / 32, lane = tid % 32;
  pl.bt = w / 4;
  pl.bs = BS[w];
  pl.R0 = 16 * pl.bt;
  pl.C0 = 16 * pl.bs;
  pl.g = lane / 4;
  pl.q = lane % 4;
  return pl;
}

struct StSmem {
  // C, B; x, dy in two buffers, all read down their columns (LDK); the
  // group's seg (f64) [BG][BC], dt, then per head and row exp(seg_t) and
  // tail_t = exp(seg_last - seg_t) dt_t
  static constexpr int C = 0, B = TK, X = 2 * TK, DY = 4 * TK,
      SEG = 6 * TK, DT = SEG + 2 * BG * BC, ES = DT + BG * BC,
      TAIL = ES + BG * BC, FLOATS = TAIL + BG * BC;
};

constexpr int st_bwd_smem_bytes() { return StSmem::FLOATS * 4; }

// Pass 1: per (b, chunk, group of BG heads), C and B staged once, each
// head's own state and state gradient
//   S_c = sum_s (x_s tail_s) B_s^T,  G_c = sum_t (dy_t exp(seg_t)) C_t^T,
// [p][n] each (x and dy scaled in place first, as the forward's pass 1
// scales x), and the chunk's decay exp(seg_last). One block of 16 warps
// an SM (118 KB of shared memory), each warp a 16 x 16 tile of both
// products; the next head's x and dy land by cp.async while this head
// computes. 1.04 ms at SSD_MAIN (H100 80GB HBM3, 700 W; the ~1.9 GB it
// moves take 0.56 ms at 3.35 TB/s), against 0.90 ms for each of the two
// launches of the forward's pass 1 it replaces.
template <typename T>
__global__ void __launch_bounds__(BWD_THREADS, 1) ssd_bwd_states(
    const BwdParams bp) {
  extern __shared__ __align__(16) float sm[];
  using L = StSmem;
  const float* Cs = sm + L::C;
  const float* Bs = sm + L::B;
  double* segs = reinterpret_cast<double*>(sm + L::SEG);   // [BG][BC]
  float* dts = sm + L::DT;           // [BG][BC]
  float* ess = sm + L::ES;           // [BG][BC]
  float* tails = sm + L::TAIL;       // [BG][BC]

  const Params& prm = bp.f;
  const int P = prm.p, N = prm.n, H = prm.heads, C = prm.chunk;
  const int g = blockIdx.x % bp.groups;
  const int ci = (blockIdx.x / bp.groups) % prm.nc;
  const int b = blockIdx.x / bp.groups / prm.nc;
  const int h0 = g * BG, hn = min(BG, H - h0);
  const int nv = min(C, prm.seq - ci * C);
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const Place pl = place_of(tid);
  const int64_t row0 = static_cast<int64_t>(b) * prm.seq + ci * C;
  const int64_t rs = static_cast<int64_t>(H) * P;
  const int64_t pn = static_cast<int64_t>(P) * N;
  const T* xg = static_cast<const T*>(prm.x) + row0 * rs;
  const T* dyg = static_cast<const T*>(prm.dy) + row0 * rs;
  const T* dg = static_cast<const T*>(prm.dt);
  const bool vec = bp.vec;
  const int64_t slot0 = (static_cast<int64_t>(b) * H + h0) * prm.nc + ci;

  auto stage_head = [&](int k) {
    const int u = (k & 1) * TK;
    stage(sm + L::X + u, LDK, xg + static_cast<int64_t>(h0 + k) * P, rs, nv,
          P, vec, tid);
    stage(sm + L::DY + u, LDK, dyg + static_cast<int64_t>(h0 + k) * P, rs,
          nv, P, vec, tid);
    cp_commit();
  };

  stage(sm + L::C, LDK, static_cast<const T*>(prm.cm) + row0 * N, N, nv, N,
        vec, tid);
  stage(sm + L::B, LDK, static_cast<const T*>(prm.bm) + row0 * N, N, nv, N,
        vec, tid);
  stage_head(0);
  for (int i = tid; i < BG * BC; i += BWD_THREADS) {
    const int t = i / BG, k = i % BG;
    dts[k * BC + t] =
        k < hn && t < nv ? to_f32(dg[(row0 + t) * H + h0 + k]) : 0.f;
  }
  __syncthreads();
  if (w < hn) {
    double* seg = segs + w * BC;
    chunk_seg(seg, dts + w * BC, prm.a[h0 + w], C, lane);
    __syncwarp();
    const double seg_last = seg[C - 1];
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int t = lane + 32 * v;
      const bool in = t < C;
      ess[w * BC + t] = in ? expf(static_cast<float>(seg[t])) : 0.f;
      tails[w * BC + t] = in
          ? expf(static_cast<float>(seg_last - seg[t])) * dts[w * BC + t]
          : 0.f;
    }
    if (lane == 0)
      prm.decay[slot0 + w * static_cast<int64_t>(prm.nc)] =
          expf(static_cast<float>(seg_last));
  }

  for (int k = 0; k < hn; ++k) {
    const int u = (k & 1) * TK;
    float* Xs = sm + L::X + u;
    float* DY = sm + L::DY + u;
    if (k + 1 < hn) stage_head(k + 1);
    else cp_commit();
    cp_wait<1>();                // head k's x and dy
    __syncthreads();
#pragma unroll
    for (int e = tid; e < BC * BC; e += BWD_THREADS) {
      const int t = e / BC, o = t * LDK + e % BC;
      Xs[o] *= tails[k * BC + t];
      DY[o] *= ess[k * BC + t];
    }
    __syncthreads();
    Acc st, gt;                  // S_c, G_c [p][n]
    zero(st);
    zero(gt);
    warp_mm<true, true>(st, Xs, LDK, Bs, LDK, pl, 0, 8);
    warp_mm<true, true>(gt, DY, LDK, Cs, LDK, pl, 0, 8);
    const int64_t off = (slot0 + k * static_cast<int64_t>(prm.nc)) * pn;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row_of(pl, i);
      if (r >= P) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int n = col_of(pl, nt, 0);
        float* so = prm.states + off + r * N + n;
        float* go = prm.gstates + off + r * N + n;
        if (N % 2 == 0 && n < N) {
          *reinterpret_cast<float2*>(so) =
              make_float2(st[nt][2 * i], st[nt][2 * i + 1]);
          *reinterpret_cast<float2*>(go) =
              make_float2(gt[nt][2 * i], gt[nt][2 * i + 1]);
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (n + e < N) {
              so[e] = st[nt][2 * i + e];
              go[e] = gt[nt][2 * i + e];
            }
        }
      }
    }
    __syncthreads();             // head k's buffers are read
  }
}

struct BwdSmem {
  // C, B, W^T; x, dy, g_c and h_c in two buffers (head k's and head
  // k + 1's), h_c read down its columns (LDK), the rest along rows (LDA);
  // the group's seg (f64) [BG][BC]; by head parity, the warps' g_c . h_c
  // (f64) [2][16]; dt, exp(seg_t), exp(seg_last - seg_t) and tail_t
  // [BG][BC]; by head parity, a head's partial sums by row block
  // [2][4][BC]: colsum (sum_t Q), dtail (x . g_c B); by column block
  // [2][4][BC]: rowsum (sum_s Q dt_s), C . dC(state)
  static constexpr int C = 0, B = TA, W = 2 * TA, G = 3 * TA, X = 5 * TA,
      DY = 7 * TA, H = 9 * TA, SEG = H + 2 * TK,
      GH = SEG + 2 * BG * BC, DT = GH + 2 * 2 * 16, ES = DT + BG * BC,
      ETL = ES + BG * BC, TAIL = ETL + BG * BC, CPART = TAIL + BG * BC,
      DTP = CPART + 8 * BC, ROWS = DTP + 8 * BC, CDC = ROWS + 8 * BC,
      FLOATS = CDC + 8 * BC;
};

constexpr int bwd_smem_bytes() { return BwdSmem::FLOATS * 4; }

// Pass 4: one (b, chunk, group of BG heads). For each head in turn:
//   dWE[t,s] = (dy_t . x_s) exp(seg_t - seg_s), s <= t; Q = dWE * CB;
//   W = (CB * exp(seg_t - seg_s)) * dt_s, the forward's weights;
//   sum_h dCB += dWE * dt_s (for dB and dC once per group);
//   dx_s = tail_s (g_c B_s) + sum_{t>=s} W[t,s] dy_t;
//   dC_t += exp(seg_t) h_c^T dy_t;  dB_s += tail_s g_c^T x_s;
//   ddt_s = sum_t Q[t,s] + dtail_s exp(seg_last - seg_s) + dDA_s a;
//   dseg_t = sum_s Q[t,s] dt_s - dt_t sum_s Q[s,t] + C_t . dC_t(state)
//            - dtail_t tail_t, and at the chunk's last row + sum_s dtail_s
//            tail_s + exp(seg_last) sum g_c h_c;
//   dDA = the reverse cumulative sum of dseg, in f64; dA's partial
//   sum_t dDA_t dt_t, in f64.
// Then dC_t += sum_s dCB[t,s] B_s and dB_s += sum_t dCB[t,s] C_t, the
// group's partials.
// Layout: one block of 16 warps an SM (512 threads, 209 KB of shared
// memory: C, B, W^T; x, dy, g_c and h_c in two buffers, head k's and head
// k + 1's; the group's seg in f64 and its per-row factors; the phases'
// partial sums). Every product is [64 x 64] over k = 64, each warp a
// 16 x 16 output tile at the same (row block, column block) in all of
// them, so that a thread keeps its share of C.B^T, sum_h dCB, dC and dB
// in registers (32 floats) through the group. The triangles skip the
// tiles and k-steps they do not reach (C.B^T and dWE: the 10 tiles with
// s <= t; dx and the end's dB: k >= the column block), and the warps of
// one scheduler hold the same share of them. Phases, a barrier between
// each; head k + 1's four tiles go in by cp.async one a phase, each into
// the buffer head k - 1 has done with:
//   S1: dC(state) = exp(seg_t) dy h_c, its row dots C . dC, g_c . h_c;
//   S2: dWE, Q, W and sum_h dCB; W^T to shared memory; Q's row and column
//       sums; warp 1, whose tile lies above the diagonal, meanwhile takes
//       the previous head's row terms (rows_of);
//   S3: g_c B, dtail's partials, dx = tail (g_c B) + W^T dy;
//   S4: dB += tail (x g_c)^T.
// Row and column sums go by shuffles inside a warp, then over the 4 row
// or column blocks in order. At SSD_MAIN on an H100 80GB HBM3 (700 W) the
// pass takes 2.40 ms, against 6.76 for a design of 8 warps, f32 FMAs and
// one-thread row terms. Thread 0's clock64 stamps put 21% of a block in
// S1, 18% in S2, 29% in S3, 15% in S4, 7% in the prologue and 6% at the
// barriers; without its products the pass takes 1.00 ms, mostly the
// ~1.9 GB of tiles it loads; the split's integer and add instructions
// cost ~0.4 ms and the two extra MMAs of each step ~0.2.
template <typename T>
__global__ void __launch_bounds__(BWD_THREADS, 1) ssd_bwd_chunk(
    const BwdParams bp) {
  extern __shared__ __align__(16) float sm[];
  using L = BwdSmem;
  const float* Cs = sm + L::C;       // C [t][n]
  const float* Bs = sm + L::B;       // B [s][n]
  float* Wt = sm + L::W;             // W^T [s][t]; at the end sum_h dCB^T
  double* segs = reinterpret_cast<double*>(sm + L::SEG);   // [BG][BC]
  float* dts = sm + L::DT;           // [BG][BC] each
  float* ess = sm + L::ES;
  float* etls = sm + L::ETL;
  float* tails = sm + L::TAIL;

  const Params& prm = bp.f;
  const int P = prm.p, N = prm.n, H = prm.heads, C = prm.chunk;
  const int g = blockIdx.x % bp.groups;
  const int ci = (blockIdx.x / bp.groups) % prm.nc;
  const int b = blockIdx.x / bp.groups / prm.nc;
  const int h0 = g * BG, hn = min(BG, H - h0);
  const int t0c = ci * C;
  const int nv = min(C, prm.seq - t0c);
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const Place pl = place_of(tid);
  const int bt = pl.bt, bs = pl.bs;
  const bool tri = bs <= bt;         // the tile reaches s <= t
  const int64_t row0 = static_cast<int64_t>(b) * prm.seq + t0c;
  const int64_t rs = static_cast<int64_t>(H) * P;
  const int64_t pn = static_cast<int64_t>(P) * N;
  const T* xg = static_cast<const T*>(prm.x) + row0 * rs;
  const T* dyg = static_cast<const T*>(prm.dy) + row0 * rs;
  const T* dg = static_cast<const T*>(prm.dt);
  T* dxg = static_cast<T*>(bp.dx);
  T* ddtg = static_cast<T*>(bp.ddt);
  const bool vec = bp.vec, svec = N % 4 == 0;
  const int64_t slot0 = (static_cast<int64_t>(b) * H + h0) * prm.nc + ci;

  // one of head k's tiles into buffer k % 2 (no more than hn heads)
  auto stage_x = [&](int k) {
    if (k < hn)
      stage(sm + L::X + (k & 1) * TA, LDA,
            xg + static_cast<int64_t>(h0 + k) * P, rs, nv, P, vec, tid);
  };
  auto stage_dy = [&](int k) {
    if (k < hn)
      stage(sm + L::DY + (k & 1) * TA, LDA,
            dyg + static_cast<int64_t>(h0 + k) * P, rs, nv, P, vec, tid);
  };
  auto stage_h = [&](int k) {
    if (k < hn)
      stage(sm + L::H + (k & 1) * TK, LDK,
            prm.states + (slot0 + k * static_cast<int64_t>(prm.nc)) * pn, N,
            P, N, svec, tid);
  };
  auto stage_g = [&](int k) {
    if (k < hn)
      stage(sm + L::G + (k & 1) * TA, LDA,
            prm.gstates + (slot0 + k * static_cast<int64_t>(prm.nc)) * pn, N,
            P, N, svec, tid);
  };
  // head k's row terms, by one warp (lane's rows 2 lane, 2 lane + 1),
  // from the partial sums its phases left by row or column block (its
  // parity's arrays): its ddt, the reverse cumulative sum dDA of dseg in
  // f64 (a warp scan), and dA's partial sum_t dDA_t dt_t in f64
  auto rows_of = [&](int k) {
    const int u = k & 1;
    const double* seg = segs + k * BC;
    const float* dth = dts + k * BC;
    const float* cpart = sm + L::CPART + u * 4 * BC;
    const float* dtp = sm + L::DTP + u * 4 * BC;
    const float* rows = sm + L::ROWS + u * 4 * BC;
    const float* cdcs = sm + L::CDC + u * 4 * BC;
    const double* ghp = reinterpret_cast<const double*>(sm + L::GH) + u * 16;
    double dsg[2], endp = 0.0;
    float ddt0[2];
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int r = 2 * lane + v;
      const bool in = r < C;
      float cs = 0.f, dtail = 0.f, rw = 0.f, cdc = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        cs += cpart[i * BC + r];
        dtail += dtp[i * BC + r];
        rw += rows[i * BC + r];
        cdc += cdcs[i * BC + r];
      }
      const float dtt = __fmul_rn(dtail, tails[k * BC + r]);
      ddt0[v] = __fadd_rn(cs, __fmul_rn(dtail, etls[k * BC + r]));
      dsg[v] = in ? static_cast<double>(rw) -
                    static_cast<double>(__fmul_rn(dth[r], cs)) +
                    static_cast<double>(cdc) - static_cast<double>(dtt)
                  : 0.0;
      endp += in ? static_cast<double>(dtt) : 0.0;
    }
    double gh = 0.0;
#pragma unroll
    for (int i = 0; i < 16; ++i) gh += ghp[i];
    const double end = warp_sum(endp) +
        static_cast<double>(expf(static_cast<float>(seg[C - 1]))) * gh;
#pragma unroll
    for (int v = 0; v < 2; ++v)
      if (2 * lane + v == C - 1) dsg[v] += end;
    // dDA_t = sum_{r>=t} dseg_r: the lanes after this one, by a scan
    const double run = dsg[0] + dsg[1];
    double incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double dn = __shfl_down_sync(0xffffffffu, incl, o);
      if (lane + o < 32) incl += dn;
    }
    const double dda[2] = {(incl - run) + dsg[1] + dsg[0],
                           (incl - run) + dsg[1]};
    const double av = static_cast<double>(prm.a[h0 + k]);
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int r = 2 * lane + v;
      if (r < nv)
        ddtg[(row0 + r) * H + h0 + k] = from_f32<T>(
            __fadd_rn(ddt0[v], static_cast<float>(dda[v] * av)));
    }
    const double da = warp_sum(dda[0] * static_cast<double>(dth[2 * lane]) +
                               dda[1] * static_cast<double>(dth[2 * lane + 1]));
    if (lane == 0)
      bp.da_part[(static_cast<int64_t>(b) * prm.nc + ci) * H + h0 + k] = da;
  };

  // ---- prologue: C, B and head 0's tiles; dt of the group's heads; each
  // head's seg and row factors, a warp a head; C.B^T ----
  stage(sm + L::C, LDA, static_cast<const T*>(prm.cm) + row0 * N, N, nv, N,
        vec, tid);
  stage(sm + L::B, LDA, static_cast<const T*>(prm.bm) + row0 * N, N, nv, N,
        vec, tid);
  stage_dy(0);
  stage_h(0);
  stage_x(0);
  stage_g(0);
  cp_commit();
  for (int i = tid; i < BG * BC; i += BWD_THREADS) {
    const int t = i / BG, k = i % BG;
    dts[k * BC + t] =
        k < hn && t < nv ? to_f32(dg[(row0 + t) * H + h0 + k]) : 0.f;
  }
  cp_wait<0>();
  __syncthreads();
  if (w < hn) {
    double* seg = segs + w * BC;
    chunk_seg(seg, dts + w * BC, prm.a[h0 + w], C, lane);
    __syncwarp();
    const double seg_last = seg[C - 1];
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int t = lane + 32 * v, o = w * BC + t;
      const bool in = t < C;
      const float etl = in ? expf(static_cast<float>(seg_last - seg[t]))
                           : 0.f;
      ess[o] = in ? expf(static_cast<float>(seg[t])) : 0.f;
      etls[o] = etl;
      tails[o] = __fmul_rn(etl, dts[o]);
    }
  }
  Acc CB, dCB;                   // C.B^T below the diagonal, sum_h dCB [t][s]
  Acc accC, accB;                // the group's dC [t][n], dB^T [n][s]
  zero(CB);
  zero(dCB);
  zero(accC);
  zero(accB);
  if (tri) warp_mm<false, false>(CB, Cs, LDA, Bs, LDA, pl, 0, 8);
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = row_of(pl, r / 2), s = col_of(pl, nt, r % 2);
      if (!(s <= t && t < C)) CB[nt][r] = 0.f;
    }
  __syncthreads();               // every head's seg and row factors

  // Head k + 1's tiles go in one a phase of head k, each into the buffer
  // head k - 1 has done with, one cp.async group each: dy (read first by
  // S1), h_c, x, g_c. Each wait lets the two latest groups stay in flight.
  for (int k = 0; k < hn; ++k) {
    const int h = h0 + k, u = k & 1;
    const float* Xs = sm + L::X + u * TA;
    const float* DY = sm + L::DY + u * TA;
    const float* Hs = sm + L::H + u * TK;
    const float* Gs = sm + L::G + u * TA;
    const double* seg = segs + k * BC;
    const float* dth = dts + k * BC;
    const float* esh = ess + k * BC;
    const float* tlh = tails + k * BC;
    float* cpart = sm + L::CPART + u * 4 * BC;
    float* dtp = sm + L::DTP + u * 4 * BC;
    float* rows = sm + L::ROWS + u * 4 * BC;
    float* cdcs = sm + L::CDC + u * 4 * BC;
    double* ghp = reinterpret_cast<double*>(sm + L::GH) + u * 16;
    stage_dy(k + 1);
    cp_commit();
    {  // S1: dC(state) = exp(seg_t) dy_t h_c [t][n]; C . dC(state); g_c . h_c
      Acc acc;
      zero(acc);
      warp_mm<false, true>(acc, DY, LDA, Hs, LDK, pl, 0, 8);
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = row_of(pl, i);
        const float e = esh[t];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float dci = __fmul_rn(acc[nt][2 * i + c], e);
            accC[nt][2 * i + c] += dci;
            part[i] = fmaf(Cs[t * LDA + col_of(pl, nt, c)], dci, part[i]);
          }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float v = row_sum(part[i]);
        if (pl.q == 0) cdcs[bs * BC + row_of(pl, i)] = v;
      }
      float gh = 0.f;            // over the tiles, zero past P and N
#pragma unroll
      for (int e = tid; e < BC * BC; e += BWD_THREADS) {
        const int r = e / BC, c = e % BC;
        gh = fmaf(Gs[r * LDA + c], Hs[r * LDK + c], gh);
      }
      const double ghs = warp_sum(static_cast<double>(gh));
      if (lane == 0) ghp[w] = ghs;
    }
    cp_wait<2>();                // head k's x
    __syncthreads();             // S1's sums; h_c is read
    stage_h(k + 1);
    cp_commit();
    {  // S2: dWE, Q, W [t][s]; sum_h dCB; W^T; Q's row and column sums
      Acc acc;
      zero(acc);
      if (tri) warp_mm<false, false>(acc, DY, LDA, Xs, LDA, pl, 0, 8);
      float rsum[2] = {0.f, 0.f}, csum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = row_of(pl, i);
        const double st = seg[t];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int s = col_of(pl, nt, c), r = 2 * i + c;
            const float ds = dth[s];
            float q = 0.f, wt = 0.f;
            if (s <= t && t < C) {
              const float e = expf(static_cast<float>(st - seg[s]));
              const float cb = CB[nt][r];
              const float dwe = __fmul_rn(acc[nt][r], e);
              q = __fmul_rn(dwe, cb);
              wt = __fmul_rn(__fmul_rn(cb, e), ds);
              dCB[nt][r] += __fmul_rn(dwe, ds);
            }
            if (tri) Wt[s * LDA + t] = wt;
            rsum[i] = fmaf(q, ds, rsum[i]);
            csum[nt][c] += q;
          }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float v = row_sum(rsum[i]);
        if (pl.q == 0) rows[bs * BC + row_of(pl, i)] = v;
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float v = col_sum(csum[nt][c]);
          if (pl.g == 0) cpart[bt * BC + col_of(pl, nt, c)] = v;
        }
      // warp 1's tile lies above the diagonal: it takes the previous
      // head's row terms meanwhile
      if (w == 1 && k > 0) rows_of(k - 1);
    }
    cp_wait<2>();                // head k's g_c
    __syncthreads();             // W^T and Q's sums are ready
    stage_x(k + 1);
    cp_commit();
    {  // S3: g_c B [p][s]; dtail's partials; dx = tail (g_c B) + W^T dy
      Acc acc;
      zero(acc);
      warp_mm<false, false>(acc, Gs, LDA, Bs, LDA, pl, 0, 8);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int s = col_of(pl, nt, c);
          float v = 0.f;
#pragma unroll
          for (int i = 0; i < 2; ++i)
            v = fmaf(Xs[s * LDA + row_of(pl, i)], acc[nt][2 * i + c], v);
          v = col_sum(v);
          if (pl.g == 0) dtp[bt * BC + s] = v;
          const float tl = tlh[s];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            acc[nt][2 * i + c] = __fmul_rn(tl, acc[nt][2 * i + c]);
        }
      warp_mm<true, false>(acc, DY, LDA, Wt, LDA, pl, 2 * bs, 8);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int s = col_of(pl, nt, c);
          if (s >= nv) continue;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int p = row_of(pl, i);
            if (p < P)
              dxg[((row0 + s) * H + h) * P + p] =
                  from_f32<T>(acc[nt][2 * i + c]);
          }
        }
    }
    __syncthreads();             // dy, W^T and dtail's partials are read
    stage_g(k + 1);
    cp_commit();
    {  // S4: dB^T += tail_s (x g_c)^T [n][s]
      Acc acc;
      zero(acc);
      warp_mm<true, false>(acc, Gs, LDA, Xs, LDA, pl, 0, 8);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float tl = tlh[col_of(pl, nt, c)];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            accB[nt][2 * i + c] += __fmul_rn(tl, acc[nt][2 * i + c]);
        }
    }
    cp_wait<2>();                // head k + 1's dy and h_c
    __syncthreads();             // head k's tiles are read
  }

  // ---- the last head's row terms; the group's dC and dB: + sum_h dCB B
  // and + sum_h dCB^T C ----
  if (w == 1) rows_of(hn - 1);
  if (tri) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        Wt[col_of(pl, nt, r % 2) * LDA + row_of(pl, r / 2)] = dCB[nt][r];
  }
  __syncthreads();
  warp_mm<true, true>(accC, Wt, LDA, Bs, LDA, pl, 0, 2 * bt + 2);
  warp_mm<true, false>(accB, Cs, LDA, Wt, LDA, pl, 2 * bs, 8);
  const int64_t base = (static_cast<int64_t>(g) * prm.batch + b) * prm.seq +
                       t0c;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      {  // dC [t][n]: t = row, n = column
        const int t = row_of(pl, i), n = col_of(pl, nt, 0);
        if (t < nv) {
          float* dst = bp.dc_part + (base + t) * N + n;
          if (svec && n < N) {
            *reinterpret_cast<float2*>(dst) =
                make_float2(accC[nt][2 * i], accC[nt][2 * i + 1]);
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (n + e < N) dst[e] = accC[nt][2 * i + e];
          }
        }
      }
      {  // dB [s][n]: n = row, s = column
        const int n = row_of(pl, i);
        if (n < N) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int s = col_of(pl, nt, e);
            if (s < nv) bp.db_part[(base + s) * N + n] = accB[nt][2 * i + e];
          }
        }
      }
    }
}

// Pass 5: the fixed-order sums. dB and dC: one thread per (b, t, n) over
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
      ssd_bwd_states<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      st_bwd_smem_bytes());
  static const cudaError_t attr4 = cudaFuncSetAttribute(
      ssd_bwd_chunk<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bwd_smem_bytes());
  if (attr1 != cudaSuccess) return attr1;
  if (attr4 != cudaSuccess) return attr4;
  const Params& p = bp.f;
  const int64_t bh = static_cast<int64_t>(p.batch) * p.heads;
  const int64_t pn = static_cast<int64_t>(p.p) * p.n;
  const int64_t red = static_cast<int64_t>(p.batch) * p.seq * p.n;
  const int64_t red_blocks =
      ((red > p.heads ? red : p.heads) + RED_THREADS - 1) / RED_THREADS;
  const int64_t chunk_blocks = static_cast<int64_t>(p.batch) * bp.groups * p.nc;
  if (chunk_blocks > INT_MAX || red_blocks > INT_MAX)
    return cudaErrorInvalidValue;
  const int v = pn % 4 == 0 ? 4 : 1;
  const dim3 pass_grid(static_cast<unsigned>(bh),
                       static_cast<unsigned>((pn / v + PASS_THREADS - 1) /
                                             PASS_THREADS));
  // 1: each chunk's own state, decay and state gradient
  ssd_bwd_states<T><<<static_cast<unsigned>(chunk_blocks), BWD_THREADS,
                      st_bwd_smem_bytes(), stream>>>(bp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // 2-3: the states entering each chunk; the reverse carry of the
  // gradients, the gradient of the state leaving each chunk
  if (v == 4) ssd_pass<4, false><<<pass_grid, PASS_THREADS, 0, stream>>>(p);
  else ssd_pass<1, false><<<pass_grid, PASS_THREADS, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (v == 4) ssd_pass<4, true><<<pass_grid, PASS_THREADS, 0, stream>>>(p);
  else ssd_pass<1, true><<<pass_grid, PASS_THREADS, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 4: the per-chunk gradients; 5: the fixed-order sums
  ssd_bwd_chunk<T><<<static_cast<unsigned>(chunk_blocks), BWD_THREADS,
                     bwd_smem_bytes(), stream>>>(bp);
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
// nc = ceil(S / chunk), groups = ceil(H / 8) (ops.py's ssd_bwd_work). Five
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
  auto al16 = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  bp.vec = dtype == 0 && p % 4 == 0 && n % 4 == 0 && al16(x) && al16(dy) &&
           al16(bm) && al16(cm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_bwd<float>(bp, s));
    case 1: return static_cast<int>(launch_bwd<__nv_bfloat16>(bp, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
