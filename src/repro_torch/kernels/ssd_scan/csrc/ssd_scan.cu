// Mamba2 SSD chunked scan (forward) for Hopper (sm_90a).
//
// Replaces repro/kernels/ssd_scan/kernel.py::_ssd_kernel (the Pallas TPU
// kernel launched by ssd_scan_kernel). Same arithmetic, per (batch, head),
// with the f32 state h [P, N] carried from chunk to chunk:
//   seg = cumsum(dt * a) over the chunk (a < 0, the head's decay rate);
//   y_t = sum_{s<=t} (C_t . B_s) exp(seg_t - seg_s) dt_s x_s
//         + exp(seg_t) sum_n C_t[n] h[:, n];
//   h <- exp(seg_last) h + sum_s x_s (B_s exp(seg_last - seg_s) dt_s)^T.
// B and C are shared by all heads. The exponent is taken only where s <= t:
// the masked differences are positive and would overflow.
//
// Layout. The TPU kernel holds the [c, c] decay and C.B^T matrices of a
// whole chunk in VMEM (64 KB each at c = 128). Here the weights
// W[t, s] = (C_t . B_s) exp(seg_t - seg_s) dt_s are formed in row tiles of
// 32 rows (16 KB at c = 128), each consumed by its rows of y before the next
// tile is formed, and C.B^T is formed per head, as the Pallas kernel forms
// it. Shared memory holds the chunk's x, B, C, the state, one W tile and the
// per-row scalars: ~131 KB at c = 128, P = N = 64, below the 227 KB a block
// may take.
//
// Bound. At zamba2-7b's main-path shape (B 2, S 8192, H 112, P 64, N 64,
// chunk 128, f32) the call moves x, dt, B, C in and y out, ~0.96 GB (0.29 ms
// at 3.35 TB/s), and does ~60 GFLOP over the lower triangles (~0.9 ms at
// 67 TFLOP/s f32): it is bound by operations. This first kernel is far from
// that: scalar f32 FMAs over shared memory, no tensor cores, one block of
// 256 threads per (b, h), so shared-memory bandwidth bounds it.
//
// Design. The TPU grid (b, h, chunk) runs the chunks in order and keeps h
// in VMEM scratch. Hopper blocks run in no order, so one block owns one
// (b, h) and loops over the chunks itself. Per chunk, a barrier between
// each phase: load (rows past S are zero, the reference wrapper's padding:
// dt = 0, x = B = C = 0, so they leave h unchanged and are not written);
// seg by a warp scan; the per-row scalars exp(seg_t) and
// exp(seg_last - seg_s) dt_s; for each row tile, W and then y = W x plus the
// incoming-state term from the old h; then the new h. Rows of B, C and h,
// read across lanes, are padded by one float so that lanes hit distinct
// banks. x, dt, B, C are read and y written through their natural layouts
// ([B, S, H, P], [B, S, H], [B, S, N]), so the wrapper transposes nothing.
//
// The kernel allocates nothing and launches on the caller's stream. The C
// entry point returns cudaGetLastError() so that the Python wrapper can
// raise on a refused launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_P = 64;    // head size
constexpr int MAX_N = 64;    // state size
constexpr int MAX_C = 128;   // chunk
constexpr int TR = 32;       // rows of W formed at a time

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
  int seq, heads, p, n, chunk;
};

__host__ __device__ constexpr int smem_floats(int c, int p, int n) {
  // x [c][p]; B, C [c][n + 1]; h [p][n + 1]; W [TR][c]; dt, seg, exp(seg),
  // tail [c]
  return c * p + 2 * c * (n + 1) + p * (n + 1) + TR * c + 4 * c;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_fwd(const Params prm) {
  extern __shared__ float smem[];
  const int P = prm.p, N = prm.n, C = prm.chunk, NS = N + 1;
  float* xs = smem;               // x [C][P]
  float* bs = xs + C * P;         // B [C][NS]
  float* cs = bs + C * NS;        // C [C][NS]
  float* hs = cs + C * NS;        // h [P][NS]
  float* ws = hs + P * NS;        // W tile [TR][C]
  float* dts = ws + TR * C;       // dt
  float* seg = dts + C;           // cumsum(dt * a)
  float* eseg = seg + C;          // exp(seg)
  float* tail = eseg + C;         // exp(seg_last - seg) * dt

  const int tid = threadIdx.x;
  const int H = prm.heads;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const float a = prm.a[h];
  const int64_t xrow = static_cast<int64_t>(H) * P;   // one time step of x, y
  const T* xg = static_cast<const T*>(prm.x) +
                static_cast<int64_t>(b) * prm.seq * xrow +
                static_cast<int64_t>(h) * P;
  T* yg = static_cast<T*>(prm.y) + static_cast<int64_t>(b) * prm.seq * xrow +
          static_cast<int64_t>(h) * P;
  const T* dg = static_cast<const T*>(prm.dt) +
                static_cast<int64_t>(b) * prm.seq * H + h;
  const T* bg = static_cast<const T*>(prm.bm) +
                static_cast<int64_t>(b) * prm.seq * N;
  const T* cg = static_cast<const T*>(prm.cm) +
                static_cast<int64_t>(b) * prm.seq * N;

  for (int i = tid; i < P * NS; i += THREADS) hs[i] = 0.f;

  for (int t0 = 0; t0 < prm.seq; t0 += C) {
    const int n = min(C, prm.seq - t0);   // rows past it are zero padding
    __syncthreads();   // the previous chunk's reads of every buffer are done
    for (int i = tid; i < C * P; i += THREADS) {
      const int t = i / P, q = i % P;
      xs[i] = t < n ? to_f32(xg[static_cast<int64_t>(t0 + t) * xrow + q]) : 0.f;
    }
    for (int i = tid; i < C * N; i += THREADS) {
      const int t = i / N, j = i % N;
      const bool ok = t < n;
      const int64_t off = static_cast<int64_t>(t0 + t) * N + j;
      bs[t * NS + j] = ok ? to_f32(bg[off]) : 0.f;
      cs[t * NS + j] = ok ? to_f32(cg[off]) : 0.f;
    }
    for (int t = tid; t < C; t += THREADS)
      dts[t] = t < n ? to_f32(dg[static_cast<int64_t>(t0 + t) * H]) : 0.f;
    __syncthreads();

    if (tid < 32) {   // seg: each lane sums a run of rows, then a warp scan
      const int per = (C + 31) / 32;
      const int beg = tid * per;
      float run = 0.f;
      for (int j = 0; j < per; ++j) {
        const int t = beg + j;
        if (t < C) {
          run += dts[t] * a;
          seg[t] = run;
        }
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += up;
      }
      const float excl = incl - run;
      for (int j = 0; j < per; ++j) {
        const int t = beg + j;
        if (t < C) seg[t] += excl;
      }
    }
    __syncthreads();
    const float seg_last = seg[C - 1];
    for (int t = tid; t < C; t += THREADS) {
      eseg[t] = expf(seg[t]);
      tail[t] = expf(seg_last - seg[t]) * dts[t];
    }

    for (int r0 = 0; r0 < n; r0 += TR) {
      const int rows = min(TR, n - r0);
      const int width = r0 + rows;   // columns s <= t of the tile's rows
      __syncthreads();   // the previous tile's W reads are done; scalars set
      for (int i = tid; i < rows * width; i += THREADS) {
        const int tt = i / width, s = i % width, t = r0 + tt;
        float w = 0.f;
        if (s <= t) {
          const float* ct = cs + t * NS;
          const float* bb = bs + s * NS;
          float cb = 0.f;
#pragma unroll 8
          for (int j = 0; j < N; ++j) cb = fmaf(ct[j], bb[j], cb);
          w = cb * expf(seg[t] - seg[s]) * dts[s];
        }
        ws[tt * C + s] = w;
      }
      __syncthreads();
      for (int i = tid; i < rows * P; i += THREADS) {
        const int tt = i / P, q = i % P, t = r0 + tt;
        const float* wt = ws + tt * C;
        float acc = 0.f;
        for (int s = 0; s <= t; ++s) acc = fmaf(wt[s], xs[s * P + q], acc);
        const float* ct = cs + t * NS;
        const float* hq = hs + q * NS;
        float hacc = 0.f;
#pragma unroll 8
        for (int j = 0; j < N; ++j) hacc = fmaf(ct[j], hq[j], hacc);
        yg[static_cast<int64_t>(t0 + t) * xrow + q] =
            from_f32<T>(fmaf(eseg[t], hacc, acc));
      }
    }
    __syncthreads();   // y has read the old h

    const float decay = expf(seg_last);
    for (int i = tid; i < P * N; i += THREADS) {
      const int q = i / N, j = i % N;
      float acc = 0.f;
      for (int s = 0; s < n; ++s)
        acc = fmaf(xs[s * P + q], bs[s * NS + j] * tail[s], acc);
      hs[q * NS + j] = fmaf(decay, hs[q * NS + j], acc);
    }
  }
}

template <typename T>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  // opted in once per type, at the largest chunk, head and state size
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_floats(MAX_C, MAX_P, MAX_N) * static_cast<int>(sizeof(float)));
  if (attr != cudaSuccess) return attr;
  const int bytes =
      smem_floats(p.chunk, p.p, p.n) * static_cast<int>(sizeof(float));
  ssd_fwd<T><<<batch * p.heads, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x [B, S, H, P], dt [B, S, H], B and C [B, S, N], all contiguous and of one
// dtype (0 = float32, 1 = bfloat16); a [H] contiguous float32;
// y [B, S, H, P] contiguous in the inputs' dtype. 1 <= P <= 64,
// 1 <= N <= 64, 1 <= chunk <= 128. Returns a cudaError_t (0 = launched).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* bm, const void* cm, void* y,
                               int batch, int seq, int heads, int p, int n,
                               int chunk, int dtype, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || p <= 0 || p > MAX_P || n <= 0 ||
      n > MAX_N || chunk <= 0 || chunk > MAX_C ||
      static_cast<int64_t>(batch) * heads > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Params prm;
  prm.x = x; prm.dt = dt; prm.a = static_cast<const float*>(a);
  prm.bm = bm; prm.cm = cm; prm.y = y;
  prm.seq = seq; prm.heads = heads; prm.p = p; prm.n = n; prm.chunk = chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch<float>(prm, batch, s));
    case 1: return static_cast<int>(launch<__nv_bfloat16>(prm, batch, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
