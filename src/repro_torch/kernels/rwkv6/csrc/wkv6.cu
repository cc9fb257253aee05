// RWKV-6 chunked WKV (forward) for Hopper (sm_90a).
//
// Replaces repro/kernels/rwkv6/kernel.py::_wkv6_kernel (the Pallas TPU
// kernel launched by wkv6_kernel). Same arithmetic, per (batch, head), with
// the f32 state S [P, P] carried from chunk to chunk:
//   lcw = cumsum(lw) over the chunk, prev = lcw - lw;
//   A[t,s] = sum_p r_t[p] k_s[p] exp(prev_t[p] - lcw_s[p])   for s < t;
//   y_t = sum_s A[t,s] v_s + (sum_p r_t u k_t) v_t + (r_t * exp(prev_t)) S;
//   S <- exp(lcw_last) * S + (k * exp(lcw_last - lcw))^T v.
// Every exponent is a difference of cumulative log-decays and is <= 0, as
// the reference forms it: no ratio of decays, which would overflow where
// lw reaches -20 a step.
//
// Layout. The TPU kernel materialises E = exp(prev_t - lcw_s) as a
// [c, c, P] f32 tensor in VMEM (256 KB at c = 32, P = 64), more than a
// Hopper block's 227 KB of shared memory. Here A is formed pair by pair,
// each a length-P dot product with the exponentials taken on the fly, so
// nothing of size c*c*P is held anywhere.
//
// Bound. At rwkv6-7b's main-path shape (B 2, S 8192, H 64, P 64, f32) the
// call moves r, k, v, lw in and y out, 1.34 GB (0.40 ms at 3.35 TB/s), and
// does ~28 GFLOP plus ~1 G expf over the strict lower triangles (~0.4 ms at
// 67 TFLOP/s f32): it sits near the ridge. This first kernel does not get
// near either: scalar f32 FMAs (and accurate expf) over shared memory, no
// tensor cores, so shared-memory bandwidth and the exponentials bound it.
//
// Design. The TPU grid (b, h, chunk) runs the chunks in order and keeps S
// in VMEM scratch. Hopper blocks run in no order, so one block of 256
// threads owns one (b, h) and loops over the chunks itself:
//   * the chunk's r, k, v, lw, the cumulative lcw, A [c, c] and S live in
//     shared memory as f32 (~62 KB at c = 32, P = 64); rows read across
//     lanes are padded by one float so that lanes hit distinct banks;
//   * phases per chunk, one barrier between each: load (zero rows past S,
//     the reference wrapper's padding: lw = 0, k = v = 0, so they leave S
//     unchanged and their rows are not written); the per-channel cumulative
//     sums; A over the strict lower triangle, one pair per thread, and the
//     bonus dot products; r and k rescaled in place by exp(prev) and
//     exp(lcw_last - lcw); y from A, the bonus and the old S; then the new S;
//   * r, k, v, lw are read and y written through the [B, S, H, P] layout
//     (rows of H*P elements), so the wrapper transposes nothing.
//
// The kernel allocates nothing and launches on the caller's stream. The C
// entry point returns cudaGetLastError() so that the Python wrapper can
// raise on a refused launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_P = 64;   // head size
constexpr int MAX_C = 64;   // chunk

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
  const void* r;
  const void* k;
  const void* v;
  const void* lw;
  const float* u;  // [H, P] f32
  void* y;
  int seq, heads, p, chunk;
};

__host__ __device__ constexpr int smem_floats(int c, int p) {
  // r, k, lw, lcw [c][p + 1]; v [c][p]; S [p][p]; A [c][c]; u [p]; bonus [c]
  return 4 * c * (p + 1) + c * p + p * p + c * c + p + c;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) wkv6_fwd(const Params prm) {
  extern __shared__ float smem[];
  const int P = prm.p, C = prm.chunk, PS = P + 1;
  float* rs = smem;               // r, then r * exp(prev)
  float* ks = rs + C * PS;        // k, then k * exp(lcw_last - lcw)
  float* lws = ks + C * PS;       // lw
  float* lcs = lws + C * PS;      // lcw, the inclusive cumulative sum
  float* vs = lcs + C * PS;       // v [C][P]
  float* st = vs + C * P;         // S [P][P]
  float* as = st + P * P;         // A [C][C], strict lower triangle
  float* us = as + C * C;         // u [P]
  float* du = us + P;             // sum_p r u k, per row

  const int tid = threadIdx.x;
  const int b = blockIdx.x / prm.heads;
  const int h = blockIdx.x % prm.heads;
  const int64_t row = static_cast<int64_t>(prm.heads) * P;  // one time step
  const int64_t base = static_cast<int64_t>(b) * prm.seq * row +
                       static_cast<int64_t>(h) * P;
  const T* rg = static_cast<const T*>(prm.r) + base;
  const T* kg = static_cast<const T*>(prm.k) + base;
  const T* vg = static_cast<const T*>(prm.v) + base;
  const T* wg = static_cast<const T*>(prm.lw) + base;
  T* yg = static_cast<T*>(prm.y) + base;

  for (int i = tid; i < P * P; i += THREADS) st[i] = 0.f;
  for (int i = tid; i < P; i += THREADS) us[i] = prm.u[h * P + i];
  const int n_pairs = C * (C - 1) / 2;

  for (int t0 = 0; t0 < prm.seq; t0 += C) {
    const int n = min(C, prm.seq - t0);   // rows past it are zero padding
    __syncthreads();   // the previous chunk's reads of every buffer are done
    for (int i = tid; i < C * P; i += THREADS) {
      const int t = i / P, q = i % P;
      const bool ok = t < n;
      const int64_t off = static_cast<int64_t>(t0 + t) * row + q;
      rs[t * PS + q] = ok ? to_f32(rg[off]) : 0.f;
      ks[t * PS + q] = ok ? to_f32(kg[off]) : 0.f;
      lws[t * PS + q] = ok ? to_f32(wg[off]) : 0.f;
      vs[t * P + q] = ok ? to_f32(vg[off]) : 0.f;
    }
    __syncthreads();
    for (int q = tid; q < P; q += THREADS) {
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        acc += lws[t * PS + q];
        lcs[t * PS + q] = acc;
      }
    }
    __syncthreads();

    // A[t, s] for s < t: pair i of the strict lower triangle, row-major
    for (int i = tid; i < n_pairs; i += THREADS) {
      int t = static_cast<int>((1.f + sqrtf(1.f + 8.f * i)) * 0.5f);
      while (t * (t - 1) / 2 > i) --t;
      while ((t + 1) * t / 2 <= i) ++t;
      const int s = i - t * (t - 1) / 2;
      const float* rt = rs + t * PS;
      const float* lt = lcs + t * PS;
      const float* wt = lws + t * PS;
      const float* kk = ks + s * PS;
      const float* ls = lcs + s * PS;
      float a = 0.f;
#pragma unroll 8
      for (int q = 0; q < P; ++q)
        a = fmaf(rt[q] * expf((lt[q] - wt[q]) - ls[q]), kk[q], a);
      as[t * C + s] = a;
    }
    for (int t = tid; t < C; t += THREADS) {
      float d = 0.f;
      for (int q = 0; q < P; ++q)
        d = fmaf(rs[t * PS + q] * us[q], ks[t * PS + q], d);
      du[t] = d;
    }
    __syncthreads();

    const float* last = lcs + (C - 1) * PS;
    for (int i = tid; i < C * P; i += THREADS) {
      const int t = i / P, q = i % P;
      rs[t * PS + q] *= expf(lcs[t * PS + q] - lws[t * PS + q]);
      ks[t * PS + q] *= expf(last[q] - lcs[t * PS + q]);
    }
    __syncthreads();

    for (int i = tid; i < n * P; i += THREADS) {
      const int t = i / P, q = i % P;
      float acc = 0.f;
      for (int s = 0; s < t; ++s) acc = fmaf(as[t * C + s], vs[s * P + q], acc);
      acc = fmaf(du[t], vs[t * P + q], acc);
      const float* rt = rs + t * PS;
      float sacc = 0.f;
#pragma unroll 8
      for (int p = 0; p < P; ++p) sacc = fmaf(rt[p], st[p * P + q], sacc);
      yg[static_cast<int64_t>(t0 + t) * row + q] = from_f32<T>(acc + sacc);
    }
    __syncthreads();   // y has read the old S

    for (int i = tid; i < P * P; i += THREADS) {
      const int p = i / P, q = i % P;
      float acc = 0.f;
      for (int s = 0; s < n; ++s) acc = fmaf(ks[s * PS + p], vs[s * P + q], acc);
      st[i] = fmaf(expf(last[p]), st[i], acc);
    }
  }
}

template <typename T>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  // opted in once per type, at the largest chunk and head size
  static const cudaError_t attr = cudaFuncSetAttribute(
      wkv6_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_floats(MAX_C, MAX_P) * static_cast<int>(sizeof(float)));
  if (attr != cudaSuccess) return attr;
  const int bytes = smem_floats(p.chunk, p.p) * static_cast<int>(sizeof(float));
  wkv6_fwd<T><<<batch * p.heads, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, lw [B, S, H, P] contiguous, all of one dtype (0 = float32,
// 1 = bfloat16); u [H, P] contiguous float32; y [B, S, H, P]
// contiguous in the inputs' dtype. 1 <= P <= 64, 1 <= chunk <= 64.
// Returns a cudaError_t (0 = launched).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* lw, const void* u, void* y, int batch,
                           int seq, int heads, int p, int chunk, int dtype,
                           void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || p <= 0 || p > MAX_P ||
      chunk <= 0 || chunk > MAX_C ||
      static_cast<int64_t>(batch) * heads > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Params prm;
  prm.r = r; prm.k = k; prm.v = v; prm.lw = lw;
  prm.u = static_cast<const float*>(u);
  prm.y = y;
  prm.seq = seq; prm.heads = heads; prm.p = p; prm.chunk = chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch<float>(prm, batch, s));
    case 1: return static_cast<int>(launch<__nv_bfloat16>(prm, batch, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
