// Fused RMSNorm for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * g,
// and its vector-Jacobian product (rmsnorm_bwd_launch, below the forward).
//
// Replaces repro/kernels/rmsnorm/kernel.py::_rmsnorm_kernel (the Pallas TPU
// kernel launched by rmsnorm_kernel). Same arithmetic: the row is read in
// its storage type, squared and summed in f32, scaled in f32, and written
// back in the storage type.
//
// Bound: memory. A call reads N*D + D elements and writes N*D, so it moves
// (2*N*D + D) * itemsize bytes; at the main path's [2048, 4096] f16 that is
// about 33.6 MB, or 10 us at the H100 SXM's 3.35 TB/s. Its 5*N*D flops are
// nothing beside that. The design therefore only has to keep the loads
// wide and coalesced: 16-byte vector loads where the pointers and D allow
// them (neighbouring threads on neighbouring 16-byte words), a scalar path
// otherwise. The second pass over the row re-reads it from L1/L2, which
// the byte count above does not charge.
//
// The TPU kernel walks a sequential grid of 256-row blocks. Hopper blocks
// run in no order, so here every row is an independent block: one block
// of up to 1024 threads per row, and one warp per row when D is small (the
// block is sized to D and never smaller than a warp). Nothing is carried
// between blocks. The row sum is a warp-shuffle reduction followed by one
// across warps through shared memory.
//
// The kernel allocates nothing: it writes through the `out` pointer it is
// given (on the main path, a typed view of the runtime's HBM arena) and
// launches on the caller's stream. The C entry point returns
// cudaGetLastError() so that the Python wrapper can raise on a refused
// launch.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// Sum of v over the block; every thread gets the total.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float partial[32];
  __shared__ float total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = lane < n_warps ? partial[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) total = s;
  }
  __syncthreads();
  return total;
}

// 16 bytes of T: one vector load or store.
template <typename T> struct alignas(16) Pack {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

template <typename T, bool VEC>
__global__ void rmsnorm_rows(const T* __restrict__ x, const T* __restrict__ g,
                             T* __restrict__ out, int d, int64_t x_stride,
                             int64_t out_stride, float eps) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * x_stride;
  T* yr = out + row * out_stride;
  float ss = 0.f;
  if (VEC) {
    constexpr int N = Pack<T>::N;
    const Pack<T>* xv = reinterpret_cast<const Pack<T>*>(xr);
    const int n_vec = d / N;
    for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
      const Pack<T> p = xv[i];
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float f = to_f32(p.v[k]);
        ss += f * f;
      }
    }
    const float r = rsqrtf(block_sum(ss) / d + eps);
    const Pack<T>* gv = reinterpret_cast<const Pack<T>*>(g);
    Pack<T>* yv = reinterpret_cast<Pack<T>*>(yr);
    for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
      const Pack<T> p = xv[i];
      const Pack<T> q = gv[i];
      Pack<T> o;
#pragma unroll
      for (int k = 0; k < N; ++k)
        o.v[k] = from_f32<T>(to_f32(p.v[k]) * r * to_f32(q.v[k]));
      yv[i] = o;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float f = to_f32(xr[i]);
      ss += f * f;
    }
    const float r = rsqrtf(block_sum(ss) / d + eps);
    for (int i = threadIdx.x; i < d; i += blockDim.x)
      yr[i] = from_f32<T>(to_f32(xr[i]) * r * to_f32(g[i]));
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* g, void* out, int64_t n_rows,
                   int d, int64_t x_stride, int64_t out_stride, float eps,
                   cudaStream_t stream) {
  constexpr int N = Pack<T>::N;
  const bool vec = d % N == 0 && x_stride % N == 0 && out_stride % N == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int items = vec ? d / N : d;           // work items per row
  int threads = ((items + 31) / 32) * 32;      // one item per thread if it fits
  if (threads < 32) threads = 32;
  if (threads > 1024) threads = 1024;
  const dim3 grid(static_cast<unsigned>(n_rows));
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(g);
  T* op = static_cast<T*>(out);
  if (vec)
    rmsnorm_rows<T, true><<<grid, threads, 0, stream>>>(xp, gp, op, d, x_stride,
                                                        out_stride, eps);
  else
    rmsnorm_rows<T, false><<<grid, threads, 0, stream>>>(xp, gp, op, d, x_stride,
                                                         out_stride, eps);
  return cudaGetLastError();
}

// --------------------------------------------------------------------------
// Backward: the exact VJP. No TPU kernel computes it (the reference trains
// through XLA's derivative of its plain rmsnorm); it exists because the
// port's forward is this file's kernel, which autograd cannot see through.
//
//   r  = rsqrt(mean(x^2) + eps), recomputed from x (the forward saves none)
//   dx = r (dy g) - x (r^3 / D) sum(dy g x)     f32, one rounding to x's type
//   dg = sum over rows of dy x r                 only when g needs a gradient
//
// Bound: memory, as the forward: x and dy read, dx written, (3 N D + D)
// elements; at llama-7b's training shape [16384, 4096] bf16 about 403 MB,
// 0.12 ms at 3.35 TB/s. Each block walks rows blockIdx.x, + gridDim.x, ...:
// two block sums a row (sum x^2 and sum dy g x) over the same vector loads
// as the forward, then the row is read again (from L1/L2) to write dx. With
// dg, each thread adds dy x r of the columns it owns into an f32 row of
// shared memory, the block writes that row to its slot of an f32 workspace
// [n_parts, D] the wrapper allocates, and a second launch sums the n_parts
// rows of each column in a fixed order: no atomics, so dg is the same every
// run for a given n_parts.
// --------------------------------------------------------------------------
template <typename T, bool VEC, bool DG>
__global__ void rmsnorm_bwd_rows(const T* __restrict__ x, const T* __restrict__ g,
                                 const T* __restrict__ dy, T* __restrict__ dx,
                                 float* __restrict__ dg_part, int64_t n_rows,
                                 int d, int64_t x_stride, int64_t dy_stride,
                                 int64_t dx_stride, float eps) {
  extern __shared__ float acc[];   // [d] column sums of dy x r (DG only)
  if (DG) {
    for (int i = threadIdx.x; i < d; i += blockDim.x) acc[i] = 0.f;
    __syncthreads();
  }
  constexpr int N = Pack<T>::N;
  for (int64_t row = blockIdx.x; row < n_rows; row += gridDim.x) {
    const T* xr = x + row * x_stride;
    const T* dyr = dy + row * dy_stride;
    T* dxr = dx + row * dx_stride;
    float ss = 0.f, sd = 0.f;
    if (VEC) {
      const Pack<T>* xv = reinterpret_cast<const Pack<T>*>(xr);
      const Pack<T>* dv = reinterpret_cast<const Pack<T>*>(dyr);
      const Pack<T>* gv = reinterpret_cast<const Pack<T>*>(g);
      for (int i = threadIdx.x; i < d / N; i += blockDim.x) {
        const Pack<T> p = xv[i], q = dv[i], w = gv[i];
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float f = to_f32(p.v[k]);
          ss += f * f;
          sd += to_f32(q.v[k]) * to_f32(w.v[k]) * f;
        }
      }
    } else {
      for (int i = threadIdx.x; i < d; i += blockDim.x) {
        const float f = to_f32(xr[i]);
        ss += f * f;
        sd += to_f32(dyr[i]) * to_f32(g[i]) * f;
      }
    }
    ss = block_sum(ss);
    sd = block_sum(sd);
    const float r = rsqrtf(ss / d + eps);
    const float c = r * r * r / d * sd;
    if (VEC) {
      const Pack<T>* xv = reinterpret_cast<const Pack<T>*>(xr);
      const Pack<T>* dv = reinterpret_cast<const Pack<T>*>(dyr);
      const Pack<T>* gv = reinterpret_cast<const Pack<T>*>(g);
      Pack<T>* ov = reinterpret_cast<Pack<T>*>(dxr);
      for (int i = threadIdx.x; i < d / N; i += blockDim.x) {
        const Pack<T> p = xv[i], q = dv[i], w = gv[i];
        Pack<T> o;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float f = to_f32(p.v[k]), e = to_f32(q.v[k]);
          o.v[k] = from_f32<T>(r * (e * to_f32(w.v[k])) - f * c);
          if (DG) acc[i * N + k] += e * f * r;
        }
        ov[i] = o;
      }
    } else {
      for (int i = threadIdx.x; i < d; i += blockDim.x) {
        const float f = to_f32(xr[i]), e = to_f32(dyr[i]);
        dxr[i] = from_f32<T>(r * (e * to_f32(g[i])) - f * c);
        if (DG) acc[i] += e * f * r;
      }
    }
  }
  if (DG) {
    __syncthreads();
    float* part = dg_part + static_cast<int64_t>(blockIdx.x) * d;
    for (int i = threadIdx.x; i < d; i += blockDim.x) part[i] = acc[i];
  }
}

// dg[col] = sum over the n_parts workspace rows, in order
template <typename T>
__global__ void rmsnorm_dg_reduce(const float* __restrict__ part, int n_parts,
                                  int d, T* __restrict__ dg) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= d) return;
  float s = 0.f;
  for (int p = 0; p < n_parts; ++p) s += part[static_cast<int64_t>(p) * d + col];
  dg[col] = from_f32<T>(s);
}

template <typename T, bool VEC, bool DG>
cudaError_t launch_bwd_rows(const T* x, const T* g, const T* dy, T* dx,
                            float* part, int64_t n_rows, int d, int64_t xs,
                            int64_t dys, int64_t dxs, float eps, int threads,
                            unsigned grid, cudaStream_t stream) {
  const size_t smem = DG ? static_cast<size_t>(d) * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rmsnorm_bwd_rows<T, VEC, DG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  rmsnorm_bwd_rows<T, VEC, DG><<<grid, threads, smem, stream>>>(
      x, g, dy, dx, part, n_rows, d, xs, dys, dxs, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* g, const void* dy, void* dx,
                       float* part, void* dg, int n_parts, int64_t n_rows,
                       int d, int64_t xs, int64_t dys, int64_t dxs, float eps,
                       cudaStream_t stream) {
  constexpr int N = Pack<T>::N;
  const bool vec = d % N == 0 && xs % N == 0 && dys % N == 0 &&
                   dxs % N == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  const int items = vec ? d / N : d;
  int threads = ((items + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  if (threads > 1024) threads = 1024;
  const bool with_dg = dg != nullptr;
  const unsigned grid = static_cast<unsigned>(with_dg ? n_parts : n_rows);
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(g);
  const T* dyp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  cudaError_t e;
  if (vec && with_dg)
    e = launch_bwd_rows<T, true, true>(xp, gp, dyp, dxp, part, n_rows, d, xs,
                                       dys, dxs, eps, threads, grid, stream);
  else if (vec)
    e = launch_bwd_rows<T, true, false>(xp, gp, dyp, dxp, part, n_rows, d, xs,
                                        dys, dxs, eps, threads, grid, stream);
  else if (with_dg)
    e = launch_bwd_rows<T, false, true>(xp, gp, dyp, dxp, part, n_rows, d, xs,
                                        dys, dxs, eps, threads, grid, stream);
  else
    e = launch_bwd_rows<T, false, false>(xp, gp, dyp, dxp, part, n_rows, d,
                                         xs, dys, dxs, eps, threads, grid,
                                         stream);
  if (e != cudaSuccess || !with_dg) return e;
  rmsnorm_dg_reduce<T><<<(d + 255) / 256, 256, 0, stream>>>(
      part, n_parts, d, static_cast<T*>(dg));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. Strides are in elements;
// the last dimension is contiguous. Returns a cudaError_t (0 = launched).
extern "C" int rmsnorm_launch(const void* x, const void* g, void* out,
                              int64_t n_rows, int d, int64_t x_stride,
                              int64_t out_stride, float eps, int dtype,
                              void* stream) {
  if (n_rows <= 0 || n_rows > 0x7fffffffLL || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          launch<float>(x, g, out, n_rows, d, x_stride, out_stride, eps, s));
    case 1:
      return static_cast<int>(
          launch<__half>(x, g, out, n_rows, d, x_stride, out_stride, eps, s));
    case 2:
      return static_cast<int>(launch<__nv_bfloat16>(x, g, out, n_rows, d, x_stride,
                                                    out_stride, eps, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The VJP of rmsnorm_launch: dx [n_rows, d] from x and dy (row strides in
// elements, last dimension contiguous), and, when dg is not null, dg [d] in
// g's type through `dg_part`, an f32 workspace of n_parts x d (1 <= n_parts
// <= n_rows: the number of row blocks, each writing one row). dtype as
// rmsnorm_launch. Returns a cudaError_t (0 = launched).
extern "C" int rmsnorm_bwd_launch(const void* x, const void* g, const void* dy,
                                  void* dx, void* dg_part, void* dg,
                                  int n_parts, int64_t n_rows, int d,
                                  int64_t x_stride, int64_t dy_stride,
                                  int64_t dx_stride, float eps, int dtype,
                                  void* stream) {
  if (n_rows <= 0 || n_rows > 0x7fffffffLL || d <= 0 ||
      (dg != nullptr && (dg_part == nullptr || n_parts <= 0 ||
                         n_parts > n_rows)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(dg_part);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_bwd<float>(x, g, dy, dx, part, dg,
                                                n_parts, n_rows, d, x_stride,
                                                dy_stride, dx_stride, eps, s));
    case 1:
      return static_cast<int>(launch_bwd<__half>(x, g, dy, dx, part, dg,
                                                 n_parts, n_rows, d, x_stride,
                                                 dy_stride, dx_stride, eps, s));
    case 2:
      return static_cast<int>(launch_bwd<__nv_bfloat16>(
          x, g, dy, dx, part, dg, n_parts, n_rows, d, x_stride, dy_stride,
          dx_stride, eps, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
