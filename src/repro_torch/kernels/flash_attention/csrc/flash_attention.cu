// Flash attention (forward) for Hopper (sm_90a): GQA, causal or bidirectional.
//
// Replaces repro/kernels/flash_attention/kernel.py::_attn_kernel (the Pallas
// TPU kernel launched by flash_attention_kernel). Same arithmetic: scores
// q.k^T in f32 times 1/sqrt(Dh); KV positions at or past `skv`, and (causal)
// past the query's absolute position q + q_offset, are set to -1e30 (not
// -inf); an online softmax over KV tiles keeps the running max, the running
// sum and the output accumulator in f32; the result is acc / max(l, 1e-30),
// written in the input type.
//
// Bound: at the serving prefill's shape (B=8, H=32, S=768, Dh=128, causal,
// bf16) the call needs 3.87e10 operations (0.039 ms at 989 TFLOP/s) and moves
// 201 MB (0.060 ms at 3.35 TB/s): on paper it sits at the ridge. This kernel
// does not get near either. It is the simple design the port starts from:
// scalar f32 FMAs over shared-memory tiles, no tensor cores (mma.sync or
// wgmma) and no TMA; each FMA costs about one shared-memory load, so the
// kernel is bound by shared-memory bandwidth, far above both bounds. A
// tensor-core redesign is later work.
//
// Design. The TPU grid (b, h, q-block, kv-block) runs in order with the KV
// axis innermost and carries (m, l, acc) in VMEM scratch from one step to the
// next. Hopper blocks run in parallel in no order, so here one thread block
// owns one (b, query head, 64-row q tile) and loops over the KV tiles itself:
//   * 256 threads, 4 per query row. Thread (r, c) holds the row's running
//     max and sum and the accumulator columns c, c+4, ... (Dh/4 floats) in
//     registers, and computes the tile's scores of columns c, c+4, ... .
//   * Q is staged once, K and V per 32-row tile, all converted to f32 in
//     shared memory. Q and K rows are padded by one float so that the four
//     threads of a row and the eight rows of a warp hit distinct banks.
//   * The row max and sum are reduced over the row's 4 lanes with shuffles;
//     the probabilities go through shared memory to the same 4 threads (one
//     __syncwarp, no block barrier) for the P.V product.
//   * GQA: query head h reads KV head h / (Hq / Hkv).
//   * Tiles wholly past `skv`, or wholly past the causal edge of the q tile,
//     are skipped. With q_offset >= 0, KV position 0 is never masked for a
//     causal row, so every row has a real maximum after the first tile and
//     the masked entries of later tiles contribute exp(-1e30 - m) = 0: the
//     result is the TPU kernel's.
//   * q, k, v are read, and o written, through the (batch, seq, head)
//     strides given, with the head dimension contiguous: the [B, S, H, Dh]
//     projections need no transpose and the ragged edges no padding copy.
//
// The kernel allocates nothing and launches on the caller's stream. The C
// entry point returns cudaGetLastError() so that the Python wrapper can raise
// on a refused launch.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 32;              // KV rows per tile
constexpr int THREADS = 256;
constexpr int TPR = THREADS / BQ;   // threads per query row
constexpr int PSTRIDE = BK + 4;     // probability row stride (bank spread)
constexpr float NEG_INF = -1e30f;

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

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // strides in elements of (batch, seq, head); the head dimension is contiguous
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int sq, skv, group, q_offset, causal;
  float scale;
};

template <int DH>
constexpr int smem_floats() {
  return BQ * (DH + 1) + BK * (DH + 1) + BK * DH + BQ * PSTRIDE;
}

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
        qi < p.sq ? to_f32(qg[static_cast<int64_t>(qi) * p.q_ss + d]) : 0.f;
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
          ok ? to_f32(kg[static_cast<int64_t>(kj) * p.k_ss + d]) : 0.f;
      vs[row * DH + d] =
          ok ? to_f32(vg[static_cast<int64_t>(kj) * p.v_ss + d]) : 0.f;
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
    T* og = static_cast<T*>(p.o) + b * p.o_sb + static_cast<int64_t>(qi) * p.o_ss +
            h * p.o_sh;
#pragma unroll
    for (int j = 0; j < ND; ++j) og[c + TPR * j] = from_f32<T>(acc[j] / den);
  }
}

template <typename T, int DH>
cudaError_t launch(const Params& p, int batch, int hq, cudaStream_t stream) {
  constexpr int bytes = smem_floats<DH>() * static_cast<int>(sizeof(float));
  // above 48 KB a block's shared memory must be opted into, once per kernel
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_fwd<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.sq + BQ - 1) / BQ, hq, batch);
  attn_fwd<T, DH><<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const Params& p, int batch, int hq, int dh,
                      cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<T, 32>(p, batch, hq, stream);
    case 64: return launch<T, 64>(p, batch, hq, stream);
    case 112: return launch<T, 112>(p, batch, hq, stream);   // zamba2-7b
    case 128: return launch<T, 128>(p, batch, hq, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, Sq, Hq, Dh], k/v [B, Skv, Hkv, Dh], o [B, Sq, Hq, Dh]; each given by
// its pointer and (batch, seq, head) strides in elements, the last dimension
// contiguous. dtype: 0 = float32, 1 = float16, 2 = bfloat16. Dh is 32, 64,
// 112 or 128. Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int batch, int sq, int skv, int hq, int hkv, int dh, int q_offset,
    int causal, int dtype, void* stream) {
  if (batch <= 0 || batch > 65535 || sq <= 0 || skv <= 0 || hq <= 0 ||
      hq > 65535 || hkv <= 0 || hq % hkv != 0 || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.sq = sq; p.skv = skv; p.group = hq / hkv; p.q_offset = q_offset;
  p.causal = causal ? 1 : 0;
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(dh)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(launch_dh<float>(p, batch, hq, dh, s));
    case 1: return static_cast<int>(launch_dh<__half>(p, batch, hq, dh, s));
    case 2: return static_cast<int>(launch_dh<__nv_bfloat16>(p, batch, hq, dh, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
