// The 16-bit tile helpers that the flash-attention forward
// (flash_attention.cu) and backward (flash_attention_bwd.cu) share: the
// swizzled tile layout and its element-load staging, the score products
// and the products with a register operand, the split of a bf16 operand
// into hi + lo, paired stores, and the tensor maps of a [B, S, H, Dh] view.
//
// Internal linkage, as hopper.cuh: each library holds its own copy, and its
// build digest covers this header (kernels/build.py).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../common/hopper.cuh"   // mbarriers, TMA, wgmma

namespace {

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T> __device__ __forceinline__ uint32_t pack2(float a, float b);
template <> __device__ __forceinline__ uint32_t pack2<__half>(float a, float b) {
  const __half2 h = __floats2half2_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// a bf16 operand as hi + lo: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

template <typename T> __device__ __forceinline__ void store2(T* p, float a,
                                                             float b);
template <> __device__ __forceinline__ void store2<__half>(__half* p, float a,
                                                           float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(
    __nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// a register operand in bf16 is issued as hi + lo, two products; in f16 once
template <typename T> constexpr bool kSplitP = false;
template <> constexpr bool kSplitP<__nv_bfloat16> = true;

// The layout tiles are staged in, TMA's 128-byte swizzle: a tile of R rows
// is cut into NH = ceil(Dh / 64) column halves of 64 channels, each R rows
// of 128 bytes; 16-byte chunk j of row r sits at chunk j ^ (r % 8) of its
// row. Channels past Dh are zeros.
template <int DH> constexpr int kHalves = (DH + 63) / 64;

// Element-load staging of rows [row0, row0 + ROWS) of a [rows, DH] view
// (row stride `rs` elements; rows at or past `limit` as zeros) into that
// layout, by the 32 lanes of one warp: for views whose pointers or strides
// are not 16-byte aligned, which TMA cannot take.
template <typename T, int ROWS, int DH>
__device__ __forceinline__ void stage_elements(unsigned char* dst,
                                               const T* src, int64_t rs,
                                               int row0, int limit, int lane) {
  for (int i = lane; i < kHalves<DH> * ROWS * 8; i += 32) {
    const int j = i % 8, r = (i / 8) % ROWS, half = i / (8 * ROWS);
    const int col = 64 * half + 8 * j, row = row0 + r;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (row < limit && col < DH) {
      const uint16_t* e = reinterpret_cast<const uint16_t*>(
          src + static_cast<int64_t>(row) * rs + col);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = static_cast<uint32_t>(e[2 * k])
             | (static_cast<uint32_t>(e[2 * k + 1]) << 16);
    }
    *reinterpret_cast<uint4*>(dst + half * ROWS * 128 + r * 128 +
                              ((j ^ (r & 7)) << 4)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// A 64 x 64 f32 accumulator tile (s[4j + 2i + e] is row 16 (warp % 4) +
// lane / 4 + 8i, column 8j + 2 (lane % 4) + e) as the A fragments of the
// four k-steps of a product over its 64 columns: register 4kk + r holds the
// pair (row + 8 (r & 1), columns 16kk + 8 (r >> 1) + 2 (lane % 4) + {0, 1}),
// which is s[4 (2kk + (r >> 1)) + 2 (r & 1) + {0, 1}]. bf16: hi in ph, lo in
// pl; f16: once, in ph.
template <typename T>
__device__ __forceinline__ void a_fragments(const float (&s)[32],
                                            uint32_t (&ph)[16],
                                            uint32_t (&pl)[16]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int at = 4 * (2 * kk + (r >> 1)) + 2 * (r & 1);
      if constexpr (kSplitP<T>) {
        split_bf16(s[at], s[at + 1], ph[4 * kk + r], pl[4 * kk + r]);
      } else {
        ph[4 * kk + r] = pack2<T>(s[at], s[at + 1]);
        pl[4 * kk + r] = 0u;
      }
    }
  }
}

// D[64 x 64] = A . B^T over the head dimension: A (64 rows from `a`) and B
// (64 rows from `b`) K-major in the swizzled layout, their column halves
// A_HALF and B_HALF bytes apart; 4 k-steps of 32 bytes inside each 128-byte
// row, then the next column half; Dh / 16 steps, so the zero columns past
// Dh 112 are not multiplied.
template <typename T, int DH, int A_HALF, int B_HALF>
__device__ __forceinline__ void issue_nt(float (&d)[32], uint32_t a,
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t at = kk / 4, in = (kk % 4) * 32u;
    wgmma_ss<T>(d, smem_desc(a + at * A_HALF + in, 16, 1024),
                smem_desc(b + at * B_HALF + in, 16, 1024), kk > 0);
  }
}

// D[64 x Dh] += A . B over 64 rows of B: A from registers (a_fragments),
// B MN-major in the swizzled layout (a tile of B_ROWS rows from `b`; SBO
// steps 8 rows, LBO the next 64-channel half); 4 k-steps of 16 rows; in
// bf16 the hi and the lo product.
template <typename T, int DH, int B_ROWS>
__device__ __forceinline__ void issue_rs(float (&d)[DH / 2],
                                         const uint32_t (&ph)[16],
                                         const uint32_t (&pl)[16],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t desc = smem_desc(b + kk * 16 * 128, B_ROWS * 128, 1024);
    wgmma_rs<T, DH>(d, ph + 4 * kk, desc);
    if constexpr (kSplitP<T>) wgmma_rs<T, DH>(d, pl + 4 * kk, desc);
  }
}

// A [B, S, H, Dh] view as a 4-d tensor map (channels, rows, heads, batch),
// boxes of 64 channels x `rows` rows in the 128-byte swizzle; channels past
// Dh and rows past S read as zeros. Strides in elements, 16-byte multiples
// (a dimension of size 1 takes any).
template <typename T>
bool encode_view(CUtensorMap* map, const void* ptr, int dh, int s, int h,
                 int b, int64_t ss, int64_t sh, int64_t sb, int rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(s > 1 ? ss * 2 : 16),
      static_cast<cuuint64_t>(h > 1 ? sh * 2 : 16),
      static_cast<cuuint64_t>(b > 1 ? sb * 2 : 16)};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, kMapType<T>, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 16-bit [B, S, H, Dh] view TMA can read: 16-byte aligned, and every
// stride of a dimension longer than 1 a positive multiple of 8 elements.
bool aligned16(const void* ptr, int b, int64_t sb, int s, int64_t ss, int h,
               int64_t sh) {
  auto ok = [](int n, int64_t st) { return n == 1 || (st > 0 && st % 8 == 0); };
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && ok(b, sb) &&
         ok(s, ss) && ok(h, sh);
}

}  // namespace
