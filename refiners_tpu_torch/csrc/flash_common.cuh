// Helpers shared by the flash attention kernels (forward and backward), for
// Hopper (sm_90a): the element conversions and packing every kernel uses;
// the 4-byte cp.async of the dK/dV kernel; the head-dim instances; and, for
// the float32 kernels, shared-memory tiles multiplied with FFMA.
//
// Register fragments of a 16-row block (g = lane / 4, t = lane % 4), as the
// wgmma accumulators and register A operands of each warp lay them out:
// - A (16 x 16, row-major), 4 registers of two values: (g, 2t), (g + 8, 2t),
//   (g, 2t + 8), (g + 8, 2t + 8);
// - an accumulator of 16 x 8 (float32), 4 values: (g, 2t), (g, 2t + 1),
//   (g + 8, 2t), (g + 8, 2t + 1).
// So the accumulators of two neighbouring 16 x 8 tiles are, packed two by
// two, the A fragment of their 16 x 16 block: a product's result feeds the
// next product from registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace flash {

constexpr int kTile = 64;  // rows per tile: 64 per warpgroup, and keys per inner step
constexpr float kMaskedScore = -1e30f;

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

// 4-byte copy; src-size 0 writes zeros
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(hopper::smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

// two floats → one register of two T, `lo` in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

// The A fragment of 16 columns of a 16-row block from the float32
// accumulators of its two 8-column tiles, lo and hi, rounded to T.
template <typename T>
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float lo[4], const float hi[4]) {
  a[0] = pack2<T>(lo[0], lo[1]);
  a[1] = pack2<T>(lo[2], lo[3]);
  a[2] = pack2<T>(hi[0], hi[1]);
  a[3] = pack2<T>(hi[2], hi[3]);
}

// head_dim rounded up to the 16-column depth of a tensor-core step
inline int pad16(int head_dim) { return (head_dim + 15) / 16 * 16; }

// The instance (padded head dim, hopper::Tile) of the wgmma kernels for
// d <= 128 that runs a head of padded width `dim_pad` (a multiple of 16 up
// to 128): 64 up to 64, then 80 and 128. A 48-column instance measured
// slower than 64 at d = 40 on the H100 (PERF.md), so there is none.
inline int narrow_template(int dim_pad) {
  if (dim_pad <= 64) return 64;
  if (dim_pad <= 80) return 80;
  return 128;
}

// Smallest compiled head-dim template that holds `dim_pad` (a multiple of 16).
inline int mma_template(int dim_pad) {
  if (dim_pad <= 48) return 48;
  if (dim_pad <= 64) return 64;
  if (dim_pad <= 80) return 80;
  if (dim_pad <= 128) return 128;
  return 0;
}

// ---------------------------------------------------------------------------
// float32: plain FMA tiles
// ---------------------------------------------------------------------------
//
// The float32 kernels keep float32 accuracy with FFMA, not tensor cores.
// 256 threads form a 16 x 16 grid (tx = tid % 16, ty = tid / 16); a thread
// owns rows ty + 16i and columns tx + 16j of a score tile of 64 columns,
// and columns tx + 16c of a rows x D accumulator. Each half-warp shares one
// ty, so a row's reductions are shuffles over 16 lanes. Tiles sit in shared
// memory with odd row pitches (D + 1, 64 + 1): the 16 rows a half-warp reads
// at one depth fall in 16 distinct banks.

constexpr int kF32Threads = 256;
constexpr int kF32ScorePitch = kTile + 1;

// Smallest compiled float32 head-dim template that holds `dim_pad`.
inline int f32_template(int dim_pad) {
  const int mma = mma_template(dim_pad);
  if (mma != 0) return mma;
  if (dim_pad <= 256) return 256;
  if (dim_pad <= 512) return 512;
  return 0;
}

// Copy rows [row0, row0 + rows) of one head into shared memory with pitch
// D + 1, 16 bytes per global read; rows past `len` and columns past `d` are
// zero.
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, long long row_stride, int row0, int rows,
                                              int len, int d) {
  constexpr int kChunks = D / 4;
  for (int c = threadIdx.x; c < rows * kChunks; c += kF32Threads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < len && col < d) val = *reinterpret_cast<const float4*>(src + (long long)(row0 + r) * row_stride + col);
    float* out = dst + r * (D + 1) + col;
    out[0] = val.x;
    out[1] = val.y;
    out[2] = val.z;
    out[3] = val.w;
  }
}

// acc[i][j] += sum over k < D of A[ty + 16i][k] * B[tx + 16j][k] (j < C): a
// tile of A B^T, A and B with pitch D + 1.
template <int D, int R, int C = 4>
__device__ __forceinline__ void mm_abt_f32(float acc[R][C], const float* a, const float* b, int tx, int ty) {
  #pragma unroll 4
  for (int k = 0; k < D; ++k) {
    float av[R], bv[C];
    #pragma unroll
    for (int i = 0; i < R; ++i) av[i] = a[(ty + 16 * i) * (D + 1) + k];
    #pragma unroll
    for (int j = 0; j < C; ++j) bv[j] = b[(tx + 16 * j) * (D + 1) + k];
    #pragma unroll
    for (int i = 0; i < R; ++i) {
      #pragma unroll
      for (int j = 0; j < C; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// acc[i][c] += sum over k < K of P[ty + 16i][k] * X[k][tx + 16c]: a tile of
// P X, P with pitch K + 1 and X (K x D) with pitch D + 1.
template <int D, int R, int K = kTile>
__device__ __forceinline__ void mm_ab_f32(float acc[R][D / 16], const float* p, const float* x, int tx, int ty) {
  #pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float pv[R];
    #pragma unroll
    for (int i = 0; i < R; ++i) pv[i] = p[(ty + 16 * i) * (K + 1) + k];
    #pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const float xv = x[k * (D + 1) + tx + 16 * c];
      #pragma unroll
      for (int i = 0; i < R; ++i) acc[i][c] = fmaf(pv[i], xv, acc[i][c]);
    }
  }
}

// max and sum over the 16 lanes of a half-warp (one row's owners)
__device__ __forceinline__ float row_max16(float x) {
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace flash
