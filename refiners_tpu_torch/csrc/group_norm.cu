// Fused GroupNorm (+SiLU) over contiguous NCHW tensors, for Hopper (sm_90a):
// two kernels, statistics (K5a) and apply (K5b).
//
// Replaces the TPU kernels of refiners_tpu/ops/group_norm.py: `_stats_kernel`
// (per-channel sums of x and x^2 over sequential spatial blocks, with the
// group fold done in XLA) and `_apply_kernel` (y = x * scale + shift, then
// an optional SiLU), both reached through `_gn_silu_forward` (entry
// `group_norm_silu`). The TPU kernel keeps channels in lanes because its
// input is channels-last; the port is NCHW, so group g of sample b is one
// contiguous run of (C / G) * H * W elements, a "slab", and no fold over
// channels is needed.
//
// K5a: grid (chunks, B * G). Block (c, s) reads chunk c of slab s
// (chunk_len elements, the last one ragged) with 16-byte loads and writes the
// float32 pair (sum(x - p), sum((x - p)^2)) to partials[s][c], where p is the
// slab's first element. The JAX kernel's single-pass E[x^2] - E[x]^2
// cancels when |mean| >> std; shifted by a sample of the slab, the sums keep
// the mean of the order of the spread, and each thread first adds the 4 or 8
// elements of one vector, then at most 8 vectors, before the block's tree:
// float32 accuracy against the two-pass reference.
//
// K5b: same grid. Each block merges its slab's partials in a fixed order
// (so every block of a slab gets the same statistics), computes
// mean = p + S1 / n and var = S2 / n - (S1 / n)^2, and folds them with the
// affine into per-channel float32 scale = w * rstd and shift = b - mean *
// scale in shared memory (the fold the JAX package does in XLA between its
// two kernels). Then it writes y = x * scale + shift, with SiLU as a
// compile-time switch, cast to x's type with 16-byte stores. A fused
// GroupNorm + SiLU is exactly these two launches.
//
// What bounds it on the H100: memory. K5a reads x once; K5b reads x once and
// writes y once (the partials, weight and bias are a few KB). At a bf16
// UNet site of (2, 960, 128, 128), 63 MB through K5a is 19 us at 3.35 TB/s
// and 126 MB through K5b 38 us. The design's answers: enough blocks to fill
// 132 SMs even where slabs are few (64 in the UNet's 320-channel level, 32
// in the VAE), vector loads and stores, and no third pass over x. Unaligned
// chunk starts (a slab of 90 elements) and ragged tails go through scalar
// head and tail loops; where x and y sit at different offsets from a 16-byte
// boundary (x a view that starts mid-vector), K5b's chunk is all scalar.
//
// Types: bfloat16, float16 and float32 in; float32 arithmetic; weight and
// bias in any of the three (their own code). Compiled without fast math:
// expf and the divisions are IEEE.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVectorsPerThread = 8;
constexpr int kMaxChannelsPerGroup = 4096;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }
template <>
__device__ __forceinline__ __half from_float<__half>(float v) { return __float2half_rn(v); }

// a weight or bias element in its own type (0 bf16, 1 f16, 2 f32)
__device__ __forceinline__ float load_param(const void* p, int dtype, int i) {
  if (dtype == 0) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (dtype == 1) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

// The part of a chunk before its first 16-byte boundary, in elements.
template <typename T>
__device__ __forceinline__ int head_len(const T* p, int len) {
  const int head = int(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / sizeof(T));
  return head < len ? head : len;
}

// Sum of (a, b) over the block; the result is valid in thread 0.
__device__ __forceinline__ float2 block_sum(float a, float b) {
  __shared__ float2 warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_sums[warp] = make_float2(a, b);
  __syncthreads();
  float2 total = make_float2(0.f, 0.f);
  if (warp == 0) {
    float2 v = lane < kThreads / 32 ? warp_sums[lane] : make_float2(0.f, 0.f);
    for (int off = 4; off > 0; off >>= 1) {
      v.x += __shfl_down_sync(0xffffffffu, v.x, off);
      v.y += __shfl_down_sync(0xffffffffu, v.y, off);
    }
    total = v;
  }
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gn_stats_kernel(const T* __restrict__ x, float2* __restrict__ partials, long long group_len, int chunk_len,
                    int num_chunks) {
  constexpr int kPerVec = 16 / sizeof(T);
  const int chunk = blockIdx.x;
  const long long slab = blockIdx.y;
  const T* slab_ptr = x + slab * group_len;
  const float pivot = to_float(slab_ptr[0]);
  const long long begin = (long long)chunk * chunk_len;
  const int len = int(min((long long)chunk_len, group_len - begin));
  const T* p = slab_ptr + begin;
  const int head = head_len(p, len);
  const int vecs = (len - head) / kPerVec;

  float s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < head; i += kThreads) {
    const float d = to_float(p[i]) - pivot;
    s1 += d;
    s2 = fmaf(d, d, s2);
  }
  const uint4* pv = reinterpret_cast<const uint4*>(p + head);
  for (int i = threadIdx.x; i < vecs; i += kThreads) {
    const uint4 raw = pv[i];
    T e[kPerVec];
    memcpy(e, &raw, 16);
    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int j = 0; j < kPerVec; ++j) {
      const float d = to_float(e[j]) - pivot;
      a1 += d;
      a2 = fmaf(d, d, a2);
    }
    s1 += a1;
    s2 += a2;
  }
  for (int i = head + vecs * kPerVec + threadIdx.x; i < len; i += kThreads) {
    const float d = to_float(p[i]) - pivot;
    s1 += d;
    s2 = fmaf(d, d, s2);
  }
  const float2 total = block_sum(s1, s2);
  if (threadIdx.x == 0) partials[slab * num_chunks + chunk] = total;
}

template <bool kSilu>
__device__ __forceinline__ float activate(float y) {
  if (kSilu) return y / (1.f + expf(-y));
  return y;
}

template <typename T, bool kSilu>
__global__ void __launch_bounds__(kThreads)
    gn_apply_kernel(const T* __restrict__ x, T* __restrict__ y, const float2* __restrict__ partials,
                    const void* __restrict__ weight, const void* __restrict__ bias, int param_dtype, int num_groups,
                    long long group_len, long long spatial, int channels_per_group, int chunk_len, int num_chunks,
                    float eps) {
  constexpr int kPerVec = 16 / sizeof(T);
  extern __shared__ float table[];  // scale[channels_per_group], shift[channels_per_group]
  __shared__ float stats[2];
  const int chunk = blockIdx.x;
  const long long slab = blockIdx.y;
  const int group = int(slab % num_groups);
  const T* slab_ptr = x + slab * group_len;

  if (threadIdx.x < 32) {
    float s1 = 0.f, s2 = 0.f;
    for (int i = threadIdx.x; i < num_chunks; i += 32) {
      const float2 v = partials[slab * num_chunks + i];
      s1 += v.x;
      s2 += v.y;
    }
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_down_sync(0xffffffffu, s1, off);
      s2 += __shfl_down_sync(0xffffffffu, s2, off);
    }
    if (threadIdx.x == 0) {
      const float n = float(group_len);
      const float m1 = s1 / n;
      const float var = fmaxf(s2 / n - m1 * m1, 0.f);
      stats[0] = to_float(slab_ptr[0]) + m1;
      stats[1] = 1.f / sqrtf(var + eps);
    }
  }
  __syncthreads();
  const float mean = stats[0], rstd = stats[1];
  for (int j = threadIdx.x; j < channels_per_group; j += kThreads) {
    const int c = group * channels_per_group + j;
    const float scale = load_param(weight, param_dtype, c) * rstd;
    table[j] = scale;
    table[channels_per_group + j] = load_param(bias, param_dtype, c) - mean * scale;
  }
  __syncthreads();
  const float* scale = table;
  const float* shift = table + channels_per_group;

  const long long begin = (long long)chunk * chunk_len;
  const int len = int(min((long long)chunk_len, group_len - begin));
  const T* p = slab_ptr + begin;
  T* q = y + slab * group_len + begin;
  // x and y meet a 16-byte boundary at the same element, or the whole chunk goes scalar
  const bool same_phase = ((reinterpret_cast<uintptr_t>(p) ^ reinterpret_cast<uintptr_t>(q)) & 15) == 0;
  const int head = same_phase ? head_len(p, len) : len;
  const int vecs = (len - head) / kPerVec;

  // element e of the slab belongs to channel e / spatial of the group
  for (int i = threadIdx.x; i < head; i += kThreads) {
    const int ch = int((begin + i) / spatial);
    q[i] = from_float<T>(activate<kSilu>(fmaf(to_float(p[i]), scale[ch], shift[ch])));
  }
  const uint4* pv = reinterpret_cast<const uint4*>(p + head);
  uint4* qv = reinterpret_cast<uint4*>(q + head);
  for (int i = threadIdx.x; i < vecs; i += kThreads) {
    const long long e0 = begin + head + (long long)i * kPerVec;
    int ch = int(e0 / spatial);
    long long r = e0 - (long long)ch * spatial;
    const uint4 raw = pv[i];
    T in[kPerVec], out[kPerVec];
    memcpy(in, &raw, 16);
#pragma unroll
    for (int j = 0; j < kPerVec; ++j) {
      while (r >= spatial) {
        r -= spatial;
        ++ch;
      }
      out[j] = from_float<T>(activate<kSilu>(fmaf(to_float(in[j]), scale[ch], shift[ch])));
      ++r;
    }
    uint4 packed;
    memcpy(&packed, out, 16);
    qv[i] = packed;
  }
  for (int i = head + vecs * kPerVec + threadIdx.x; i < len; i += kThreads) {
    const int ch = int((begin + i) / spatial);
    q[i] = from_float<T>(activate<kSilu>(fmaf(to_float(p[i]), scale[ch], shift[ch])));
  }
}

bool valid(long long num_slabs, long long group_len, int chunk_len, int num_chunks) {
  return num_slabs > 0 && num_slabs <= 65535 && group_len > 0 && chunk_len > 0 && chunk_len % 8 == 0 &&
         num_chunks > 0 && (long long)num_chunks * chunk_len >= group_len &&
         (long long)(num_chunks - 1) * chunk_len < group_len;
}

template <typename T>
int launch_stats(const void* x, float* partials, long long num_slabs, long long group_len, int chunk_len,
                 int num_chunks, cudaStream_t stream) {
  const dim3 grid(num_chunks, unsigned(num_slabs));
  gn_stats_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), reinterpret_cast<float2*>(partials),
                                                     group_len, chunk_len, num_chunks);
  return int(cudaGetLastError());
}

template <typename T>
int launch_apply(const void* x, void* y, const float* partials, const void* weight, const void* bias, int param_dtype,
                 long long num_slabs, int num_groups, long long group_len, long long spatial,
                 int channels_per_group, int chunk_len, int num_chunks, float eps, int silu, cudaStream_t stream) {
  const dim3 grid(num_chunks, unsigned(num_slabs));
  const size_t smem = 2 * sizeof(float) * channels_per_group;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const float2* pt = reinterpret_cast<const float2*>(partials);
  if (silu) {
    gn_apply_kernel<T, true><<<grid, kThreads, smem, stream>>>(xt, yt, pt, weight, bias, param_dtype, num_groups,
                                                                group_len, spatial, channels_per_group, chunk_len,
                                                                num_chunks, eps);
  } else {
    gn_apply_kernel<T, false><<<grid, kThreads, smem, stream>>>(xt, yt, pt, weight, bias, param_dtype, num_groups,
                                                                 group_len, spatial, channels_per_group, chunk_len,
                                                                 num_chunks, eps);
  }
  return int(cudaGetLastError());
}

}  // namespace

// K5a. x: contiguous (num_slabs, group_len) in `dtype` (0 bf16, 1 f16, 2 f32);
// partials: (num_slabs, num_chunks) float2, num_chunks = ceil(group_len /
// chunk_len). Returns a cudaError_t.
extern "C" int refiners_group_norm_stats(const void* x, float* partials, int dtype, long long num_slabs,
                                         long long group_len, int chunk_len, int num_chunks, void* stream) {
  if (x == nullptr || partials == nullptr || !valid(num_slabs, group_len, chunk_len, num_chunks)) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_stats<__nv_bfloat16>(x, partials, num_slabs, group_len, chunk_len, num_chunks, s);
    case 1: return launch_stats<__half>(x, partials, num_slabs, group_len, chunk_len, num_chunks, s);
    case 2: return launch_stats<float>(x, partials, num_slabs, group_len, chunk_len, num_chunks, s);
    default: return int(cudaErrorInvalidValue);
  }
}

// K5b. y = GroupNorm(x) (+ SiLU) from K5a's partials; weight and bias
// (num_groups * channels_per_group,) in `param_dtype`; spatial = group_len /
// channels_per_group. Returns a cudaError_t.
extern "C" int refiners_group_norm_apply(const void* x, void* y, const float* partials, const void* weight,
                                         const void* bias, int dtype, int param_dtype, long long num_slabs,
                                         int num_groups, long long group_len, long long spatial,
                                         int channels_per_group, int chunk_len, int num_chunks, float eps, int silu,
                                         void* stream) {
  if (x == nullptr || y == nullptr || partials == nullptr || weight == nullptr || bias == nullptr ||
      !valid(num_slabs, group_len, chunk_len, num_chunks) || num_groups <= 0 || num_slabs % num_groups != 0 ||
      channels_per_group <= 0 || channels_per_group > kMaxChannelsPerGroup || spatial <= 0 ||
      spatial * channels_per_group != group_len || param_dtype < 0 || param_dtype > 2) {
    return int(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_apply<__nv_bfloat16>(x, y, partials, weight, bias, param_dtype, num_slabs, num_groups, group_len,
                                         spatial, channels_per_group, chunk_len, num_chunks, eps, silu, s);
    case 1:
      return launch_apply<__half>(x, y, partials, weight, bias, param_dtype, num_slabs, num_groups, group_len,
                                  spatial, channels_per_group, chunk_len, num_chunks, eps, silu, s);
    case 2:
      return launch_apply<float>(x, y, partials, weight, bias, param_dtype, num_slabs, num_groups, group_len, spatial,
                                 channels_per_group, chunk_len, num_chunks, eps, silu, s);
    default: return int(cudaErrorInvalidValue);
  }
}
