// Flash attention forward over packed (B, L, H*D) operands, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel_packed` (with `_flash_forward_packed`)
// of refiners_tpu/ops/flash_attention.py. Same contract: per (batch, head),
// O = softmax(scale * Q K^T + mask) V with an online softmax; running max and
// sum and the output accumulator in float32; P cast to the input type before
// the PV product; output cast to the input type. Masked scores are -1e30 (not
// -inf), so a causal row with no admissible key gets uniform weights over the
// keys, as the TPU kernel does. Keys past the sequence end do not take part.
// No logsumexp is written.
//
// Head h of batch b starts at b*batch_stride + h*D with row stride row_stride
// (both in elements, given by the caller), so heads are read straight out of
// the projection layout with no split/merge-heads copies.
//
// What bounds it on the H100: at seq >= 1024 with D = 64 the kernel is bound by
// tensor-core throughput (4*L^2*D flops against 4*L*D bytes per head); at the
// VAE's D = 512 site by registers and shared memory per block, since a query
// tile's float32 accumulator (rows x 512) must live beside a K/V tile.
//
// Two kernels, picked by head_dim; both are one block of 4 warps per
// (query tile, batch*head) with a loop over K/V tiles of 64 keys:
//
// - head_dim <= 128 (the UNet's d = 64 sites): FlashAttention-2's layout on
//   mma.sync m16n8k16 tensor-core instructions. Each warp owns 16 query rows;
//   its Q fragments, S tile, softmax statistics and O accumulator stay in
//   registers, and P goes from the S accumulators straight into the A
//   operand of the PV product. K and V tiles are double-buffered in shared
//   memory with cp.async, read with ldmatrix (transposed for V).
// - head_dim up to 512 (the VAE's site): WMMA 16x16x16 fragments, with S and
//   the O accumulator in shared memory (a 32 x 512 float32 accumulator does
//   not fit in registers), the online softmax with one warp per row. Tile
//   sizes are chosen per head_dim to fit (32x64 at D = 512, about 180 KB of
//   dynamic shared memory).
//
// wgmma, TMA and warp specialization are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxBlockK = 64;
constexpr float kMaskedScore = -1e30f;
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB per block on Hopper

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int heads, head_dim, dim_pad, q_len, kv_len;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs;
  float scale;
  int causal;
  int block_q, block_k;
};

// ---------------------------------------------------------------------------
// head_dim up to 512: WMMA with shared-memory accumulators
// ---------------------------------------------------------------------------

// Byte offsets of the shared-memory sections; each starts 128-byte aligned,
// which satisfies WMMA's 32-byte pointer alignment. Row pitches are padded
// (+8 halves, +4 floats) against bank conflicts and stay valid WMMA strides.
struct Layout {
  size_t q, kv, s, p, o, m, l, alpha, total;
};

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

__host__ __device__ inline Layout make_layout(int bq, int bk, int dp) {
  Layout L;
  size_t off = 0;
  L.q = off;
  off = align128(off + size_t(bq) * (dp + 8) * 2);
  L.kv = off;
  off = align128(off + size_t(bk) * (dp + 8) * 2);
  L.s = off;
  off = align128(off + size_t(bq) * (bk + 4) * 4);
  L.p = off;
  off = align128(off + size_t(bq) * (bk + 8) * 2);
  L.o = off;
  off = align128(off + size_t(bq) * (dp + 4) * 4);
  L.m = off;
  off = align128(off + size_t(bq) * 4);
  L.l = off;
  off = align128(off + size_t(bq) * 4);
  L.alpha = off;
  off = align128(off + size_t(bq) * 4);
  L.total = off;
  return L;
}

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

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Copy rows [row0, row0 + rows) of one head into shared memory, 16 bytes per
// thread and step; rows past `len` and columns past `d` are zero.
template <typename T>
__device__ void load_tile(T* dst, int ld, const T* src, long long row_stride, int row0, int rows, int len, int d,
                          int dp) {
  const int chunks = dp / 8;
  for (int c = threadIdx.x; c < rows * chunks; c += kThreads) {
    const int r = c / chunks;
    const int col = (c % chunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < len && col < d) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + col);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + col) = val;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_wmma_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int bq = p.block_q, bk = p.block_k, dp = p.dim_pad, d = p.head_dim;
  const int ldq = dp + 8, lds = bk + 4, ldp = bk + 8, ldo = dp + 4;
  const Layout L = make_layout(bq, bk, dp);
  T* sQ = reinterpret_cast<T*>(smem + L.q);
  T* sKV = reinterpret_cast<T*>(smem + L.kv);
  float* sS = reinterpret_cast<float*>(smem + L.s);
  T* sP = reinterpret_cast<T*>(smem + L.p);
  float* sO = reinterpret_cast<float*>(smem + L.o);
  float* sM = reinterpret_cast<float*>(smem + L.m);
  float* sL = reinterpret_cast<float*>(smem + L.l);
  float* sAlpha = reinterpret_cast<float*>(smem + L.alpha);

  const int b = blockIdx.y / p.heads;
  const int h = blockIdx.y % p.heads;
  const int q0 = blockIdx.x * bq;
  const T* qh = static_cast<const T*>(p.q) + b * p.q_bs + (long long)h * d;
  const T* kh = static_cast<const T*>(p.k) + b * p.k_bs + (long long)h * d;
  const T* vh = static_cast<const T*>(p.v) + b * p.v_bs + (long long)h * d;
  T* oh = static_cast<T*>(p.o) + b * p.o_bs + (long long)h * d;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  load_tile(sQ, ldq, qh, p.q_rs, q0, bq, p.q_len, d, dp);
  for (int i = threadIdx.x; i < bq * ldo; i += kThreads) sO[i] = 0.f;
  for (int r = threadIdx.x; r < bq; r += kThreads) {
    sM[r] = kMaskedScore;
    sL[r] = 0.f;
  }
  __syncthreads();

  const int causal_shift = p.kv_len - p.q_len;
  const int s_cols = bk / 16;
  const int o_cols = dp / 16;
  for (int k0 = 0; k0 < p.kv_len; k0 += bk) {
    load_tile(sKV, ldq, kh, p.k_rs, k0, bk, p.kv_len, d, dp);
    __syncthreads();

    // S = Q K^T (unscaled), float32 accumulation
    for (int t = warp; t < (bq / 16) * s_cols; t += kWarps) {
      const int ti = t / s_cols, tj = t % s_cols;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < dp; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> bt;
        wmma::load_matrix_sync(a, sQ + ti * 16 * ldq + kk, ldq);
        wmma::load_matrix_sync(bt, sKV + tj * 16 * ldq + kk, ldq);
        wmma::mma_sync(acc, a, bt, acc);
      }
      wmma::store_matrix_sync(sS + ti * 16 * lds + tj * 16, acc, lds, wmma::mem_row_major);
    }
    __syncthreads();

    // online softmax, one warp per row
    for (int r = warp; r < bq; r += kWarps) {
      const int row = q0 + r;
      const float m_prev = sM[r];
      float s[kMaxBlockK / 32];
      float m_cur = -INFINITY;
      for (int i = 0; i < bk / 32; ++i) {
        const int col = k0 + lane + 32 * i;
        float x = sS[r * lds + lane + 32 * i] * p.scale;
        if (col >= p.kv_len) {
          x = -INFINITY;
        } else if (p.causal && col > row + causal_shift) {
          x = kMaskedScore;
        }
        s[i] = x;
        m_cur = fmaxf(m_cur, x);
      }
      const float m_new = fmaxf(m_prev, warp_max(m_cur));
      float sum = 0.f;
      for (int i = 0; i < bk / 32; ++i) {
        const float e = expf(s[i] - m_new);
        sP[r * ldp + lane + 32 * i] = from_float<T>(e);
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sAlpha[r] = alpha;
        sL[r] = alpha * sL[r] + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    load_tile(sKV, ldq, vh, p.v_rs, k0, bk, p.kv_len, d, dp);
    for (int i = threadIdx.x; i < bq * dp; i += kThreads) {
      const int r = i / dp;
      sO[r * ldo + i % dp] *= sAlpha[r];
    }
    __syncthreads();

    // O += P V
    for (int t = warp; t < (bq / 16) * o_cols; t += kWarps) {
      const int ti = t / o_cols, tj = t % o_cols;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sO + ti * 16 * ldo + tj * 16, ldo, wmma::mem_row_major);
      for (int kk = 0; kk < bk; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> vb;
        wmma::load_matrix_sync(a, sP + ti * 16 * ldp + kk, ldp);
        wmma::load_matrix_sync(vb, sKV + kk * ldq + tj * 16, ldq);
        wmma::mma_sync(acc, a, vb, acc);
      }
      wmma::store_matrix_sync(sO + ti * 16 * ldo + tj * 16, acc, ldo, wmma::mem_row_major);
    }
    __syncthreads();
  }

  // O / l, cast, 16-byte stores
  const int chunks = d / 8;
  for (int c = threadIdx.x; c < bq * chunks; c += kThreads) {
    const int r = c / chunks;
    const int col = (c % chunks) * 8;
    if (q0 + r >= p.q_len) continue;
    const float l = sL[r];
    alignas(16) T out[8];
    for (int j = 0; j < 8; ++j) out[j] = from_float<T>(sO[r * ldo + col + j] / l);
    *reinterpret_cast<uint4*>(oh + (long long)(q0 + r) * p.o_rs + col) = *reinterpret_cast<const uint4*>(out);
  }
}

// ---------------------------------------------------------------------------
// head_dim <= 128: register-resident FlashAttention-2 on mma.sync
// ---------------------------------------------------------------------------

constexpr int kMmaBlock = 64;  // query rows per block (16 per warp) and keys per tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  // src-size 0 writes 16 zero bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), float32 accumulation
template <typename T>
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
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

// Start copying rows [row0, row0 + 64) of one head into shared memory (row
// pitch D + 8); rows past `len` and columns past `d` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src, long long row_stride, int row0, int len,
                                                int d) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < kMmaBlock * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    const bool valid = row0 + r < len && col < d;
    cp_async16(dst + r * (D + 8) + col, valid ? src + (long long)(row0 + r) * row_stride + col : src, valid);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_mma_kernel(const Params p) {
  constexpr int LD = D + 8;  // +16 bytes per row: ldmatrix rows fall in distinct banks
  constexpr int kTile = kMmaBlock * LD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kTile;      // two buffers
  T* sV = sK + 2 * kTile;  // two buffers

  const int d = p.head_dim;
  const int b = blockIdx.y / p.heads;
  const int h = blockIdx.y % p.heads;
  const int q0 = blockIdx.x * kMmaBlock;
  const T* qh = static_cast<const T*>(p.q) + b * p.q_bs + (long long)h * d;
  const T* kh = static_cast<const T*>(p.k) + b * p.k_bs + (long long)h * d;
  const T* vh = static_cast<const T*>(p.v) + b * p.v_bs + (long long)h * d;
  T* oh = static_cast<T*>(p.o) + b * p.o_bs + (long long)h * d;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // accumulator row within the warp's 16 (and g + 8)
  const int t = lane & 3;   // accumulator column pair
  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;
  const int causal_shift = p.kv_len - p.q_len;
  const int n_tiles = (p.kv_len + kMmaBlock - 1) / kMmaBlock;

  load_tile_async<T, D>(sQ, qh, p.q_rs, q0, p.q_len, d);
  load_tile_async<T, D>(sK, kh, p.k_rs, 0, p.kv_len, d);
  load_tile_async<T, D>(sV, vh, p.v_rs, 0, p.kv_len, d);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float o[D / 8][4];
  #pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {kMaskedScore, kMaskedScore};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile_async<T, D>(sK + (buf ^ 1) * kTile, kh, p.k_rs, (j + 1) * kMmaBlock, p.kv_len, d);
      load_tile_async<T, D>(sV + (buf ^ 1) * kTile, vh, p.v_rs, (j + 1) * kMmaBlock, p.kv_len, d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
      #pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane % 16)) * LD + kk * 16 + (lane / 16) * 8);
      }
    }

    // S = Q K^T for this warp's 16 rows x 64 keys
    const T* kb = sK + buf * kTile;
    float s[kMmaBlock / 8][4];
    #pragma unroll
    for (int i = 0; i < kMmaBlock / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    #pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      #pragma unroll
      for (int np = 0; np < kMmaBlock / 16; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, kb + (np * 16 + (lane % 8) + (lane / 16) * 8) * LD + kk * 16 + ((lane / 8) % 2) * 8);
        mma_16816<T>(s[2 * np], qf[kk], kf[0], kf[1]);
        mma_16816<T>(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // online softmax; a row's 64 scores are spread over the 4 lanes of a quad
    float mx[2] = {-INFINITY, -INFINITY};
    #pragma unroll
    for (int nt = 0; nt < kMmaBlock / 8; ++nt) {
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * kMmaBlock + nt * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        float x = s[nt][e] * p.scale;
        if (col >= p.kv_len) {
          x = -INFINITY;
        } else if (p.causal && col > row + causal_shift) {
          x = kMaskedScore;
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
    #pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    #pragma unroll
    for (int nt = 0; nt < kMmaBlock / 8; ++nt) {
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = pe;
        l[e >> 1] += pe;
      }
    }
    #pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }

    // O += P V; the S accumulators of key columns [16kc, 16kc + 16) are the
    // A fragment of that 16-key slice
    const T* vb = sV + buf * kTile;
    #pragma unroll
    for (int kc = 0; kc < kMmaBlock / 16; ++kc) {
      const uint32_t pa[4] = {
          pack2<T>(s[2 * kc][0], s[2 * kc][1]), pack2<T>(s[2 * kc][2], s[2 * kc][3]),
          pack2<T>(s[2 * kc + 1][0], s[2 * kc + 1][1]), pack2<T>(s[2 * kc + 1][2], s[2 * kc + 1][3])};
      #pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vb + (kc * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD + dp * 16 + (lane / 16) * 8);
        mma_16816<T>(o[2 * dp], pa, vf[0], vf[1]);
        mma_16816<T>(o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  #pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = i * 8 + 2 * t;
    if (col >= d) continue;
    if (row_a < p.q_len) {
      *reinterpret_cast<uint32_t*>(oh + (long long)row_a * p.o_rs + col) = pack2<T>(o[i][0] / l[0], o[i][1] / l[0]);
    }
    if (row_b < p.q_len) {
      *reinterpret_cast<uint32_t*>(oh + (long long)row_b * p.o_rs + col) = pack2<T>(o[i][2] / l[1], o[i][3] / l[1]);
    }
  }
}

template <typename T, int D>
int launch_mma(const Params& p, int batch, cudaStream_t stream) {
  const int bytes = 5 * kMmaBlock * (D + 8) * int(sizeof(T));  // Q + 2 x K + 2 x V
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(flash_fwd_mma_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return int(err);
  }
  const dim3 grid((p.q_len + kMmaBlock - 1) / kMmaBlock, batch * p.heads);
  flash_fwd_mma_kernel<T, D><<<grid, kThreads, bytes, stream>>>(p);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

bool choose_tiles(int dp, int* bq, int* bk, size_t* bytes) {
  static const int candidates[][2] = {{64, 64}, {64, 32}, {32, 64}, {32, 32}, {16, 32}};
  for (const auto& c : candidates) {
    const size_t total = make_layout(c[0], c[1], dp).total;
    if (total <= kMaxSharedBytes) {
      *bq = c[0];
      *bk = c[1];
      *bytes = total;
      return true;
    }
  }
  return false;
}

template <typename T>
int launch(Params p, int batch, cudaStream_t stream) {
  if (p.dim_pad <= 64) return launch_mma<T, 64>(p, batch, stream);
  if (p.dim_pad <= 128) return launch_mma<T, 128>(p, batch, stream);
  size_t bytes = 0;
  if (!choose_tiles(p.dim_pad, &p.block_q, &p.block_k, &bytes)) return int(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(flash_fwd_wmma_kernel<T>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err != cudaSuccess) return int(err);
  }
  const dim3 grid((p.q_len + p.block_q - 1) / p.block_q, batch * p.heads);
  flash_fwd_wmma_kernel<T><<<grid, kThreads, bytes, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float16. Strides are in elements. Returns a
// cudaError_t value (0 on success). Launches on `stream`, does not
// synchronize, allocates nothing.
extern "C" int refiners_flash_attention_packed(const void* q, const void* k, const void* v, void* o, int dtype,
                                               int batch, int heads, int head_dim, int q_len, int kv_len,
                                               long long q_bs, long long q_rs, long long k_bs, long long k_rs,
                                               long long v_bs, long long v_rs, long long o_bs, long long o_rs,
                                               float scale, int causal, void* stream) {
  if (head_dim <= 0 || head_dim > 512 || head_dim % 8 != 0 || batch <= 0 || heads <= 0 || kv_len <= 0) {
    return int(cudaErrorInvalidValue);
  }
  if (q_len <= 0) return 0;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.heads = heads;
  p.head_dim = head_dim;
  p.dim_pad = (head_dim + 15) / 16 * 16;
  p.q_len = q_len;
  p.kv_len = kv_len;
  p.q_bs = q_bs;
  p.q_rs = q_rs;
  p.k_bs = k_bs;
  p.k_rs = k_rs;
  p.v_bs = v_bs;
  p.v_rs = v_rs;
  p.o_bs = o_bs;
  p.o_rs = o_rs;
  p.scale = scale;
  p.causal = causal;
  p.block_q = 0;
  p.block_k = 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<__nv_bfloat16>(p, batch, s);
    case 1:
      return launch<__half>(p, batch, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
