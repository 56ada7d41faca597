// Flash attention backward (FlashAttention-2 recomputation), for Hopper
// (sm_90a): two kernels, one for dK and dV and one for dQ.
//
// Replaces the TPU kernels `_flash_bwd_dkv_kernel` and `_flash_bwd_dq_kernel`
// (with `_recompute_p_ds` and `_flash_backward`) of
// refiners_tpu/ops/flash_attention.py, with the same contract. Per
// (batch, head), from Q, K, V, dO, the forward's logsumexp `lse` and
// delta = rowsum(dO * O) (both float32, laid out (batch*heads, q_len),
// delta computed by the caller):
//
//   S = Q K^T (float32 accumulation), P = exp(scale * S - lse), forced to 0
//   outside the masks; dP = dO V^T; dS = P * (dP - delta);
//   dV = P^T dO, dK = scale * dS^T Q, dQ = scale * dS K.
//
// P and dS are rounded to the input type once each before their products,
// as on the TPU; every accumulator is float32 and the scale is applied at
// the end. The masks are the forward's: keys past the end, rows past the
// end, and with `causal` the keys with col > row + (kv_len - q_len). A
// causal row with no admissible key has P = 0 everywhere, so it gets a zero
// gradient, as the TPU kernel gives it.
//
// As on the TPU there are two kernels and no atomics: the dK/dV kernel owns
// a tile of 64 keys (16 per warp) and loops over the query tiles; the dQ
// kernel owns a tile of 64 queries and loops over the key tiles. Each
// recomputes S, P, dP and dS for its tile pairs on mma.sync m16n8k16. In
// the dK/dV kernel a warp's products run transposed (S^T = K Q^T,
// dP^T = V dO^T), so that P^T and dS^T come out as accumulators that feed
// the next products (P^T dO, dS^T Q) from registers, as P feeds PV in the
// forward. The streamed tiles (Q, dO, lse, delta for dK/dV; K and V for dQ)
// are double-buffered in shared memory with cp.async. With `causal`, tiles
// that lie wholly above the diagonal are skipped.
//
// Heads are read through (batch, head, row) strides, so the packed
// (B, L, H*D) layout and the flat (B, H, L, D) layout both run in place.
// head_dim <= 128, compiled for padded head dims 48, 64, 80 and 128.
//
// For float32 the same two kernels run on plain FFMA with 8 warps (P and dS
// unrounded, float32 throughout), so the gradients keep float32 accuracy.
//
// What bounds it on the H100: tensor-core throughput, as in the forward
// (the dK/dV kernel does 8*L^2*d flops per head, the dQ kernel 6*L^2*d),
// with register pressure at d = 128 (two float32 accumulators of 16 x d per
// warp in the dK/dV kernel).

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int heads, head_dim, q_len, kv_len;
  long long q_bs, q_hs, q_rs, k_bs, k_hs, k_rs, v_bs, v_hs, v_rs, do_bs, do_hs, do_rs;
  long long dq_bs, dq_hs, dq_rs, dk_bs, dk_hs, dk_rs, dv_bs, dv_hs, dv_rs;
  float scale;
  int causal;
};

__device__ __forceinline__ bool admissible(const BwdParams& p, int row, int col) {
  return row < p.q_len && col < p.kv_len && (!p.causal || col <= row + (p.kv_len - p.q_len));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const BwdParams p) {
  constexpr int LD = D + 8;
  constexpr int kTileElems = kTile * LD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kTileElems;
  T* sQ = sV + kTileElems;       // two buffers
  T* sdO = sQ + 2 * kTileElems;  // two buffers
  float* sLse = reinterpret_cast<float*>(sdO + 2 * kTileElems);  // two buffers
  float* sDelta = sLse + 2 * kTile;                              // two buffers

  const int d = p.head_dim;
  const int b = blockIdx.y / p.heads;
  const int h = blockIdx.y % p.heads;
  const int k0 = blockIdx.x * kTile;
  const T* qh = static_cast<const T*>(p.q) + b * p.q_bs + h * p.q_hs;
  const T* kh = static_cast<const T*>(p.k) + b * p.k_bs + h * p.k_hs;
  const T* vh = static_cast<const T*>(p.v) + b * p.v_bs + h * p.v_hs;
  const T* doh = static_cast<const T*>(p.dout) + b * p.do_bs + h * p.do_hs;
  const float* lse = p.lse + (long long)blockIdx.y * p.q_len;
  const float* delta = p.delta + (long long)blockIdx.y * p.q_len;
  T* dkh = static_cast<T*>(p.dk) + b * p.dk_bs + h * p.dk_hs;
  T* dvh = static_cast<T*>(p.dv) + b * p.dv_bs + h * p.dv_hs;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int key_a = k0 + warp * 16 + g;  // this thread's accumulator rows are keys
  const int key_b = key_a + 8;
  const int n_q = (p.q_len + kTile - 1) / kTile;
  // causal: queries before k0 - (kv_len - q_len) see none of these keys
  const int first_row = p.causal ? k0 - (p.kv_len - p.q_len) : 0;
  const int j0 = first_row > 0 ? first_row / kTile : 0;

  load_tile_async<T, D>(sK, kh, p.k_rs, k0, p.kv_len, d);
  load_tile_async<T, D>(sV, vh, p.v_rs, k0, p.kv_len, d);
  cp_async_commit();

  auto load_q_tile = [&](int j, int buf) {
    const int q0 = j * kTile;
    load_tile_async<T, D>(sQ + buf * kTileElems, qh, p.q_rs, q0, p.q_len, d);
    load_tile_async<T, D>(sdO + buf * kTileElems, doh, p.do_rs, q0, p.q_len, d);
    const int i = threadIdx.x % kTile;
    const bool valid = q0 + i < p.q_len;
    if (threadIdx.x < kTile) {
      cp_async4(sLse + buf * kTile + i, valid ? lse + q0 + i : lse, valid);
    } else {
      cp_async4(sDelta + buf * kTile + i, valid ? delta + q0 + i : delta, valid);
    }
  };

  float dk[D / 8][4];
  float dv[D / 8][4];
  #pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }

  if (j0 < n_q) {
    load_q_tile(j0, 0);
    cp_async_commit();
  }
  for (int j = j0; j < n_q; ++j) {
    const int buf = (j - j0) & 1;
    if (j + 1 < n_q) {
      load_q_tile(j + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* qb = sQ + buf * kTileElems;
    const T* dob = sdO + buf * kTileElems;
    const float* lb = sLse + buf * kTile;
    const float* db = sDelta + buf * kTile;
    const int q0 = j * kTile;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x 64 queries
    float s[kTile / 8][4];
    float dp[kTile / 8][4];
    #pragma unroll
    for (int i = 0; i < kTile / 8; ++i) {
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    }
    #pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a<LD>(ka, sK, warp * 16, kk, lane);
      load_a<LD>(va, sV, warp * 16, kk, lane);
      #pragma unroll
      for (int np = 0; np < kTile / 16; ++np) {
        uint32_t f[4];
        load_b_rows<LD>(f, qb, np, kk, lane);
        mma_16816<T>(s[2 * np], ka, f[0], f[1]);
        mma_16816<T>(s[2 * np + 1], ka, f[2], f[3]);
        load_b_rows<LD>(f, dob, np, kk, lane);
        mma_16816<T>(dp[2 * np], va, f[0], f[1]);
        mma_16816<T>(dp[2 * np + 1], va, f[2], f[3]);
      }
    }

    // P^T (into s) and dS^T (into dp)
    #pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = nt * 8 + 2 * t + (e & 1);
        const bool keep = admissible(p, q0 + qi, e < 2 ? key_a : key_b);
        const float pe = keep ? expf(s[nt][e] * p.scale - lb[qi]) : 0.f;
        s[nt][e] = pe;
        dp[nt][e] = pe * (dp[nt][e] - db[qi]);
      }
    }

    // dV += P^T dO and dK += dS^T Q over the 64 queries, 16 at a time
    #pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      uint32_t pa[4], dsa[4];
      acc_to_a<T>(pa, s[2 * kc], s[2 * kc + 1]);
      acc_to_a<T>(dsa, dp[2 * kc], dp[2 * kc + 1]);
      #pragma unroll
      for (int dpi = 0; dpi < D / 16; ++dpi) {
        uint32_t f[4];
        load_b_cols<LD>(f, dob, kc, dpi, lane);
        mma_16816<T>(dv[2 * dpi], pa, f[0], f[1]);
        mma_16816<T>(dv[2 * dpi + 1], pa, f[2], f[3]);
        load_b_cols<LD>(f, qb, kc, dpi, lane);
        mma_16816<T>(dk[2 * dpi], dsa, f[0], f[1]);
        mma_16816<T>(dk[2 * dpi + 1], dsa, f[2], f[3]);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

  #pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = i * 8 + 2 * t;
    if (col >= d) continue;
    if (key_a < p.kv_len) {
      *reinterpret_cast<uint32_t*>(dkh + (long long)key_a * p.dk_rs + col) =
          pack2<T>(dk[i][0] * p.scale, dk[i][1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvh + (long long)key_a * p.dv_rs + col) = pack2<T>(dv[i][0], dv[i][1]);
    }
    if (key_b < p.kv_len) {
      *reinterpret_cast<uint32_t*>(dkh + (long long)key_b * p.dk_rs + col) =
          pack2<T>(dk[i][2] * p.scale, dk[i][3] * p.scale);
      *reinterpret_cast<uint32_t*>(dvh + (long long)key_b * p.dv_rs + col) = pack2<T>(dv[i][2], dv[i][3]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int LD = D + 8;
  constexpr int kTileElems = kTile * LD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sdO = sQ + kTileElems;
  T* sK = sdO + kTileElems;     // two buffers
  T* sV = sK + 2 * kTileElems;  // two buffers

  const int d = p.head_dim;
  const int b = blockIdx.y / p.heads;
  const int h = blockIdx.y % p.heads;
  const int q0 = blockIdx.x * kTile;
  const T* qh = static_cast<const T*>(p.q) + b * p.q_bs + h * p.q_hs;
  const T* kh = static_cast<const T*>(p.k) + b * p.k_bs + h * p.k_hs;
  const T* vh = static_cast<const T*>(p.v) + b * p.v_bs + h * p.v_hs;
  const T* doh = static_cast<const T*>(p.dout) + b * p.do_bs + h * p.do_hs;
  T* dqh = static_cast<T*>(p.dq) + b * p.dq_bs + h * p.dq_hs;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;
  const float* lse = p.lse + (long long)blockIdx.y * p.q_len;
  const float* delta = p.delta + (long long)blockIdx.y * p.q_len;
  const float lse_r[2] = {row_a < p.q_len ? lse[row_a] : 0.f, row_b < p.q_len ? lse[row_b] : 0.f};
  const float delta_r[2] = {row_a < p.q_len ? delta[row_a] : 0.f, row_b < p.q_len ? delta[row_b] : 0.f};

  int n_k = (p.kv_len + kTile - 1) / kTile;
  if (p.causal) {  // keys past the tile's last row + (kv_len - q_len) are masked for every row
    const int last_col = q0 + kTile - 1 + (p.kv_len - p.q_len);
    n_k = last_col < 0 ? 0 : min(n_k, last_col / kTile + 1);
  }

  float dq[D / 8][4];
  #pragma unroll
  for (int i = 0; i < D / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  if (n_k > 0) {
    load_tile_async<T, D>(sQ, qh, p.q_rs, q0, p.q_len, d);
    load_tile_async<T, D>(sdO, doh, p.do_rs, q0, p.q_len, d);
    load_tile_async<T, D>(sK, kh, p.k_rs, 0, p.kv_len, d);
    load_tile_async<T, D>(sV, vh, p.v_rs, 0, p.kv_len, d);
    cp_async_commit();
  }
  for (int j = 0; j < n_k; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_k) {
      load_tile_async<T, D>(sK + (buf ^ 1) * kTileElems, kh, p.k_rs, (j + 1) * kTile, p.kv_len, d);
      load_tile_async<T, D>(sV + (buf ^ 1) * kTileElems, vh, p.v_rs, (j + 1) * kTile, p.kv_len, d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kb = sK + buf * kTileElems;
    const T* vb = sV + buf * kTileElems;

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys
    float s[kTile / 8][4];
    float dp[kTile / 8][4];
    #pragma unroll
    for (int i = 0; i < kTile / 8; ++i) {
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    }
    #pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], doa[4];
      load_a<LD>(qa, sQ, warp * 16, kk, lane);
      load_a<LD>(doa, sdO, warp * 16, kk, lane);
      #pragma unroll
      for (int np = 0; np < kTile / 16; ++np) {
        uint32_t f[4];
        load_b_rows<LD>(f, kb, np, kk, lane);
        mma_16816<T>(s[2 * np], qa, f[0], f[1]);
        mma_16816<T>(s[2 * np + 1], qa, f[2], f[3]);
        load_b_rows<LD>(f, vb, np, kk, lane);
        mma_16816<T>(dp[2 * np], doa, f[0], f[1]);
        mma_16816<T>(dp[2 * np + 1], doa, f[2], f[3]);
      }
    }

    // dS (into dp)
    #pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * kTile + nt * 8 + 2 * t + (e & 1);
        const int r = e >> 1;
        const bool keep = admissible(p, r == 0 ? row_a : row_b, col);
        const float pe = keep ? expf(s[nt][e] * p.scale - lse_r[r]) : 0.f;
        dp[nt][e] = pe * (dp[nt][e] - delta_r[r]);
      }
    }

    // dQ += dS K over the 64 keys, 16 at a time
    #pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      uint32_t dsa[4];
      acc_to_a<T>(dsa, dp[2 * kc], dp[2 * kc + 1]);
      #pragma unroll
      for (int dpi = 0; dpi < D / 16; ++dpi) {
        uint32_t f[4];
        load_b_cols<LD>(f, kb, kc, dpi, lane);
        mma_16816<T>(dq[2 * dpi], dsa, f[0], f[1]);
        mma_16816<T>(dq[2 * dpi + 1], dsa, f[2], f[3]);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

  #pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = i * 8 + 2 * t;
    if (col >= d) continue;
    if (row_a < p.q_len) {
      *reinterpret_cast<uint32_t*>(dqh + (long long)row_a * p.dq_rs + col) =
          pack2<T>(dq[i][0] * p.scale, dq[i][1] * p.scale);
    }
    if (row_b < p.q_len) {
      *reinterpret_cast<uint32_t*>(dqh + (long long)row_b * p.dq_rs + col) =
          pack2<T>(dq[i][2] * p.scale, dq[i][3] * p.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: FFMA tiles
// ---------------------------------------------------------------------------

// The same two kernels in float32 on plain FFMA, 256 threads (see
// flash_common.cuh for the thread layout). Every tile sits in shared memory;
// the scores and the gradient accumulators in registers. P and dS go
// through shared memory to their products.

template <int D>
__global__ void __launch_bounds__(kF32Threads) flash_bwd_dkv_f32_kernel(const BwdParams p) {
  constexpr int R = kTile / 16;
  constexpr int kTileElems = kTile * (D + 1);
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + kTileElems;
  float* sQ = sV + kTileElems;
  float* sdO = sQ + kTileElems;
  float* sP = sdO + kTileElems;          // P^T: keys x queries
  float* sdS = sP + kTile * kF32ScorePitch;  // dS^T
  float* sLse = sdS + kTile * kF32ScorePitch;
  float* sDelta = sLse + kTile;

  const int d = p.head_dim;
  const int b = blockIdx.y / p.heads;
  const int h = blockIdx.y % p.heads;
  const int k0 = blockIdx.x * kTile;
  const float* qh = static_cast<const float*>(p.q) + b * p.q_bs + h * p.q_hs;
  const float* kh = static_cast<const float*>(p.k) + b * p.k_bs + h * p.k_hs;
  const float* vh = static_cast<const float*>(p.v) + b * p.v_bs + h * p.v_hs;
  const float* doh = static_cast<const float*>(p.dout) + b * p.do_bs + h * p.do_hs;
  const float* lse = p.lse + (long long)blockIdx.y * p.q_len;
  const float* delta = p.delta + (long long)blockIdx.y * p.q_len;
  float* dkh = static_cast<float*>(p.dk) + b * p.dk_bs + h * p.dk_hs;
  float* dvh = static_cast<float*>(p.dv) + b * p.dv_bs + h * p.dv_hs;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int n_q = (p.q_len + kTile - 1) / kTile;
  const int first_row = p.causal ? k0 - (p.kv_len - p.q_len) : 0;
  const int j0 = first_row > 0 ? first_row / kTile : 0;

  load_tile_f32<D>(sK, kh, p.k_rs, k0, kTile, p.kv_len, d);
  load_tile_f32<D>(sV, vh, p.v_rs, k0, kTile, p.kv_len, d);
  float dk[R][D / 16], dv[R][D / 16];
  #pragma unroll
  for (int i = 0; i < R; ++i) {
    #pragma unroll
    for (int c = 0; c < D / 16; ++c) dk[i][c] = dv[i][c] = 0.f;
  }

  for (int j = j0; j < n_q; ++j) {
    const int q0 = j * kTile;
    __syncthreads();  // the previous tile's products are done with sQ, sdO
    load_tile_f32<D>(sQ, qh, p.q_rs, q0, kTile, p.q_len, d);
    load_tile_f32<D>(sdO, doh, p.do_rs, q0, kTile, p.q_len, d);
    const int r = threadIdx.x;
    if (r < kTile) {
      sLse[r] = q0 + r < p.q_len ? lse[q0 + r] : 0.f;
      sDelta[r] = q0 + r < p.q_len ? delta[q0 + r] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries
    float s[R][4], dp[R][4];
    #pragma unroll
    for (int i = 0; i < R; ++i) {
      #pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
    }
    mm_abt_f32<D, R>(s, sK, sQ, tx, ty);
    mm_abt_f32<D, R>(dp, sV, sdO, tx, ty);
    #pragma unroll
    for (int i = 0; i < R; ++i) {
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = tx + 16 * e;
        const float pe = admissible(p, q0 + qi, k0 + ty + 16 * i) ? expf(s[i][e] * p.scale - sLse[qi]) : 0.f;
        sP[(ty + 16 * i) * kF32ScorePitch + qi] = pe;
        sdS[(ty + 16 * i) * kF32ScorePitch + qi] = pe * (dp[i][e] - sDelta[qi]);
      }
    }
    __syncthreads();
    mm_ab_f32<D, R>(dv, sP, sdO, tx, ty);  // dV += P^T dO
    mm_ab_f32<D, R>(dk, sdS, sQ, tx, ty);  // dK += dS^T Q
  }

  #pragma unroll
  for (int i = 0; i < R; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= p.kv_len) continue;
    #pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const int col = tx + 16 * c;
      if (col >= d) continue;
      dkh[(long long)key * p.dk_rs + col] = dk[i][c] * p.scale;
      dvh[(long long)key * p.dv_rs + col] = dv[i][c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads) flash_bwd_dq_f32_kernel(const BwdParams p) {
  constexpr int R = kTile / 16;
  constexpr int kTileElems = kTile * (D + 1);
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sdO = sQ + kTileElems;
  float* sK = sdO + kTileElems;
  float* sV = sK + kTileElems;
  float* sdS = sV + kTileElems;

  const int d = p.head_dim;
  const int b = blockIdx.y / p.heads;
  const int h = blockIdx.y % p.heads;
  const int q0 = blockIdx.x * kTile;
  const float* qh = static_cast<const float*>(p.q) + b * p.q_bs + h * p.q_hs;
  const float* kh = static_cast<const float*>(p.k) + b * p.k_bs + h * p.k_hs;
  const float* vh = static_cast<const float*>(p.v) + b * p.v_bs + h * p.v_hs;
  const float* doh = static_cast<const float*>(p.dout) + b * p.do_bs + h * p.do_hs;
  float* dqh = static_cast<float*>(p.dq) + b * p.dq_bs + h * p.dq_hs;
  const float* lse = p.lse + (long long)blockIdx.y * p.q_len;
  const float* delta = p.delta + (long long)blockIdx.y * p.q_len;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float lse_r[R], delta_r[R];
  #pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    lse_r[i] = row < p.q_len ? lse[row] : 0.f;
    delta_r[i] = row < p.q_len ? delta[row] : 0.f;
  }
  int n_k = (p.kv_len + kTile - 1) / kTile;
  if (p.causal) {  // keys past the tile's last row + (kv_len - q_len) are masked for every row
    const int last_col = q0 + kTile - 1 + (p.kv_len - p.q_len);
    n_k = last_col < 0 ? 0 : min(n_k, last_col / kTile + 1);
  }

  load_tile_f32<D>(sQ, qh, p.q_rs, q0, kTile, p.q_len, d);
  load_tile_f32<D>(sdO, doh, p.do_rs, q0, kTile, p.q_len, d);
  float dq[R][D / 16];
  #pragma unroll
  for (int i = 0; i < R; ++i) {
    #pragma unroll
    for (int c = 0; c < D / 16; ++c) dq[i][c] = 0.f;
  }

  for (int j = 0; j < n_k; ++j) {
    const int k0 = j * kTile;
    __syncthreads();  // the previous tile's product is done with sK
    load_tile_f32<D>(sK, kh, p.k_rs, k0, kTile, p.kv_len, d);
    load_tile_f32<D>(sV, vh, p.v_rs, k0, kTile, p.kv_len, d);
    __syncthreads();

    // S = Q K^T and dP = dO V^T, then dS
    float s[R][4], dp[R][4];
    #pragma unroll
    for (int i = 0; i < R; ++i) {
      #pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
    }
    mm_abt_f32<D, R>(s, sQ, sK, tx, ty);
    mm_abt_f32<D, R>(dp, sdO, sV, tx, ty);
    #pragma unroll
    for (int i = 0; i < R; ++i) {
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + tx + 16 * e;
        const float pe = admissible(p, q0 + ty + 16 * i, col) ? expf(s[i][e] * p.scale - lse_r[i]) : 0.f;
        sdS[(ty + 16 * i) * kF32ScorePitch + tx + 16 * e] = pe * (dp[i][e] - delta_r[i]);
      }
    }
    __syncthreads();
    mm_ab_f32<D, R>(dq, sdS, sK, tx, ty);  // dQ += dS K
  }

  #pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.q_len) continue;
    #pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const int col = tx + 16 * c;
      if (col < d) dqh[(long long)row * p.dq_rs + col] = dq[i][c] * p.scale;
    }
  }
}

template <int D, bool kDkv>
int launch_one_f32(const BwdParams& p, int batch, cudaStream_t stream) {
  const int tiles = 4 * kTile * (D + 1) * int(sizeof(float));
  const int scores = kTile * kF32ScorePitch * int(sizeof(float));
  const int bytes = kDkv ? tiles + 2 * scores + 2 * kTile * int(sizeof(float)) : tiles + scores;
  auto kernel = kDkv ? flash_bwd_dkv_f32_kernel<D> : flash_bwd_dq_f32_kernel<D>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return int(err);
  }
  const int len = kDkv ? p.kv_len : p.q_len;
  const dim3 grid((len + kTile - 1) / kTile, batch * p.heads);
  kernel<<<grid, kF32Threads, bytes, stream>>>(p);
  return int(cudaGetLastError());
}

template <bool kDkv>
int launch_f32(const BwdParams& p, int batch, cudaStream_t stream) {
  switch (mma_template((p.head_dim + 15) / 16 * 16)) {
    case 48:
      return launch_one_f32<48, kDkv>(p, batch, stream);
    case 64:
      return launch_one_f32<64, kDkv>(p, batch, stream);
    case 80:
      return launch_one_f32<80, kDkv>(p, batch, stream);
    case 128:
      return launch_one_f32<128, kDkv>(p, batch, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int D, bool kDkv>
int launch_one(const BwdParams& p, int batch, cudaStream_t stream) {
  const int tiles = 6 * kTile * (D + 8) * int(sizeof(T));
  const int bytes = kDkv ? tiles + 4 * kTile * int(sizeof(float)) : tiles;
  auto kernel = kDkv ? flash_bwd_dkv_kernel<T, D> : flash_bwd_dq_kernel<T, D>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return int(err);
  }
  const int len = kDkv ? p.kv_len : p.q_len;
  const dim3 grid((len + kTile - 1) / kTile, batch * p.heads);
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return int(cudaGetLastError());
}

template <typename T, bool kDkv>
int launch(const BwdParams& p, int batch, cudaStream_t stream) {
  switch (mma_template((p.head_dim + 15) / 16 * 16)) {
    case 48:
      return launch_one<T, 48, kDkv>(p, batch, stream);
    case 64:
      return launch_one<T, 64, kDkv>(p, batch, stream);
    case 80:
      return launch_one<T, 80, kDkv>(p, batch, stream);
    case 128:
      return launch_one<T, 128, kDkv>(p, batch, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

template <bool kDkv>
int run(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* delta,
        void* dq, void* dk, void* dv, int dtype, int batch, int heads, int head_dim, int q_len, int kv_len,
        const long long* strides, float scale, int causal, void* stream) {
  if (head_dim <= 0 || head_dim > 128 || head_dim % 8 != 0 || batch <= 0 || heads <= 0 || q_len <= 0 ||
      kv_len <= 0) {
    return int(cudaErrorInvalidValue);
  }
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.heads = heads;
  p.head_dim = head_dim;
  p.q_len = q_len;
  p.kv_len = kv_len;
  long long* const fields[] = {&p.q_bs,  &p.q_hs,  &p.q_rs,  &p.k_bs,  &p.k_hs,  &p.k_rs,  &p.v_bs,
                               &p.v_hs,  &p.v_rs,  &p.do_bs, &p.do_hs, &p.do_rs, &p.dq_bs, &p.dq_hs,
                               &p.dq_rs, &p.dk_bs, &p.dk_hs, &p.dk_rs, &p.dv_bs, &p.dv_hs, &p.dv_rs};
  for (int i = 0; i < 21; ++i) *fields[i] = strides[i];
  p.scale = scale;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<__nv_bfloat16, kDkv>(p, batch, s);
    case 1:
      return launch<__half, kDkv>(p, batch, s);
    case 2:
      return launch_f32<kDkv>(p, batch, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Both entries take the same arguments. dtype: 0 = bfloat16, 1 = float16,
// 2 = float32.
// `strides` holds 21 values in elements: (batch, head, row) for q, k, v,
// dout, dq, dk and dv. lse and delta are (batch*heads, q_len) float32. The
// dK/dV entry writes dk and dv (dq may be null); the dQ entry writes dq (dk
// and dv may be null). Returns a cudaError_t value (0 on success). Launches
// on `stream`, does not synchronize, allocates nothing.
extern "C" int refiners_flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                                const float* lse, const float* delta, void* dq, void* dk,
                                                void* dv, int dtype, int batch, int heads, int head_dim,
                                                int q_len, int kv_len, const long long* strides, float scale,
                                                int causal, void* stream) {
  return run<true>(q, k, v, dout, lse, delta, dq, dk, dv, dtype, batch, heads, head_dim, q_len, kv_len, strides,
                   scale, causal, stream);
}

extern "C" int refiners_flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                               const float* lse, const float* delta, void* dq, void* dk, void* dv,
                                               int dtype, int batch, int heads, int head_dim, int q_len,
                                               int kv_len, const long long* strides, float scale, int causal,
                                               void* stream) {
  return run<false>(q, k, v, dout, lse, delta, dq, dk, dv, dtype, batch, heads, head_dim, q_len, kv_len, strides,
                    scale, causal, stream);
}
