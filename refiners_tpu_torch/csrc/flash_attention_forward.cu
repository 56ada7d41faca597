// Flash attention forward, for Hopper (sm_90a): one kernel source for the
// port's three forward entries, the packed (B, L, H*D) layout and the flat
// (B, H, L, D) layout, with an optional additive bias (dense, or SAM's
// decomposed relative position) and an optional logsumexp output.
//
// Replaces three TPU kernels of refiners_tpu/ops/flash_attention.py:
// `_flash_kernel_packed` (with `_flash_forward_packed`, entry
// `flash_attention_packed`), `_flash_kernel` (with `_flash_forward`, entry
// `flash_attention`) and `_flash_relpos_kernel` (entry
// `flash_attention_relpos`). The first two differ on the TPU only because of
// its 128-lane blocks; here head h of batch b starts at
// b*batch_stride + h*head_stride with its own row stride (all in elements,
// given by the caller), so one kernel reads either layout, or column slices
// of a fused projection, in place with no split/merge-heads copies.
//
// Same contract as the TPU kernels: per (batch, head),
// O = softmax(scale * Q K^T + bias + mask) V with an online softmax; running
// max and sum and the output accumulator in float32; P cast to the input
// type before the PV product; output cast to the input type. The bias takes
// one of three compile-time modes:
// - none;
// - dense: float32, read through four strides (a stride of 0 broadcasts, as
//   torch.broadcast_to gives);
// - relative position (SAM's image encoder, K3): for a key grid of kh rows
//   and kw columns (kh * kw = kv_len), bias[q, k] = v_rel[q, k / kw] +
//   h_rel[q, k % kw], with v_rel (q_len, kh) and h_rel (q_len, kw) per head in
//   the input type, widened to float32. The (q_len, kv_len) bias is never
//   materialized: a SAM-H global layer reads 2 x 16 x 4096 x 64 values in
//   place of a 1 GiB float32 bias. The TPU kernel rebuilds the bias tile with
//   two 0/1 expansion matmuls and needs every key tile to share one kw phase
//   (else it falls back to `_flash_kernel` with a materialized bias); here
//   each score computes k / kw and k % kw, so any kw is taken and there is no
//   fallback. The two rows of a query are read through L1.
// Masked scores are -1e30 (not -inf), so a causal row with no admissible key
// gets uniform weights over the keys, as the TPU kernel does; keys past the
// sequence end do not take part. With an lse pointer the kernel also writes
// m + log(l) per row, float32, laid out (batch*heads, q_len): the residual
// the backward kernels recompute P from.
//
// What bounds it on the H100: at seq >= 1024 the work is 4*L^2*d flops
// against 4*L*d bytes per head, so tensor-core throughput (989 TFLOP/s in
// bf16); a dense bias adds a float32 read per score, which makes a biased
// call bound by that read, and the relative-position bias adds two cached
// reads, an integer division and a remainder per score: instruction throughput.
//
// Three kernels, picked by type and head_dim; each is one block per
// (query tile of 64 rows, batch*head) with a loop over K/V tiles of 64 keys:
//
// - bfloat16 and float16, head_dim <= 128 (the UNet's d = 40, 64 and 80
//   sites): FlashAttention-2's layout on mma.sync m16n8k16, 4 warps,
//   compiled for padded head dims 48, 64, 80 and 128. Each warp owns 16
//   query rows; its Q fragments, S tile, softmax statistics and O
//   accumulator stay in registers, and P goes from the S accumulators
//   straight into the A operand of the PV product. K and V tiles are
//   double-buffered in shared memory with cp.async, read with ldmatrix
//   (transposed for V).
// - bfloat16 and float16, 128 < head_dim <= 512 (the SDXL VAE's mid-block
//   site, one head of d = 512 over L = 16384): `flash_fwd_wgmma_kernel`,
//   Hopper's warpgroup products, compiled for padded head dims 256 and 512
//   (zero columns past d). It replaces `_flash_kernel_packed` and
//   `_flash_kernel` of refiners_tpu/ops/flash_attention.py (:707, :105) at
//   these widths. A 64-row O accumulator of 512 float32 columns is 256
//   registers a thread for one warpgroup, more than it has, so the block is
//   two warpgroups split along d: each owns O[:, half] in registers
//   (m64n256, 128 a thread), loads its half of Q, K and V with TMA onto its
//   own mbarriers (the next K half in flight during softmax and P V, the
//   next V half during the next Q K^T), computes S over its half of d with
//   wgmma from shared memory, and adds the other warpgroup's partial S
//   through shared memory (the only exchange: both then run the same online
//   softmax in registers). No accumulator is staged through shared memory
//   across tiles. Beyond flops, what bounds it is re-reading K and V: every
//   64-row block reads all of them (32 MiB at the VAE's site, L2-resident),
//   about 8 GiB of L2 traffic per call; sharing K/V tiles across a cluster
//   with TMA multicast is the next step.
// - float32 (head_dim up to 512): 8 warps on plain FFMA, so the result
//   keeps float32 accuracy as the float32 plain version has it: Q, one K or
//   V tile and P in shared memory, the scores and the O accumulator in
//   registers, compiled for padded head dims 48, 64, 80, 128, 256 and 512.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr size_t kMaxSharedBytes = 232448;  // 227 KB per block on Hopper
// widest key grid side of the relative-position bias (kh and kw each)
constexpr int kMaxRelPosSide = 256;

// bias modes, a template parameter of every kernel
constexpr int kNoBias = 0;
constexpr int kDenseBias = 1;
constexpr int kRelPosBias = 2;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const float* bias;  // dense bias; may be null
  const void* vrel;   // relative-position bias, in the input type; both null or both set
  const void* hrel;
  float* lse;  // may be null
  int heads, head_dim, dim_pad, q_len, kv_len, kw;
  long long q_bs, q_hs, q_rs, k_bs, k_hs, k_rs, v_bs, v_hs, v_rs, o_bs, o_hs, o_rs;
  long long bias_bs, bias_hs, bias_rs, bias_cs;
  long long vrel_bs, vrel_hs, vrel_rs, hrel_bs, hrel_hs, hrel_rs;
  float scale;
  int causal;
};

__host__ __device__ inline int bias_mode(const Params& p) {
  if (p.vrel != nullptr) return kRelPosBias;
  return p.bias != nullptr ? kDenseBias : kNoBias;
}

// One (batch, head)'s bias operands: the dense bias, or the rows of v_rel and
// h_rel; the pointers a mode does not use are null.
template <typename T>
struct HeadBias {
  const float* dense;
  const T* vrel;
  const T* hrel;
};

template <typename T>
__device__ __forceinline__ HeadBias<T> head_bias(const Params& p, int b, int h) {
  HeadBias<T> hb;
  hb.dense = p.bias == nullptr ? nullptr : p.bias + b * p.bias_bs + h * p.bias_hs;
  hb.vrel = p.vrel == nullptr ? nullptr : static_cast<const T*>(p.vrel) + b * p.vrel_bs + h * p.vrel_hs;
  hb.hrel = p.hrel == nullptr ? nullptr : static_cast<const T*>(p.hrel) + b * p.hrel_bs + h * p.hrel_hs;
  return hb;
}

// Scaled score of (row, col) with the bias of mode kBias added and the masks
// applied: keys past the end are -inf, causally masked keys -1e30. The mode
// is a template parameter so that the unbiased kernels' inner loop carries
// no test for it.
template <int kBias, typename T>
__device__ __forceinline__ float masked_score(const Params& p, const HeadBias<T>& hb, float s, int row, int col,
                                              int causal_shift) {
  float x = s * p.scale;
  if (col >= p.kv_len) return -INFINITY;
  if (kBias == kDenseBias && row < p.q_len) x += hb.dense[row * p.bias_rs + col * p.bias_cs];
  if (kBias == kRelPosBias && row < p.q_len) {
    x += to_float(hb.vrel[row * p.vrel_rs + col / p.kw]) + to_float(hb.hrel[row * p.hrel_rs + col % p.kw]);
  }
  if (p.causal && col > row + causal_shift) x = kMaskedScore;
  return x;
}

// ---------------------------------------------------------------------------
// 128 < head_dim <= 512: wgmma with register accumulators, TMA loads
// ---------------------------------------------------------------------------

constexpr int kWarpgroup = 128;
constexpr int kWideThreads = 2 * kWarpgroup;
// named barriers (0 is __syncthreads): both warpgroups' S partials are
// written; warpgroup g's partial has been read (2 + g); warpgroup g is done
// with its V half (4 + g)
constexpr int kBarExchange = 1;
constexpr int kBarPartialRead = 2;
constexpr int kBarVRead = 4;

// Shared memory of the wide kernel at padded head dim D, in bytes from a
// 1024-byte-aligned base: Q, K and V tiles of 64 rows x D (D / 64 TMA boxes
// each; warpgroup g reads boxes [g D / 128, (g + 1) D / 128)), the two
// warpgroups' float32 S partials, six mbarriers (Q, K, V of each
// warpgroup's half).
template <int D>
struct WideSmem {
  static constexpr int kTileBytes = kTile * D * 2;
  static constexpr int q = 0;
  static constexpr int k = kTileBytes;
  static constexpr int v = 2 * kTileBytes;
  static constexpr int partials = 3 * kTileBytes;
  static constexpr int bars = partials + 2 * kTile * kTile * 4;
  static constexpr int bytes = bars + 6 * 8 + hopper::kSwizzleAtomBytes;  // + room to align the base
  static_assert(bytes <= int(kMaxSharedBytes), "wide forward tiles exceed shared memory");
};

// Warpgroup g's half of one 64-row tile: D / 128 boxes from column g D / 2,
// onto `bar` (one arrival plus the boxes' bytes).
template <int D>
__device__ __forceinline__ void load_half(const CUtensorMap* map, uint32_t bar, uint32_t dst, int g, int row, int h,
                                          int b) {
  constexpr int kBoxes = D / 2 / hopper::kBox;
  hopper::mbar_expect_tx(bar, kBoxes * hopper::kBoxBytes);
  #pragma unroll
  for (int i = 0; i < kBoxes; ++i) {
    hopper::tma_load_4d(dst + i * hopper::kBoxBytes, map, bar, (g * kBoxes + i) * hopper::kBox, row, h, b);
  }
}

// One block of two warpgroups per (64 query rows, batch*head), a loop over
// key tiles of 64. Warpgroup g owns columns [g D / 2, (g + 1) D / 2) of d:
// it loads that half of the Q, K and V tiles itself (one thread starts the
// TMA copies onto the warpgroup's mbarriers), computes the partial
// S = Q K^T over its half with wgmma from shared memory, and keeps O[:, half]
// in registers (m64n256: 128 floats a thread at D = 512). The two S
// partials meet in shared memory; each warpgroup adds the other's, so both
// hold the whole S in the same accumulator layout and run the same online
// softmax (identical m and l, no second exchange). P goes from the S
// accumulators into the A registers of O += P V[:, half] (V MN-major,
// through the transpose bit: no transposed copy). The next K half is in
// flight during softmax and P V, the next V half during the next Q K^T.
template <typename T, int D, int kBias>
__global__ void __launch_bounds__(kWideThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = WideSmem<D>;
  constexpr int DH = D / 2;                                     // columns of d per warpgroup
  constexpr int kHalfBytes = DH / hopper::kBox * hopper::kBoxBytes;
  extern __shared__ unsigned char smem_raw[];
  constexpr uintptr_t kAlign = hopper::kSwizzleAtomBytes;
  unsigned char* smem =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) & ~(kAlign - 1));
  float* partials = reinterpret_cast<float*>(smem + L::partials);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bars);

  const int g = threadIdx.x / kWarpgroup;
  const int tid = threadIdx.x % kWarpgroup;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row_a = blockIdx.x * kTile + warp * 16 + lane / 4;  // this thread's accumulator rows
  const int row_b = row_a + 8;
  const int t = lane % 4;
  const int b = blockIdx.y / p.heads;
  const int h = blockIdx.y % p.heads;
  const HeadBias<T> hb = head_bias<T>(p, b, h);
  const int causal_shift = p.kv_len - p.q_len;
  const int n_tiles = (p.kv_len + kTile - 1) / kTile;
  const bool leader = tid == 0;  // starts this warpgroup's copies

  const uint32_t sq = hopper::smem_u32(smem + L::q) + g * kHalfBytes;
  const uint32_t sk = hopper::smem_u32(smem + L::k) + g * kHalfBytes;
  const uint32_t sv = hopper::smem_u32(smem + L::v) + g * kHalfBytes;
  const uint32_t qbar = hopper::smem_u32(bars + g);
  const uint32_t kbar = hopper::smem_u32(bars + 2 + g);
  const uint32_t vbar = hopper::smem_u32(bars + 4 + g);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 6; ++i) hopper::mbar_init(hopper::smem_u32(bars + i), 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (leader) {
    load_half<D>(&tq, qbar, sq, g, blockIdx.x * kTile, h, b);
    load_half<D>(&tk, kbar, sk, g, 0, h, b);
    load_half<D>(&tv, vbar, sv, g, 0, h, b);
  }

  float o[DH / 2];
  #pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m[2] = {kMaskedScore, kMaskedScore};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float4* mine = reinterpret_cast<float4*>(partials + g * kTile * kTile) + tid;
  const float4* theirs = reinterpret_cast<const float4*>(partials + (1 - g) * kTile * kTile) + tid;
  hopper::mbar_wait(qbar, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const uint32_t parity = j & 1;
    const bool more = j + 1 < n_tiles;

    // partial S = Q[:, half] K[:, half]^T
    float s[32];
    hopper::mbar_wait(kbar, parity);
    hopper::wgmma_fence();
    #pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk / 4) * hopper::kBoxBytes + (kk % 4) * 32;
      hopper::wgmma_m64n64k16_ss<T>(s, hopper::kmajor_desc(sq + off), hopper::kmajor_desc(sk + off), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);

    // exchange the partials: thread i of one warpgroup holds the same
    // (row, column) entries as thread i of the other
    if (j > 0) hopper::bar_sync(kBarPartialRead + g, kWideThreads);  // the other has read our last one
    #pragma unroll
    for (int i = 0; i < 8; ++i) mine[i * kWarpgroup] = make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
    hopper::bar_sync(kBarExchange, kWideThreads);
    if (leader && more) load_half<D>(&tk, kbar, sk, g, (j + 1) * kTile, h, b);  // our K half is free
    __syncwarp();
    #pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 x = theirs[i * kWarpgroup];
      s[4 * i] += x.x;
      s[4 * i + 1] += x.y;
      s[4 * i + 2] += x.z;
      s[4 * i + 3] += x.w;
    }
    if (more) hopper::bar_arrive(kBarPartialRead + (1 - g), kWideThreads);

    // online softmax; a row's 64 scores are spread over the 4 lanes of a quad
    float mx[2] = {-INFINITY, -INFINITY};
    #pragma unroll
    for (int n = 0; n < 8; ++n) {
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * kTile + n * 8 + 2 * t + (e & 1);
        const float x = masked_score<kBias>(p, hb, s[4 * n + e], e < 2 ? row_a : row_b, col, causal_shift);
        s[4 * n + e] = x;
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
    for (int i = 0; i < 32; ++i) {
      const float pe = expf(s[i] - m[(i >> 1) & 1]);
      s[i] = pe;
      l[(i >> 1) & 1] += pe;
    }
    uint32_t pa[4][4];  // P as the A operand of each 16-key step
    #pragma unroll
    for (int kc = 0; kc < 4; ++kc) acc_to_a<T>(pa[kc], s + 8 * kc, s + 8 * kc + 4);
    #pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    // O[:, half] += P V[:, half]
    hopper::mbar_wait(vbar, parity);
    hopper::wgmma_fence();
    #pragma unroll
    for (int kc = 0; kc < 4; ++kc) hopper::wgmma_rs<T, DH>(o, pa[kc], hopper::mnmajor_desc(sv + kc * 16 * 128));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    if (more) {
      hopper::bar_sync(kBarVRead + g, kWarpgroup);  // every warp of ours is done with V
      if (leader) load_half<D>(&tv, vbar, sv, g, (j + 1) * kTile, h, b);
    }
  }

  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  T* oh = static_cast<T*>(p.o) + b * p.o_bs + h * p.o_hs;
  #pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    const int col = g * DH + n * 8 + 2 * t;
    if (col >= p.head_dim) continue;
    if (row_a < p.q_len) {
      *reinterpret_cast<uint32_t*>(oh + (long long)row_a * p.o_rs + col) =
          pack2<T>(o[4 * n] / l[0], o[4 * n + 1] / l[0]);
    }
    if (row_b < p.q_len) {
      *reinterpret_cast<uint32_t*>(oh + (long long)row_b * p.o_rs + col) =
          pack2<T>(o[4 * n + 2] / l[1], o[4 * n + 3] / l[1]);
    }
  }
  if (p.lse != nullptr && g == 0 && t == 0) {
    float* lse = p.lse + (long long)blockIdx.y * p.q_len;
    if (row_a < p.q_len) lse[row_a] = m[0] + logf(l[0]);
    if (row_b < p.q_len) lse[row_b] = m[1] + logf(l[1]);
  }
}

// The three tensor maps (q, k, v: columns, rows, heads, batch) and the launch.
template <typename T, int D>
int launch_wgmma(const Params& p, int batch, cudaStream_t stream) {
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  CUtensorMap tq, tk, tv;
  if (!hopper::encode_box_map(&tq, bf16, p.q, p.head_dim, p.q_len, p.heads, batch, p.q_rs, p.q_hs, p.q_bs) ||
      !hopper::encode_box_map(&tk, bf16, p.k, p.head_dim, p.kv_len, p.heads, batch, p.k_rs, p.k_hs, p.k_bs) ||
      !hopper::encode_box_map(&tv, bf16, p.v, p.head_dim, p.kv_len, p.heads, batch, p.v_rs, p.v_hs, p.v_bs)) {
    return int(cudaErrorInvalidValue);
  }
  constexpr int bytes = WideSmem<D>::bytes;
  const int mode = bias_mode(p);
  auto kernel = mode == kRelPosBias ? flash_fwd_wgmma_kernel<T, D, kRelPosBias>
                : mode == kDenseBias ? flash_fwd_wgmma_kernel<T, D, kDenseBias>
                                     : flash_fwd_wgmma_kernel<T, D, kNoBias>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((p.q_len + kTile - 1) / kTile, batch * p.heads);
  kernel<<<grid, kWideThreads, bytes, stream>>>(tq, tk, tv, p);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// head_dim <= 128: register-resident FlashAttention-2 on mma.sync
// ---------------------------------------------------------------------------

template <typename T, int D, int kBias>
__global__ void __launch_bounds__(kThreads) flash_fwd_mma_kernel(const Params p) {
  constexpr int LD = D + 8;  // +16 bytes per row: ldmatrix rows fall in distinct banks
  constexpr int kTileElems = kTile * LD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kTileElems;      // two buffers
  T* sV = sK + 2 * kTileElems;  // two buffers

  const int d = p.head_dim;
  const int b = blockIdx.y / p.heads;
  const int h = blockIdx.y % p.heads;
  const int q0 = blockIdx.x * kTile;
  const T* qh = static_cast<const T*>(p.q) + b * p.q_bs + h * p.q_hs;
  const T* kh = static_cast<const T*>(p.k) + b * p.k_bs + h * p.k_hs;
  const T* vh = static_cast<const T*>(p.v) + b * p.v_bs + h * p.v_hs;
  T* oh = static_cast<T*>(p.o) + b * p.o_bs + h * p.o_hs;
  const HeadBias<T> hb = head_bias<T>(p, b, h);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // accumulator row within the warp's 16 (and g + 8)
  const int t = lane & 3;   // accumulator column pair
  const int row_a = q0 + warp * 16 + g;
  const int row_b = row_a + 8;
  const int causal_shift = p.kv_len - p.q_len;
  const int n_tiles = (p.kv_len + kTile - 1) / kTile;

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
      load_tile_async<T, D>(sK + (buf ^ 1) * kTileElems, kh, p.k_rs, (j + 1) * kTile, p.kv_len, d);
      load_tile_async<T, D>(sV + (buf ^ 1) * kTileElems, vh, p.v_rs, (j + 1) * kTile, p.kv_len, d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
      #pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) load_a<LD>(qf[kk], sQ, warp * 16, kk, lane);
    }

    // S = Q K^T for this warp's 16 rows x 64 keys
    const T* kb = sK + buf * kTileElems;
    float s[kTile / 8][4];
    #pragma unroll
    for (int i = 0; i < kTile / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    #pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      #pragma unroll
      for (int np = 0; np < kTile / 16; ++np) {
        uint32_t kf[4];
        load_b_rows<LD>(kf, kb, np, kk, lane);
        mma_16816<T>(s[2 * np], qf[kk], kf[0], kf[1]);
        mma_16816<T>(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // online softmax; a row's 64 scores are spread over the 4 lanes of a quad
    float mx[2] = {-INFINITY, -INFINITY};
    #pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * kTile + nt * 8 + 2 * t + (e & 1);
        const float x = masked_score<kBias>(p, hb, s[nt][e], e < 2 ? row_a : row_b, col, causal_shift);
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
    for (int nt = 0; nt < kTile / 8; ++nt) {
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
    const T* vb = sV + buf * kTileElems;
    #pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      uint32_t pa[4];
      acc_to_a<T>(pa, s[2 * kc], s[2 * kc + 1]);
      #pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        load_b_cols<LD>(vf, vb, kc, dp, lane);
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
  if (p.lse != nullptr && t == 0) {
    float* lse = p.lse + (long long)blockIdx.y * p.q_len;
    if (row_a < p.q_len) lse[row_a] = m[0] + logf(l[0]);
    if (row_b < p.q_len) lse[row_b] = m[1] + logf(l[1]);
  }
}

template <typename T, int D>
int launch_mma(const Params& p, int batch, cudaStream_t stream) {
  const int bytes = 5 * kTile * (D + 8) * int(sizeof(T));  // Q + 2 x K + 2 x V
  const int mode = bias_mode(p);
  auto kernel = mode == kRelPosBias ? flash_fwd_mma_kernel<T, D, kRelPosBias>
                : mode == kDenseBias ? flash_fwd_mma_kernel<T, D, kDenseBias>
                                     : flash_fwd_mma_kernel<T, D, kNoBias>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return int(err);
  }
  const dim3 grid((p.q_len + kTile - 1) / kTile, batch * p.heads);
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// float32: FFMA tiles, head_dim up to 512
// ---------------------------------------------------------------------------

// One block of 256 threads per (query tile of BQ rows, batch*head), a loop
// over K/V tiles of 64 keys. Q, one K or V tile and P sit in shared memory
// (K and V take turns in one buffer); the scores, softmax statistics and O
// accumulator in registers (see flash_common.cuh for the thread layout).
template <int D, int BQ>
constexpr int f32_forward_bytes() {
  return (BQ * (D + 1) + kTile * (D + 1) + BQ * kF32ScorePitch) * int(sizeof(float));
}

template <int D, int BQ, int kBias>
__global__ void __launch_bounds__(kF32Threads) flash_fwd_f32_kernel(const Params p) {
  constexpr int R = BQ / 16;  // rows per thread
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sKV = sQ + BQ * (D + 1);
  float* sP = sKV + kTile * (D + 1);

  const int d = p.head_dim;
  const int b = blockIdx.y / p.heads;
  const int h = blockIdx.y % p.heads;
  const int q0 = blockIdx.x * BQ;
  const float* qh = static_cast<const float*>(p.q) + b * p.q_bs + h * p.q_hs;
  const float* kh = static_cast<const float*>(p.k) + b * p.k_bs + h * p.k_hs;
  const float* vh = static_cast<const float*>(p.v) + b * p.v_bs + h * p.v_hs;
  float* oh = static_cast<float*>(p.o) + b * p.o_bs + h * p.o_hs;
  const HeadBias<float> hb = head_bias<float>(p, b, h);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int causal_shift = p.kv_len - p.q_len;

  load_tile_f32<D>(sQ, qh, p.q_rs, q0, BQ, p.q_len, d);
  float o[R][D / 16];
  float m[R], l[R];  // l: this thread's share of the row sums
  #pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kMaskedScore;
    l[i] = 0.f;
    #pragma unroll
    for (int c = 0; c < D / 16; ++c) o[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < p.kv_len; k0 += kTile) {
    __syncthreads();  // the previous tile's PV is done with sKV
    load_tile_f32<D>(sKV, kh, p.k_rs, k0, kTile, p.kv_len, d);
    __syncthreads();
    float s[R][4];
    #pragma unroll
    for (int i = 0; i < R; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    mm_abt_f32<D, R>(s, sQ, sKV, tx, ty);

    #pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = masked_score<kBias>(p, hb, s[i][j], row, k0 + tx + 16 * j, causal_shift);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha;
      #pragma unroll
      for (int c = 0; c < D / 16; ++c) o[i][c] *= alpha;
      #pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pe = expf(s[i][j] - m_new);
        l[i] += pe;
        sP[(ty + 16 * i) * kF32ScorePitch + tx + 16 * j] = pe;
      }
    }
    __syncthreads();  // every thread is done with K; P is complete
    load_tile_f32<D>(sKV, vh, p.v_rs, k0, kTile, p.kv_len, d);
    __syncthreads();
    mm_ab_f32<D, R>(o, sP, sKV, tx, ty);
  }

  #pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    const float li = row_sum16(l[i]);
    if (row >= p.q_len) continue;
    #pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const int col = tx + 16 * c;
      if (col < d) oh[(long long)row * p.o_rs + col] = o[i][c] / li;
    }
    if (p.lse != nullptr && tx == 0) p.lse[(long long)blockIdx.y * p.q_len + row] = m[i] + logf(li);
  }
}

template <int D, int BQ>
int launch_f32_d(const Params& p, int batch, cudaStream_t stream) {
  constexpr int bytes = f32_forward_bytes<D, BQ>();
  static_assert(bytes <= int(kMaxSharedBytes), "float32 forward tiles exceed shared memory");
  const int mode = bias_mode(p);
  auto kernel = mode == kRelPosBias ? flash_fwd_f32_kernel<D, BQ, kRelPosBias>
                : mode == kDenseBias ? flash_fwd_f32_kernel<D, BQ, kDenseBias>
                                     : flash_fwd_f32_kernel<D, BQ, kNoBias>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return int(err);
  }
  const dim3 grid((p.q_len + BQ - 1) / BQ, batch * p.heads);
  kernel<<<grid, kF32Threads, bytes, stream>>>(p);
  return int(cudaGetLastError());
}

int launch_f32(const Params& p, int batch, cudaStream_t stream) {
  switch (f32_template(p.dim_pad)) {
    case 48:
      return launch_f32_d<48, 64>(p, batch, stream);
    case 64:
      return launch_f32_d<64, 64>(p, batch, stream);
    case 80:
      return launch_f32_d<80, 64>(p, batch, stream);
    case 128:
      return launch_f32_d<128, 64>(p, batch, stream);
    case 256:
      return launch_f32_d<256, 64>(p, batch, stream);
    case 512:
      return launch_f32_d<512, 32>(p, batch, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T>
int launch(const Params& p, int batch, cudaStream_t stream) {
  switch (mma_template(p.dim_pad)) {
    case 48:
      return launch_mma<T, 48>(p, batch, stream);
    case 64:
      return launch_mma<T, 64>(p, batch, stream);
    case 80:
      return launch_mma<T, 80>(p, batch, stream);
    case 128:
      return launch_mma<T, 128>(p, batch, stream);
    default:
      break;
  }
  return p.dim_pad <= 256 ? launch_wgmma<T, 256>(p, batch, stream) : launch_wgmma<T, 512>(p, batch, stream);
}

// The fields every entry sets: operands, sizes, the (batch, head, row)
// strides of q, k, v and o (12 values, in elements), the scale; no bias, no
// lse, no mask.
Params base_params(const void* q, const void* k, const void* v, void* o, int heads, int head_dim, int q_len,
                   int kv_len, const long long* strides, float scale) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.heads = heads;
  p.head_dim = head_dim;
  p.dim_pad = (head_dim + 15) / 16 * 16;
  p.q_len = q_len;
  p.kv_len = kv_len;
  long long* const fields[] = {&p.q_bs, &p.q_hs, &p.q_rs, &p.k_bs, &p.k_hs, &p.k_rs,
                               &p.v_bs, &p.v_hs, &p.v_rs, &p.o_bs, &p.o_hs, &p.o_rs};
  for (int i = 0; i < 12; ++i) *fields[i] = strides[i];
  p.scale = scale;
  return p;
}

bool valid_sizes(int batch, int heads, int head_dim, int kv_len) {
  return head_dim > 0 && head_dim <= 512 && head_dim % 8 == 0 && batch > 0 && heads > 0 && kv_len > 0;
}

int run(const Params& p, int dtype, int batch, void* stream) {
  if (p.q_len <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<__nv_bfloat16>(p, batch, s);
    case 1:
      return launch<__half>(p, batch, s);
    case 2:
      return launch_f32(p, batch, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// The entries return a cudaError_t value (0 on success), launch on `stream`,
// do not synchronize and allocate nothing. dtype: 0 = bfloat16,
// 1 = float16, 2 = float32.

// K1/K2. `strides` holds 16 values in elements: (batch, head, row) for q, k,
// v and o, then (batch, head, row, column) for the bias. `bias` and `lse`
// may be null; lse is (batch*heads, q_len) float32.
extern "C" int refiners_flash_attention_forward(const void* q, const void* k, const void* v, void* o,
                                                const float* bias, float* lse, int dtype, int batch, int heads,
                                                int head_dim, int q_len, int kv_len, const long long* strides,
                                                float scale, int causal, void* stream) {
  if (!valid_sizes(batch, heads, head_dim, kv_len)) return int(cudaErrorInvalidValue);
  Params p = base_params(q, k, v, o, heads, head_dim, q_len, kv_len, strides, scale);
  p.bias = bias;
  p.lse = lse;
  p.bias_bs = strides[12];
  p.bias_hs = strides[13];
  p.bias_rs = strides[14];
  p.bias_cs = strides[15];
  p.causal = causal;
  return run(p, dtype, batch, stream);
}

// K3: the relative-position bias of a kh x kw key grid (kh * kw = kv_len,
// each side at most kMaxRelPosSide); `vrel` (q_len, kh) and `hrel`
// (q_len, kw) per head, in the input type, unit stride along their last dim.
// `strides` holds 18 values in elements: (batch, head, row) for q, k, v, o,
// vrel and hrel. No mask, no lse.
extern "C" int refiners_flash_attention_relpos_forward(const void* q, const void* k, const void* v, void* o,
                                                       const void* vrel, const void* hrel, int dtype, int batch,
                                                       int heads, int head_dim, int q_len, int kv_len, int kh,
                                                       int kw, const long long* strides, float scale,
                                                       void* stream) {
  if (!valid_sizes(batch, heads, head_dim, kv_len) || vrel == nullptr || hrel == nullptr || kh <= 0 || kw <= 0 ||
      kh > kMaxRelPosSide || kw > kMaxRelPosSide || (long long)kh * kw != kv_len) {
    return int(cudaErrorInvalidValue);
  }
  Params p = base_params(q, k, v, o, heads, head_dim, q_len, kv_len, strides, scale);
  p.vrel = vrel;
  p.hrel = hrel;
  p.kw = kw;
  p.vrel_bs = strides[12];
  p.vrel_hs = strides[13];
  p.vrel_rs = strides[14];
  p.hrel_bs = strides[15];
  p.hrel_hs = strides[16];
  p.hrel_rs = strides[17];
  return run(p, dtype, batch, stream);
}
