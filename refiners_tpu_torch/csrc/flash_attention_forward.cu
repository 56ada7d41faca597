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
// type before the PV product; O divided by the row sum at the end, cast to
// the input type. The bias takes one of three compile-time modes:
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
//   any kw is taken and there is no fallback.
// Masked scores are -1e30 (not -inf), so a causal row with no admissible key
// gets uniform weights over the keys, as the TPU kernel does; keys past the
// sequence end do not take part. With an lse pointer the kernel also writes
// m + log(l) per row, float32, laid out (batch*heads, q_len): the residual
// the backward kernels recompute P from.
//
// What bounds it on the H100: at seq >= 1024 the work is 4*L^2*d flops
// against 4*L*d bytes per head, so tensor-core throughput (989 TFLOP/s in
// bf16), and beside it the softmax: one exp2 per score on the SM's 16
// MUFU lanes a clock, which at d = 64 takes as long as the two products.
// A dense bias adds a float32 read per score, which makes a biased call bound
// by that read; the relative-position bias adds two reads per score from
// shared memory.
//
// Three kernels, picked by the dtype and the head dim (`forward_kernel`);
// a bias of either kind and the lse output are modes of each:
//
// - bfloat16 and float16, head_dim <= 128 (K1 at the SDXL UNet's d = 64 and
//   SD1.5's d = 40/80 inference sites, K2 at SD1.5's training sites with
//   the lse, every K3 call): `flash_fwd_narrow_kernel`, compiled for padded
//   head dims 64, 80 and 128. A block is 128 query rows: two
//   warpgroups of 64 rows, each holding its O (m64nD, float32) and softmax
//   statistics in registers. K and V tiles of 64 or 128 keys (kNarrowKeys)
//   arrive by TMA in a three-stage ring ("full" mbarriers with transaction
//   counts), shared by both warpgroups, so every K/V byte read from L2
//   serves 128 rows; the last warp done with a stage starts its refill, so
//   there is no producer warp and 256 threads may use up to 255 registers
//   each. Each warpgroup runs tile j's softmax while tile j - 1's P V is on
//   the tensor cores, and the two take turns to issue their products
//   (ping-pong), so one's softmax overlaps the other's products. S = Q K^T
//   runs on wgmma from shared memory (K-major) over ceil(d / 16) steps of
//   16, so the zero columns past d cost nothing there; O += P V on wgmma
//   with P from the S accumulators in registers and V MN-major through the
//   transpose bit (no transposed copy). The softmax is in base 2: scale *
//   log2(e) is folded into one multiply-add per score, exp2 is the MUFU
//   instruction, and O is rescaled only when a row's maximum moved. Tiles
//   are whole 64-column boxes with the 128-byte swizzle plus 16-column
//   boxes with the 32-byte swizzle (hopper::Tile): d = 80 (SAM-H, SD1.5's
//   32x32 site) is one of each, P V two products (n64 and n16). d <= 64
//   (SD1.5's d = 40 at its 64x64 site) runs the D = 64 instance. The bias
//   modes:
//   - dense (K2): each thread reads its own entries in place through L1, 8
//     bytes (a column pair) a load where the strides allow, issued before
//     it waits for S so that the read overlaps the product; a stride of 0
//     (torch.broadcast_to) reads one value for many. The bias is folded in
//     times log2(e) before the row maximum, raised to -1e30 first (a
//     float32 mask value such as -3.4e38 would overflow to -inf times
//     log2(e)), and causally masked pairs are -1e30 log2(e): -1e30 in
//     natural units, as a -1e30 bias is.
//   - relative position (K3): each block stages its 128 rows of v_rel and
//     h_rel in shared memory as float32 times log2(e) (odd row pitch: the
//     8 rows a warp reads at one column fall in distinct banks), 65 KiB at
//     SAM-H's 64 x 64 grid; for each accumulator column the thread keeps
//     its key's offset (o / kw, o % kw) in the grid, computed once, and the
//     tile's first key as counters that advance by (64 / kw, 64 % kw) per
//     tile, so the inner loop has one compare and no division or remainder
//     per score. Grids whose tables exceed 96 KiB (kh + kw past about 190)
//     read v_rel and h_rel in place through L1 with the same counters.
//   The lse is the row's base-2 max and sum turned to natural-log units,
//   written once per row at the end.
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
      hopper::wgmma_ss<T, 64>(s, hopper::kmajor_desc(sq + off), hopper::kmajor_desc(sk + off), kk > 0);
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
  if (!hopper::encode_map(&tq, bf16, p.q, p.head_dim, p.q_len, p.heads, batch, p.q_rs, p.q_hs, p.q_bs, hopper::kBox) ||
      !hopper::encode_map(&tk, bf16, p.k, p.head_dim, p.kv_len, p.heads, batch, p.k_rs, p.k_hs, p.k_bs, hopper::kBox) ||
      !hopper::encode_map(&tv, bf16, p.v, p.head_dim, p.kv_len, p.heads, batch, p.v_rs, p.v_hs, p.v_bs, hopper::kBox)) {
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
// head_dim <= 128: wgmma and TMA, two consumer warpgroups sharing a K/V ring
// ---------------------------------------------------------------------------

constexpr int kNarrowRows = 2 * kTile;          // query rows per block, 64 per warpgroup
constexpr int kNarrowThreads = 2 * kWarpgroup;  // two warpgroups
constexpr int kNarrowWarps = kNarrowThreads / 32;
constexpr int kNarrowStages = 3;                // depth of the K/V ring
// bytes of the block's two relative-position tables (128 rows of v_rel and
// of h_rel, float32) that shared memory holds; wider key grids read them
// through L1
constexpr int kMaxRelPosTableBytes = 96 * 1024;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// a masked score in base-2 units: -1e30 in natural ones, as a -1e30 bias
// also lands, so that a row whose keys are all masked by either gets the
// plain version's uniform weights and lse
constexpr float kMaskedScore2 = kMaskedScore * kLog2e;
// named barriers: 1 + g, warpgroup g's rows of the tables are staged; 3 + g,
// warpgroup g's turn to issue its products
constexpr int kBarTables = 1;
constexpr int kBarTurn = 3;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Keys per tile of the narrow kernel: 128 at D = 80 and 128 without a bias,
// so that S is one m64n128 product per 16 columns, which reads its two
// shared-memory operands at 96 bytes a clock at full rate where m64n64
// needs 128, all the SM has; 64 at D = 64, where the 128-key tile
// measured slower on the H100 (at D = 64), and with a bias, whose reads
// (and, for the relative position, per-column offsets) need the registers.
template <int D, int kBias>
constexpr int kNarrowKeys = kBias == kNoBias && D > 64 ? 128 : 64;

// Shared memory of the narrow kernel, in bytes from a 1024-byte-aligned
// base: Q as two 64-row tiles, one per warpgroup; the BK-row K tiles and V
// tiles of the ring; the mbarriers (Q; then K full and V full for each
// stage) and each stage's running count of warps done with it; the
// relative-position tables.
template <int D, int BK>
struct NarrowSmem {
  using QTile = hopper::Tile<D, kTile>;
  using KVTile = hopper::Tile<D, BK>;
  static constexpr int q = 0;
  static constexpr int k = 2 * QTile::kBytes;
  static constexpr int v = k + kNarrowStages * KVTile::kBytes;
  static constexpr int bars = v + kNarrowStages * KVTile::kBytes;
  static constexpr int done = bars + (1 + 2 * kNarrowStages) * 8;
  static constexpr int tables = done + kNarrowStages * 4;
  static constexpr int bytes = tables + hopper::kSwizzleAtomBytes;  // + room to align the base
  static_assert(bytes + (BK == 64 ? kMaxRelPosTableBytes : 0) <= int(kMaxSharedBytes),
                "narrow forward tiles exceed shared memory");
};

// How the narrow kernel walks its bias, computed once on the host. The
// relative-position bias's key grid: a key tile is step_q grid rows and
// step_r columns; the tables' row pitches in shared memory, in floats (odd,
// so the 8 rows a warp reads at one column fall in distinct banks), or
// in_smem = 0 to read v_rel and h_rel in place. The dense bias: pairs = 1
// when each thread's column pair is one aligned 8-byte load (unit column
// stride, even row, head and batch strides, an even key count).
struct BiasWalk {
  int kh, step_q, step_r, pitch_v, pitch_h, in_smem, pairs;
};

// Copy rows [row0, row0 + 64) of a relative-position table (`cols` values a
// row, row stride `stride`) into shared memory as float32 times log2(e), at
// row pitch `pitch`, by one warpgroup, eight loads in flight a thread; rows
// past `rows` are zeros.
template <typename T>
__device__ __forceinline__ void stage_table(float* dst, int pitch, const T* src, long long stride, int cols, int row0,
                                            int rows, int tid) {
  const int n = kTile * cols;
  for (int i0 = tid; i0 < n; i0 += 8 * kWarpgroup) {
    float x[8];
    #pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * kWarpgroup, r = i / cols;
      x[u] = i < n && row0 + r < rows ? to_float(__ldg(src + (long long)(row0 + r) * stride + i - r * cols)) : 0.f;
    }
    #pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * kWarpgroup, r = i / cols;
      if (i < n) dst[r * pitch + i - r * cols] = x[u] * kLog2e;
    }
  }
}

// One block of 256 threads per (128 query rows, batch*head), a loop over key
// tiles of BK: two warpgroups of 64 query rows each, reading the same K and
// V tiles from a ring of kNarrowStages stages. Thread 0 loads Q and the
// first tiles with TMA, each tile onto its stage's "full" mbarriers; after
// that, the last of the 8 warps to be done with a stage (a count in shared
// memory) starts the loads of the tile it holds next, so no warp waits for
// another and none is set aside to load. Each warpgroup computes S = Q K^T
// with wgmma from shared memory (K-major, ceil(d / 16) steps of 16; m64n128
// without a bias at D = 80 and 128), runs the online softmax in registers
// in base 2 (scale and log2(e) folded into one multiply-add), adds the bias
// of its mode, and accumulates O += P V with wgmma, P from registers, V
// MN-major through the transpose bit: n64 or n128 over the whole boxes,
// n16 (D = 80) over the narrow one. Tile j's softmax runs
// while tile j - 1's P V is on the tensor cores, so a stage is free one
// tile later than it would be without the overlap: the ring has three
// stages. The bias modes:
// - dense: each thread reads its entries of the float32 bias in place
//   through L1 (8-byte column pairs where the layout allows), issued before
//   it waits for S, and adds them times log2(e) before the row maximum;
// - relative position: the block's rows of v_rel and h_rel staged in
//   shared memory, walked by counters that advance with the tile (no
//   division or remainder per score).
// With an lse pointer, each row's (m + log2 l) ln 2 is written at the end.
template <typename T, int D, int kBias>
__global__ void __launch_bounds__(kNarrowThreads, 1)
    flash_fwd_narrow_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tq16,
                            const __grid_constant__ CUtensorMap tk16, const __grid_constant__ CUtensorMap tv16,
                            const Params p, const BiasWalk walk) {
  constexpr int BK = kNarrowKeys<D, kBias>;
  using L = NarrowSmem<D, BK>;
  using QTile = typename L::QTile;
  using KVTile = typename L::KVTile;
  constexpr int kMainN = KVTile::kMainN;  // O columns in the whole boxes (n64/n128 accumulator)
  constexpr int kRemN = KVTile::kRemN;    // in the narrow box (n16 accumulator)
  constexpr int kO = kMainN > 0 ? kMainN / 2 : 1;
  constexpr int kORem = kRemN > 0 ? kRemN / 2 : 1;
  extern __shared__ unsigned char smem_raw[];
  // aligned by an offset from the array, so that the compiler knows every
  // pointer below to be shared memory (the tables are read with ld.shared)
  constexpr uint32_t kAlign = hopper::kSwizzleAtomBytes;
  unsigned char* smem = smem_raw + (kAlign - hopper::smem_u32(smem_raw) % kAlign) % kAlign;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bars);
  int* done = reinterpret_cast<int*>(smem + L::done);
  const uint32_t qbar = hopper::smem_u32(bars);
  const uint32_t kfull0 = hopper::smem_u32(bars + 1);
  const uint32_t vfull0 = hopper::smem_u32(bars + 1 + kNarrowStages);
  const uint32_t sq0 = hopper::smem_u32(smem + L::q);
  const uint32_t sk0 = hopper::smem_u32(smem + L::k);
  const uint32_t sv0 = hopper::smem_u32(smem + L::v);
  const int b = blockIdx.y / p.heads;
  const int h = blockIdx.y % p.heads;
  const int q0 = blockIdx.x * kNarrowRows;
  const int n_tiles = (p.kv_len + BK - 1) / BK;

  // K_j and V_j into stage j % kNarrowStages, each onto its full mbarrier
  auto load_kv = [&](int j) {
    const int s = j % kNarrowStages;
    hopper::mbar_expect_tx(kfull0 + 8 * s, KVTile::kBytes);
    hopper::load_tile<D, BK>(&tk, &tk16, kfull0 + 8 * s, sk0 + s * KVTile::kBytes, j * BK, h, b);
    hopper::mbar_expect_tx(vfull0 + 8 * s, KVTile::kBytes);
    hopper::load_tile<D, BK>(&tv, &tv16, vfull0 + 8 * s, sv0 + s * KVTile::kBytes, j * BK, h, b);
  };
  if (threadIdx.x == 0) {
    hopper::mbar_init(qbar, 1);
    for (int s = 0; s < kNarrowStages; ++s) {
      hopper::mbar_init(kfull0 + 8 * s, 1);
      hopper::mbar_init(vfull0 + 8 * s, 1);
      done[s] = 0;
    }
    hopper::fence_barrier_init();
    hopper::mbar_expect_tx(qbar, 2 * QTile::kBytes);
    hopper::load_tile<D, kTile>(&tq, &tq16, qbar, sq0, q0, h, b);
    hopper::load_tile<D, kTile>(&tq, &tq16, qbar, sq0 + QTile::kBytes, q0 + kTile, h, b);
    for (int j = 0; j < kNarrowStages && j < n_tiles; ++j) load_kv(j);
  }
  __syncthreads();

  const int g = threadIdx.x / kWarpgroup;
  const int tid = threadIdx.x % kWarpgroup;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int t = lane % 4;
  const int local_a = g * kTile + warp * 16 + lane / 4;  // this thread's accumulator rows in the block
  const int row_a = q0 + local_a;
  const int row_b = row_a + 8;
  const int causal_shift = p.kv_len - p.q_len;
  const float scale_log2 = p.scale * kLog2e;
  const int ksteps = (p.head_dim + 15) / 16;
  const uint32_t sq = sq0 + g * QTile::kBytes;

  // relative-position bias: the rows of the tables this thread reads, in
  // shared memory (offsets into `tables`) or in place (pointers), and each
  // accumulator column's offset in the key grid, (o / kw) << 16 | o % kw for
  // o = 8n + 2t + c, computed once; (bq, br) is the tile's first key
  const float* tables = reinterpret_cast<const float*>(smem + L::tables);
  int va = 0, vb = 0, ha = 0, hb = 0;
  const T* gva = nullptr;
  const T* gvb = nullptr;
  const T* gha = nullptr;
  const T* ghb = nullptr;
  int offset[kBias == kRelPosBias ? BK / 8 : 1][2];
  int bq = 0, br = 0;
  if constexpr (kBias == kRelPosBias) {
    const HeadBias<T> rel = head_bias<T>(p, b, h);
    if (walk.in_smem) {
      float* sv = reinterpret_cast<float*>(smem + L::tables);
      float* sh = sv + kNarrowRows * walk.pitch_v;
      // this warpgroup's 64 rows
      const int row0 = q0 + g * kTile;
      stage_table(sv + g * kTile * walk.pitch_v, walk.pitch_v, rel.vrel, p.vrel_rs, walk.kh, row0, p.q_len, tid);
      stage_table(sh + g * kTile * walk.pitch_h, walk.pitch_h, rel.hrel, p.hrel_rs, p.kw, row0, p.q_len, tid);
      hopper::bar_sync(kBarTables + g, kWarpgroup);
      va = local_a * walk.pitch_v;
      vb = va + 8 * walk.pitch_v;
      ha = kNarrowRows * walk.pitch_v + local_a * walk.pitch_h;
      hb = ha + 8 * walk.pitch_h;
    } else {
      const long long ra = min(row_a, p.q_len - 1), rb = min(row_b, p.q_len - 1);
      gva = rel.vrel + ra * p.vrel_rs;
      gvb = rel.vrel + rb * p.vrel_rs;
      gha = rel.hrel + ra * p.hrel_rs;
      ghb = rel.hrel + rb * p.hrel_rs;
    }
    #pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      #pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int o = n * 8 + 2 * t + c;
        offset[n][c] = (o / p.kw) << 16 | o % p.kw;
      }
    }
  }

  // dense bias: this thread's two rows of it (rows past the end read the
  // last row, and are never stored)
  const float* bias_a = nullptr;
  const float* bias_b = nullptr;
  if constexpr (kBias == kDenseBias) {
    const float* rows = p.bias + b * p.bias_bs + h * p.bias_hs;
    bias_a = rows + (long long)min(row_a, p.q_len - 1) * p.bias_rs;
    bias_b = rows + (long long)min(row_b, p.q_len - 1) * p.bias_rs;
  }
  // tile j's dense bias at this thread's accumulator entries ([n][row]
  // holds columns 8n + 2t and 8n + 2t + 1), zero past the last key
  constexpr int kBiasN = kBias == kDenseBias ? BK / 8 : 1;
  auto load_bias = [&](float2 (&bv)[kBiasN][2], int j) {
    if constexpr (kBias == kDenseBias) {
      #pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const int col = j * BK + n * 8 + 2 * t;
        const bool in0 = col < p.kv_len, in1 = col + 1 < p.kv_len;
        if (walk.pairs) {
          const float2 zero = make_float2(0.f, 0.f);
          bv[n][0] = in0 ? __ldg(reinterpret_cast<const float2*>(bias_a + col)) : zero;
          bv[n][1] = in0 ? __ldg(reinterpret_cast<const float2*>(bias_b + col)) : zero;
        } else {
          const long long c0 = col * p.bias_cs, c1 = c0 + p.bias_cs;
          bv[n][0] = make_float2(in0 ? __ldg(bias_a + c0) : 0.f, in1 ? __ldg(bias_a + c1) : 0.f);
          bv[n][1] = make_float2(in0 ? __ldg(bias_b + c0) : 0.f, in1 ? __ldg(bias_b + c1) : 0.f);
        }
      }
    }
  };

  float o[kO];
  float orem[kORem];
  #pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.f;
  #pragma unroll
  for (int i = 0; i < kORem; ++i) orem[i] = 0.f;
  // running maxima, in base-2 units (the first tile always holds a key, so
  // they are finite from then on), and this thread's share of the row sums
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  // S = Q K_j^T over the 16-column steps that hold head columns, issued
  // once K_j has landed; not waited for
  auto issue_qk = [&](float (&s)[BK / 2], int j) {
    const int stage = j % kNarrowStages;
    const uint32_t sk = sk0 + stage * KVTile::kBytes;
    hopper::mbar_wait(kfull0 + 8 * stage, (j / kNarrowStages) & 1);
    hopper::fence_regs(s);
    hopper::wgmma_fence();
    #pragma unroll
    for (int kk = 0; kk < KVTile::kSteps; ++kk) {
      if (kk > 0 && kk >= ksteps) break;
      hopper::wgmma_ss<T, BK>(s, QTile::kmajor(sq, kk), KVTile::kmajor(sk, kk), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::fence_regs(s);
  };

  // O += P V_j, issued once V_j has landed; not waited for
  auto issue_pv = [&](const uint32_t (&pa)[BK / 16][4], int j) {
    const int stage = j % kNarrowStages;
    const uint32_t sv = sv0 + stage * KVTile::kBytes;
    hopper::mbar_wait(vfull0 + 8 * stage, (j / kNarrowStages) & 1);
    hopper::fence_regs(o);
    hopper::fence_regs(orem);
    hopper::wgmma_fence();
    #pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      if constexpr (kMainN > 0) hopper::wgmma_rs<T, kMainN>(o, pa[kc], KVTile::mn_main(sv, kc));
      if constexpr (kRemN > 0) hopper::wgmma_rs<T, kRemN>(orem, pa[kc], KVTile::mn_rem(sv, kc));
    }
    hopper::wgmma_commit();
    hopper::fence_regs(o);
    hopper::fence_regs(orem);
  };

  // tile j's scores in s → its P in pa (the A operand of each 16-key step),
  // the running maxima and sums updated, alpha the factor that rescales O
  auto softmax = [&](float (&s)[BK / 2], int j, const float2 (&bv)[kBiasN][2], uint32_t (&pa)[BK / 16][4],
                     float (&alpha)[2]) {
    // scores in base 2 with the bias and the masks; a row's BK scores are
    // spread over the 4 lanes of a quad. Maxima and sums run in two
    // independent chains a row (by column parity c), which halves their
    // dependent latency
    float mx[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
    auto score_tile = [&](auto masked, auto from_smem) {
      #pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        #pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = j * BK + n * 8 + 2 * t + c;
          const bool valid = !decltype(masked)::value || col < p.kv_len;
          float bias_a = 0.f, bias_b = 0.f;
          if constexpr (kBias == kDenseBias) {
            bias_a = fmaxf(c ? bv[n][0].y : bv[n][0].x, kMaskedScore) * kLog2e;
            bias_b = fmaxf(c ? bv[n][1].y : bv[n][1].x, kMaskedScore) * kLog2e;
          }
          if constexpr (kBias == kRelPosBias) {
            if (valid) {
              int kq = bq + (offset[n][c] >> 16), kr = br + (offset[n][c] & 0xffff);
              if (kr >= p.kw) {
                kr -= p.kw;
                ++kq;
              }
              if constexpr (decltype(from_smem)::value) {
                bias_a = tables[va + kq] + tables[ha + kr];
                bias_b = tables[vb + kq] + tables[hb + kr];
              } else {
                bias_a = (to_float(__ldg(gva + kq)) + to_float(__ldg(gha + kr))) * kLog2e;
                bias_b = (to_float(__ldg(gvb + kq)) + to_float(__ldg(ghb + kr))) * kLog2e;
              }
            }
          }
          float xa = fmaf(s[4 * n + c], scale_log2, bias_a);
          float xb = fmaf(s[4 * n + 2 + c], scale_log2, bias_b);
          if constexpr (decltype(masked)::value) {
            if (!valid) {
              xa = xb = -INFINITY;
            } else if (p.causal) {
              if (col > row_a + causal_shift) xa = kMaskedScore2;
              if (col > row_b + causal_shift) xb = kMaskedScore2;
            }
          }
          s[4 * n + c] = xa;
          s[4 * n + 2 + c] = xb;
          mx[0][c] = fmaxf(mx[0][c], xa);
          mx[1][c] = fmaxf(mx[1][c], xb);
        }
      }
    };
    auto score = [&](auto masked) {
      if constexpr (kBias == kRelPosBias) {
        if (walk.in_smem) {
          score_tile(masked, std::true_type{});
        } else {
          score_tile(masked, std::false_type{});
        }
      } else {
        score_tile(masked, std::false_type{});
      }
    };
    if (!p.causal && (j + 1) * BK <= p.kv_len) {
      score(std::false_type{});
    } else {
      score(std::true_type{});
    }
    if constexpr (kBias == kRelPosBias) {
      bq += walk.step_q;
      br += walk.step_r;
      if (br >= p.kw) {
        br -= p.kw;
        ++bq;
      }
    }

    #pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = fmaxf(mx[r][0], mx[r][1]);
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      const float m_new = fmaxf(m[r], x);
      alpha[r] = fast_exp2(m[r] - m_new);
      m[r] = m_new;
    }
    float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    #pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const float pe = fast_exp2(s[i] - m[(i >> 1) & 1]);
      s[i] = pe;
      sum[(i >> 1) & 1][i & 1] += pe;
    }
    #pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], alpha[r], sum[r][0] + sum[r][1]);
    #pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) acc_to_a<T>(pa[kc], s + 8 * kc, s + 8 * kc + 4);
  };

  // this warp is done with tile j's stage; the last of the 8 refills it
  auto release = [&](int j) {
    __syncwarp();
    if (lane == 0 && atomicAdd(done + j % kNarrowStages, 1) % kNarrowWarps == kNarrowWarps - 1 &&
        j + kNarrowStages < n_tiles) {
      load_kv(j + kNarrowStages);
    }
  };

  // Each warpgroup overlaps tile j's softmax with tile j - 1's P V: S_j and
  // P_{j-1} V_{j-1} are issued together (then tile j's dense bias is read),
  // the softmax waits for S_j only, and O is rescaled once P_{j-1} V_{j-1}
  // has landed (not at all when no row's maximum moved: the factor is then
  // exactly 1). P alternates between two register arrays (no copy lands
  // between two products, where ptxas would serialize them). The two
  // warpgroups take turns to issue their products (named barriers 3 and 4),
  // so that one's softmax runs while the other's products hold the tensor
  // cores.
  auto turn = [&] { hopper::bar_sync(kBarTurn + g, kNarrowThreads); };
  auto pass = [&](bool last) {
    if (g == 0 || !last) hopper::bar_arrive(kBarTurn + 1 - g, kNarrowThreads);
  };
  float s[BK / 2];
  float alpha[2];
  float2 bv[kBiasN][2];
  uint32_t pa[2][BK / 16][4];
  auto step = [&](int j, const uint32_t (&prev)[BK / 16][4], uint32_t (&cur)[BK / 16][4]) {
    turn();
    issue_qk(s, j);
    issue_pv(prev, j - 1);
    pass(false);
    load_bias(bv, j);
    hopper::wgmma_wait<1>();
    hopper::fence_regs(s);
    softmax(s, j, bv, cur, alpha);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    hopper::fence_regs(orem);
    release(j - 1);
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
      #pragma unroll
      for (int i = 0; i < kO; ++i) o[i] *= alpha[(i >> 1) & 1];
      #pragma unroll
      for (int i = 0; i < kORem; ++i) orem[i] *= alpha[(i >> 1) & 1];
    }
  };
  if (g == 1) hopper::bar_arrive(kBarTurn, kNarrowThreads);  // warpgroup 0 issues first
  hopper::mbar_wait(qbar, 0);
  turn();
  issue_qk(s, 0);
  pass(false);
  load_bias(bv, 0);
  hopper::wgmma_wait<0>();
  hopper::fence_regs(s);
  softmax(s, 0, bv, pa[0], alpha);
  for (int j = 1; j < n_tiles; j += 2) {
    step(j, pa[0], pa[1]);
    if (j + 1 < n_tiles) step(j + 1, pa[1], pa[0]);
  }
  turn();
  if (n_tiles & 1) {
    issue_pv(pa[0], n_tiles - 1);
  } else {
    issue_pv(pa[1], n_tiles - 1);
  }
  pass(true);
  hopper::wgmma_wait<0>();
  hopper::fence_regs(o);
  hopper::fence_regs(orem);

  #pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  T* oh = static_cast<T*>(p.o) + b * p.o_bs + h * p.o_hs;
  auto store = [&](int col, float a0, float a1, float b0, float b1) {
    if (col >= p.head_dim) return;
    if (row_a < p.q_len) {
      *reinterpret_cast<uint32_t*>(oh + (long long)row_a * p.o_rs + col) = pack2<T>(a0 / l[0], a1 / l[0]);
    }
    if (row_b < p.q_len) {
      *reinterpret_cast<uint32_t*>(oh + (long long)row_b * p.o_rs + col) = pack2<T>(b0 / l[1], b1 / l[1]);
    }
  };
  #pragma unroll
  for (int n = 0; n < kMainN / 8; ++n) store(n * 8 + 2 * t, o[4 * n], o[4 * n + 1], o[4 * n + 2], o[4 * n + 3]);
  #pragma unroll
  for (int n = 0; n < kRemN / 8; ++n) {
    store(kMainN + n * 8 + 2 * t, orem[4 * n], orem[4 * n + 1], orem[4 * n + 2], orem[4 * n + 3]);
  }
  // lse in natural-log units; a row whose every key is masked keeps the
  // -1e30 of its scores exactly, as the plain version gives it
  if (p.lse != nullptr && t == 0) {
    float* lse = p.lse + (long long)blockIdx.y * p.q_len;
    const int rows[2] = {row_a, row_b};
    #pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] < p.q_len) {
        lse[rows[r]] = m[r] == kMaskedScore2 ? kMaskedScore + logf(l[r]) : (m[r] + log2f(l[r])) * kLn2;
      }
    }
  }
}

// Row pitch of a float32 relative-position table of n columns: odd, so that
// 8 rows at one column fall in 8 distinct banks.
inline int table_pitch(int n) { return n | 1; }

// The six tensor maps (q, k, v: 64-column boxes, then 16-column boxes), the
// bias walk, and the launch of mode kBias.
template <typename T, int D, int kBias>
int launch_narrow_mode(const Params& p, int batch, cudaStream_t stream) {
  constexpr int BK = kNarrowKeys<D, kBias>;
  using L = NarrowSmem<D, BK>;
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  const void* bases[3] = {p.q, p.k, p.v};
  const int rows[3] = {p.q_len, p.kv_len, p.kv_len};
  const long long strides[3][3] = {{p.q_rs, p.q_hs, p.q_bs}, {p.k_rs, p.k_hs, p.k_bs}, {p.v_rs, p.v_hs, p.v_bs}};
  CUtensorMap maps[3][2];
  for (int i = 0; i < 3; ++i) {
    if (!hopper::encode_tile_maps(maps[i], bf16, bases[i], p.head_dim, rows[i], p.heads, batch, strides[i][0],
                                  strides[i][1], strides[i][2])) {
      return int(cudaErrorInvalidValue);
    }
  }
  BiasWalk walk = {};
  int bytes = L::bytes;
  if (kBias == kRelPosBias) {
    walk.kh = p.kv_len / p.kw;
    walk.step_q = BK / p.kw;
    walk.step_r = BK % p.kw;
    walk.pitch_v = table_pitch(walk.kh);
    walk.pitch_h = table_pitch(p.kw);
    const int table_bytes = kNarrowRows * (walk.pitch_v + walk.pitch_h) * int(sizeof(float));
    walk.in_smem = table_bytes <= kMaxRelPosTableBytes;
    if (walk.in_smem) bytes += table_bytes;
  }
  if (kBias == kDenseBias) {
    walk.pairs = p.bias_cs == 1 && p.kv_len % 2 == 0 && p.bias_bs % 2 == 0 && p.bias_hs % 2 == 0 &&
                 p.bias_rs % 2 == 0 && reinterpret_cast<uintptr_t>(p.bias) % 8 == 0;
  }
  auto kernel = flash_fwd_narrow_kernel<T, D, kBias>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return int(err);
  const dim3 blocks((p.q_len + kNarrowRows - 1) / kNarrowRows, batch * p.heads);
  kernel<<<blocks, kNarrowThreads, bytes, stream>>>(maps[0][0], maps[1][0], maps[2][0], maps[0][1], maps[1][1],
                                                    maps[2][1], p, walk);
  return int(cudaGetLastError());
}

template <typename T, int D>
int launch_narrow(const Params& p, int batch, cudaStream_t stream) {
  switch (bias_mode(p)) {
    case kRelPosBias:
      return launch_narrow_mode<T, D, kRelPosBias>(p, batch, stream);
    case kDenseBias:
      return launch_narrow_mode<T, D, kDenseBias>(p, batch, stream);
    default:
      return launch_narrow_mode<T, D, kNoBias>(p, batch, stream);
  }
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

// The kernel that serves a call: float32 on FFMA; bfloat16 and float16 with
// d > 128 on the wide wgmma kernel, with d <= 128 on the narrow one, with
// or without a bias of either kind and an lse output.
enum ForwardKernel { kNarrowKernel = 0, kWideKernel = 1, kF32Kernel = 2 };

int forward_kernel(int dtype, int dim_pad) {
  if (dtype == 2) return kF32Kernel;
  return dim_pad > 128 ? kWideKernel : kNarrowKernel;
}

template <typename T>
int launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int kDtype = std::is_same<T, __nv_bfloat16>::value ? 0 : 1;
  if (forward_kernel(kDtype, p.dim_pad) == kWideKernel) {
    return p.dim_pad <= 256 ? launch_wgmma<T, 256>(p, batch, stream) : launch_wgmma<T, 512>(p, batch, stream);
  }
  switch (narrow_template(p.dim_pad)) {
    case 64:
      return launch_narrow<T, 64>(p, batch, stream);
    case 80:
      return launch_narrow<T, 80>(p, batch, stream);
    default:
      return launch_narrow<T, 128>(p, batch, stream);
  }
}

// The fields every entry sets: operands, sizes, the (batch, head, row)
// strides of q, k, v and o (12 values, in elements), the scale; no bias, no
// lse, no mask. The head dim padded to 16, which picks the kernel's
// instance.
Params base_params(const void* q, const void* k, const void* v, void* o, int heads, int head_dim, int q_len,
                   int kv_len, const long long* strides, float scale) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.heads = heads;
  p.head_dim = head_dim;
  p.dim_pad = pad16(head_dim);
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

// Which kernel a call of the entries above launches (see ForwardKernel):
// 0 the narrow wgmma kernel, 1 the wide wgmma kernel, 2 float32 FFMA; -1
// for sizes the entries refuse. A bias of either kind and an lse output
// are modes of each kernel, so they do not change it.
extern "C" int refiners_flash_attention_forward_kernel(int dtype, int head_dim) {
  if (!valid_sizes(1, 1, head_dim, 1) || dtype < 0 || dtype > 2) return -1;
  return forward_kernel(dtype, pad16(head_dim));
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
