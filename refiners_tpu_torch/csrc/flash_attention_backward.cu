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
// As on the TPU there are two kernels and no atomics, so the gradients are
// deterministic: the dK/dV kernel owns a tile of keys and loops over the
// query tiles; the dQ kernel owns a tile of queries and loops over the key
// tiles. With `causal`, tiles that lie wholly above the diagonal are
// skipped. Heads are read through (batch, head, row) strides, so the packed
// (B, L, H*D) layout, the flat (B, H, L, D) layout and column slices of a
// fused projection all run in place. head_dim <= 512, a multiple of 8.
//
// bfloat16 and float16, head_dim <= 128: both kernels are warpgroup wgmma
// kernels on TMA, compiled for padded head dims 64, 80 and 128 (hopper::Tile: whole
// 64-column boxes with the 128-byte swizzle plus a 16-column box with the
// 32-byte swizzle, so d = 80 pays for 80 columns; d <= 64 runs the D = 64
// instance). A block is two warpgroups of 64 rows that own their operand
// tiles (loaded once by TMA) and their gradient accumulators (registers),
// while the other side's tiles stream through a three-stage TMA ring that
// the last of the block's 8 warps done with a stage refills. The two
// warpgroups take turns on the tensor cores, as the forward's narrow kernel
// does, and neither P nor dS ever goes through shared memory: each is
// computed in the accumulator of its product and packed there into a
// register A operand.
// - dK/dV (K4a): `flash_bwd_dkv_wgmma_kernel`, 128 keys a block, K and V
//   owned; Q and dO stream, lse and delta beside them by cp.async onto the
//   same mbarriers. S^T = K Q^T and dP^T = V dO^T from shared memory, so
//   P^T and dS^T come out as accumulators whose rows are keys, and feed
//   dV += P^T dO and dK += dS^T Q as register A operands (dO and Q read
//   MN-major through the transpose bit). Every Q and dO byte read from L2
//   serves 128 keys.
// - dQ (K4b): `flash_bwd_dq_wgmma_kernel`, 128 query rows a block, Q and dO
//   owned, each row's lse and delta in registers; K and V stream.
//   S = Q K^T and dP = dO V^T from shared memory, dS fed to dQ += dS K as a
//   register A operand (K read MN-major). Every K and V byte read from L2
//   serves 128 queries.
// - bfloat16 and float16, 128 < head_dim <= 512 (the SD1.5 and SDXL VAEs'
//   mid-block, one head of d = 512): `flash_bwd_wide_wgmma_kernel`, wgmma on
//   TMA, compiled for padded head dims 256 and 512 (zero columns past d).
//   A 64-row float32 gradient of 512 columns is half the SM's registers, so
//   a block of two warpgroups owns 64 rows of ONE gradient, split along d
//   between the warpgroups (m64n256, 128 floats a thread), as the wide
//   forward splits O. S and dP reduce over d: each warpgroup computes its
//   partial over its half with wgmma from shared memory, and the partials
//   meet in shared memory, after which P and dS are computed in the
//   accumulators and fed to the gradient's product as register A operands.
//   dQ blocks own Q and dO and stream K and V in 32-row tiles; the dK/dV
//   entry launches dK blocks (K and V owned, Q and dO streamed in 32-row
//   tiles, S^T and dP^T) and dV blocks (K owned, Q and dO streamed in 64-row
//   tiles, S^T alone) in one grid, so S^T is computed twice (10 L^2 d
//   flops for dK and dV against 8). Every streamed half is refilled by TMA
//   as soon as the last product that reads it has landed.
// - float32: the same two kernels on plain FFMA with 8 warps (P and dS
//   unrounded, float32 throughout), so the gradients keep float32 accuracy;
//   smaller tiles at d > 128.
//
// What bounds it on the H100: tensor-core throughput, as in the forward
// (the dK/dV kernel does 8*L^2*d flops per head, the dQ kernel 6*L^2*d),
// and beside it the exp2 of every P entry on the MUFU, which each narrow
// kernel computes once. The wide kernel does 10*L^2*d for dK and dV and
// keeps its two warpgroups in step (the partials' exchange every tile), so
// each tile's products, exchange, exp2 and loads follow one another; on the
// H100 at d = 512 that holds it near 0.3 of the tensor cores' rate
// (PERF.md). With 64 rows a warpgroup, the dK/dV kernel holds 64 x D
// float32 of dK and of dV per warpgroup in registers (D floats a thread),
// two 64 x 64 score tiles and their packed A operands: 224 values at
// D = 128, which ptxas fits in 254 of the 255 registers a thread of a
// 256-thread block may use; the dQ kernel holds one gradient, so it can
// afford 128-key score tiles up to D = 80.

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

// ---------------------------------------------------------------------------
// dK and dV, bfloat16 and float16: wgmma and TMA
// ---------------------------------------------------------------------------

constexpr size_t kMaxSharedBytes = 232448;  // 227 KB per block on Hopper
constexpr int kWarpgroup = 128;
// both wgmma kernels: blocks of two warpgroups, 64 rows each (keys for
// dK/dV, query rows for dQ), and a TMA ring of three stages
constexpr int kThreads = 2 * kWarpgroup;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockRows = 2 * kTile;
constexpr int kStages = 3;
// named barriers: 1 + g, warpgroup g's turn to issue its products
constexpr int kBarTurn = 1;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory of the dK/dV kernel at padded head dim D, in bytes from a
// 1024-byte-aligned base: K and V as two 64-row tiles each (one per
// warpgroup, loaded once); the ring's Q tiles, then its dO tiles; each
// stage's 64 lse values and 64 delta values (float32); the mbarriers (K and
// V; then each stage's full barrier) and each stage's running count of
// warps done with it.
template <int D>
struct DkvSmem {
  using Tile = hopper::Tile<D, kTile>;
  static constexpr int k = 0;
  static constexpr int v = 2 * Tile::kBytes;
  static constexpr int q = 4 * Tile::kBytes;
  static constexpr int dout = q + kStages * Tile::kBytes;
  static constexpr int rows = dout + kStages * Tile::kBytes;
  static constexpr int kRowBytes = 2 * kTile * 4;  // a stage's lse and delta
  static constexpr int bars = rows + kStages * kRowBytes;
  static constexpr int done = bars + (1 + kStages) * 8;
  static constexpr int bytes = done + kStages * 4 + hopper::kSwizzleAtomBytes;  // + room to align the base
  static_assert(bytes <= int(kMaxSharedBytes), "dK/dV tiles exceed shared memory");
};

// One block of 256 threads per (128 keys, batch*head), a loop over the
// query tiles of 64 that see any of its keys. Warpgroup g owns keys
// [64g, 64g + 64) of the block: its K and V rows stay in shared memory
// (K-major A operands) and its dK and dV accumulators (64 x D, float32) in
// registers. Q and dO of each query tile arrive by TMA in a ring of
// kStages stages, lse and delta beside them by cp.async, one full
// mbarrier a stage, shared by both warpgroups; the last of the 8 warps done
// with a stage starts the loads of the tile it holds next. Per tile i, a
// warpgroup issues in one turn
//   S^T = K Q^T and dP^T = V dO^T (wgmma, both operands in shared memory,
//     K-major, ceil(d / 16) steps of 16), then tile i - 1's
//   dV += P^T dO and dK += dS^T Q (wgmma, A from registers, B the stage's
//     dO or Q tile MN-major through the transpose bit),
// computes P^T = exp2(S^T scale log2(e) - lse log2(e)) and
// dS^T = P^T (dP^T - delta) (lse and delta per accumulator column, from
// shared memory) in the S^T and dP^T accumulators once those have landed,
// while tile i - 1's products run, and packs them to the input type in the
// layout of a register A operand once those have landed too: neither P nor
// dS is ever written to shared memory, and no extra registers hold a second
// copy. The two warpgroups take turns to issue (ping-pong), so that one's
// P and dS run while the other's products hold the tensor cores. Masks are
// applied only on tiles that need them (the ragged last tile, the causal
// diagonal); query rows past the end and zero-filled K rows past the end
// contribute nothing, and rows past the end are never stored.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                               const __grid_constant__ CUtensorMap tq16, const __grid_constant__ CUtensorMap tk16,
                               const __grid_constant__ CUtensorMap tv16, const __grid_constant__ CUtensorMap tdo16,
                               const BwdParams p) {
  using L = DkvSmem<D>;
  using Tile = typename L::Tile;
  constexpr int kMainN = Tile::kMainN;  // gradient columns in the whole boxes
  constexpr int kRemN = Tile::kRemN;    // in the narrow boxes
  constexpr int kAcc = kMainN > 0 ? kMainN / 2 : 1;
  constexpr int kAccRem = kRemN > 0 ? kRemN / 2 : 1;
  extern __shared__ unsigned char smem_raw[];
  constexpr uint32_t kAlign = hopper::kSwizzleAtomBytes;
  unsigned char* smem = smem_raw + (kAlign - hopper::smem_u32(smem_raw) % kAlign) % kAlign;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bars);
  int* done = reinterpret_cast<int*>(smem + L::done);
  float* stage_rows = reinterpret_cast<float*>(smem + L::rows);
  const uint32_t kvbar = hopper::smem_u32(bars);
  const uint32_t full0 = hopper::smem_u32(bars + 1);
  const uint32_t sk0 = hopper::smem_u32(smem + L::k);
  const uint32_t sv0 = hopper::smem_u32(smem + L::v);
  const uint32_t sq0 = hopper::smem_u32(smem + L::q);
  const uint32_t sdo0 = hopper::smem_u32(smem + L::dout);
  const int b = blockIdx.y / p.heads;
  const int h = blockIdx.y % p.heads;
  const int k0 = blockIdx.x * kBlockRows;
  const int shift = p.kv_len - p.q_len;  // causal: key k sees queries q >= k - shift
  const int n_q = (p.q_len + kTile - 1) / kTile;
  const int first_row = p.causal ? k0 - shift : 0;
  const int j0 = first_row > 0 ? min(first_row / kTile, n_q) : 0;
  const int n_tiles = n_q - j0;
  const float* lse_head = p.lse + (long long)blockIdx.y * p.q_len;
  const float* delta_head = p.delta + (long long)blockIdx.y * p.q_len;
  const int lane = threadIdx.x % 32;

  // query tile j0 + i into stage i % kStages, by one whole warp: lane 0
  // starts the TMA loads of Q and dO; every lane copies 2 of the tile's 64
  // lse values and 2 of its delta values with cp.async, which arrive on the
  // same full mbarrier (one arrival a lane), zeros past q_len. A head's lse
  // and delta start wherever q_len puts them, where a TMA copy would need
  // its start 16-byte aligned.
  auto load_q = [&](int i) {
    const int s = i % kStages;
    const int q0 = (j0 + i) * kTile;
    const uint32_t bar = full0 + 8 * s;
    if (lane == 0) {
      hopper::mbar_expect_tx(bar, 2 * Tile::kBytes);
      hopper::load_tile<D, kTile>(&tq, &tq16, bar, sq0 + s * Tile::kBytes, q0, h, b);
      hopper::load_tile<D, kTile>(&tdo, &tdo16, bar, sdo0 + s * Tile::kBytes, q0, h, b);
    }
    float* rows = stage_rows + s * 2 * kTile;
    #pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = lane + 32 * u;
      const bool in = q0 + r < p.q_len;
      cp_async4(rows + r, lse_head + (in ? q0 + r : 0), in);
      cp_async4(rows + kTile + r, delta_head + (in ? q0 + r : 0), in);
    }
    hopper::cp_async_mbar_arrive(bar);
    __syncwarp();
  };
  if (threadIdx.x == 0) {
    hopper::mbar_init(kvbar, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full0 + 8 * s, 1 + 32);  // lane 0's expect_tx, then every lane's copies
      done[s] = 0;
    }
    hopper::fence_barrier_init();
    hopper::mbar_expect_tx(kvbar, 4 * Tile::kBytes);
    for (int w = 0; w < 2; ++w) {
      hopper::load_tile<D, kTile>(&tk, &tk16, kvbar, sk0 + w * Tile::kBytes, k0 + w * kTile, h, b);
      hopper::load_tile<D, kTile>(&tv, &tv16, kvbar, sv0 + w * Tile::kBytes, k0 + w * kTile, h, b);
    }
  }
  if (threadIdx.x < 32) {
    __syncwarp();  // the barriers are initialized
    for (int i = 0; i < kStages && i < n_tiles; ++i) load_q(i);
  }
  __syncthreads();

  const int g = threadIdx.x / kWarpgroup;
  const int tid = threadIdx.x % kWarpgroup;
  const int t = lane % 4;
  const int key_a = k0 + g * kTile + (tid / 32) * 16 + lane / 4;  // this thread's accumulator rows are keys
  const int key_b = key_a + 8;
  const uint32_t sk = sk0 + g * Tile::kBytes;
  const uint32_t sv = sv0 + g * Tile::kBytes;
  const float scale_log2 = p.scale * kLog2e;
  const int ksteps = (p.head_dim + 15) / 16;

  float dk[kAcc], dkr[kAccRem], dv[kAcc], dvr[kAccRem];
  #pragma unroll
  for (int i = 0; i < kAcc; ++i) dk[i] = dv[i] = 0.f;
  #pragma unroll
  for (int i = 0; i < kAccRem; ++i) dkr[i] = dvr[i] = 0.f;
  float s[kTile / 2];   // S^T, then P^T
  float dp[kTile / 2];  // dP^T, then dS^T
  uint32_t pa[kTile / 16][4], da[kTile / 16][4];  // P^T and dS^T as A operands of 16 queries each

  // acc (64 keys x 64 queries) = A B^T over the head's 16-column steps, A
  // this warpgroup's K or V rows, B the stage's Q or dO tile; not committed
  auto issue_ss = [&](float (&acc)[kTile / 2], uint32_t a, uint32_t bt) {
    #pragma unroll
    for (int kk = 0; kk < Tile::kSteps; ++kk) {
      if (kk > 0 && kk >= ksteps) break;
      hopper::wgmma_ss<T, kTile>(acc, Tile::kmajor(a, kk), Tile::kmajor(bt, kk), kk > 0);
    }
  };
  // (acc, acc_rem) (64 keys x D) += X B, X (64 keys x 64 queries) from
  // registers, B the stage's dO or Q tile; not committed
  auto issue_rs = [&](float (&acc)[kAcc], float (&acc_rem)[kAccRem], const uint32_t (&x)[kTile / 16][4],
                      uint32_t bt) {
    #pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      if constexpr (kMainN > 0) hopper::wgmma_rs<T, kMainN>(acc, x[kc], Tile::mn_main(bt, kc));
      if constexpr (kRemN > 0) hopper::wgmma_rs<T, kRemN>(acc_rem, x[kc], Tile::mn_rem(bt, kc));
    }
  };
  auto fence_grads = [&] {
    hopper::fence_regs(dk);
    hopper::fence_regs(dkr);
    hopper::fence_regs(dv);
    hopper::fence_regs(dvr);
  };
  // dV += P^T dO and dK += dS^T Q of tile i, from pa and da; not committed
  auto issue_grads = [&](int i) {
    const int stage = i % kStages;
    issue_rs(dv, dvr, pa, sdo0 + stage * Tile::kBytes);
    issue_rs(dk, dkr, da, sq0 + stage * Tile::kBytes);
  };
  // this warp is done with tile i's stage; the last of the 8 refills it
  auto release = [&](int i) {
    __syncwarp();
    int last = 0;
    if (lane == 0) last = atomicAdd(done + i % kStages, 1) % kWarps == kWarps - 1;
    if (__shfl_sync(0xffffffffu, last, 0) && i + kStages < n_tiles) load_q(i + kStages);
  };
  // The two warpgroups take turns to issue their products (named barriers
  // 1 and 2), so that one's P and dS run while the other's products hold
  // the tensor cores.
  auto turn = [&] { hopper::bar_sync(kBarTurn + g, kThreads); };
  auto pass = [&](bool last) {
    if (g == 0 || !last) hopper::bar_arrive(kBarTurn + 1 - g, kThreads);
  };

  // Per tile i, one turn issues S^T_i = K Q_i^T and dP^T_i = V dO_i^T, then
  // tile i - 1's dV and dK products; P^T_i and dS^T_i are computed (as
  // floats, in the S^T and dP^T accumulators) once S^T_i and dP^T_i have
  // landed, while tile i - 1's products run, and packed into the A
  // operands once those have landed too.
  hopper::mbar_wait(kvbar, 0);
  if (n_tiles > 0) {
    if (g == 1) hopper::bar_arrive(kBarTurn, kThreads);  // warpgroup 0 issues first
    for (int i = 0; i < n_tiles; ++i) {
      const int stage = i % kStages;
      const int q0 = (j0 + i) * kTile;
      const float* lse = stage_rows + stage * 2 * kTile;
      const float* delta = lse + kTile;
      hopper::mbar_wait(full0 + 8 * stage, (i / kStages) & 1);
      turn();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      fence_grads();
      hopper::wgmma_fence();
      issue_ss(s, sk, sq0 + stage * Tile::kBytes);    // S^T = K Q^T
      issue_ss(dp, sv, sdo0 + stage * Tile::kBytes);  // dP^T = V dO^T
      hopper::wgmma_commit();
      if (i > 0) {
        issue_grads(i - 1);
        hopper::wgmma_commit();
      }
      pass(false);
      if (i > 0) {
        hopper::wgmma_wait<1>();  // S^T and dP^T have landed; tile i - 1's products may run on
      } else {
        hopper::wgmma_wait<0>();
      }
      hopper::fence_regs(s);
      hopper::fence_regs(dp);

      // P^T and dS^T; accumulator entry 4n + e is (key e < 2 ? key_a :
      // key_b, query q0 + 8n + 2t + (e & 1))
      const bool masked = q0 + kTile > p.q_len || (p.causal && k0 + kBlockRows - 1 > q0 + shift);
      #pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        const float2 lv = *reinterpret_cast<const float2*>(lse + 8 * n + 2 * t);
        const float2 dl = *reinterpret_cast<const float2*>(delta + 8 * n + 2 * t);
        #pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = e & 1;
          float pe = fast_exp2(fmaf(s[4 * n + e], scale_log2, -(c ? lv.y : lv.x) * kLog2e));
          if (masked) {
            const int q = q0 + 8 * n + 2 * t + c;
            if (q >= p.q_len || (p.causal && (e < 2 ? key_a : key_b) > q + shift)) pe = 0.f;
          }
          s[4 * n + e] = pe;
          dp[4 * n + e] = pe * (dp[4 * n + e] - (c ? dl.y : dl.x));
        }
      }
      hopper::wgmma_wait<0>();  // tile i - 1's products have landed: its stage, pa and da are free
      fence_grads();
      if (i > 0) release(i - 1);
      #pragma unroll
      for (int kc = 0; kc < kTile / 16; ++kc) {
        acc_to_a<T>(pa[kc], s + 8 * kc, s + 8 * kc + 4);
        acc_to_a<T>(da[kc], dp + 8 * kc, dp + 8 * kc + 4);
      }
    }
    turn();
    fence_grads();
    hopper::wgmma_fence();
    issue_grads(n_tiles - 1);
    hopper::wgmma_commit();
    pass(true);
    hopper::wgmma_wait<0>();
    fence_grads();
  }

  T* dkh = static_cast<T*>(p.dk) + b * p.dk_bs + h * p.dk_hs;
  T* dvh = static_cast<T*>(p.dv) + b * p.dv_bs + h * p.dv_hs;
  auto store = [&](int col, const float* k4, const float* v4) {
    if (col >= p.head_dim) return;
    if (key_a < p.kv_len) {
      *reinterpret_cast<uint32_t*>(dkh + (long long)key_a * p.dk_rs + col) = pack2<T>(k4[0] * p.scale, k4[1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvh + (long long)key_a * p.dv_rs + col) = pack2<T>(v4[0], v4[1]);
    }
    if (key_b < p.kv_len) {
      *reinterpret_cast<uint32_t*>(dkh + (long long)key_b * p.dk_rs + col) = pack2<T>(k4[2] * p.scale, k4[3] * p.scale);
      *reinterpret_cast<uint32_t*>(dvh + (long long)key_b * p.dv_rs + col) = pack2<T>(v4[2], v4[3]);
    }
  };
  #pragma unroll
  for (int n = 0; n < kMainN / 8; ++n) store(n * 8 + 2 * t, dk + 4 * n, dv + 4 * n);
  #pragma unroll
  for (int n = 0; n < kRemN / 8; ++n) store(kMainN + n * 8 + 2 * t, dkr + 4 * n, dvr + 4 * n);
}

// ---------------------------------------------------------------------------
// dQ, bfloat16 and float16: wgmma and TMA
// ---------------------------------------------------------------------------

// Keys per tile of the dQ kernel at padded head dim D: 128 up to D = 80,
// where S and dP are m64n128 products (fewer shared-memory bytes per
// product than m64n64) and the tile's 128 scores a row, their dS operands
// and the gradient fit in 240 and 248 registers; it measured 13-14 % faster
// than 64 keys at both SD1.5 sites on the H100 (PERF.md). 64 at D = 128,
// whose wider gradient would not fit beside 128 scores a row.
template <int D>
constexpr int kDqKeys = D <= 80 ? 128 : 64;

// Shared memory of the dQ kernel at padded head dim D, in bytes from a
// 1024-byte-aligned base: Q and dO as two 64-row tiles each (one per
// warpgroup, loaded once); the ring's K tiles, then its V tiles; the
// mbarriers (Q and dO; then each stage's full barrier) and each stage's
// running count of warps done with it.
template <int D>
struct DqSmem {
  using QTile = hopper::Tile<D, kTile>;
  using KVTile = hopper::Tile<D, kDqKeys<D>>;
  static constexpr int q = 0;
  static constexpr int dout = 2 * QTile::kBytes;
  static constexpr int k = 4 * QTile::kBytes;
  static constexpr int v = k + kStages * KVTile::kBytes;
  static constexpr int bars = v + kStages * KVTile::kBytes;
  static constexpr int done = bars + (1 + kStages) * 8;
  static constexpr int bytes = done + kStages * 4 + hopper::kSwizzleAtomBytes;  // + room to align the base
  static_assert(bytes <= int(kMaxSharedBytes), "dQ tiles exceed shared memory");
};

// One block of 256 threads per (128 query rows, batch*head), a loop over the
// key tiles of BK that any of its rows sees. Warpgroup g owns rows
// [64g, 64g + 64) of the block: its Q and dO rows stay in shared memory
// (K-major A operands), its dQ accumulator (64 x D, float32) and its rows'
// lse and delta in registers. K and V of each key tile arrive by TMA in a
// ring of kStages stages, one full mbarrier a stage, shared by both
// warpgroups; the last of the 8 warps done with a stage starts the loads of
// the tile it holds next. Per tile j, a warpgroup issues in one turn
//   S = Q K^T and dP = dO V^T (wgmma m64nBK, both operands in shared
//     memory, K-major, ceil(d / 16) steps of 16), then tile j - 1's
//   dQ += dS K (wgmma, A from registers, B the stage's K tile MN-major
//     through the transpose bit, BK / 16 steps),
// computes P = exp2(S scale log2(e) - lse log2(e)) and dS = P (dP - delta)
// in the S and dP accumulators once those have landed, while tile j - 1's
// product runs, and packs dS to the input type in the layout of a register
// A operand once that has landed too: dS never goes through shared memory.
// The two warpgroups take turns to issue (ping-pong), so that one's P and
// dS run while the other's products hold the tensor cores. Masks are
// applied only on tiles that need them (the ragged last tile, the causal
// diagonal). Both warpgroups walk the block's tiles: with `causal`, the
// first warpgroup's P is 0 past its own diagonal (at BK = 64 the whole last
// tile), so every stage of the ring is closed by all 8 warps.
// Query rows past the end read zeros (Q, dO, lse, delta) and give dS = 0;
// they are never stored.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                              const __grid_constant__ CUtensorMap tq16, const __grid_constant__ CUtensorMap tk16,
                              const __grid_constant__ CUtensorMap tv16, const __grid_constant__ CUtensorMap tdo16,
                              const BwdParams p) {
  constexpr int BK = kDqKeys<D>;
  using L = DqSmem<D>;
  using QTile = typename L::QTile;
  using KVTile = typename L::KVTile;
  constexpr int kMainN = KVTile::kMainN;  // gradient columns in the whole boxes
  constexpr int kRemN = KVTile::kRemN;    // in the narrow box
  constexpr int kAcc = kMainN > 0 ? kMainN / 2 : 1;
  constexpr int kAccRem = kRemN > 0 ? kRemN / 2 : 1;
  extern __shared__ unsigned char smem_raw[];
  constexpr uint32_t kAlign = hopper::kSwizzleAtomBytes;
  unsigned char* smem = smem_raw + (kAlign - hopper::smem_u32(smem_raw) % kAlign) % kAlign;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bars);
  int* done = reinterpret_cast<int*>(smem + L::done);
  const uint32_t qbar = hopper::smem_u32(bars);
  const uint32_t full0 = hopper::smem_u32(bars + 1);
  const uint32_t sq0 = hopper::smem_u32(smem + L::q);
  const uint32_t sdo0 = hopper::smem_u32(smem + L::dout);
  const uint32_t sk0 = hopper::smem_u32(smem + L::k);
  const uint32_t sv0 = hopper::smem_u32(smem + L::v);
  const int b = blockIdx.y / p.heads;
  const int h = blockIdx.y % p.heads;
  const int q0 = blockIdx.x * kBlockRows;
  const int shift = p.kv_len - p.q_len;  // causal: row r sees keys k <= r + shift
  int n_tiles = (p.kv_len + BK - 1) / BK;
  if (p.causal) {  // keys past the block's last row + shift are masked for every row
    const int last_col = min(q0 + kBlockRows, p.q_len) - 1 + shift;
    n_tiles = last_col < 0 ? 0 : min(n_tiles, last_col / BK + 1);
  }

  // K_j and V_j into stage j % kStages, onto its full mbarrier
  auto load_kv = [&](int j) {
    const int s = j % kStages;
    const uint32_t bar = full0 + 8 * s;
    hopper::mbar_expect_tx(bar, 2 * KVTile::kBytes);
    hopper::load_tile<D, BK>(&tk, &tk16, bar, sk0 + s * KVTile::kBytes, j * BK, h, b);
    hopper::load_tile<D, BK>(&tv, &tv16, bar, sv0 + s * KVTile::kBytes, j * BK, h, b);
  };
  if (threadIdx.x == 0 && n_tiles > 0) {
    hopper::mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full0 + 8 * s, 1);
      done[s] = 0;
    }
    hopper::fence_barrier_init();
    hopper::mbar_expect_tx(qbar, 4 * QTile::kBytes);
    for (int w = 0; w < 2; ++w) {
      hopper::load_tile<D, kTile>(&tq, &tq16, qbar, sq0 + w * QTile::kBytes, q0 + w * kTile, h, b);
      hopper::load_tile<D, kTile>(&tdo, &tdo16, qbar, sdo0 + w * QTile::kBytes, q0 + w * kTile, h, b);
    }
    for (int j = 0; j < kStages && j < n_tiles; ++j) load_kv(j);
  }
  __syncthreads();

  const int g = threadIdx.x / kWarpgroup;
  const int tid = threadIdx.x % kWarpgroup;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int row0 = q0 + g * kTile;                      // this warpgroup's first row
  const int row_a = row0 + (tid / 32) * 16 + lane / 4;  // this thread's accumulator rows
  const int row_b = row_a + 8;
  const uint32_t sq = sq0 + g * QTile::kBytes;
  const uint32_t sdo = sdo0 + g * QTile::kBytes;
  const float scale_log2 = p.scale * kLog2e;
  const int ksteps = (p.head_dim + 15) / 16;
  // this thread's rows' lse (times log2(e)) and delta, zeros past q_len: a
  // head's lse and delta start wherever q_len puts them
  const float* lse_head = p.lse + (long long)blockIdx.y * p.q_len;
  const float* delta_head = p.delta + (long long)blockIdx.y * p.q_len;
  const float lse2[2] = {row_a < p.q_len ? lse_head[row_a] * kLog2e : 0.f,
                         row_b < p.q_len ? lse_head[row_b] * kLog2e : 0.f};
  const float delta[2] = {row_a < p.q_len ? delta_head[row_a] : 0.f, row_b < p.q_len ? delta_head[row_b] : 0.f};

  float dq[kAcc], dqr[kAccRem];
  #pragma unroll
  for (int i = 0; i < kAcc; ++i) dq[i] = 0.f;
  #pragma unroll
  for (int i = 0; i < kAccRem; ++i) dqr[i] = 0.f;
  float s[BK / 2];   // S, then P
  float dp[BK / 2];  // dP, then dS
  uint32_t da[BK / 16][4];  // dS as A operands of 16 keys each

  // acc (64 rows x BK keys) = A B^T over the head's 16-column steps, A this
  // warpgroup's Q or dO rows, B the stage's K or V tile; not committed
  auto issue_ss = [&](float (&acc)[BK / 2], uint32_t a, uint32_t bt) {
    #pragma unroll
    for (int kk = 0; kk < QTile::kSteps; ++kk) {
      if (kk > 0 && kk >= ksteps) break;
      hopper::wgmma_ss<T, BK>(acc, QTile::kmajor(a, kk), KVTile::kmajor(bt, kk), kk > 0);
    }
  };
  auto fence_grads = [&] {
    hopper::fence_regs(dq);
    hopper::fence_regs(dqr);
  };
  // dQ += dS K of tile j, from da; not committed
  auto issue_grads = [&](int j) {
    const uint32_t sk = sk0 + (j % kStages) * KVTile::kBytes;
    #pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      if constexpr (kMainN > 0) hopper::wgmma_rs<T, kMainN>(dq, da[kc], KVTile::mn_main(sk, kc));
      if constexpr (kRemN > 0) hopper::wgmma_rs<T, kRemN>(dqr, da[kc], KVTile::mn_rem(sk, kc));
    }
  };
  // this warp is done with tile j's stage; the last of the 8 refills it
  auto release = [&](int j) {
    __syncwarp();
    if (lane == 0 && atomicAdd(done + j % kStages, 1) % kWarps == kWarps - 1 && j + kStages < n_tiles) {
      load_kv(j + kStages);
    }
  };
  // The two warpgroups take turns to issue their products (named barriers
  // 1 and 2), so that one's P and dS run while the other's products hold
  // the tensor cores.
  auto turn = [&] { hopper::bar_sync(kBarTurn + g, kThreads); };
  auto pass = [&](bool last) {
    if (g == 0 || !last) hopper::bar_arrive(kBarTurn + 1 - g, kThreads);
  };

  // Per tile j, one turn issues S_j = Q K_j^T and dP_j = dO V_j^T, then tile
  // j - 1's dQ product; P_j and dS_j are computed (as floats, in the S and
  // dP accumulators) once S_j and dP_j have landed, while tile j - 1's
  // product runs, and packed into the A operands once that has landed too.
  if (n_tiles > 0) {
    hopper::mbar_wait(qbar, 0);
    if (g == 1) hopper::bar_arrive(kBarTurn, kThreads);  // warpgroup 0 issues first
    for (int j = 0; j < n_tiles; ++j) {
      const int stage = j % kStages;
      const int k0 = j * BK;
      hopper::mbar_wait(full0 + 8 * stage, (j / kStages) & 1);
      turn();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      fence_grads();
      hopper::wgmma_fence();
      issue_ss(s, sq, sk0 + stage * KVTile::kBytes);    // S = Q K^T
      issue_ss(dp, sdo, sv0 + stage * KVTile::kBytes);  // dP = dO V^T
      hopper::wgmma_commit();
      if (j > 0) {
        issue_grads(j - 1);
        hopper::wgmma_commit();
      }
      pass(false);
      if (j > 0) {
        hopper::wgmma_wait<1>();  // S and dP have landed; tile j - 1's product may run on
      } else {
        hopper::wgmma_wait<0>();
      }
      hopper::fence_regs(s);
      hopper::fence_regs(dp);

      // P and dS; accumulator entry 4n + e is (row e < 2 ? row_a : row_b,
      // key k0 + 8n + 2t + (e & 1))
      const bool masked = k0 + BK > p.kv_len || (p.causal && k0 + BK - 1 > row0 + shift);
      #pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        #pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float pe = fast_exp2(fmaf(s[4 * n + e], scale_log2, -lse2[r]));
          if (masked) {
            const int key = k0 + 8 * n + 2 * t + (e & 1);
            if (key >= p.kv_len || (p.causal && key > (r ? row_b : row_a) + shift)) pe = 0.f;
          }
          dp[4 * n + e] = pe * (dp[4 * n + e] - delta[r]);
        }
      }
      hopper::wgmma_wait<0>();  // tile j - 1's product has landed: its stage and da are free
      fence_grads();
      if (j > 0) release(j - 1);
      #pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) acc_to_a<T>(da[kc], dp + 8 * kc, dp + 8 * kc + 4);
    }
    turn();
    fence_grads();
    hopper::wgmma_fence();
    issue_grads(n_tiles - 1);
    hopper::wgmma_commit();
    pass(true);
    hopper::wgmma_wait<0>();
    fence_grads();
  }

  T* dqh = static_cast<T*>(p.dq) + b * p.dq_bs + h * p.dq_hs;
  auto store = [&](int col, const float* q4) {
    if (col >= p.head_dim) return;
    if (row_a < p.q_len) {
      *reinterpret_cast<uint32_t*>(dqh + (long long)row_a * p.dq_rs + col) =
          pack2<T>(q4[0] * p.scale, q4[1] * p.scale);
    }
    if (row_b < p.q_len) {
      *reinterpret_cast<uint32_t*>(dqh + (long long)row_b * p.dq_rs + col) =
          pack2<T>(q4[2] * p.scale, q4[3] * p.scale);
    }
  };
  #pragma unroll
  for (int n = 0; n < kMainN / 8; ++n) store(n * 8 + 2 * t, dq + 4 * n);
  #pragma unroll
  for (int n = 0; n < kRemN / 8; ++n) store(kMainN + n * 8 + 2 * t, dqr + 4 * n);
}

// The eight tile maps (q, k, v, dout: 64-column and 16-column boxes) and
// the launch of the dK/dV kernel (kDkv) or the dQ kernel.
template <typename T, int D, bool kDkv>
int launch_wgmma(const BwdParams& p, int batch, cudaStream_t stream) {
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  const void* bases[4] = {p.q, p.k, p.v, p.dout};
  const int rows[4] = {p.q_len, p.kv_len, p.kv_len, p.q_len};
  const long long strides[4][3] = {
      {p.q_rs, p.q_hs, p.q_bs}, {p.k_rs, p.k_hs, p.k_bs}, {p.v_rs, p.v_hs, p.v_bs}, {p.do_rs, p.do_hs, p.do_bs}};
  CUtensorMap maps[4][2];
  for (int i = 0; i < 4; ++i) {
    if (!hopper::encode_tile_maps(maps[i], bf16, bases[i], p.head_dim, rows[i], p.heads, batch, strides[i][0],
                                  strides[i][1], strides[i][2])) {
      return int(cudaErrorInvalidValue);
    }
  }
  constexpr int bytes = kDkv ? DkvSmem<D>::bytes : DqSmem<D>::bytes;
  auto kernel = kDkv ? flash_bwd_dkv_wgmma_kernel<T, D> : flash_bwd_dq_wgmma_kernel<T, D>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return int(err);
  const int len = kDkv ? p.kv_len : p.q_len;
  const dim3 grid((len + kBlockRows - 1) / kBlockRows, batch * p.heads);
  kernel<<<grid, kThreads, bytes, stream>>>(maps[0][0], maps[1][0], maps[2][0], maps[3][0], maps[0][1], maps[1][1],
                                            maps[2][1], maps[3][1], p);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// 128 < head_dim <= 512, bfloat16 and float16: wgmma and TMA, one gradient a
// block
// ---------------------------------------------------------------------------

// The three kinds of block of the wide kernel, each of which owns 64 rows of
// one gradient: dQ owns 64 query rows (Q and dO) and streams K and V; dK
// owns 64 keys (K and V) and streams Q and dO; dV owns 64 keys (K alone) and
// streams Q and dO.
constexpr int kWideDq = 0;
constexpr int kWideDk = 1;
constexpr int kWideDv = 2;
// named barriers of the wide kernel (0 is __syncthreads): both warpgroups'
// partials are written (1); warpgroup g's partials have been read (2 + g);
// warpgroup g is done with its half of the late streamed tile (4 + g)
constexpr int kBarExchange = 1;
constexpr int kBarPartialRead = 2;
constexpr int kBarLateFree = 4;

// Shared memory of a wide block of kind K at padded head dim D (256 or 512),
// in bytes from a 1024-byte-aligned base. First the owned tiles, 64 rows x D
// each (D / 64 TMA boxes of 64 rows; warpgroup g reads boxes
// [g D / 128, (g + 1) D / 128)): Q and dO (dQ), K and V (dK), K (dV). Then
// two streamed tiles of kRows rows x D (boxes of kRows rows): the early one,
// free once the products that reduce over d have landed (V for dQ, dO for
// dK, Q for dV), and the late one, free once the gradient's product has
// landed (K for dQ, Q for dK, dO for dV). Then each warpgroup's float32
// partials (64 x 64: S and dP against 32 streamed rows, or S against 64),
// each warpgroup's copy of the late tile's lse and delta (dK, dV), and six
// mbarriers (each warpgroup's owned, early and late halves). The dQ and dK
// blocks own two tiles, so they stream 32 rows a tile; the dV block owns
// one and streams 64. At D = 512 each kind takes 226 KiB of the 227.
template <int D, int K>
struct WideBlockSmem {
  static constexpr int kOwned = K == kWideDv ? 1 : 2;
  static constexpr int kRows = K == kWideDv ? kTile : kTile / 2;  // streamed rows a tile
  static constexpr int kOwnBytes = kTile * D * 2;
  static constexpr int kStreamBytes = kRows * D * 2;
  static constexpr int kPartialBytes = kTile * kTile * 4;  // a warpgroup's partials
  static constexpr int kRowFloats = 2 * kTile;             // a warpgroup's lse, then delta
  static constexpr int own = 0;
  static constexpr int early = kOwned * kOwnBytes;
  static constexpr int late = early + kStreamBytes;
  static constexpr int partials = late + kStreamBytes;
  static constexpr int rows = partials + 2 * kPartialBytes;
  static constexpr int bars = rows + 2 * kRowFloats * 4;
  static constexpr int bytes = bars + 6 * 8 + hopper::kSwizzleAtomBytes;  // + room to align the base
  static_assert(bytes <= int(kMaxSharedBytes), "wide backward tiles exceed shared memory");
};

// Warpgroup g's half of rows [row, row + R) of one head: D / 128 boxes of R
// rows from column g D / 2, into `dst` onto `bar` (expect_tx by the caller).
template <int D, int R>
__device__ __forceinline__ void load_half_tile(const CUtensorMap* map, uint32_t bar, uint32_t dst, int g, int row,
                                               int h, int b) {
  constexpr int kBoxes = D / 2 / hopper::kBox;
  #pragma unroll
  for (int i = 0; i < kBoxes; ++i) {
    hopper::tma_load_4d(dst + i * R * 128, map, bar, (g * kBoxes + i) * hopper::kBox, row, h, b);
  }
}

// One block of the wide kernel: 64 owned rows of one gradient (kind K), a
// loop over the streamed tiles of R rows that any owned row sees. A 64-row
// gradient of 512 float32 columns is 256 registers a thread of one
// warpgroup, so the block's two warpgroups split it along d, as the wide
// forward splits O: warpgroup g owns the gradient's columns
// [g D / 2, (g + 1) D / 2) in registers (m64n256 at D = 512, 128 floats a
// thread) and loads only its half of every tile, by TMA onto its own
// mbarriers. Per streamed tile:
//   the products that reduce over d, over the warpgroup's half (wgmma,
//     both operands K-major in shared memory): dP = dO V^T and S = Q K^T
//     (dQ), dP^T = V dO^T and S^T = K Q^T (dK), S^T = K Q^T (dV);
//   the two warpgroups' float32 partials meet in shared memory, so both
//     hold the whole S (and dP) in the same accumulator layout (the sums
//     are the same two numbers in either order: both get the same bits);
//   P = exp2(S scale log2(e) - lse log2(e)), 0 outside the masks, and
//     dS = P (dP - delta), in those accumulators, packed to the input type
//     as register A operands (neither goes through shared memory);
//   the gradient over the warpgroup's columns, B the late tile read MN-major
//     through the transpose bit: dQ += dS K, dK += dS^T Q, dV += P^T dO.
// Each streamed half is refilled as soon as the last product that reads it
// has landed: the early tile right after the partials' exchange, the late
// one after the gradient's product; the next late tile's load runs under
// the early one's product (dQ, dK issue dP before S). Query rows and keys
// past the end read zeros, give P = 0 (or feed rows that are never stored)
// and are never stored; columns past d are zeros and are never stored.
template <typename T, int D, int K>
__device__ __forceinline__ void wide_block(const CUtensorMap* own1, const CUtensorMap* own2,
                                           const CUtensorMap* early_map, const CUtensorMap* late_map,
                                           const BwdParams& p, unsigned char* smem) {
  using L = WideBlockSmem<D, K>;
  constexpr int R = L::kRows;
  constexpr int DH = D / 2;                // gradient columns of a warpgroup
  constexpr bool kDq = K == kWideDq;       // owned rows are query rows (else keys)
  constexpr bool kDp = K != kWideDv;       // S and dP, or S alone
  constexpr int kOwnHalf = DH * kTile * 2;  // bytes of a warpgroup's half of an owned tile
  constexpr int kStreamHalf = DH * R * 2;   // of a streamed tile
  constexpr int kBoxStride = R * 128;       // from one box of a streamed tile to the next
  constexpr int kF4 = R / 8;                // float4 of one partial a thread
  float* partials = reinterpret_cast<float*>(smem + L::partials);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bars);

  const int g = threadIdx.x / kWarpgroup;
  const int tid = threadIdx.x % kWarpgroup;
  const int warp = tid / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int b = blockIdx.y / p.heads;
  const int h = blockIdx.y % p.heads;
  const int o0 = blockIdx.x * kTile;             // the first owned row
  const int row_a = o0 + warp * 16 + lane / 4;  // this thread's accumulator rows
  const int row_b = row_a + 8;
  const int shift = p.kv_len - p.q_len;  // causal: query row q sees keys k <= q + shift
  const int str_len = kDq ? p.kv_len : p.q_len;
  int j0 = 0;  // the first streamed tile any owned row sees
  int n_tiles = (str_len + R - 1) / R;
  if (p.causal && kDq) {
    const int last = min(o0 + kTile, p.q_len) - 1 + shift;
    n_tiles = last < 0 ? 0 : min(n_tiles, last / R + 1);
  } else if (p.causal) {
    const int first = o0 - shift;
    j0 = first > 0 ? min(first / R, n_tiles) : 0;
    n_tiles -= j0;
  }

  const uint32_t sown1 = hopper::smem_u32(smem + L::own) + g * kOwnHalf;
  const uint32_t sown2 = sown1 + L::kOwnBytes;
  const uint32_t searly = hopper::smem_u32(smem + L::early) + g * kStreamHalf;
  const uint32_t slate = hopper::smem_u32(smem + L::late) + g * kStreamHalf;
  float* rows = reinterpret_cast<float*>(smem + L::rows) + g * L::kRowFloats;
  const uint32_t own_bar = hopper::smem_u32(bars + g);
  const uint32_t early_bar = hopper::smem_u32(bars + 2 + g);
  const uint32_t late_bar = hopper::smem_u32(bars + 4 + g);
  const float* lse_head = p.lse + (long long)blockIdx.y * p.q_len;
  const float* delta_head = p.delta + (long long)blockIdx.y * p.q_len;

  // the early half of streamed tile j, by one thread
  auto load_early = [&](int j) {
    hopper::mbar_expect_tx(early_bar, kStreamHalf);
    load_half_tile<D, R>(early_map, early_bar, searly, g, (j0 + j) * R, h, b);
  };
  // the late half of streamed tile j, and (dK, dV) the lse and delta of its
  // rows, by a whole warp: lane 0 starts the TMA copies, every lane copies
  // its rows' values with cp.async onto the same mbarrier (one arrival a
  // lane), zeros past q_len (a head's lse starts wherever q_len puts it,
  // where a TMA copy would need its start 16-byte aligned)
  auto load_late = [&](int j) {
    const int s0 = (j0 + j) * R;
    if (lane == 0) {
      hopper::mbar_expect_tx(late_bar, kStreamHalf);
      load_half_tile<D, R>(late_map, late_bar, slate, g, s0, h, b);
    }
    if constexpr (!kDq) {
      #pragma unroll
      for (int u = 0; u < R / 32; ++u) {
        const int r = lane + 32 * u;
        const bool in = s0 + r < p.q_len;
        cp_async4(rows + r, lse_head + (in ? s0 + r : 0), in);
        if constexpr (kDp) cp_async4(rows + kTile + r, delta_head + (in ? s0 + r : 0), in);
      }
      hopper::cp_async_mbar_arrive(late_bar);
    }
    __syncwarp();
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 6; ++i) hopper::mbar_init(hopper::smem_u32(bars + i), i >= 4 && !kDq ? 1 + 32 : 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (n_tiles > 0 && warp == 0) {
    if (lane == 0) {
      hopper::mbar_expect_tx(own_bar, L::kOwned * kOwnHalf);
      load_half_tile<D, kTile>(own1, own_bar, sown1, g, o0, h, b);
      if constexpr (kDp) load_half_tile<D, kTile>(own2, own_bar, sown2, g, o0, h, b);
      load_early(0);
    }
    __syncwarp();
    load_late(0);
  }

  // dQ: this thread's rows' lse (times log2(e)) and delta, zeros past q_len
  float lse2[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
  if constexpr (kDq) {
    lse2[0] = row_a < p.q_len ? lse_head[row_a] * kLog2e : 0.f;
    lse2[1] = row_b < p.q_len ? lse_head[row_b] * kLog2e : 0.f;
    delta_r[0] = row_a < p.q_len ? delta_head[row_a] : 0.f;
    delta_r[1] = row_b < p.q_len ? delta_head[row_b] : 0.f;
  }
  const float scale_log2 = p.scale * kLog2e;

  float grad[DH / 2];
  #pragma unroll
  for (int i = 0; i < DH / 2; ++i) grad[i] = 0.f;
  float s[R / 2];              // S (or S^T), then P
  float dp[kDp ? R / 2 : 1];   // dP (or dP^T), then dS
  uint32_t pa[R / 16][4];      // dS (dQ, dK) or P (dV) as A operands of 16 streamed rows each
  float4* mine = reinterpret_cast<float4*>(partials + g * kTile * kTile) + tid;
  const float4* theirs = reinterpret_cast<const float4*>(partials + (1 - g) * kTile * kTile) + tid;

  // acc (64 owned rows x R streamed rows) = A B^T over this warpgroup's
  // half of d, A an owned half, B a streamed half; not committed
  auto issue_ss = [&](float (&acc)[R / 2], uint32_t a_half, uint32_t b_half) {
    #pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      hopper::wgmma_ss<T, R>(acc, hopper::kmajor_desc(a_half + (kk / 4) * hopper::kBoxBytes + col),
                             hopper::kmajor_desc(b_half + (kk / 4) * kBoxStride + col), kk > 0);
    }
  };

  if (n_tiles > 0) {
    hopper::mbar_wait(own_bar, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const uint32_t parity = j & 1;
      const bool more = j + 1 < n_tiles;
      const int s0 = (j0 + j) * R;

      // the products that reduce over d, over this warpgroup's half
      hopper::fence_regs(s);
      if constexpr (kDp) hopper::fence_regs(dp);
      hopper::mbar_wait(early_bar, parity);
      hopper::wgmma_fence();
      if constexpr (kDp) {
        issue_ss(dp, sown2, searly);  // dP = dO V^T (dQ), dP^T = V dO^T (dK)
        hopper::mbar_wait(late_bar, parity);
        issue_ss(s, sown1, slate);  // S = Q K^T (dQ), S^T = K Q^T (dK)
      } else {
        issue_ss(s, sown1, searly);  // S^T = K Q^T
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      if constexpr (kDp) hopper::fence_regs(dp);

      // the partials meet in shared memory: thread i of one warpgroup holds
      // the same entries as thread i of the other
      if (j > 0) hopper::bar_sync(kBarPartialRead + g, kThreads);  // the other has read our last ones
      #pragma unroll
      for (int i = 0; i < kF4; ++i) {
        mine[i * kWarpgroup] = make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
      }
      if constexpr (kDp) {
        #pragma unroll
        for (int i = 0; i < kF4; ++i) {
          mine[(kF4 + i) * kWarpgroup] = make_float4(dp[4 * i], dp[4 * i + 1], dp[4 * i + 2], dp[4 * i + 3]);
        }
      }
      hopper::bar_sync(kBarExchange, kThreads);
      if (tid == 0 && more) load_early(j + 1);  // the products that read our early half have landed
      __syncwarp();
      #pragma unroll
      for (int i = 0; i < kF4; ++i) {
        const float4 x = theirs[i * kWarpgroup];
        s[4 * i] += x.x;
        s[4 * i + 1] += x.y;
        s[4 * i + 2] += x.z;
        s[4 * i + 3] += x.w;
      }
      if constexpr (kDp) {
        #pragma unroll
        for (int i = 0; i < kF4; ++i) {
          const float4 x = theirs[(kF4 + i) * kWarpgroup];
          dp[4 * i] += x.x;
          dp[4 * i + 1] += x.y;
          dp[4 * i + 2] += x.z;
          dp[4 * i + 3] += x.w;
        }
      }
      if (more) hopper::bar_arrive(kBarPartialRead + 1 - g, kThreads);
      if constexpr (!kDp) hopper::mbar_wait(late_bar, parity);  // dO and the lse

      // P and dS; accumulator entry 4n + e is (owned row e < 2 ? row_a :
      // row_b, streamed row s0 + 8n + 2t + (e & 1))
      const bool masked = kDq ? s0 + R > p.kv_len || (p.causal && s0 + R - 1 > o0 + shift)
                              : s0 + R > p.q_len || (p.causal && o0 + kTile - 1 > s0 + shift);
      #pragma unroll
      for (int n = 0; n < R / 8; ++n) {
        float2 lv = make_float2(0.f, 0.f), dl = make_float2(0.f, 0.f);
        if constexpr (!kDq) lv = *reinterpret_cast<const float2*>(rows + 8 * n + 2 * t);
        if constexpr (K == kWideDk) dl = *reinterpret_cast<const float2*>(rows + kTile + 8 * n + 2 * t);
        #pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int c = e & 1;
          const float lse = kDq ? lse2[r] : (c ? lv.y : lv.x) * kLog2e;
          float pe = fast_exp2(fmaf(s[4 * n + e], scale_log2, -lse));
          if (masked) {
            const int own = r ? row_b : row_a;
            const int str = s0 + 8 * n + 2 * t + c;
            const int q = kDq ? own : str;
            const int key = kDq ? str : own;
            if (str >= str_len || (p.causal && key > q + shift)) pe = 0.f;
          }
          if constexpr (kDp) {
            dp[4 * n + e] = pe * (dp[4 * n + e] - (kDq ? delta_r[r] : (c ? dl.y : dl.x)));
          } else {
            s[4 * n + e] = pe;
          }
        }
      }
      #pragma unroll
      for (int kc = 0; kc < R / 16; ++kc) {
        if constexpr (kDp) {
          acc_to_a<T>(pa[kc], dp + 8 * kc, dp + 8 * kc + 4);
        } else {
          acc_to_a<T>(pa[kc], s + 8 * kc, s + 8 * kc + 4);
        }
      }

      // the gradient over this warpgroup's columns: dQ += dS K, dK += dS^T Q
      // or dV += P^T dO, B the late half MN-major (R / 16 steps of 16 rows)
      hopper::fence_regs(grad);
      hopper::wgmma_fence();
      #pragma unroll
      for (int kc = 0; kc < R / 16; ++kc) {
        hopper::wgmma_rs<T, DH>(grad, pa[kc], hopper::mnmajor_desc(slate + kc * 16 * 128, kBoxStride));
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(grad);
      if (more) {
        hopper::bar_sync(kBarLateFree + g, kWarpgroup);  // every warp of ours is done with the late half
        if (warp == 0) load_late(j + 1);
      }
    }
  }

  // accumulator entry 4n + e: row e < 2 ? row_a : row_b, column
  // g D / 2 + 8n + 2t + (e & 1)
  T* out = static_cast<T*>(kDq ? p.dq : K == kWideDk ? p.dk : p.dv);
  out += kDq ? b * p.dq_bs + h * p.dq_hs : K == kWideDk ? b * p.dk_bs + h * p.dk_hs : b * p.dv_bs + h * p.dv_hs;
  const long long out_rs = kDq ? p.dq_rs : K == kWideDk ? p.dk_rs : p.dv_rs;
  const float out_scale = K == kWideDv ? 1.f : p.scale;
  const int own_len = kDq ? p.q_len : p.kv_len;
  #pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    const int col = g * DH + 8 * n + 2 * t;
    if (col >= p.head_dim) continue;
    if (row_a < own_len) {
      *reinterpret_cast<uint32_t*>(out + (long long)row_a * out_rs + col) =
          pack2<T>(grad[4 * n] * out_scale, grad[4 * n + 1] * out_scale);
    }
    if (row_b < own_len) {
      *reinterpret_cast<uint32_t*>(out + (long long)row_b * out_rs + col) =
          pack2<T>(grad[4 * n + 2] * out_scale, grad[4 * n + 3] * out_scale);
    }
  }
}

// The wide kernel: one block of two warpgroups per (64 owned rows,
// batch*head[, gradient]). The dQ entry's blocks are dQ blocks; the dK/dV
// entry's grid has a third dimension of 2, dK blocks (the heavier, first)
// then dV blocks, so the two gradients of one key tile are computed by two
// blocks side by side and S^T is computed twice. Tensor maps: the two owned
// operands (64-row boxes: Q and dO for dQ, K and V for dK/dV), then the S
// partner and the dP partner streamed in 32-row boxes (K and V for dQ, Q and
// dO for dK) and in 64-row boxes (Q and dO for dV).
template <typename T, int D, bool kDkv>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_wide_wgmma_kernel(const __grid_constant__ CUtensorMap own1, const __grid_constant__ CUtensorMap own2,
                                const __grid_constant__ CUtensorMap s1_32, const __grid_constant__ CUtensorMap s2_32,
                                const __grid_constant__ CUtensorMap s1_64, const __grid_constant__ CUtensorMap s2_64,
                                const BwdParams p) {
  extern __shared__ unsigned char smem_raw[];
  constexpr uint32_t kAlign = hopper::kSwizzleAtomBytes;
  unsigned char* smem = smem_raw + (kAlign - hopper::smem_u32(smem_raw) % kAlign) % kAlign;
  if constexpr (kDkv) {
    if (blockIdx.z == 0) {
      wide_block<T, D, kWideDk>(&own1, &own2, &s2_32, &s1_32, p, smem);
    } else {
      wide_block<T, D, kWideDv>(&own1, nullptr, &s1_64, &s2_64, p, smem);
    }
  } else {
    wide_block<T, D, kWideDq>(&own1, &own2, &s2_32, &s1_32, p, smem);
  }
}

// one operand of the backward as its tensor maps see it
struct Operand {
  const void* base;
  int rows;
  long long rs, hs, bs;
};

// The six tensor maps and the launch of the wide kernel for the dK/dV entry
// (kDkv) or the dQ entry.
template <typename T, int D, bool kDkv>
int launch_wide_wgmma(const BwdParams& p, int batch, cudaStream_t stream) {
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  const Operand q{p.q, p.q_len, p.q_rs, p.q_hs, p.q_bs};
  const Operand k{p.k, p.kv_len, p.k_rs, p.k_hs, p.k_bs};
  const Operand v{p.v, p.kv_len, p.v_rs, p.v_hs, p.v_bs};
  const Operand dout{p.dout, p.q_len, p.do_rs, p.do_hs, p.do_bs};
  // the owned pair, then the S partner and the dP partner
  const Operand ops[4] = {kDkv ? k : q, kDkv ? v : dout, kDkv ? q : k, kDkv ? dout : v};
  const int operand[6] = {0, 1, 2, 3, 2, 3};
  const int box_rows[6] = {kTile, kTile, kTile / 2, kTile / 2, kTile, kTile};
  CUtensorMap maps[6];
  for (int i = 0; i < 6; ++i) {
    const Operand& o = ops[operand[i]];
    if (!hopper::encode_map(&maps[i], bf16, o.base, p.head_dim, o.rows, p.heads, batch, o.rs, o.hs, o.bs,
                            hopper::kBox, box_rows[i])) {
      return int(cudaErrorInvalidValue);
    }
  }
  constexpr int dk_bytes = WideBlockSmem<D, kWideDk>::bytes;
  constexpr int dv_bytes = WideBlockSmem<D, kWideDv>::bytes;
  constexpr int bytes = kDkv ? (dk_bytes > dv_bytes ? dk_bytes : dv_bytes) : WideBlockSmem<D, kWideDq>::bytes;
  auto kernel = flash_bwd_wide_wgmma_kernel<T, D, kDkv>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return int(err);
  const int len = kDkv ? p.kv_len : p.q_len;
  const dim3 grid((len + kTile - 1) / kTile, batch * p.heads, kDkv ? 2 : 1);
  kernel<<<grid, kThreads, bytes, stream>>>(maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], p);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// float32: FFMA tiles
// ---------------------------------------------------------------------------

// The same two kernels in float32 on plain FFMA, 256 threads (see
// flash_common.cuh for the thread layout): a block owns BR rows (keys for
// dK/dV, query rows for dQ) and streams the other side in tiles of BC rows.
// Every tile sits in shared memory; the scores and the gradient
// accumulators in registers. P and dS go through shared memory to their
// products. BR = BC = 64 up to D = 128; the wide heads take smaller tiles
// so that four of them fit in shared memory: 32 and 64 rows at D = 256, 16
// and 32 at D = 512.

template <int D, int BR, int BC>
constexpr int f32_backward_bytes(bool dkv) {
  return (2 * BR * (D + 1) + 2 * BC * (D + 1) + (dkv ? 2 : 1) * BR * (BC + 1) + (dkv ? 2 * BC : 0)) *
         int(sizeof(float));
}

template <int D, int BR, int BC>
__global__ void __launch_bounds__(kF32Threads) flash_bwd_dkv_f32_kernel(const BwdParams p) {
  constexpr int R = BR / 16;  // keys a thread
  constexpr int C = BC / 16;  // query rows a thread
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + BR * (D + 1);
  float* sQ = sV + BR * (D + 1);
  float* sdO = sQ + BC * (D + 1);
  float* sP = sdO + BC * (D + 1);     // P^T: keys x queries
  float* sdS = sP + BR * (BC + 1);    // dS^T
  float* sLse = sdS + BR * (BC + 1);
  float* sDelta = sLse + BC;

  const int d = p.head_dim;
  const int b = blockIdx.y / p.heads;
  const int h = blockIdx.y % p.heads;
  const int k0 = blockIdx.x * BR;
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
  const int n_q = (p.q_len + BC - 1) / BC;
  const int first_row = p.causal ? k0 - (p.kv_len - p.q_len) : 0;
  const int j0 = first_row > 0 ? first_row / BC : 0;

  load_tile_f32<D>(sK, kh, p.k_rs, k0, BR, p.kv_len, d);
  load_tile_f32<D>(sV, vh, p.v_rs, k0, BR, p.kv_len, d);
  float dk[R][D / 16], dv[R][D / 16];
  #pragma unroll
  for (int i = 0; i < R; ++i) {
    #pragma unroll
    for (int c = 0; c < D / 16; ++c) dk[i][c] = dv[i][c] = 0.f;
  }

  for (int j = j0; j < n_q; ++j) {
    const int q0 = j * BC;
    __syncthreads();  // the previous tile's products are done with sQ, sdO
    load_tile_f32<D>(sQ, qh, p.q_rs, q0, BC, p.q_len, d);
    load_tile_f32<D>(sdO, doh, p.do_rs, q0, BC, p.q_len, d);
    const int r = threadIdx.x;
    if (r < BC) {
      sLse[r] = q0 + r < p.q_len ? lse[q0 + r] : 0.f;
      sDelta[r] = q0 + r < p.q_len ? delta[q0 + r] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries
    float s[R][C], dp[R][C];
    #pragma unroll
    for (int i = 0; i < R; ++i) {
      #pragma unroll
      for (int e = 0; e < C; ++e) s[i][e] = dp[i][e] = 0.f;
    }
    mm_abt_f32<D, R, C>(s, sK, sQ, tx, ty);
    mm_abt_f32<D, R, C>(dp, sV, sdO, tx, ty);
    #pragma unroll
    for (int i = 0; i < R; ++i) {
      #pragma unroll
      for (int e = 0; e < C; ++e) {
        const int qi = tx + 16 * e;
        const float pe = admissible(p, q0 + qi, k0 + ty + 16 * i) ? expf(s[i][e] * p.scale - sLse[qi]) : 0.f;
        sP[(ty + 16 * i) * (BC + 1) + qi] = pe;
        sdS[(ty + 16 * i) * (BC + 1) + qi] = pe * (dp[i][e] - sDelta[qi]);
      }
    }
    __syncthreads();
    mm_ab_f32<D, R, BC>(dv, sP, sdO, tx, ty);  // dV += P^T dO
    mm_ab_f32<D, R, BC>(dk, sdS, sQ, tx, ty);  // dK += dS^T Q
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

template <int D, int BR, int BC>
__global__ void __launch_bounds__(kF32Threads) flash_bwd_dq_f32_kernel(const BwdParams p) {
  constexpr int R = BR / 16;  // query rows a thread
  constexpr int C = BC / 16;  // keys a thread
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sdO = sQ + BR * (D + 1);
  float* sK = sdO + BR * (D + 1);
  float* sV = sK + BC * (D + 1);
  float* sdS = sV + BC * (D + 1);

  const int d = p.head_dim;
  const int b = blockIdx.y / p.heads;
  const int h = blockIdx.y % p.heads;
  const int q0 = blockIdx.x * BR;
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
  int n_k = (p.kv_len + BC - 1) / BC;
  if (p.causal) {  // keys past the tile's last row + (kv_len - q_len) are masked for every row
    const int last_col = q0 + BR - 1 + (p.kv_len - p.q_len);
    n_k = last_col < 0 ? 0 : min(n_k, last_col / BC + 1);
  }

  load_tile_f32<D>(sQ, qh, p.q_rs, q0, BR, p.q_len, d);
  load_tile_f32<D>(sdO, doh, p.do_rs, q0, BR, p.q_len, d);
  float dq[R][D / 16];
  #pragma unroll
  for (int i = 0; i < R; ++i) {
    #pragma unroll
    for (int c = 0; c < D / 16; ++c) dq[i][c] = 0.f;
  }

  for (int j = 0; j < n_k; ++j) {
    const int k0 = j * BC;
    __syncthreads();  // the previous tile's product is done with sK
    load_tile_f32<D>(sK, kh, p.k_rs, k0, BC, p.kv_len, d);
    load_tile_f32<D>(sV, vh, p.v_rs, k0, BC, p.kv_len, d);
    __syncthreads();

    // S = Q K^T and dP = dO V^T, then dS
    float s[R][C], dp[R][C];
    #pragma unroll
    for (int i = 0; i < R; ++i) {
      #pragma unroll
      for (int e = 0; e < C; ++e) s[i][e] = dp[i][e] = 0.f;
    }
    mm_abt_f32<D, R, C>(s, sQ, sK, tx, ty);
    mm_abt_f32<D, R, C>(dp, sdO, sV, tx, ty);
    #pragma unroll
    for (int i = 0; i < R; ++i) {
      #pragma unroll
      for (int e = 0; e < C; ++e) {
        const int col = k0 + tx + 16 * e;
        const float pe = admissible(p, q0 + ty + 16 * i, col) ? expf(s[i][e] * p.scale - lse_r[i]) : 0.f;
        sdS[(ty + 16 * i) * (BC + 1) + tx + 16 * e] = pe * (dp[i][e] - delta_r[i]);
      }
    }
    __syncthreads();
    mm_ab_f32<D, R, BC>(dq, sdS, sK, tx, ty);  // dQ += dS K
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

template <int D, int BR, int BC, bool kDkv>
int launch_one_f32(const BwdParams& p, int batch, cudaStream_t stream) {
  constexpr int bytes = f32_backward_bytes<D, BR, BC>(kDkv);
  static_assert(bytes <= int(kMaxSharedBytes), "float32 backward tiles exceed shared memory");
  auto kernel = kDkv ? flash_bwd_dkv_f32_kernel<D, BR, BC> : flash_bwd_dq_f32_kernel<D, BR, BC>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return int(err);
  }
  const int len = kDkv ? p.kv_len : p.q_len;
  const dim3 grid((len + BR - 1) / BR, batch * p.heads);
  kernel<<<grid, kF32Threads, bytes, stream>>>(p);
  return int(cudaGetLastError());
}

template <bool kDkv>
int launch_f32(const BwdParams& p, int batch, cudaStream_t stream) {
  switch (f32_template(pad16(p.head_dim))) {
    case 48:
      return launch_one_f32<48, 64, 64, kDkv>(p, batch, stream);
    case 64:
      return launch_one_f32<64, 64, 64, kDkv>(p, batch, stream);
    case 80:
      return launch_one_f32<80, 64, 64, kDkv>(p, batch, stream);
    case 128:
      return launch_one_f32<128, 64, 64, kDkv>(p, batch, stream);
    case 256:
      return launch_one_f32<256, 32, 64, kDkv>(p, batch, stream);
    case 512:
      return launch_one_f32<512, 16, 32, kDkv>(p, batch, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// bfloat16 and float16: each kernel at the smallest of its instances that
// holds the head (the narrow wgmma kernels up to 128, the wide one at 256
// and 512)
template <typename T, bool kDkv>
int launch(const BwdParams& p, int batch, cudaStream_t stream) {
  const int dim_pad = pad16(p.head_dim);
  if (dim_pad > 256) return launch_wide_wgmma<T, 512, kDkv>(p, batch, stream);
  if (dim_pad > 128) return launch_wide_wgmma<T, 256, kDkv>(p, batch, stream);
  switch (narrow_template(dim_pad)) {
    case 64:
      return launch_wgmma<T, 64, kDkv>(p, batch, stream);
    case 80:
      return launch_wgmma<T, 80, kDkv>(p, batch, stream);
    default:
      return launch_wgmma<T, 128, kDkv>(p, batch, stream);
  }
}

template <bool kDkv>
int run(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* delta,
        void* dq, void* dk, void* dv, int dtype, int batch, int heads, int head_dim, int q_len, int kv_len,
        const long long* strides, float scale, int causal, void* stream) {
  if (head_dim <= 0 || head_dim > 512 || head_dim % 8 != 0 || batch <= 0 || heads <= 0 || q_len <= 0 ||
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
