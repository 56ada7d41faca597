// The LoRAs of one Linear, added into its output in place, for Hopper
// (sm_90a): y += sum_i s_i * (x D_i^T) U_i^T, where D_i (r_i x in) and U_i
// (out x r_i) are LoRA i's down and up weights. Two kernels, one launch each
// per call, whatever the number of LoRAs (1 to 4):
// - lora_down_kernel: H = x [D_1; ...; D_n]^T summed in float32, each
//   LoRA's columns scaled by s_i in float32 and rounded once, one pass over x;
// - lora_up_add_kernel: y += sum_i (s_i H_i) U_i^T, one pass over y.
//
// No TPU kernel is replaced. The JAX package leaves a LoRA to XLA
// (refiners_tpu/fluxion/adapters/lora.py: a Sum of the target and
// Chain(down, up, Multiply) branches), which fuses the chain. Eager PyTorch
// runs the same Sum as ten launches per adapted Linear with two LoRAs, eight
// of them full-width passes over the target's output (the up products, the
// scales, the adds of Multiply's zero bias and the Sum's adds).
//
// What bounds them on the H100: memory, and at the SDXL UNet's sizes (y of
// 5 MB at N = 2048, out = 1280, most of it in L2) the latency of each
// block's chain of loads, barriers and stores. The ranks are small (K =
// sum r_i = 64 for two rank-32 LoRAs): the down product reads x once
// (2 * N * in bytes in bf16) for 2 * N * in * K operations, the up-add
// reads and writes y once (4 * N * out bytes) for 2 * N * out * K, both
// about K / 2 = 32 operations a byte against the 295 where the tensor cores
// become the limit. Neither kernel makes a copy of any weight: each LoRA's
// weights are read where they lie, and [D_1; ...] exists only in shared
// memory. Both launch as programmatic dependents (griddepcontrol): the
// up-add's launch overlaps the end of the down kernel, and loads U, which
// no kernel before it writes, before it waits for H and y.
//
// lora_down_kernel: a cluster of blocks shares 64 rows of x, each block an
// equal share of `in` (the cluster as large as keeps the grid near one
// wave: 4 blocks at N = 2048, 8 at N = 154, 1 at N = 8192). A block's
// thread 0 keeps up to 6 k-tiles in flight by TMA (x: 64 rows x 64 columns;
// the LoRAs' 16-row slabs of D, each from its own tensor map, side by side
// into one NT-row operand; both 128-byte swizzled), its warpgroup multiplies
// them (wgmma m64nNTk16, B the slabs, K-major), back to back where no stage
// is refilled. The partial tiles meet in shared memory and each block adds
// its share of the rows from all of them through distributed shared memory,
// in one fixed order: the result does not depend on timing. Columns of H
// past a chunk's LoRAs hold whatever the stale shared memory gave; the
// up-add never reads them.
//
// lora_up_add_kernel: a block (one warpgroup) walks down one 128-column tile
// of y in 64-row tiles (as many blocks as keep three on each SM). U's rows
// go to shared memory once, as the wgmma B operand (K-major, one 16-column K
// step per 4 KiB region with the 32-byte swizzle that
// hopper::narrow_kmajor_desc reads; ranks padded to 16 with zeros). The
// next row tile's y (16-byte cp.async into a padded staging buffer, free of
// bank conflicts on the epilogue's reads) and its H (straight into the A
// registers) are in flight while this tile's products accumulate in float32
// (wgmma m64n128k16, A from registers, four K steps a group) and its
// epilogue adds y in float32, rounds once and stores 16 bytes a thread.

#include <cooperative_groups.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxLoras = 4;
constexpr int kMaxSteps = 32;  // 16-column K steps: the ranks, each padded to 16, at most 512 in all
constexpr int kWarpgroup = 128;

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

template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  } else {
    return __half22float2(*reinterpret_cast<const __half2*>(&v));
  }
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  constexpr uintptr_t kAlign = hopper::kSwizzleAtomBytes;
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + kAlign - 1) & ~(kAlign - 1));
}

// programmatic dependent launch: let the stream's next kernel launch now (the
// down kernel does so once its work is done, so that the up-add's launch
// overlaps only the down kernel's exit); wait until the kernels before this
// one have completed and their writes are visible (at once where this kernel
// was not launched as a dependent)
__device__ __forceinline__ void launch_dependents() { asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory"); }
__device__ __forceinline__ void wait_prerequisites() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

// ---------------------------------------------------------------------------
// the down product
// ---------------------------------------------------------------------------

constexpr int kDownRows = 64;    // rows of x a block: one warpgroup
constexpr int kMaxSplit = 8;     // blocks of a cluster at most (the portable cluster size)
constexpr int kSplitBlocks = 160;  // a cluster takes more blocks while the grid stays within this
constexpr int kDownStages = 6;   // k-tiles in flight
constexpr int kSlabRows = 16;    // rows of D a TMA box
constexpr int kSlabBytes = kSlabRows * hopper::kBox * 2;  // 2 KiB

struct Down {
  CUtensorMap d[kMaxLoras];  // LoRA i's down weight (in columns x r_i rows), 64 x 16 boxes
  int slabs;                 // 16-row slabs of all the downs: sum ceil(r_i / 16)
  unsigned char slab_lora[kMaxSteps];
  unsigned char slab_row[kMaxSteps];  // the slab's first row / 16 within its LoRA
  float scale[kMaxLoras];             // LoRA i's s_i, applied to its columns of H in float32
};

template <int NT>
struct DownSmem {
  static constexpr int kX = hopper::kBoxBytes;           // 64 rows x 64 columns of x
  static constexpr int kD = NT * hopper::kBox * 2;       // NT rows x 64 columns of D
  static constexpr int kStage = kX + kD;
  static constexpr int kBars = kDownStages * kStage;
  static constexpr int kPitch = NT + 4;                  // floats a row of the partial tile
  static constexpr int bytes = kBars + kDownStages * 8 + hopper::kSwizzleAtomBytes;
  static_assert(kDownRows * kPitch * 4 <= kBars, "the partial tile reuses the stages");
};

// H[:, NT c .. NT c + NT) = x D_chunk^T for chunk c = blockIdx.y, rows
// 64 blockIdx.x .. + 64; the cluster's blocks (1, 1, split) each take k-tiles
// [z per, (z + 1) per), z the block's rank in it.
template <typename T, int NT>
__global__ void __launch_bounds__(kWarpgroup, 1)
    lora_down_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ Down dn, T* __restrict__ h,
                     long long n_rows, int ld_h, int k_tiles) {
  using L = DownSmem<NT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int z = static_cast<int>(cluster.block_rank());
  const int split = static_cast<int>(cluster.num_blocks());
  const int row0 = blockIdx.x * kDownRows;
  const int chunk = blockIdx.y;
  const int per = (k_tiles + split - 1) / split;
  const int kt0 = z * per;
  const int n_tiles = max(0, min(k_tiles, kt0 + per) - kt0);
  // this chunk's slabs: NT / 16 of them, fewer in the last chunk
  const int q0 = chunk * (NT / kSlabRows);
  const int nq = min(NT / kSlabRows, dn.slabs - q0);

  if (tid == 0) {
    for (int s = 0; s < kDownStages; ++s) hopper::mbar_init(hopper::smem_u32(bars + s), 1);
    hopper::fence_barrier_init();
  }
  wait_prerequisites();  // x may come from the kernel just before
  __syncthreads();

  auto fetch = [&](int stage, int kt) {
    const uint32_t bar = hopper::smem_u32(bars + stage);
    const uint32_t base = hopper::smem_u32(smem + stage * L::kStage);
    hopper::mbar_expect_tx(bar, L::kX + nq * kSlabBytes);
    hopper::tma_load_4d(base, &tx, bar, kt * hopper::kBox, row0, 0, 0);
    for (int q = 0; q < nq; ++q) {
      const CUtensorMap* map = &dn.d[dn.slab_lora[q0 + q]];
      hopper::tma_load_4d(base + L::kX + q * kSlabBytes, map, bar, kt * hopper::kBox, dn.slab_row[q0 + q] * kSlabRows,
                          0, 0);
    }
  };

  if (tid == 0) {
    for (int t = 0; t < min(kDownStages, n_tiles); ++t) fetch(t, kt0 + t);
  }
  float acc[NT / 2];
  #pragma unroll
  for (int e = 0; e < NT / 2; ++e) acc[e] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t % kDownStages;
    hopper::mbar_wait(hopper::smem_u32(bars + stage), (t / kDownStages) & 1);
    const uint32_t xs = hopper::smem_u32(smem + stage * L::kStage);
    hopper::wgmma_fence();
    #pragma unroll
    for (int kk = 0; kk < hopper::kBox / 16; ++kk) {
      hopper::wgmma_ss<T, NT>(acc, hopper::kmajor_desc(xs + kk * 32), hopper::kmajor_desc(xs + L::kX + kk * 32), 1);
    }
    hopper::wgmma_commit();
    if (t + kDownStages < n_tiles) {
      // the stage is refilled once every warp's products on it are done; with no refill the
      // products of all the tiles run back to back
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      __syncthreads();
      if (tid == 0) fetch(stage, kt0 + t + kDownStages);
    }
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  // the partial tile into shared memory (the stages are free: every load was waited for)
  float* part = reinterpret_cast<float*>(smem);
  {
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
    #pragma unroll
    for (int n = 0; n < NT / 8; ++n) {
      #pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * warp + g + 8 * half;
        *reinterpret_cast<float2*>(part + r * L::kPitch + 8 * n + 2 * c) =
            make_float2(acc[4 * n + 2 * half], acc[4 * n + 2 * half + 1]);
      }
    }
  }
  cluster.sync();
  // block z adds its share of the rows from every partial, in rank order
  const int rows_each = kDownRows / split;
  const int pairs = rows_each * NT / 2;
  for (int p = tid; p < pairs; p += kWarpgroup) {
    const int r = z * rows_each + p / (NT / 2);
    const int col = 2 * (p % (NT / 2));
    float2 sum = make_float2(0.f, 0.f);
    for (int k = 0; k < split; ++k) {
      const float2 v = *reinterpret_cast<const float2*>(cluster.map_shared_rank(part, k) + r * L::kPitch + col);
      sum.x += v.x;
      sum.y += v.y;
    }
    const long long row = static_cast<long long>(row0) + r;
    const float scale = dn.scale[dn.slab_lora[(chunk * NT + col) / kSlabRows]];
    if (row < n_rows) *reinterpret_cast<uint32_t*>(h + row * ld_h + chunk * NT + col) = pack2<T>(sum.x * scale, sum.y * scale);
  }
  // H is written: the up-add may launch (it still waits for this grid to complete before reading H)
  launch_dependents();
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <typename T, int NT>
int launch_down(const CUtensorMap& tx, const Down& dn, void* h, long long n_rows, int ld_h, int k_tiles, int chunks,
                cudaStream_t stream) {
  constexpr int bytes = DownSmem<NT>::bytes;
  const cudaError_t err = cudaFuncSetAttribute(lora_down_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return int(err);
  // the largest cluster (a power of two, at most one block a k-tile) that keeps the grid within kSplitBlocks
  const long long row_blocks = (n_rows + kDownRows - 1) / kDownRows;
  unsigned split = 1;
  while (split < kMaxSplit && int(split) < k_tiles && row_blocks * chunks * split * 2 <= kSplitBlocks) split *= 2;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(unsigned(row_blocks), unsigned(chunks), split);
  config.blockDim = dim3(kWarpgroup);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  cudaLaunchAttribute cluster[2];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = split;
  cluster[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  cluster[1].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = cluster;
  config.numAttrs = 2;
  const cudaError_t launch =
      cudaLaunchKernelEx(&config, lora_down_kernel<T, NT>, tx, dn, static_cast<T*>(h), n_rows, ld_h, k_tiles);
  return int(launch != cudaSuccess ? launch : cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the up products and the add
// ---------------------------------------------------------------------------

constexpr int kGroup = 4;   // K steps a group of products (their A registers live together)
constexpr int kBM = 64;     // rows of y a block: one warpgroup
constexpr int kBN = 128;    // columns of y a block: one m64n128 accumulator
constexpr int kStepBytes = kBN * 32;  // one K step of U: kBN rows x 16 columns, 32-byte swizzle
constexpr int kUChunks = 2 * kBN / kWarpgroup;  // 16-byte chunks of U a thread writes for a K step
constexpr int kYPitch = kBN * 2 + 16;  // bytes a row of a staged y tile (padded: no bank conflicts)
constexpr int kYBytes = kBM * kYPitch;
constexpr int kYChunks = kBM * kBN / 8;  // 16-byte chunks of a y tile
constexpr int kYStages = 2;              // y tiles staged: this one and the next
constexpr int kUpBlocks = 3 * 132;       // blocks the up-add's grid aims at: three on each of the H100's SMs

struct Up {
  const void* h;             // (n_rows, ld_h) s_i H_i: K step s is columns [16 s, 16 s + 16)
  const void* u[kMaxLoras];  // (out, rank) up weights, row-major
  int rank[kMaxLoras];
  int vec[kMaxLoras];  // U rows load as 16-byte vectors: rank % 8 == 0 and a 16-byte-aligned base
  int ld_h;
  int steps;           // K steps, padded to a multiple of kGroup with steps of zeros
  unsigned char step_lora[kMaxSteps];  // kMaxLoras on a padding step
  unsigned char step_col[kMaxSteps];   // the step's first column / 16 within its LoRA
};

#define LORA_F8(i)                                                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
      "+f"(d[i + 7])
#define LORA_F32(i) LORA_F8(i), LORA_F8(i + 8), LORA_F8(i + 16), LORA_F8(i + 24)
#define LORA_N128_REGS                                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                    \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "                           \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                           \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "

// d (64 x 128, float32) += A B^T: A (64 x 16) from registers, B (128 x 16)
// K-major in shared memory (the transpose bit clear)
template <typename T>
__device__ __forceinline__ void wgmma_rs_kmajor(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " LORA_N128_REGS
                 "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
                 : LORA_F32(0), LORA_F32(32)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " LORA_N128_REGS
                 "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
                 : LORA_F32(0), LORA_F32(32)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
}

#undef LORA_N128_REGS
#undef LORA_F32
#undef LORA_F8

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

// generic-proxy writes to shared memory made visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// The A fragment of K step `step` for this thread's rows r0, r0 + 8: s_i H_i
// as the down kernel rounded it, two columns a load (zeros past the rows and
// on a padding step)
template <typename T>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const Up& P, int step, long long r0, long long n_rows, int c) {
  const T* h = static_cast<const T*>(P.h);
  #pragma unroll
  for (int e = 0; e < 4; ++e) {
    const long long row = r0 + 8 * (e & 1);
    const int col = 16 * step + 2 * c + 8 * (e >> 1);
    a[e] = P.step_lora[step] < kMaxLoras && row < n_rows
               ? __ldcg(reinterpret_cast<const unsigned int*>(h + row * P.ld_h + col))
               : 0u;
  }
}

template <typename T>
__device__ __forceinline__ void load_group(uint32_t (&a)[kGroup][4], const Up& P, int s0, long long r0,
                                           long long n_rows, int c) {
  #pragma unroll
  for (int j = 0; j < kGroup; ++j) load_a<T>(a[j], P, s0 + j, r0, n_rows, c);
}

// U's rows col .. of K step `step`, 8 columns `half`, as 16 bytes (zeros past
// `out`, past the rank and on a padding step)
template <typename T>
__device__ __forceinline__ uint4 load_u(const Up& P, int step, int col, int out, int half) {
  uint4 v = make_uint4(0, 0, 0, 0);
  const int i = P.step_lora[step];
  if (i >= kMaxLoras || col >= out) return v;
  const int rank = P.rank[i];
  const int k = P.step_col[step] * 16 + half * 8;
  const T* u = static_cast<const T*>(P.u[i]) + static_cast<long long>(col) * rank + k;
  if (P.vec[i]) {
    if (k < rank) v = *reinterpret_cast<const uint4*>(u);
  } else {
    T* w = reinterpret_cast<T*>(&v);
    #pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (k + e < rank) w[e] = u[e];
    }
  }
  return v;
}

// y's tile at row0 (64 rows x 128 columns from col0) into a staged buffer, by 16-byte cp.async
template <typename T>
__device__ __forceinline__ void stage_y(unsigned char* sy, const T* y, long long row0, int col0, long long n_rows,
                                        int out, int tid) {
  #pragma unroll
  for (int j = 0; j < kYChunks / kWarpgroup; ++j) {
    const int chunk = tid + j * kWarpgroup;
    const int r = chunk / (kBN / 8), cc = chunk % (kBN / 8);
    const long long row = row0 + r;
    const int col = col0 + cc * 8;
    if (row < n_rows && col < out) cp_async16(hopper::smem_u32(sy + r * kYPitch + cc * 16), y + row * out + col);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// y += the products for column tile blockIdx.y, row tiles blockIdx.x,
// blockIdx.x + gridDim.x, ...: U loaded once (while the down kernel still
// runs), the next two row tiles' y and the next one's H in flight while this
// one's products and epilogue run.
template <typename T>
__global__ void __launch_bounds__(kWarpgroup, 3)
    lora_up_add_kernel(T* __restrict__ y, long long n_rows, int out, const __grid_constant__ Up P) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* su = smem;                         // P.steps regions of kStepBytes
  unsigned char* sy = smem + P.steps * kStepBytes;  // kYStages buffers of kBM rows x kYPitch bytes
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  const int col0 = blockIdx.y * kBN;
  const long long row_tiles = (n_rows + kBM - 1) / kBM;
  const long long stride = gridDim.x;
  long long tile = blockIdx.x;

  // 1. U's rows col0 .. col0 + 128 of every K step: weights, read before the down kernel ends
  for (int s0 = 0; s0 < P.steps; s0 += kGroup) {
    uint4 v[kGroup][kUChunks];
    #pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      #pragma unroll
      for (int u = 0; u < kUChunks; ++u) {
        const int chunk = tid + u * kWarpgroup;  // row chunk / 2, half chunk % 2
        v[j][u] = load_u<T>(P, s0 + j, col0 + (chunk >> 1), out, chunk & 1);
      }
    }
    #pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      #pragma unroll
      for (int u = 0; u < kUChunks; ++u) {
        const int chunk = tid + u * kWarpgroup, r = chunk >> 1, half = chunk & 1;
        *reinterpret_cast<uint4*>(su + (s0 + j) * kStepBytes + r * 32 + ((half ^ ((r >> 2) & 1)) << 4)) = v[j][u];
      }
    }
  }
  fence_proxy_async();
  // 2. y (the target's output) and H (the down kernel's) once their kernels are done: the first
  // row tiles' y, the first one's H
  wait_prerequisites();
  #pragma unroll
  for (int k = 0; k < kYStages - 1; ++k) {
    if (tile + k * stride < row_tiles) stage_y<T>(sy + k * kYBytes, y, (tile + k * stride) * kBM, col0, n_rows, out, tid);
  }
  uint32_t a[kGroup][4], next_a[kGroup][4];
  load_group<T>(a, P, 0, tile * kBM + 16 * warp + g, n_rows, c);
  const uint32_t su_addr = hopper::smem_u32(su);

  for (int t = 0; tile < row_tiles; ++t, tile += stride) {
    const long long row0 = tile * kBM, r0 = row0 + 16 * warp + g;
    const long long next = tile + stride;
    unsigned char* buf = sy + (t % kYStages) * kYBytes;
    // the tile kYStages - 1 ahead, into the buffer the last iteration released
    const long long ahead = tile + (kYStages - 1) * stride;
    if (ahead < row_tiles) stage_y<T>(sy + ((t + kYStages - 1) % kYStages) * kYBytes, y, ahead * kBM, col0, n_rows, out, tid);
    __syncthreads();  // U (the first time) is in place

    // 3. the products; the next tile's H loads meanwhile
    float acc[64];
    #pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.f;
    for (int s0 = 0; s0 < P.steps; s0 += kGroup) {
      if (s0 > 0) load_group<T>(a, P, s0, r0, n_rows, c);
      hopper::wgmma_fence();
      #pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        wgmma_rs_kmajor<T>(acc, a[j], hopper::narrow_kmajor_desc(su_addr + (s0 + j) * kStepBytes));
      }
      hopper::wgmma_commit();
      if (s0 + kGroup >= P.steps && next < row_tiles) load_group<T>(next_a, P, 0, next * kBM + 16 * warp + g, n_rows, c);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
    }

    // 4. y + acc in float32, rounded once, through the staged tile: this tile's copy has landed
    // once no more than the copies of the tiles after it are pending
    const long long after = (row_tiles - 1 - tile) / stride;
    const long long pending = after < kYStages - 1 ? after : kYStages - 1;
    if (pending >= 2) {
      asm volatile("cp.async.wait_group 2;\n" ::: "memory");
    } else if (pending == 1) {
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    #pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
      const int col = 8 * n + 2 * c;
      #pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * warp + g + 8 * half;
        if (row0 + r >= n_rows || col0 + col >= out) continue;
        uint32_t* p = reinterpret_cast<uint32_t*>(buf + r * kYPitch + col * 2);
        const float2 old = unpack2<T>(*p);
        *p = pack2<T>(old.x + acc[4 * n + 2 * half], old.y + acc[4 * n + 2 * half + 1]);
      }
    }
    __syncthreads();
    #pragma unroll
    for (int j = 0; j < kYChunks / kWarpgroup; ++j) {
      const int chunk = tid + j * kWarpgroup;
      const int r = chunk / (kBN / 8), cc = chunk % (kBN / 8);
      const long long row = row0 + r;
      const int col = col0 + cc * 8;
      if (row < n_rows && col < out) {
        *reinterpret_cast<uint4*>(y + row * out + col) = *reinterpret_cast<const uint4*>(buf + r * kYPitch + cc * 16);
      }
    }
    if (next < row_tiles) {
      #pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        #pragma unroll
        for (int e = 0; e < 4; ++e) a[j][e] = next_a[j][e];
      }
    }
    __syncthreads();  // this buffer is read: a later tile may land in it
  }
}

inline int up_smem_bytes(int steps) { return steps * kStepBytes + kYStages * kYBytes + hopper::kSwizzleAtomBytes; }

template <typename T>
int launch_up(void* y, long long n_rows, int out, const Up& P, cudaStream_t stream) {
  const int bytes = up_smem_bytes(P.steps);
  const cudaError_t err = cudaFuncSetAttribute(lora_up_add_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return int(err);
  // each block walks down one column tile, all blocks resident at once (a grid past kUpBlocks would
  // leave its last blocks a second wave) and the row tiles shared out evenly: the fewest row tiles a
  // block that fit, then the fewest blocks that take them
  const long long row_tiles = (n_rows + kBM - 1) / kBM;
  const int col_tiles = (out + kBN - 1) / kBN;
  const long long per_block = (row_tiles + std::max(kUpBlocks / col_tiles, 1) - 1) / std::max(kUpBlocks / col_tiles, 1);
  const long long rows = (row_tiles + per_block - 1) / per_block;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(rows), static_cast<unsigned>(col_tiles));
  config.blockDim = dim3(kWarpgroup);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  cudaLaunchAttribute dependent[1];
  dependent[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  dependent[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = dependent;
  config.numAttrs = 1;
  const cudaError_t launch = cudaLaunchKernelEx(&config, lora_up_add_kernel<T>, static_cast<T*>(y), n_rows, out, P);
  return int(launch != cudaSuccess ? launch : cudaGetLastError());
}

// ranks -> the K steps' LoRAs and columns; false past kMaxSteps
bool plan_steps(int count, const int* ranks, int& steps, unsigned char* step_lora, unsigned char* step_col) {
  steps = 0;
  for (int i = 0; i < count; ++i) {
    if (ranks[i] <= 0) return false;
    for (int j = 0; j < (ranks[i] + 15) / 16; ++j, ++steps) {
      if (steps >= kMaxSteps) return false;
      step_lora[steps] = static_cast<unsigned char>(i);
      step_col[steps] = static_cast<unsigned char>(j);
    }
  }
  return true;
}

}  // namespace

// The width of the H that refiners_lora_down writes for these ranks
// (the ranks, each padded to 16, then to the chunk: 32, 64 or a multiple of
// 128), or 0 where the kernels do not take them.
extern "C" int refiners_lora_h_width(int count, const int* ranks) {
  unsigned char lora[kMaxSteps], col[kMaxSteps];
  int steps = 0;
  if (count < 1 || count > kMaxLoras || ranks == nullptr || !plan_steps(count, ranks, steps, lora, col)) return 0;
  const int k = 16 * steps;
  return k <= 32 ? 32 : k <= 64 ? 64 : (k + 127) / 128 * 128;
}

// h (n_rows, ld_h) = x (n_rows, in; rows ld_x elements apart, a multiple of 8,
// 16-byte-aligned) times the `count` downs[i] (ranks[i], in; contiguous,
// 16-byte-aligned), side by side in 16-column steps, each LoRA's columns
// scaled by scales[i] in float32 and rounded once; x, the downs and h in
// `dtype` (0 bf16, 1 f16); ld_h = refiners_lora_h_width. Returns a
// cudaError_t.
extern "C" int refiners_lora_down(const void* x, long long n_rows, int in, long long ld_x, int dtype, int count,
                                  const void* const* downs, const int* ranks, const float* scales, void* h, int ld_h,
                                  void* stream) {
  const int width = refiners_lora_h_width(count, ranks);
  if (x == nullptr || downs == nullptr || scales == nullptr || h == nullptr || n_rows <= 0 || in <= 0 || in % 8 != 0 ||
      ld_x < in ||
      ld_x % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 || width == 0 || ld_h != width ||
      (n_rows + kDownRows - 1) / kDownRows > 0x7fffffffLL || n_rows > 0x7fffffffLL || (dtype != 0 && dtype != 1)) {
    return int(cudaErrorInvalidValue);
  }
  const bool bf16 = dtype == 0;
  CUtensorMap tx;
  if (!hopper::encode_map(&tx, bf16, x, in, int(n_rows), 1, 1, ld_x, 0, 0, hopper::kBox, kDownRows)) {
    return int(cudaErrorInvalidValue);
  }
  Down dn{};
  unsigned char cols[kMaxSteps];
  if (!plan_steps(count, ranks, dn.slabs, dn.slab_lora, cols)) return int(cudaErrorInvalidValue);
  for (int q = 0; q < dn.slabs; ++q) dn.slab_row[q] = cols[q];
  for (int i = 0; i < count; ++i) {
    dn.scale[i] = scales[i];
    if (downs[i] == nullptr || reinterpret_cast<uintptr_t>(downs[i]) % 16 != 0 ||
        !hopper::encode_map(&dn.d[i], bf16, downs[i], in, ranks[i], 1, 1, in, 0, 0, hopper::kBox, kSlabRows)) {
      return int(cudaErrorInvalidValue);
    }
  }
  const int k_tiles = (in + hopper::kBox - 1) / hopper::kBox;
  const int nt = ld_h < 128 ? ld_h : 128;
  const int chunks = ld_h / nt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (nt == 32) return launch_down<__nv_bfloat16, 32>(tx, dn, h, n_rows, ld_h, k_tiles, chunks, s);
    if (nt == 64) return launch_down<__nv_bfloat16, 64>(tx, dn, h, n_rows, ld_h, k_tiles, chunks, s);
    return launch_down<__nv_bfloat16, 128>(tx, dn, h, n_rows, ld_h, k_tiles, chunks, s);
  }
  if (nt == 32) return launch_down<__half, 32>(tx, dn, h, n_rows, ld_h, k_tiles, chunks, s);
  if (nt == 64) return launch_down<__half, 64>(tx, dn, h, n_rows, ld_h, k_tiles, chunks, s);
  return launch_down<__half, 128>(tx, dn, h, n_rows, ld_h, k_tiles, chunks, s);
}

// y (n_rows, out), contiguous, 16-byte-aligned, out a multiple of 8, in
// `dtype` (0 bf16, 1 f16): y += sum_i (s_i H_i) ups[i]^T, s_i H_i LoRA i's
// steps of h (n_rows, ld_h) as refiners_lora_down writes it, ups[i] (out,
// ranks[i]) contiguous, all in `dtype`. Returns a cudaError_t.
extern "C" int refiners_lora_up_add(void* y, long long n_rows, int out, int dtype, int count, const void* h, int ld_h,
                                    const void* const* ups, const int* ranks, void* stream) {
  if (y == nullptr || h == nullptr || ups == nullptr || n_rows <= 0 || out <= 0 || ld_h <= 0 || out % 8 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0 || refiners_lora_h_width(count, ranks) != ld_h ||
      (n_rows + kBM - 1) / kBM > 0x7fffffffLL || (out + kBN - 1) / kBN > 65535) {
    return int(cudaErrorInvalidValue);
  }
  Up P{};
  P.h = h;
  P.ld_h = ld_h;
  int steps = 0;
  if (!plan_steps(count, ranks, steps, P.step_lora, P.step_col)) return int(cudaErrorInvalidValue);
  for (; steps % kGroup != 0; ++steps) {
    P.step_lora[steps] = kMaxLoras;
    P.step_col[steps] = 0;
  }
  P.steps = steps;
  for (int i = 0; i < count; ++i) {
    if (ups[i] == nullptr) return int(cudaErrorInvalidValue);
    P.u[i] = ups[i];
    P.rank[i] = ranks[i];
    P.vec[i] = ranks[i] % 8 == 0 && reinterpret_cast<uintptr_t>(ups[i]) % 16 == 0;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_up<__nv_bfloat16>(y, n_rows, out, P, s);
    case 1: return launch_up<__half>(y, n_rows, out, P, s);
    default: return int(cudaErrorInvalidValue);
  }
}

