// Hopper (sm_90a) building blocks for the port's kernels, in raw PTX: TMA
// tensor maps and tile loads completed on mbarriers, named barriers, and
// warpgroup matrix products (wgmma) with their shared-memory descriptors.
//
// Layout conventions (bfloat16 and float16 operands):
// - A tile of 64 rows x 64 columns loaded by TMA with the 128-byte swizzle is
//   one "box": 64 rows of 128 bytes, 8 KiB, whose 16-byte chunks are XOR-ed
//   with the row index modulo 8. A box must start 1024-byte aligned. Wider
//   tiles are boxes side by side, box b at byte 8192 * b.
// - Read as a K-major wgmma operand (rows = M or N, columns = K), a box is
//   the canonical SW128 layout: 8-row groups 1024 bytes apart (SBO); the
//   product's 16-deep K step k starts 32 * k bytes into the box.
// - Read as an MN-major operand (rows = K, columns = N, as V is in P V), N
//   runs 64 columns within a box and then to the next box (LBO = 8192
//   bytes), K runs 8 rows per 1024 bytes (SBO); the K step k starts 16
//   rows, 2048 bytes, further on.
// - Accumulators of wgmma.m64nN (float32, N / 2 registers a thread): thread
//   t of the warpgroup, warp w = t / 32, lane l, g = l / 4, c = l % 4, holds
//   d[4n + e] at row 16w + g + 8 * (e / 2), column 8n + 2c + e % 2.
// - A from registers (m64nNk16): 4 registers of two values, the 16 x 16
//   A fragment of warp w's 16 rows, so the accumulators of two
//   neighbouring 8-column chunks, packed two by two, are the A operand of
//   their 16 columns (see acc_to_a in flash_common.cuh).
// - A narrow box of 16 columns x 64 rows with the 32-byte swizzle (2 KiB,
//   256-byte aligned) holds the 16 columns past a whole box (d = 80): read
//   K-major it is one 16-deep K step with 8-row groups 256 bytes apart;
//   read MN-major (N = 16) its K step k starts 16 rows, 512 bytes, further
//   on.
// - `Tile<D, R>` lays out R rows x D columns of one head as these boxes;
//   the attention kernels read Q, K, V, dO through it.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

constexpr int kBox = 64;                  // rows and columns of a TMA box
constexpr int kBoxBytes = kBox * kBox * 2;  // a box of 16-bit values: 8 KiB
constexpr int kSwizzleAtomBytes = 1024;   // 8 rows of 128 bytes
constexpr int kNarrowBox = 16;            // columns of a 32-byte-swizzled box
constexpr int kNarrowBoxBytes = kNarrowBox * kBox * 2;  // 2 KiB
constexpr int kNarrowAtomBytes = 256;     // 8 rows of 32 bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers and named barriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// makes the initialized barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival, and `bytes` more expected from async copies this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` has completed; called by whole
// warps, which leave it converged (the warpgroup instructions need that)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
  __syncwarp();
}

// one arrival on `bar` once every cp.async the calling thread has issued so
// far has landed (the barrier's expected count includes it)
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// named barrier `id` (1..15; 0 is __syncthreads) over `count` threads
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// arrive at named barrier `id` without waiting
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// Copy the box at (c0, c1, c2, c3) of a 4-D tensor map into shared memory at
// `dst`; completes `bytes` of the transaction count of mbarrier `bar`.
// Elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor of a swizzled operand at byte address
// `addr` (within an atom pattern aligned to its repeat): leading and stride
// byte offsets in bytes; `layout` 1 for the 128-byte swizzle, 3 for 32 bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint32_t layout) {
  return uint64_t((addr & 0x3FFFF) >> 4) | uint64_t((lbo >> 4) & 0x3FFF) << 16 |
         uint64_t((sbo >> 4) & 0x3FFF) << 32 | uint64_t(layout) << 62;
}

// a K-major operand of whole boxes (K step offsets added by the caller)
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) { return smem_desc(addr, 16, kSwizzleAtomBytes, 1); }

// an MN-major operand whose N runs over boxes `box_stride` bytes apart
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr, uint32_t box_stride = kBoxBytes) {
  return smem_desc(addr, box_stride, kSwizzleAtomBytes, 1);
}

// a narrow box read K-major (one 16-deep K step) or MN-major (N = 16)
__device__ __forceinline__ uint64_t narrow_kmajor_desc(uint32_t addr) {
  return smem_desc(addr, 16, kNarrowAtomBytes, 3);
}
__device__ __forceinline__ uint64_t narrow_mnmajor_desc(uint32_t addr) {
  return smem_desc(addr, kNarrowBoxBytes, kNarrowAtomBytes, 3);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
  #pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define HOPPER_F8(d, i)                                                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
      "+f"(d[i + 7])
#define HOPPER_F32(d, i) HOPPER_F8(d, i), HOPPER_F8(d, i + 8), HOPPER_F8(d, i + 16), HOPPER_F8(d, i + 24)

#define HOPPER_N16_REGS "{%0, %1, %2, %3, %4, %5, %6, %7}, "
#define HOPPER_N32_REGS "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
#define HOPPER_N64_REGS                                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                    \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
#define HOPPER_N128_REGS                                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                    \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "                           \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                           \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
#define HOPPER_N256_REGS                                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                    \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "                           \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                           \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "                           \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "                           \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "                           \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "                \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
// d (64 x N, float32) = (scale_d ? d : 0) + A B^T, A and B K-major in
// shared memory: N = 32, 64 or 128
template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_ss is compiled for N = 32, 64 and 128");
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  if constexpr (N == 32 && bf16) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " HOPPER_N32_REGS "%16, %17, p, 1, 1, 0, 0;\n}\n"
                 : HOPPER_F8(d, 0), HOPPER_F8(d, 8) : "l"(a), "l"(b), "r"(scale_d));
  } else if constexpr (N == 32) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 " HOPPER_N32_REGS "%16, %17, p, 1, 1, 0, 0;\n}\n"
                 : HOPPER_F8(d, 0), HOPPER_F8(d, 8) : "l"(a), "l"(b), "r"(scale_d));
  } else if constexpr (N == 64 && bf16) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_N64_REGS "%32, %33, p, 1, 1, 0, 0;\n}\n"
                 : HOPPER_F32(d, 0) : "l"(a), "l"(b), "r"(scale_d));
  } else if constexpr (N == 64) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " HOPPER_N64_REGS "%32, %33, p, 1, 1, 0, 0;\n}\n"
                 : HOPPER_F32(d, 0) : "l"(a), "l"(b), "r"(scale_d));
  } else if constexpr (bf16) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_N128_REGS
                 "%64, %65, p, 1, 1, 0, 0;\n}\n"
                 : HOPPER_F32(d, 0), HOPPER_F32(d, 32) : "l"(a), "l"(b), "r"(scale_d));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " HOPPER_N128_REGS
                 "%64, %65, p, 1, 1, 0, 0;\n}\n"
                 : HOPPER_F32(d, 0), HOPPER_F32(d, 32) : "l"(a), "l"(b), "r"(scale_d));
  }
}

// an RS product: A in operands I0..I3, the B descriptor in I4, scale-d in P
#define HOPPER_RS_TAIL(I0, I1, I2, I3, I4) \
  "{%" #I0 ", %" #I1 ", %" #I2 ", %" #I3 "}, %" #I4 ", p, 1, 1, 1;\n}\n"
#define HOPPER_RS(SHAPE, TYPE, REGS, P, I0, I1, I2, I3, I4)                                           \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                                               \
  "wgmma.mma_async.sync.aligned." SHAPE ".f32." TYPE "." TYPE " " REGS HOPPER_RS_TAIL(I0, I1, I2, I3, I4)

// d (64 x N, float32) += A B, A (64 x 16) from registers, B (16 x N)
// MN-major in shared memory (the transpose bit set): N = 16, 64, 128 or 256
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  static_assert(N == 16 || N == 64 || N == 128 || N == 256, "wgmma_rs is compiled for N = 16, 64, 128 and 256");
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
#define HOPPER_RS_IN "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)
  if constexpr (N == 16 && bf16) {
    asm volatile(HOPPER_RS("m64n16k16", "bf16", HOPPER_N16_REGS, 13, 8, 9, 10, 11, 12)
                 : HOPPER_F8(d, 0) : HOPPER_RS_IN);
  } else if constexpr (N == 16) {
    asm volatile(HOPPER_RS("m64n16k16", "f16", HOPPER_N16_REGS, 13, 8, 9, 10, 11, 12)
                 : HOPPER_F8(d, 0) : HOPPER_RS_IN);
  } else if constexpr (N == 64 && bf16) {
    asm volatile(HOPPER_RS("m64n64k16", "bf16", HOPPER_N64_REGS, 37, 32, 33, 34, 35, 36)
                 : HOPPER_F32(d, 0) : HOPPER_RS_IN);
  } else if constexpr (N == 64) {
    asm volatile(HOPPER_RS("m64n64k16", "f16", HOPPER_N64_REGS, 37, 32, 33, 34, 35, 36)
                 : HOPPER_F32(d, 0) : HOPPER_RS_IN);
  } else if constexpr (N == 128 && bf16) {
    asm volatile(HOPPER_RS("m64n128k16", "bf16", HOPPER_N128_REGS, 69, 64, 65, 66, 67, 68)
                 : HOPPER_F32(d, 0), HOPPER_F32(d, 32) : HOPPER_RS_IN);
  } else if constexpr (N == 128) {
    asm volatile(HOPPER_RS("m64n128k16", "f16", HOPPER_N128_REGS, 69, 64, 65, 66, 67, 68)
                 : HOPPER_F32(d, 0), HOPPER_F32(d, 32) : HOPPER_RS_IN);
  } else if constexpr (bf16) {
    asm volatile(HOPPER_RS("m64n256k16", "bf16", HOPPER_N256_REGS, 133, 128, 129, 130, 131, 132)
                 : HOPPER_F32(d, 0), HOPPER_F32(d, 32), HOPPER_F32(d, 64), HOPPER_F32(d, 96) : HOPPER_RS_IN);
  } else {
    asm volatile(HOPPER_RS("m64n256k16", "f16", HOPPER_N256_REGS, 133, 128, 129, 130, 131, 132)
                 : HOPPER_F32(d, 0), HOPPER_F32(d, 32), HOPPER_F32(d, 64), HOPPER_F32(d, 96) : HOPPER_RS_IN);
  }
#undef HOPPER_RS_IN
}

#undef HOPPER_RS
#undef HOPPER_RS_TAIL
#undef HOPPER_N16_REGS
#undef HOPPER_N32_REGS
#undef HOPPER_N64_REGS
#undef HOPPER_N128_REGS
#undef HOPPER_N256_REGS
#undef HOPPER_F32
#undef HOPPER_F8

// ---------------------------------------------------------------------------
// tiles of one head, as the attention kernels lay them out
// ---------------------------------------------------------------------------

// R rows (a multiple of 64) x D columns (D = 64, 80 or 128, the head dim
// padded) of one head: D / 64 whole boxes of 64 columns (128-byte swizzle),
// each its R / 64 row boxes of 8 KiB one after another (R * 128 bytes);
// then, at D = 80, a narrow box of 16 columns (32-byte swizzle), R * 32
// bytes. Rows run on across row boxes, so R rows are one wgmma operand.
// Read MN-major, the whole boxes are one operand of N = kMainN and the
// narrow box one of N = 16, so no product runs over zero columns past D;
// read K-major, the tile is D / 16 steps of 16 columns.
template <int D, int R>
struct Tile {
  static_assert(D == 64 || D == 80 || D == 128, "tiles are compiled for D = 64, 80 and 128");
  static_assert(R % kBox == 0, "a tile is whole row boxes");
  static constexpr int kBoxes = D / kBox;
  static constexpr int kMainN = kBoxes * kBox;  // columns in whole boxes
  static constexpr int kRemN = D % kBox;        // columns in the narrow box (0 or 16)
  static constexpr int kBoxStride = R * 128;    // bytes from one whole box to the next
  static constexpr int kNarrow = kBoxes * kBoxStride;  // offset of the narrow box
  static constexpr int kBytes = kNarrow + kRemN * R * 2;
  static constexpr int kSteps = D / 16;

  // K-major descriptor of K step kk (columns [16 kk, 16 kk + 16)) of the
  // tile at `base`
  static __device__ __forceinline__ uint64_t kmajor(uint32_t base, int kk) {
    return kk < 4 * kBoxes ? kmajor_desc(base + (kk / 4) * kBoxStride + (kk % 4) * 32)
                           : narrow_kmajor_desc(base + kNarrow);
  }
  // MN-major descriptors of K step kc (rows [16 kc, 16 kc + 16)): the whole
  // boxes' columns, the narrow box's columns
  static __device__ __forceinline__ uint64_t mn_main(uint32_t base, int kc) {
    return mnmajor_desc(base + kc * 16 * 128, kBoxStride);
  }
  static __device__ __forceinline__ uint64_t mn_rem(uint32_t base, int kc) {
    return narrow_mnmajor_desc(base + kNarrow + kc * 16 * 32);
  }
};

// Rows [row, row + R) of head (h, b) onto `bar`, laid out as Tile<D, R>:
// `map` serves the whole boxes, `narrow` the narrow one.
template <int D, int R>
__device__ __forceinline__ void load_tile(const CUtensorMap* map, const CUtensorMap* narrow, uint32_t bar,
                                          uint32_t dst, int row, int h, int b) {
  using L = Tile<D, R>;
  #pragma unroll
  for (int r = 0; r < R / kBox; ++r) {
    #pragma unroll
    for (int i = 0; i < L::kBoxes; ++i) {
      tma_load_4d(dst + i * L::kBoxStride + r * kBoxBytes, map, bar, i * kBox, row + r * kBox, h, b);
    }
    if constexpr (L::kRemN > 0) {
      tma_load_4d(dst + L::kNarrow + r * kNarrowBoxBytes, narrow, bar, L::kMainN, row + r * kBox, h, b);
    }
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, looked up through the CUDA runtime
// (cudaGetDriverEntryPoint), so that the libraries need no link against libcuda
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    return err == cudaSuccess && status == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(ptr)
                                                                       : nullptr;
  }();
  return fn;
}

// A 4-D tensor map over 16-bit values (columns, rows, heads, batch), strides
// in elements, for boxes of `box_cols` columns x `box_rows` rows (64, or 32
// for the wide backward's streamed tiles) of one head: 64 columns with the
// 128-byte swizzle, or 16 (`kNarrowBox`) with the 32-byte swizzle. Columns
// past `cols` and rows past `rows` read as zeros. Returns false where the
// encoder refuses the map (strides not multiples of 16 bytes, an unaligned
// base).
inline bool encode_map(CUtensorMap* map, bool bf16, const void* base, int cols, int rows, int heads, int batch,
                       long long row_stride, long long head_stride, long long batch_stride, int box_cols,
                       int box_rows = kBox) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr || (box_cols != kBox && box_cols != kNarrowBox)) return false;
  const cuuint64_t dims[4] = {cuuint64_t(cols), cuuint64_t(rows), cuuint64_t(heads), cuuint64_t(batch)};
  const long long strides[3] = {row_stride, head_stride, batch_stride};
  cuuint64_t bytes[3];
  for (int i = 0; i < 3; ++i) {
    // a dimension of size 1 is never stepped along: any valid stride will do
    const bool unit = dims[i + 1] == 1 && (strides[i] <= 0 || strides[i] % 8 != 0);
    bytes[i] = unit ? 16 : cuuint64_t(strides[i]) * 2;
  }
  const cuuint32_t box[4] = {cuuint32_t(box_cols), cuuint32_t(box_rows), 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = box_cols == kBox ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult res = encode(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 4,
                              const_cast<void*>(base), dims, bytes, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS;
}

// The two maps of a head-strided operand that `load_tile` reads: 64-column
// boxes (maps[0]) and 16-column boxes (maps[1]).
inline bool encode_tile_maps(CUtensorMap (&maps)[2], bool bf16, const void* base, int cols, int rows, int heads,
                             int batch, long long row_stride, long long head_stride, long long batch_stride) {
  return encode_map(&maps[0], bf16, base, cols, rows, heads, batch, row_stride, head_stride, batch_stride, kBox) &&
         encode_map(&maps[1], bf16, base, cols, rows, heads, batch, row_stride, head_stride, batch_stride,
                    kNarrowBox);
}

}  // namespace hopper
