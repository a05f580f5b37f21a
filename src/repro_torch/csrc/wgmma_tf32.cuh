// TF32 wgmma for the float32 attention backward
// (flash_attention_bwd_tf32.cu): the RS products (A from registers, B from
// shared memory) at the widths it uses, a K-major descriptor without
// swizzle, and the float32 tensor maps its producer loads raw tiles with.
// The descriptor of a 128-byte-swizzled tile, the fences and the driver's
// tensor-map entry are wgmma.cuh's.
//
// wgmma.m64nNk8 in TF32 takes both operands K-major only (no transpose
// bit). Fragments, for the thread of lane l (g = l / 4, t = l % 4) in warp
// w of the warpgroup:
// - A (4 registers, the TF32 bits of f32 values): a0 = (row 16 w + g,
//   k t), a1 = (16 w + g + 8, t), a2 = (16 w + g, t + 4), a3 = (16 w + g +
//   8, t + 4), as mma.sync.m16n8k8's A;
// - D (N / 2 f32): d[4 j + e] = (row 16 w + g + 8 (e >> 1), column 8 j +
//   2 t + (e & 1)), as the bf16 products'.
// B is read from shared memory through a descriptor: N rows of 8 k values
// (32 bytes), as a 128-byte-swizzled tile ([rows][32 floats], the address
// stepping 32 bytes a k-step, 8-row groups 1024 bytes apart) or as core
// matrices without swizzle (desc_plain: a core matrix is 8 rows of 4
// floats, 128 contiguous bytes; LBO the step between the two core matrices
// of a k-step, SBO the step between 8-row groups).
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

// a K-major operand in core matrices without swizzle (layout type 0);
// offsets in bytes
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// wait until at most N of this warpgroup's committed groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D[64 x 16] (+)= A[64 x 8] . B[8 x 16] in TF32, f32 accumulation;
// accumulate = 0 overwrites D
__device__ __forceinline__ void wgmma_tf32_n16(float (&d)[8],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, "
      "1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 32] (+)= A[64 x 8] . B[8 x 32]
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 8] . B[8 x 64]
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <int N>
struct TF32;
template <>
struct TF32<16> {
  __device__ static void rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                            int acc) {
    wgmma_tf32_n16(d, a, b, acc);
  }
};
template <>
struct TF32<32> {
  __device__ static void rs(float (&d)[16], const uint32_t (&a)[4],
                            uint64_t b, int acc) {
    wgmma_tf32_n32(d, a, b, acc);
  }
};
template <>
struct TF32<64> {
  __device__ static void rs(float (&d)[32], const uint32_t (&a)[4],
                            uint64_t b, int acc) {
    wgmma_tf32_n64(d, a, b, acc);
  }
};

// ---- host side --------------------------------------------------------------

// [heads, s, d] float32, boxes of 32 columns (128 bytes) x box_rows rows,
// 128-byte swizzle, rows past s zero-filled
bool make_map_f32(EncodeTiled fn, CUtensorMap* map, const void* ptr,
                  int64_t heads, int64_t s, int d, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 4, (cuuint64_t)s * d * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
