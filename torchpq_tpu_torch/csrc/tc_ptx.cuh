// The tensor-core and asynchronous-copy instructions of flat_scan_tc.cu and
// block_scan_wg.cu (its cp.async copies), one inline-PTX wrapper each (sm_80
// and later; built for sm_90a), and the fragment layouts they imply, as
// plain functions of the lane (scan_tc.cuh's selects index the C fragment's,
// which the wgmma accumulators share warp by warp).
//
// Layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16 with floating point
// type" and "Warp-level matrix load instruction: ldmatrix"); lane l,
// g = l / 4, t = l % 4; each 32-bit register holds two bf16, the lower
// column in the low half:
//   A 16x16 (.row):  a[i] = A[g + 8 * (i % 2)][2t + 8 * (i / 2) + {0, 1}]
//   B 16x8  (.col):  b[i] = B[2t + 8 * i + {0, 1}][g]
//   C 16x8  (f32):   c[i] = C[g + 8 * (i / 2)][2t + (i % 2)]
//   ldmatrix .x4:    lane l gives the address of row l % 8 of matrix l / 8
//                    and receives, in register j, row g, columns 2t and
//                    2t + 1 of matrix j.
// B is K x N column-major, so a cache stored [slot][k] row-major is B as it
// lies: an 8 x 8 matrix of cache rows (slots) is one B register fragment.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace tpq {

// Row of C (in the 16-row m tile) that register c[i] of `lane` holds.
__host__ __device__ constexpr int frag_c_row(int lane, int i) {
  return lane / 4 + 8 * (i / 2);
}
// Column of C (in the 8-column n tile) that register c[i] of `lane` holds.
__host__ __device__ constexpr int frag_c_col(int lane, int i) {
  return 2 * (lane % 4) + i % 2;
}
// Row (of 16) and column (of 16) of the A tile whose address `lane` gives
// to ldmatrix.x4, so that the four registers are a[0..3].
__host__ __device__ constexpr int ldm_a_row(int lane) {
  return lane % 8 + 8 * ((lane / 8) % 2);
}
__host__ __device__ constexpr int ldm_a_col(int lane) {
  return 8 * (lane / 16);
}
// Slot (of a 16-slot slab = two n8 tiles) and column (of 16) of the cache
// tile whose address `lane` gives to ldmatrix.x4, so that registers 0, 1
// are b[0], b[1] of the first n8 tile and 2, 3 those of the second.
__host__ __device__ constexpr int ldm_b_row(int lane) {
  return lane % 8 + 8 * (lane / 16);
}
__host__ __device__ constexpr int ldm_b_col(int lane) {
  return 8 * ((lane / 8) % 2);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 writes 16 zero bytes
// and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 8 bytes global -> shared.
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// 4 bytes global -> shared.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory (see the layout above).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c += A (16x16 bf16) * B (16x8 bf16), f32 accumulation.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = A (16x16 bf16) * B (16x8 bf16), from a zero accumulator.
__device__ __forceinline__ void mma_bf16_16816_zero(float (&c)[4],
                                                    const uint32_t (&a)[4],
                                                    uint32_t b0,
                                                    uint32_t b1) {
  const float z = 0.0f;
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(z));
}

}  // namespace tpq
