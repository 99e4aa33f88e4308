// Hopper's asynchronous instructions for block_scan_wg.cu and
// flat_scan_wg.cu, one inline-PTX wrapper each (sm_90a): the warpgroup
// matrix product (wgmma: bf16 with f32 sums, s8 with s32 sums), the tensor
// memory accelerator's 2-D tiled load (TMA), the shared-memory barriers
// that track arrivals and transferred bytes (mbarrier), the register
// hand-over between warpgroups (setmaxnreg), named barriers and the proxy
// fence. The index math they rely on is wg_layout.cuh's.

#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

#include "tc_ptx.cuh"
#include "wg_layout.cuh"

namespace tpq {
namespace wg {

// --- mbarrier -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Make the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival (release: this thread's earlier shared-memory writes are
// seen by whoever waits for the phase).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 state;\n"
      " mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(smem_u32(bar))
      : "memory");
}

// Raise the phase's expected transaction bytes (no arrival).
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// An arrival that fires when this thread's earlier cp.async copies have
// landed (counted among the barrier's expected arrivals: .noinc).
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Cycles a barrier wait may last before the kernel traps (~10 s): a
// schedule that never completes a phase fails the launch instead of
// hanging the card.
constexpr long long WAIT_LIMIT = 1LL << 34;

// Wait until the barrier's phase of parity `parity` has completed
// (acquire).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (t0 == 0) {
      t0 = now;
    } else if (now - t0 > WAIT_LIMIT) {
      __trap();
    }
  }
}

// --- TMA ------------------------------------------------------------------

// The 2-D box at tensor coordinates (x, y) of `map` into shared memory at
// `dst` (1,024-byte aligned for the 128-byte swizzle); its bytes complete
// the transaction count of `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y)
      : "memory");
}

// --- ordering -------------------------------------------------------------

// This thread's generic-proxy accesses to shared memory (what cp.async
// wrote and a barrier wait made visible) ordered before its later
// async-proxy ones (wgmma's operand reads).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier among `count` threads (a multiple of 32) under id `id` (0 is
// __syncthreads').
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The same with the barrier's id and count as immediates (no register
// holds them across a loop), and an arrival on it that does not wait for
// it to complete (the threads that wait on it pass once COUNT arrived).
template <int ID, int COUNT>
__device__ __forceinline__ void named_barrier_imm() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(COUNT) : "memory");
}
template <int ID, int COUNT>
__device__ __forceinline__ void named_barrier_arrive_imm() {
  asm volatile("bar.arrive %0, %1;\n" ::"n"(ID), "n"(COUNT) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// --- wgmma ----------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Tie the accumulators to this point of the instruction stream: the
// compiler neither reads them before the wait that completes the products
// nor moves their other uses across a wgmma.
__device__ __forceinline__ void fence_acc(float (&d)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[j][i])::"memory");
  }
}

// d += A (64 x 16 bf16, descriptor da) * B (16 x 64 bf16, K-major rows,
// descriptor db), f32. Register d[j][i] holds acc_row / acc_col of
// register 4 j + i.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[8][4], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(1));
}

// d = A * B from a zero sum (scale-d false): d is written, not read, so
// the compiler keeps no earlier value of it alive.
__device__ __forceinline__ void wgmma_m64n64k16_zero(float (&d)[8][4],
                                                     uint64_t da,
                                                     uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0][0]), "=f"(d[0][1]), "=f"(d[0][2]), "=f"(d[0][3]),
        "=f"(d[1][0]), "=f"(d[1][1]), "=f"(d[1][2]), "=f"(d[1][3]),
        "=f"(d[2][0]), "=f"(d[2][1]), "=f"(d[2][2]), "=f"(d[2][3]),
        "=f"(d[3][0]), "=f"(d[3][1]), "=f"(d[3][2]), "=f"(d[3][3]),
        "=f"(d[4][0]), "=f"(d[4][1]), "=f"(d[4][2]), "=f"(d[4][3]),
        "=f"(d[5][0]), "=f"(d[5][1]), "=f"(d[5][2]), "=f"(d[5][3]),
        "=f"(d[6][0]), "=f"(d[6][1]), "=f"(d[6][2]), "=f"(d[6][3]),
        "=f"(d[7][0]), "=f"(d[7][1]), "=f"(d[7][2]), "=f"(d[7][3])
      : "l"(da), "l"(db), "r"(0));
}

// The same over 128 window rows (B 16 x 128): lo holds the m16n8
// fragments of the first 64 columns (rows of B), hi those of the next 64.
__device__ __forceinline__ void wgmma_m64n128k16(float (&lo)[8][4],
                                                 float (&hi)[8][4],
                                                 uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(lo[0][0]), "+f"(lo[0][1]), "+f"(lo[0][2]), "+f"(lo[0][3]),
        "+f"(lo[1][0]), "+f"(lo[1][1]), "+f"(lo[1][2]), "+f"(lo[1][3]),
        "+f"(lo[2][0]), "+f"(lo[2][1]), "+f"(lo[2][2]), "+f"(lo[2][3]),
        "+f"(lo[3][0]), "+f"(lo[3][1]), "+f"(lo[3][2]), "+f"(lo[3][3]),
        "+f"(lo[4][0]), "+f"(lo[4][1]), "+f"(lo[4][2]), "+f"(lo[4][3]),
        "+f"(lo[5][0]), "+f"(lo[5][1]), "+f"(lo[5][2]), "+f"(lo[5][3]),
        "+f"(lo[6][0]), "+f"(lo[6][1]), "+f"(lo[6][2]), "+f"(lo[6][3]),
        "+f"(lo[7][0]), "+f"(lo[7][1]), "+f"(lo[7][2]), "+f"(lo[7][3]),
        "+f"(hi[0][0]), "+f"(hi[0][1]), "+f"(hi[0][2]), "+f"(hi[0][3]),
        "+f"(hi[1][0]), "+f"(hi[1][1]), "+f"(hi[1][2]), "+f"(hi[1][3]),
        "+f"(hi[2][0]), "+f"(hi[2][1]), "+f"(hi[2][2]), "+f"(hi[2][3]),
        "+f"(hi[3][0]), "+f"(hi[3][1]), "+f"(hi[3][2]), "+f"(hi[3][3]),
        "+f"(hi[4][0]), "+f"(hi[4][1]), "+f"(hi[4][2]), "+f"(hi[4][3]),
        "+f"(hi[5][0]), "+f"(hi[5][1]), "+f"(hi[5][2]), "+f"(hi[5][3]),
        "+f"(hi[6][0]), "+f"(hi[6][1]), "+f"(hi[6][2]), "+f"(hi[6][3]),
        "+f"(hi[7][0]), "+f"(hi[7][1]), "+f"(hi[7][2]), "+f"(hi[7][3])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_m64n128k16_zero(float (&lo)[8][4],
                                                      float (&hi)[8][4],
                                                      uint64_t da,
                                                      uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(lo[0][0]), "=f"(lo[0][1]), "=f"(lo[0][2]), "=f"(lo[0][3]),
        "=f"(lo[1][0]), "=f"(lo[1][1]), "=f"(lo[1][2]), "=f"(lo[1][3]),
        "=f"(lo[2][0]), "=f"(lo[2][1]), "=f"(lo[2][2]), "=f"(lo[2][3]),
        "=f"(lo[3][0]), "=f"(lo[3][1]), "=f"(lo[3][2]), "=f"(lo[3][3]),
        "=f"(lo[4][0]), "=f"(lo[4][1]), "=f"(lo[4][2]), "=f"(lo[4][3]),
        "=f"(lo[5][0]), "=f"(lo[5][1]), "=f"(lo[5][2]), "=f"(lo[5][3]),
        "=f"(lo[6][0]), "=f"(lo[6][1]), "=f"(lo[6][2]), "=f"(lo[6][3]),
        "=f"(lo[7][0]), "=f"(lo[7][1]), "=f"(lo[7][2]), "=f"(lo[7][3]),
        "=f"(hi[0][0]), "=f"(hi[0][1]), "=f"(hi[0][2]), "=f"(hi[0][3]),
        "=f"(hi[1][0]), "=f"(hi[1][1]), "=f"(hi[1][2]), "=f"(hi[1][3]),
        "=f"(hi[2][0]), "=f"(hi[2][1]), "=f"(hi[2][2]), "=f"(hi[2][3]),
        "=f"(hi[3][0]), "=f"(hi[3][1]), "=f"(hi[3][2]), "=f"(hi[3][3]),
        "=f"(hi[4][0]), "=f"(hi[4][1]), "=f"(hi[4][2]), "=f"(hi[4][3]),
        "=f"(hi[5][0]), "=f"(hi[5][1]), "=f"(hi[5][2]), "=f"(hi[5][3]),
        "=f"(hi[6][0]), "=f"(hi[6][1]), "=f"(hi[6][2]), "=f"(hi[6][3]),
        "=f"(hi[7][0]), "=f"(hi[7][1]), "=f"(hi[7][2]), "=f"(hi[7][3])
      : "l"(da), "l"(db), "r"(0));
}

// d += A (64 x 32 int8, descriptor da) * B (32 x 64 int8, K-major rows,
// descriptor db), exact s32 sums (no saturation: |d| < 2^24 for rows of at
// most 1,024 bytes). Both operands K-major, as 8-bit wgmma requires. The
// s32 accumulator lies as the f32 one (acc_row / acc_col).
__device__ __forceinline__ void wgmma_m64n64k32_s8(
    int (&d)[8][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
        "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
        "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
        "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
        "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
        "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
        "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
        "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3])
      : "l"(da), "l"(db), "r"(1));
}

// d = A * B from a zero sum (scale-d false).
__device__ __forceinline__ void wgmma_m64n64k32_s8_zero(
    int (&d)[8][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "=r"(d[0][0]), "=r"(d[0][1]), "=r"(d[0][2]), "=r"(d[0][3]),
        "=r"(d[1][0]), "=r"(d[1][1]), "=r"(d[1][2]), "=r"(d[1][3]),
        "=r"(d[2][0]), "=r"(d[2][1]), "=r"(d[2][2]), "=r"(d[2][3]),
        "=r"(d[3][0]), "=r"(d[3][1]), "=r"(d[3][2]), "=r"(d[3][3]),
        "=r"(d[4][0]), "=r"(d[4][1]), "=r"(d[4][2]), "=r"(d[4][3]),
        "=r"(d[5][0]), "=r"(d[5][1]), "=r"(d[5][2]), "=r"(d[5][3]),
        "=r"(d[6][0]), "=r"(d[6][1]), "=r"(d[6][2]), "=r"(d[6][3]),
        "=r"(d[7][0]), "=r"(d[7][1]), "=r"(d[7][2]), "=r"(d[7][3])
      : "l"(da), "l"(db), "r"(0));
}

// The same over 128 window rows: lo the first 64 columns, hi the next 64.
__device__ __forceinline__ void wgmma_m64n128k32_s8(
    int (&lo)[8][4], int (&hi)[8][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(lo[0][0]), "+r"(lo[0][1]), "+r"(lo[0][2]), "+r"(lo[0][3]),
        "+r"(lo[1][0]), "+r"(lo[1][1]), "+r"(lo[1][2]), "+r"(lo[1][3]),
        "+r"(lo[2][0]), "+r"(lo[2][1]), "+r"(lo[2][2]), "+r"(lo[2][3]),
        "+r"(lo[3][0]), "+r"(lo[3][1]), "+r"(lo[3][2]), "+r"(lo[3][3]),
        "+r"(lo[4][0]), "+r"(lo[4][1]), "+r"(lo[4][2]), "+r"(lo[4][3]),
        "+r"(lo[5][0]), "+r"(lo[5][1]), "+r"(lo[5][2]), "+r"(lo[5][3]),
        "+r"(lo[6][0]), "+r"(lo[6][1]), "+r"(lo[6][2]), "+r"(lo[6][3]),
        "+r"(lo[7][0]), "+r"(lo[7][1]), "+r"(lo[7][2]), "+r"(lo[7][3]),
        "+r"(hi[0][0]), "+r"(hi[0][1]), "+r"(hi[0][2]), "+r"(hi[0][3]),
        "+r"(hi[1][0]), "+r"(hi[1][1]), "+r"(hi[1][2]), "+r"(hi[1][3]),
        "+r"(hi[2][0]), "+r"(hi[2][1]), "+r"(hi[2][2]), "+r"(hi[2][3]),
        "+r"(hi[3][0]), "+r"(hi[3][1]), "+r"(hi[3][2]), "+r"(hi[3][3]),
        "+r"(hi[4][0]), "+r"(hi[4][1]), "+r"(hi[4][2]), "+r"(hi[4][3]),
        "+r"(hi[5][0]), "+r"(hi[5][1]), "+r"(hi[5][2]), "+r"(hi[5][3]),
        "+r"(hi[6][0]), "+r"(hi[6][1]), "+r"(hi[6][2]), "+r"(hi[6][3]),
        "+r"(hi[7][0]), "+r"(hi[7][1]), "+r"(hi[7][2]), "+r"(hi[7][3])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_m64n128k32_s8_zero(
    int (&lo)[8][4], int (&hi)[8][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "=r"(lo[0][0]), "=r"(lo[0][1]), "=r"(lo[0][2]), "=r"(lo[0][3]),
        "=r"(lo[1][0]), "=r"(lo[1][1]), "=r"(lo[1][2]), "=r"(lo[1][3]),
        "=r"(lo[2][0]), "=r"(lo[2][1]), "=r"(lo[2][2]), "=r"(lo[2][3]),
        "=r"(lo[3][0]), "=r"(lo[3][1]), "=r"(lo[3][2]), "=r"(lo[3][3]),
        "=r"(lo[4][0]), "=r"(lo[4][1]), "=r"(lo[4][2]), "=r"(lo[4][3]),
        "=r"(lo[5][0]), "=r"(lo[5][1]), "=r"(lo[5][2]), "=r"(lo[5][3]),
        "=r"(lo[6][0]), "=r"(lo[6][1]), "=r"(lo[6][2]), "=r"(lo[6][3]),
        "=r"(lo[7][0]), "=r"(lo[7][1]), "=r"(lo[7][2]), "=r"(lo[7][3]),
        "=r"(hi[0][0]), "=r"(hi[0][1]), "=r"(hi[0][2]), "=r"(hi[0][3]),
        "=r"(hi[1][0]), "=r"(hi[1][1]), "=r"(hi[1][2]), "=r"(hi[1][3]),
        "=r"(hi[2][0]), "=r"(hi[2][1]), "=r"(hi[2][2]), "=r"(hi[2][3]),
        "=r"(hi[3][0]), "=r"(hi[3][1]), "=r"(hi[3][2]), "=r"(hi[3][3]),
        "=r"(hi[4][0]), "=r"(hi[4][1]), "=r"(hi[4][2]), "=r"(hi[4][3]),
        "=r"(hi[5][0]), "=r"(hi[5][1]), "=r"(hi[5][2]), "=r"(hi[5][3]),
        "=r"(hi[6][0]), "=r"(hi[6][1]), "=r"(hi[6][2]), "=r"(hi[6][3]),
        "=r"(hi[7][0]), "=r"(hi[7][1]), "=r"(hi[7][2]), "=r"(hi[7][3])
      : "l"(da), "l"(db), "r"(0));
}

__device__ __forceinline__ void fence_acc(int (&d)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(d[j][i])::"memory");
  }
}

// One 32-byte k step of the operand the accumulators name: bf16 (k16, f32
// sums) for float accumulators, int8 (k32, s32 sums) for int ones; _zero
// from a zero sum. N = 64 (one column half) or 128 (lo and hi).
__device__ __forceinline__ void wgmma_n64(float (&d)[8][4], uint64_t da,
                                          uint64_t db) {
  wgmma_m64n64k16(d, da, db);
}
__device__ __forceinline__ void wgmma_n64(int (&d)[8][4], uint64_t da,
                                          uint64_t db) {
  wgmma_m64n64k32_s8(d, da, db);
}
__device__ __forceinline__ void wgmma_n64_zero(float (&d)[8][4], uint64_t da,
                                               uint64_t db) {
  wgmma_m64n64k16_zero(d, da, db);
}
__device__ __forceinline__ void wgmma_n64_zero(int (&d)[8][4], uint64_t da,
                                               uint64_t db) {
  wgmma_m64n64k32_s8_zero(d, da, db);
}
__device__ __forceinline__ void wgmma_n128(float (&lo)[8][4],
                                           float (&hi)[8][4], uint64_t da,
                                           uint64_t db) {
  wgmma_m64n128k16(lo, hi, da, db);
}
__device__ __forceinline__ void wgmma_n128(int (&lo)[8][4], int (&hi)[8][4],
                                           uint64_t da, uint64_t db) {
  wgmma_m64n128k32_s8(lo, hi, da, db);
}
__device__ __forceinline__ void wgmma_n128_zero(float (&lo)[8][4],
                                                float (&hi)[8][4],
                                                uint64_t da, uint64_t db) {
  wgmma_m64n128k16_zero(lo, hi, da, db);
}
__device__ __forceinline__ void wgmma_n128_zero(int (&lo)[8][4],
                                                int (&hi)[8][4], uint64_t da,
                                                uint64_t db) {
  wgmma_m64n128k32_s8_zero(lo, hi, da, db);
}

}  // namespace wg
}  // namespace tpq
