// IVF block scan over the bf16 decoded cache on the tensor cores (mma.sync,
// sm_90a): the deep pack32 selects (k_pair 17-64) of rows of d <= 128, d %
// 8 == 0, whose phases cover few window tiles. The counterpart of
// torchpq_tpu/ops/pallas_scan.py:scan_blocks_pallas in bf16 mode at these
// shapes; block_scan_wg.cu (wgmma, TMA, warp-specialised) serves every
// other bf16 shape, and since PR 19 this file keeps only the instance
// ops/block_scan.py:pick_route still sends work to: where a pack32 phase
// covers fewer than 8 window tiles (the untapered deep-k scan, 2; the
// IVFPQR k = 100 scan, 4; the residual k = 100 scan, 5), its sorted phase
// ends (scan_tc.cuh:sort_slice) beat block_scan_wg.cu's narrow instances,
// whose consumers have no registers left to sort (ptxas spilled 40-64 B)
// and extract pass by pass: 5.039 against 6.423 ms, 3.002 against 3.314
// and 1.542 against 1.600 in turns on those scans' own arguments (the
// deep-k head, 8 tiles a phase, went the other way: 1.718 against 1.587;
// NVIDIA H100 80GB HBM3, 700.00 W). It computes, for block b, prober p and
// window slot j < s_eff (column j of the window):
//
//   score = factor * <q_p, y_{start_c[b] + j}> - pen_j,   factor = 2 or 1
//   pen_j = penalty[start_c[b] + j] + (off[b] <= j < off[b] + cap[b] ? 0 : BIG)
//
// summed in f32 over bf16 operands, then the pack32 select of
// block_scan.cu in its wire format (one maximal key per strided group of
// slots {j, j+G, ...}, then the k_pair largest). Rows whose prober is -1
// are not scored but written dead (INT_MIN); ops/adc.py:_merge_pairs
// never reads them.
//
// What bounds it on an H100: at those scans' arguments the window rows'
// bytes (0.13-0.28 ms at 3.35 TB/s); the time goes to the k_pair 64
// select (its phase ends sort 32-128 group maxima a row) and to dependent
// mma.sync chains, with one CTA of 8 warps per SM.
//
// Design: scan_tc.cuh's body (persistent CTAs of 8 warps, live 16-prober
// tiles only, mma.sync over tiles of 128 window columns, warps split by
// column slices, pack32 maxima in registers, phase ends sorted by
// sort_slice), fed by its RowsSource: the window's bf16 rows are B as they
// lie in the cache ([slot][k]), so a tile is a copy, 16 bytes per cp.async
// (tc_ptx.cuh); column c is slot c. The copy of the next stage is in
// flight while the warps score this one. The A fragments of a warp's m
// tile stay in registers; tiles are of whole rows of round32(2d) + 16
// bytes. Shared memory at d = 128: 2 x 34,816 B tiles + 2,048 B penalties
// and slots + 544 B prober rows and tile flags + the slice and running
// lists: 172,064 B at k_pair 64.

#include <cstdint>

#include "scan_tc.cuh"

namespace {

using namespace tpq;
using namespace tpq::tc;

template <bool PACK, int KMAX>
__global__ void __launch_bounds__(THREADS, 1) block_scan_tc_kernel(
    const __nv_bfloat16* __restrict__ qtable,
    const int* __restrict__ probers, const int* __restrict__ start_c,
    const int* __restrict__ off, const int* __restrict__ capb,
    const float* __restrict__ penalty,
    const __nv_bfloat16* __restrict__ decoded, int* __restrict__ out,
    int n_blocks, int p_tile, int d, int s_eff, int k_pair, float factor,
    int slot_mask, int n_groups) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  static_assert(PACK && KMAX == MAX_PACK_K, "the sorted pack32 instance");
  RowsSource src;
  src.init(decoded, penalty, 2 * d, row_ld(2 * d));
  scan_blocks(
      src, smem_raw, reinterpret_cast<const unsigned char*>(qtable), probers,
      start_c, off, capb, out, n_blocks, p_tile, 2 * d, s_eff, k_pair,
      factor, slot_mask, n_groups);
}

size_t smem_of(int d, int pack32, int k_pair) {
  return body_smem_bytes(2 * d, pack32, k_pair);
}

int occupancy_of(int d, int k_pair) {
  return occupancy(block_scan_tc_kernel<true, MAX_PACK_K>,
                   smem_of(d, true, k_pair));
}

}  // namespace

// Plain C entry point (bound with ctypes). qtable [nq, d] bf16 and decoded
// [capacity, d] bf16, both 16-byte aligned, d % 8 == 0 and d <= 128;
// probers [n_blocks, p_tile] int32 (p_tile % 16 == 0,
// p_tile <= 128), start_c / off / capb [n_blocks] int32, penalty
// [capacity] f32, out int32; pack32 only (the sorted instance at any
// k_pair <= 64: 172,064 B of shared memory at d = 128 and k_pair 64) with
// n_groups % 8 == 0, either n_groups == s_eff <= 128, or n_groups a
// multiple of 128 that divides s_eff. n_ctas: the persistent grid (at most
// n_blocks). Returns 0 or the CUDA error code of an attribute call or the
// launch (cudaErrorInvalidValue, without launching, for the exact select,
// other shapes or a shared memory above SMEM_LIMIT). Launches on `stream`,
// does not synchronize and allocates nothing.
extern "C" int torchpq_block_scan_tc(
    const void* qtable, const int* probers, const int* start_c,
    const int* off, const int* capb, const float* penalty,
    const void* decoded, int* out, int n_blocks, int p_tile, int d,
    int s_eff, int k_pair, int euclidean, int pack32, int slot_mask,
    int n_groups, int n_ctas, void* stream) {
  const size_t smem = smem_of(d, pack32, k_pair);
  if (!pack32 ||
      !shape_ok(n_blocks, n_ctas, p_tile, 2 * d, MAX_ROW, s_eff, k_pair,
                pack32, n_groups) ||
      smem > SMEM_LIMIT || reinterpret_cast<uintptr_t>(qtable) % 16 ||
      reinterpret_cast<uintptr_t>(decoded) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const float factor = euclidean ? 2.0f : 1.0f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TPQ_ARGS                                                          \
  static_cast<const __nv_bfloat16*>(qtable), probers, start_c, off, capb, \
      penalty, static_cast<const __nv_bfloat16*>(decoded), out, n_blocks, \
      p_tile, d, s_eff, k_pair, factor, slot_mask, n_groups
#define TPQ_LAUNCH(...)                                                   \
  return launch_kernel(block_scan_tc_kernel<__VA_ARGS__>, dim3(n_ctas),   \
                       THREADS, smem, st, TPQ_ARGS)
  TPQ_LAUNCH(true, MAX_PACK_K);
#undef TPQ_LAUNCH
#undef TPQ_ARGS
}

// Dynamic shared memory of one CTA at width d.
extern "C" long long torchpq_block_scan_tc_smem(int d, int pack32,
                                               int k_pair) {
  return (long long)smem_of(d, pack32, k_pair);
}

// CTAs one SM holds at once (registers and shared memory permitting), or
// minus the CUDA error code (the one instance: pack32 is the only select).
extern "C" int torchpq_block_scan_tc_occupancy(int d, int, int k_pair) {
  return occupancy_of(d, k_pair);
}
