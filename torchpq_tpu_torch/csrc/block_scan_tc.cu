// IVF block scan over the bf16 decoded cache on Hopper's tensor cores
// (sm_90a): the counterpart of torchpq_tpu/ops/pallas_scan.py:
// scan_blocks_pallas in bf16 mode for rows of d <= 128, d % 8 == 0
// (block_scan_wg.cu serves the wider bf16 rows, 128 < d <= 1024;
// block_scan_tc_int8.cu the int8 mode; block_scan.cu, on the CUDA cores,
// f32 caches and the other shapes). It
// computes what block_scan.cu computes, for block b, prober p and window
// slot j < s_eff (column j of the window):
//
//   score = factor * <q_p, y_{start_c[b] + j}> - pen_j,   factor = 2 or 1
//   pen_j = penalty[start_c[b] + j] + (off[b] <= j < off[b] + cap[b] ? 0 : BIG)
//
// summed in f32 over bf16 operands, then the selects of block_scan.cu in
// its wire format (exact: value descending, slot ascending; pack32: one
// maximal key per strided group of slots {j, j+G, ...}, then the k_pair
// largest). One difference: rows whose prober is -1 are not scored but
// written dead (exact: sortable(-inf) keys and -1 addresses; pack32:
// INT_MIN). ops/adc.py:_merge_pairs never reads them.
//
// What bounds it on an H100: at the bf16 plans' arguments (4,075 blocks of
// 128 probers at n_probe 8, 4,507 at n_probe 32; s_eff 640 over the
// compacted layout; d = 128) the bytes are the window rows the blocks
// cover, ~0.3 GB (~0.09 ms at 3.35 TB/s: the blocks of one cell share its
// window, so most of the ~0.7 GB the CTAs copy comes from L2), and the
// products of the live probers ~1e10-4e10 operations (~0.01-0.04 ms at
// 989 TFLOP/s bf16). With one CTA of 8 warps per SM (its registers), two
// warps per scheduler hide little latency: the time goes to dependent
// chains (each k step's mma.sync on the last, the pack32 keys and their
// phase-end extraction, the exact select's inserts) and to each tile's copy
// where the scoring is too short to cover it, not to bytes or products.
// block_scan.cu spent its time on what this design drops: an f32 FMA chain
// per prober (every window element feeds 128 FMAs) and pad probers scored
// in full (15% of rows are live at n_probe 8, 56% at n_probe 32).
//
// Design: scan_tc.cuh's body (persistent CTAs of 8 warps, live 16-prober
// tiles only, mma.sync over tiles of 128 window columns, warps split by
// column slices, pack32 maxima in registers, the exact select staged
// through shared memory), fed by its RowsSource: the window's bf16 rows
// are B as they lie in the cache ([slot][k]), so a tile is a copy, 16
// bytes per cp.async (tc_ptx.cuh); column c is slot c. The copy of the
// next stage is in flight while the warps score this one (the two stage
// buffers alternate), and each thread waits for its own copies after
// scoring, before the stage's barrier. The A fragments of a warp's m tile
// stay in registers; tiles are of whole rows of round32(2d) + 16 bytes;
// pack32 above k_pair 16 (the deep-k scans, up to 64) runs in a kernel
// instance of its own whose phase ends sort the group maxima
// (scan_tc.cuh:sort_slice) instead of extracting them pass by pass.
// Budget at d = 128: shared memory 2 x 34,816 B tiles + 2,048 B penalties
// and slots + 544 B prober rows and tile flags + the slice lists + exact:
// 37,376 B staging rows and row bounds, 12,288 B queues; pack32: running
// lists: 132,128 B exact and 89,120 B pack32 at k_pair 10, 172,064 B
// pack32 at k_pair 64. One CTA of 8 warps per SM, for its registers (the
// body's, few of the source's).

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
  RowsSource<false> src;
  src.init(decoded, penalty, nullptr, 2 * d, row_ld(2 * d, false));
  scan_blocks<Bf16, PACK, KMAX, false, false>(
      src, smem_raw, reinterpret_cast<const unsigned char*>(qtable), nullptr,
      probers, start_c, off, capb, out, n_blocks, p_tile, 2 * d, s_eff,
      k_pair, factor, slot_mask, n_groups);
}

size_t smem_of(int d, int pack32, int k_pair) {
  return body_smem_bytes(2 * d, pack32, k_pair, false, false);
}

template <bool PACK, int KMAX>
int occupancy_of(int d, int k_pair) {
  return occupancy(block_scan_tc_kernel<PACK, KMAX>,
                   smem_of(d, PACK, k_pair));
}

}  // namespace

// Plain C entry point (bound with ctypes). qtable [nq, d] bf16 and decoded
// [capacity, d] bf16, both 16-byte aligned, d % 8 == 0 and d <= 128;
// probers [n_blocks, p_tile] int32 (p_tile % 16 == 0,
// p_tile <= 128), start_c / off / capb [n_blocks] int32, penalty
// [capacity] f32, out int32; exact: k_pair <= 16; pack32: k_pair <= 64
// (172,064 B of shared memory at d = 128) and n_groups % 8 == 0,
// either n_groups == s_eff <= 128, or n_groups a multiple of 128 that
// divides s_eff. n_ctas: the persistent grid (at most n_blocks). Returns 0
// or the CUDA error code of an attribute call or the launch
// (cudaErrorInvalidValue, without launching, for other shapes or a shared
// memory above SMEM_LIMIT). Launches on `stream`, does not synchronize and
// allocates nothing.
extern "C" int torchpq_block_scan_tc(
    const void* qtable, const int* probers, const int* start_c,
    const int* off, const int* capb, const float* penalty,
    const void* decoded, int* out, int n_blocks, int p_tile, int d,
    int s_eff, int k_pair, int euclidean, int pack32, int slot_mask,
    int n_groups, int n_ctas, void* stream) {
  const size_t smem = smem_of(d, pack32, k_pair);
  if (!shape_ok(n_blocks, n_ctas, p_tile, 2 * d, MAX_ROW, s_eff,
                k_pair, pack32, n_groups) ||
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
  if (pack32 && k_pair > PASS_K) {  // the deep selects: sorted
    TPQ_LAUNCH(true, MAX_PACK_K);
  }
  if (pack32) TPQ_LAUNCH(true, PASS_K);
  if (k_pair <= 10) TPQ_LAUNCH(false, 10);
  TPQ_LAUNCH(false, 16);
#undef TPQ_LAUNCH
#undef TPQ_ARGS
}

// Dynamic shared memory of one CTA at width d.
extern "C" long long torchpq_block_scan_tc_smem(int d, int pack32,
                                               int k_pair) {
  return (long long)smem_of(d, pack32, k_pair);
}

// CTAs one SM holds at once (registers and shared memory permitting), or
// minus the CUDA error code.
extern "C" int torchpq_block_scan_tc_occupancy(int d, int pack32,
                                               int k_pair) {
  if (pack32 && k_pair > PASS_K) {
    return occupancy_of<true, MAX_PACK_K>(d, k_pair);
  }
  if (pack32) return occupancy_of<true, PASS_K>(d, k_pair);
  return k_pair <= 10 ? occupancy_of<false, 10>(d, k_pair)
                      : occupancy_of<false, 16>(d, k_pair);
}
