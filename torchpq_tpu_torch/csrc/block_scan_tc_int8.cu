// IVF block scan over the int8 scan cache on Hopper's tensor cores
// (sm_90a): the counterpart of torchpq_tpu/ops/pallas_scan.py:
// scan_blocks_pallas in int8 mode (int8 query rows and cache rows with f32
// scales per query and per slot), for rows of d <= 1024 with d % 16 == 0
// (block_scan.cu, on the CUDA cores, serves the other int8 shapes). For
// block b, prober p and window slot j < s_eff (column j of the window):
//
//   ab    = sum_k q8[p, k] * y8[start_c[b] + j, k]    (exact, s32)
//   m     = (factor * q_scale[p]) * scale[start_c[b] + j]   (f32, that order)
//   score = fmaf(float(ab), m, -pen_j),   factor = 2 (euclidean) or 1
//   pen_j = penalty[start_c[b] + j] + (off[b] <= j < off[b] + cap[b] ? 0 : BIG)
//
// then the selects of block_scan.cu in its wire format. The products are
// exact integers in any order and their f32 conversion is exact (|ab| <=
// d * 127^2 < 2^24 for d <= 1040), so the scores are block_scan.cu's
// (scan_common.cuh:scan_rows_int8) bit for bit, ties included, on every
// input. One difference: rows whose prober is -1 are not scored but
// written dead (exact: sortable(-inf) keys and -1 addresses; pack32:
// INT_MIN). ops/adc.py:_merge_pairs never reads them.
//
// What bounds it on an H100: at the 1M x 128 int8 plans' arguments (4,075
// blocks of 128 probers at n_probe 8, 4,507 at n_probe 32; s_eff 640 over
// the compacted layout) the bytes are the window rows the blocks cover and
// their scales, ~0.2 GB (~0.05 ms at 3.35 TB/s; most of what the CTAs copy
// comes from L2, the blocks of a cell sharing its window), and the products
// of the live probers ~1e10-4e10 operations (~0.01-0.02 ms at 1,979 TOP/s
// int8). As for the bf16 scan (block_scan_tc.cu), what is left is latency:
// the dependent chains of the select and each tile's copy where the scoring
// is too short to cover it. At the GIST-class cache (d = 1024) a block's
// products are 8x longer and the window chunks 4 per tile. block_scan.cu
// spent its time on what this design drops: __dp4a chains on the CUDA
// cores with every window byte feeding 128 probers, pad probers scored in
// full (15% of rows are live at n_probe 8, 56% at n_probe 32).
//
// Design: scan_tc.cuh's body over its S8 operand (mma.sync m16n8k32 s8,
// s32 sums, fragments byte for byte the bf16 ones), fed by RowsSource<true>
// (16-byte cp.async copies of the window rows, column c slot c, and each
// column's penalty and scale); the scale m of each score from the prober's
// factor * q_scale (two per lane, read once per block) and the column's
// scale in shared memory.
// - d <= 256 (narrow): the A fragments of a warp's m tile in registers (16
//   at d = 128, 32 at d = 256), tiles of whole rows; pack32 above k_pair 16
//   in a kernel instance whose phase ends sort (scan_tc.cuh:sort_slice).
//   Budget at d = 128: shared memory 2 x 18,432 B tiles + 3,072 B
//   penalties, slots and scales + 544 B prober rows and tile flags + the
//   slice lists + exact: 37,376 B staging rows and row bounds, 12,288 B
//   queues; pack32: running lists:
//   100,384 B exact and 57,376 B pack32 at k_pair 10 (at d = 256: 133,152 B
//   and 90,144 B; 173,088 B pack32 at k_pair 64).
// - 256 < d <= 1024 (chunked, the GIST-class cache): each tile in k chunks
//   of 256 bytes, a ring stage per (tile, chunk) holding the window chunk
//   and the block's query rows' chunk (2 x (34,816 + 34,816) B), A by
//   ldmatrix per k step, the accumulators of a warp's columns kept across a
//   tile's chunks (64 registers). Budget at d = 1024: 202,784 B exact and
//   159,776 B pack32 at k_pair 10, 208,928 B exact at 16, 218,144 B pack32
//   at 48 (pass by pass); pack32 k_pair 49-64 (the GIST-class plans at
//   k = 100) in an instance of its own with one running list
//   (scan_tc.cuh's ONE_LIST: the merge staged through the query chunk
//   just scored), pass by pass as well: 209,440 B at 64 (two lists:
//   242,720 B, above the limit). One CTA of 8 warps per SM in both, for
//   its registers.

#include <cstdint>

#include "scan_tc.cuh"

namespace {

using namespace tpq;
using namespace tpq::tc;

template <bool PACK, int KMAX, bool CHUNKED, bool ONE_LIST>
__global__ void __launch_bounds__(THREADS, 1) block_scan_tc_int8_kernel(
    const signed char* __restrict__ qtable, const float* __restrict__ q_scale,
    const int* __restrict__ probers, const int* __restrict__ start_c,
    const int* __restrict__ off, const int* __restrict__ capb,
    const float* __restrict__ penalty, const float* __restrict__ scale,
    const signed char* __restrict__ decoded, int* __restrict__ out,
    int n_blocks, int p_tile, int d, int s_eff, int k_pair, float factor,
    int slot_mask, int n_groups) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  RowsSource<true> src;
  src.init(decoded, penalty, scale, d, row_ld(d, CHUNKED));
  scan_blocks<S8, PACK, KMAX, CHUNKED, ONE_LIST>(
      src, smem_raw, reinterpret_cast<const unsigned char*>(qtable), q_scale,
      probers, start_c, off, capb, out, n_blocks, p_tile, d, s_eff, k_pair,
      factor, slot_mask, n_groups);
}

size_t smem_of(int d, int pack32, int k_pair) {
  return body_smem_bytes(d, pack32, k_pair, true, d > MAX_ROW, false,
                         one_list_of(d, pack32, k_pair));
}

template <bool PACK, int KMAX, bool CHUNKED, bool ONE_LIST>
int occupancy_of(int d, int k_pair) {
  return occupancy(block_scan_tc_int8_kernel<PACK, KMAX, CHUNKED, ONE_LIST>,
                   smem_of(d, PACK, k_pair));
}

template <bool CHUNKED>
int occupancy_mode(int d, int pack32, int k_pair) {
  if (pack32 && !CHUNKED && k_pair > PASS_K) {
    return occupancy_of<true, MAX_PACK_K, false, false>(d, k_pair);
  }
  if (pack32 && CHUNKED && k_pair > CHUNKED_PACK_K) {
    return occupancy_of<true, PASS_K, true, true>(d, k_pair);
  }
  if (pack32) return occupancy_of<true, PASS_K, CHUNKED, false>(d, k_pair);
  return k_pair <= 10 ? occupancy_of<false, 10, CHUNKED, false>(d, k_pair)
                      : occupancy_of<false, 16, CHUNKED, false>(d, k_pair);
}

}  // namespace

// Plain C entry point (bound with ctypes). qtable [nq, d] int8 and decoded
// [capacity, d] int8, both 16-byte aligned, d % 16 == 0 and d <= 1024
// (chunked above 256); q_scale [nq] and scale [capacity] f32; probers
// [n_blocks, p_tile] int32 (p_tile % 16 == 0, p_tile <= 128), start_c /
// off / capb [n_blocks] int32, penalty [capacity] f32, out int32; exact:
// k_pair <= 16; pack32: k_pair <= 64 (d <= 256: 173,088 B at k_pair 64;
// chunked rows: 218,144 B at 48, one running list above it, 209,440 B at
// 64) and n_groups % 8 == 0, either n_groups == s_eff <= 128, or n_groups a
// multiple of 128 that divides s_eff. n_ctas: the persistent grid (at most
// n_blocks). Returns 0 or the CUDA error code of an attribute call or the
// launch (cudaErrorInvalidValue, without launching, for other shapes or a
// shared memory above SMEM_LIMIT). Launches on `stream`, does not
// synchronize and allocates nothing.
extern "C" int torchpq_block_scan_tc_int8(
    const void* qtable, const float* q_scale, const int* probers,
    const int* start_c, const int* off, const int* capb,
    const float* penalty, const float* scale, const void* decoded, int* out,
    int n_blocks, int p_tile, int d, int s_eff, int k_pair, int euclidean,
    int pack32, int slot_mask, int n_groups, int n_ctas, void* stream) {
  const size_t smem = smem_of(d, pack32, k_pair);
  if (!shape_ok(n_blocks, n_ctas, p_tile, d, MAX_CHUNKED_ROW, s_eff, k_pair,
                pack32, n_groups) ||
      smem > SMEM_LIMIT || reinterpret_cast<uintptr_t>(qtable) % 16 ||
      reinterpret_cast<uintptr_t>(decoded) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const float factor = euclidean ? 2.0f : 1.0f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TPQ_ARGS                                                              \
  static_cast<const signed char*>(qtable), q_scale, probers, start_c, off,   \
      capb, penalty, scale, static_cast<const signed char*>(decoded), out,   \
      n_blocks, p_tile, d, s_eff, k_pair, factor, slot_mask, n_groups
#define TPQ_LAUNCH(...)                                                    \
  return launch_kernel(block_scan_tc_int8_kernel<__VA_ARGS__>, dim3(n_ctas), \
                       THREADS, smem, st, TPQ_ARGS)
  if (d > MAX_ROW) {  // chunked rows
    if (pack32 && k_pair > CHUNKED_PACK_K) {  // one running list
      TPQ_LAUNCH(true, PASS_K, true, true);
    }
    if (pack32) TPQ_LAUNCH(true, PASS_K, true, false);
    if (k_pair <= 10) TPQ_LAUNCH(false, 10, true, false);
    TPQ_LAUNCH(false, 16, true, false);
  }
  if (pack32 && k_pair > PASS_K) {  // the deep selects: sorted
    TPQ_LAUNCH(true, MAX_PACK_K, false, false);
  }
  if (pack32) TPQ_LAUNCH(true, PASS_K, false, false);
  if (k_pair <= 10) TPQ_LAUNCH(false, 10, false, false);
  TPQ_LAUNCH(false, 16, false, false);
#undef TPQ_LAUNCH
#undef TPQ_ARGS
}

// Dynamic shared memory of one CTA at width d.
extern "C" long long torchpq_block_scan_tc_int8_smem(int d, int pack32,
                                                    int k_pair) {
  return (long long)smem_of(d, pack32, k_pair);
}

// CTAs one SM holds at once (registers and shared memory permitting), or
// minus the CUDA error code.
extern "C" int torchpq_block_scan_tc_int8_occupancy(int d, int pack32,
                                                    int k_pair) {
  return d > MAX_ROW ? occupancy_mode<true>(d, pack32, k_pair)
                     : occupancy_mode<false>(d, pack32, k_pair);
}
