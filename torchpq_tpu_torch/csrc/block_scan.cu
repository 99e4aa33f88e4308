// IVF block scan for Hopper (sm_90a): the CUDA counterpart of
// torchpq_tpu/ops/pallas_scan.py:scan_blocks_pallas.
//
// A block is up to p_tile probers (queries) of one IVF cell. For block b,
// prober p and window slot j in [0, s_eff):
//
//   score = c * <q_p, y_{start_c[b] + j}> - pen,   c = 2 (euclidean) or 1
//   pen   = penalty[start_c[b] + j] + (off[b] <= j < off[b] + cap[b] ? 0 : BIG)
//
// with f32 accumulation over bf16 (or f32) operands, BIG = FLT_MAX / 4 and
// penalty = norm-or-BIG per slot. Then the top k_pair per prober, in the JAX
// package's wire format, which ops/adc.py:_merge_pairs consumes unchanged:
//
//   exact  -> [B, p_tile, 2*k_pair] int32: sortable keys ++ absolute
//             addresses, ordered by value descending then slot ascending
//             (the "first maximal column per pass" order); entries with
//             value <= -BIG/2 are dead: sortable(-inf) and -1.
//   pack32 -> [B, p_tile, k_pair] int32: key = (sortable(score) & ~slot_mask)
//             | slot, reduced to one winner per strided group
//             (group g holds slots g, g+G, g+2G, ...), then the k_pair
//             largest group winners, descending. Keys are unique per row.
//
// Design (first, simple version): one CTA per (block, slice of pt probers);
// each thread owns one prober. The CTA reads its query rows by prober id
// from the [nq, d] query table into shared memory (in the cache's dtype),
// streams the cell window through shared memory in f32 tiles of TS slots,
// and each thread scores U slots at a time from registers. The exact select
// keeps a sorted top-KMAX list in registers; the pack32 select keeps its G
// group maxima in shared memory. The scoring loop and both selects are
// scan_common.cuh's, shared with codes_scan.cu. What bounds it on an H100:
// every window element read from memory feeds p_tile (128) FMAs, so the
// kernel is bound by f32 FMA issue and shared-memory bandwidth, not by HBM.
// block_scan_wg.cu serves bf16 and int8 caches of d <= 1024 on the tensor
// cores (ops/block_scan.py:pick_route); this kernel serves f32 caches and
// the other shapes of both modes.
//
// int8 mode (the int8 scan-cache tier, entry point torchpq_block_scan_int8):
// the cache rows and query rows are int8 with per-slot and per-query f32
// scales, and
//
//   score = fmaf(float(sum_k q8[p,k] * y8[j,k]), (c * q_scale[p]) * scale[j],
//                -pen)
//
// (scan_common.cuh:scan_rows_int8). The window moves 1 byte per element, a
// quarter of the f32 tier's and half the bf16 tier's, and __dp4a does four
// int8 products per instruction; the bound is the same per-prober rate of
// products as above, divided by four.

#include <cstdint>

#include "scan_common.cuh"

namespace {

using namespace tpq;

// A window of decoded cache rows: column c is slot c.
template <typename T>
struct DecodedWindow {
  const T* rows;       // decoded + s0 * d
  const float* pen;    // penalty + s0
  int d, o0, o1;       // row width; the cell's slots [o0, o1) in the window

  __device__ __forceinline__ void load(int ts, int nrow, float* y_s,
                                       float* pen_s, int* slot_s) const {
    const int t = threadIdx.x;
    const int pt = blockDim.x;
    const T* src = rows + (size_t)ts * d;
    for (int i = 4 * t; i < TS * d; i += 4 * pt) {  // d % 4 == 0
      *reinterpret_cast<float4*>(y_s + i) =
          (i / d) < nrow ? load4(src + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (t < TS) {
      const int j = ts + t;
      float pv = 0.0f;
      if (t < nrow) {
        pv = pen[j] + ((j >= o0 && j < o1) ? 0.0f : big_penalty());
      }
      pen_s[t] = pv;
      slot_s[t] = j;
    }
  }
};

// A window of int8 cache rows and their scales: column c is slot c.
struct Int8Window {
  const signed char* rows;  // decoded + s0 * d
  const float* pen;         // penalty + s0
  const float* scale;       // scale + s0
  int d, o0, o1;

  __device__ __forceinline__ void load(int ts, int nrow, signed char* y_s,
                                       float* pen_s, float* sc_s,
                                       int* slot_s) const {
    const int t = threadIdx.x;
    const int pt = blockDim.x;
    const signed char* src = rows + (size_t)ts * d;
    for (int i = 16 * t; i < TS * d; i += 16 * pt) {  // d % 16 == 0
      *reinterpret_cast<int4*>(y_s + i) =
          (i / d) < nrow ? __ldg(reinterpret_cast<const int4*>(src + i))
                         : make_int4(0, 0, 0, 0);
    }
    if (t < TS) {
      const int j = ts + t;
      float pv = 0.0f;
      float sv = 0.0f;
      if (t < nrow) {
        pv = pen[j] + ((j >= o0 && j < o1) ? 0.0f : big_penalty());
        sv = scale[j];
      }
      pen_s[t] = pv;
      sc_s[t] = sv;
      slot_s[t] = j;
    }
  }
};

template <typename T, bool PACK, int KMAX>
__global__ void block_scan_kernel(
    const T* __restrict__ qtable, const int* __restrict__ probers,
    const int* __restrict__ start_c, const int* __restrict__ off,
    const int* __restrict__ capb, const float* __restrict__ penalty,
    const T* __restrict__ decoded, int* __restrict__ out, int p_tile, int d,
    int s_eff, int k_pair, float factor, int slot_mask, int n_groups) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int s0 = start_c[b];
  const DecodedWindow<T> win{decoded + (size_t)s0 * d, penalty + s0, d,
                             off[b], off[b] + capb[b]};
  scan_block<T, PACK, KMAX>(win, smem_raw, qtable, probers, out, p_tile, d,
                            s_eff, k_pair, factor, slot_mask, n_groups, s0);
}

template <bool PACK, int KMAX>
__global__ void block_scan_int8_kernel(
    const signed char* __restrict__ qtable, const float* __restrict__ q_scale,
    const int* __restrict__ probers, const int* __restrict__ start_c,
    const int* __restrict__ off, const int* __restrict__ capb,
    const float* __restrict__ penalty, const float* __restrict__ scale,
    const signed char* __restrict__ decoded, int* __restrict__ out,
    int p_tile, int d, int s_eff, int k_pair, float factor, int slot_mask,
    int n_groups) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int s0 = start_c[b];
  const Int8Window win{decoded + (size_t)s0 * d, penalty + s0, scale + s0, d,
                       off[b], off[b] + capb[b]};
  const int pt = blockDim.x;
  const int t = threadIdx.x;
  const size_t row = (size_t)b * p_tile + blockIdx.y * pt + t;
  const int pr = probers[row];
  const int prow = pr < 0 ? 0 : pr;  // padding rows score query 0, never read
  const float qmul = factor * q_scale[prow];
  if constexpr (PACK) {
    PackSelect sel(int8_best(smem_raw, pt, d) + t, pt, n_groups, slot_mask);
    scan_rows_int8(win, smem_raw, qtable, prow, qmul, d, s_eff, sel);
    sel.write(out + row * k_pair, k_pair);
  } else {
    ExactSelect<KMAX> sel;
    scan_rows_int8(win, smem_raw, qtable, prow, qmul, d, s_eff, sel);
    sel.write(out + row * 2 * k_pair, k_pair, s0);
  }
}

template <typename T, bool PACK, int KMAX>
int launch(const void* qtable, const int* probers, const int* start_c,
           const int* off, const int* capb, const float* penalty,
           const void* decoded, int* out, int n_blocks, int p_tile, int d,
           int s_eff, int k_pair, float factor, int slot_mask, int n_groups,
           int pt, cudaStream_t stream) {
  const size_t smem = core_smem_bytes(pt, d, PACK, n_groups, sizeof(T));
  return launch_kernel(block_scan_kernel<T, PACK, KMAX>,
                       dim3(n_blocks, p_tile / pt), pt, smem, stream,
                       static_cast<const T*>(qtable), probers, start_c, off,
                       capb, penalty, static_cast<const T*>(decoded), out,
                       p_tile, d, s_eff, k_pair, factor, slot_mask, n_groups);
}

template <typename T>
int dispatch(const void* qtable, const int* probers, const int* start_c,
             const int* off, const int* capb, const float* penalty,
             const void* decoded, int* out, int n_blocks, int p_tile, int d,
             int s_eff, int k_pair, float factor, int pack32, int slot_mask,
             int n_groups, int pt, cudaStream_t stream) {
#define TPQ_ARGS                                                          \
  qtable, probers, start_c, off, capb, penalty, decoded, out, n_blocks,   \
      p_tile, d, s_eff, k_pair, factor, slot_mask, n_groups, pt, stream
  if (pack32) return launch<T, true, 1>(TPQ_ARGS);
  if (k_pair <= 16) return launch<T, false, 16>(TPQ_ARGS);
  if (k_pair <= 32) return launch<T, false, 32>(TPQ_ARGS);
  return launch<T, false, 64>(TPQ_ARGS);
#undef TPQ_ARGS
}

template <bool PACK, int KMAX>
int launch_int8(const void* qtable, const float* q_scale, const int* probers,
                const int* start_c, const int* off, const int* capb,
                const float* penalty, const float* scale, const void* decoded,
                int* out, int n_blocks, int p_tile, int d, int s_eff,
                int k_pair, float factor, int slot_mask, int n_groups, int pt,
                cudaStream_t stream) {
  const size_t smem = int8_smem_bytes(pt, d, PACK, n_groups);
  return launch_kernel(block_scan_int8_kernel<PACK, KMAX>,
                       dim3(n_blocks, p_tile / pt), pt, smem, stream,
                       static_cast<const signed char*>(qtable), q_scale,
                       probers, start_c, off, capb, penalty, scale,
                       static_cast<const signed char*>(decoded), out, p_tile,
                       d, s_eff, k_pair, factor, slot_mask, n_groups);
}

}  // namespace

// Plain C entry point (bound with ctypes). Returns 0 or the CUDA error code
// of the attribute call or the launch. Launches on `stream`, does not
// synchronize and allocates nothing.
extern "C" int torchpq_block_scan(
    const void* qtable, const int* probers, const int* start_c,
    const int* off, const int* capb, const float* penalty,
    const void* decoded, int* out, int n_blocks, int p_tile, int d,
    int s_eff, int k_pair, int euclidean, int pack32, int slot_mask,
    int n_groups, int is_bf16, int pt, void* stream) {
  if (n_blocks <= 0 || pt <= 0 || p_tile % pt || d % 4 || k_pair < 1 ||
      k_pair > 64 || k_pair > s_eff || (pack32 && n_groups < k_pair)) {
    return (int)cudaErrorInvalidValue;
  }
  const float factor = euclidean ? 2.0f : 1.0f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch<__nv_bfloat16>(qtable, probers, start_c, off, capb,
                                   penalty, decoded, out, n_blocks, p_tile,
                                   d, s_eff, k_pair, factor, pack32,
                                   slot_mask, n_groups, pt, st);
  }
  return dispatch<float>(qtable, probers, start_c, off, capb, penalty,
                         decoded, out, n_blocks, p_tile, d, s_eff, k_pair,
                         factor, pack32, slot_mask, n_groups, pt, st);
}

// Dynamic shared memory one CTA of `pt` probers needs (the wrapper checks it
// against the card's limit before launching).
extern "C" long long torchpq_block_scan_smem(int pt, int d, int pack32,
                                             int n_groups, int is_bf16) {
  return (long long)core_smem_bytes(pt, d, pack32, n_groups,
                                    is_bf16 ? 2 : 4);
}

// int8 mode. qtable [nq, d] int8, q_scale [nq] f32, scale [capacity] f32,
// decoded [capacity, d] int8 (d % 16 == 0, rows 16-byte aligned); the other
// arguments as torchpq_block_scan's. Returns 0 or the CUDA error code.
extern "C" int torchpq_block_scan_int8(
    const void* qtable, const float* q_scale, const int* probers,
    const int* start_c, const int* off, const int* capb,
    const float* penalty, const float* scale, const void* decoded, int* out,
    int n_blocks, int p_tile, int d, int s_eff, int k_pair, int euclidean,
    int pack32, int slot_mask, int n_groups, int pt, void* stream) {
  if (n_blocks <= 0 || pt < TS || p_tile % pt || d <= 0 || d % 16 ||
      k_pair < 1 || k_pair > 64 || k_pair > s_eff ||
      (pack32 && n_groups < k_pair) ||
      reinterpret_cast<uintptr_t>(qtable) % 16 ||
      reinterpret_cast<uintptr_t>(decoded) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const float factor = euclidean ? 2.0f : 1.0f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TPQ_ARGS                                                           \
  qtable, q_scale, probers, start_c, off, capb, penalty, scale, decoded,   \
      out, n_blocks, p_tile, d, s_eff, k_pair, factor, slot_mask,          \
      n_groups, pt, st
  if (pack32) return launch_int8<true, 1>(TPQ_ARGS);
  if (k_pair <= 16) return launch_int8<false, 16>(TPQ_ARGS);
  if (k_pair <= 32) return launch_int8<false, 32>(TPQ_ARGS);
  return launch_int8<false, 64>(TPQ_ARGS);
#undef TPQ_ARGS
}

// Dynamic shared memory one int8 CTA of `pt` probers needs.
extern "C" long long torchpq_block_scan_int8_smem(int pt, int d, int pack32,
                                                  int n_groups) {
  return (long long)int8_smem_bytes(pt, d, pack32, n_groups);
}
