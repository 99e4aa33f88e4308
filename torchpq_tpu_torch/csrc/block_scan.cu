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
// kernel is bound by f32 FMA issue and shared-memory bandwidth, not by HBM;
// tensor cores (wgmma) and TMA are for later versions.

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
