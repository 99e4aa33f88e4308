// Fused flat (exhaustive) scan for Hopper (sm_90a): the CUDA counterpart of
// torchpq_tpu/ops/pallas_flat.py:flat_scan_pallas.
//
// For query q and cache slot j (slots past cap, up to the end of the last
// split, are dead pad slots, as the JAX glue pads the cache to its window):
//
//   score = c * <bf16(q), y_j> - penalty[j],   c = 2 (euclidean) or 1
//
// summed in f32 (a dead pad slot scores -penalty = -BIG). Slots fall into
// buckets of 64 (the TPU kernel's w / 32 at w = 2048); each bucket offers its
// top 2 (the first maximal slot, then the first maximum of the rest), and
// the result per query is the top R of those candidates, by value
// descending then address ascending -> values [nq, R] f32, addresses
// [nq, R] int32.
//
// That top R is associative over address ranges, so the kernel splits the
// cache: CTA (x, y) scores queries [x*pt, x*pt + pt) (one per thread)
// against slots [y*split, (y+1)*split) and keeps a sorted top-KMAX list in
// registers; a second kernel (flat_common.cuh) merges the n_splits partial
// lists of each query in split (address) order, with ties to the earlier
// entry. The TPU grid (one program per 512 queries) would give 20 CTAs at
// 10k queries for 132 SMs; the split gives n_splits times as many.
//
// Scoring is scan_common.cuh's f32 FMA loop over shared-memory tiles (query
// rows in the cache's dtype, bf16-rounded by the wrapper). What bounds it on
// an H100: 2 * nq * cap * d operations against cap * d * 2 bytes of cache
// (bf16), so it is compute-bound (some 10^3 operations per byte read), and
// the CUDA cores' f32 FMA rate is this version's limit. It is the route of
// f32 caches and of the bf16 widths the tensor-core kernel does not take
// (d % 8 != 0 or d > 1024); flat_scan_tc.cu serves every other bf16 cache.

#include <cstdint>

#include "flat_common.cuh"

namespace {

using namespace tpq;

// A window of cache rows [s0, s0 + s_eff) of which the first n_valid exist;
// the rest are the glue's dead pad rows (zero, penalty BIG).
template <typename T>
struct FlatWindow {
  const T* rows;     // decoded + s0 * d
  const float* pen;  // penalty + s0
  int d, n_valid;

  __device__ __forceinline__ void load(int ts, int nrow, float* y_s,
                                       float* pen_s, int* slot_s) const {
    const int t = threadIdx.x;
    const int pt = blockDim.x;
    const T* src = rows + (size_t)ts * d;
    const int nv = min(nrow, n_valid - ts);
    for (int i = 4 * t; i < TS * d; i += 4 * pt) {  // d % 4 == 0
      *reinterpret_cast<float4*>(y_s + i) =
          (i / d) < nv ? load4(src + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (t < TS) {
      const int j = ts + t;
      pen_s[t] = t < nrow ? (j < n_valid ? pen[j] : big_penalty()) : 0.0f;
      slot_s[t] = j;
    }
  }
};

// Bucket top 2, then a running top-KMAX list ordered by value descending
// and visit (address) order on ties.
template <int KMAX>
struct FlatSelect {
  float vals[KMAX];
  int slots[KMAX];
  float m1, m2;
  int a1, a2;

  __device__ __forceinline__ FlatSelect() {
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      vals[i] = neg_inf();
      slots[i] = -1;
    }
    m1 = m2 = neg_inf();
    a1 = a2 = -1;
  }
  __device__ __forceinline__ void push(float sc, int j, int) {
    if (sc > m1) {
      m2 = m1;
      a2 = a1;
      m1 = sc;
      a1 = j;
    } else if (sc > m2) {
      m2 = sc;
      a2 = j;
    }
    if ((j & (BUCKET - 1)) == BUCKET - 1) {  // the bucket's last slot
      insert<KMAX>(vals, slots, m1, a1);
      insert<KMAX>(vals, slots, m2, a2);
      m1 = m2 = neg_inf();
      a1 = a2 = -1;
    }
  }
};

template <typename T, int KMAX>
__global__ void flat_scan_kernel(const T* __restrict__ qtable,
                                 const float* __restrict__ penalty,
                                 const T* __restrict__ decoded,
                                 float* __restrict__ part_v,
                                 int* __restrict__ part_a, int nq, int cap,
                                 int d, int r_keep, int split, float factor) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const int s0 = blockIdx.y * split;
  const FlatWindow<T> win{decoded + (size_t)s0 * d, penalty + s0, d,
                          cap - s0};
  FlatSelect<KMAX> sel;
  // slots are window-relative; the window starts on a bucket boundary
  scan_rows<T>(win, smem_raw, qtable, q < nq ? q : 0, d, split, factor, sel);
  if (q < nq) {
    const size_t o = ((size_t)blockIdx.y * nq + q) * r_keep;
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      if (i < r_keep) {
        part_v[o + i] = sel.vals[i];
        part_a[o + i] = sel.slots[i] < 0 ? -1 : s0 + sel.slots[i];
      }
    }
  }
}

template <typename T, int KMAX>
int launch(const void* qtable, const float* penalty, const void* decoded,
           float* part_v, int* part_a, float* out_v, int* out_a, int nq,
           int cap, int d, int r_keep, int split, int n_splits, float factor,
           int pt, cudaStream_t stream) {
  const size_t smem = core_smem_bytes(pt, d, 0, 0, sizeof(T));
  const dim3 grid((nq + pt - 1) / pt, n_splits);
  int rc = launch_kernel(flat_scan_kernel<T, KMAX>, grid, pt, smem, stream,
                         static_cast<const T*>(qtable), penalty,
                         static_cast<const T*>(decoded), part_v, part_a, nq,
                         cap, d, r_keep, split, factor);
  if (rc != 0) return rc;
  return launch_flat_merge<KMAX>(part_v, part_a, out_v, out_a, nq, r_keep,
                                 n_splits, stream);
}

template <typename T>
int dispatch(const void* qtable, const float* penalty, const void* decoded,
             float* part_v, int* part_a, float* out_v, int* out_a, int nq,
             int cap, int d, int r_keep, int split, int n_splits,
             float factor, int pt, cudaStream_t stream) {
#define TPQ_ARGS                                                          \
  qtable, penalty, decoded, part_v, part_a, out_v, out_a, nq, cap, d,     \
      r_keep, split, n_splits, factor, pt, stream
  if (r_keep <= 16) return launch<T, 16>(TPQ_ARGS);
  return launch<T, 32>(TPQ_ARGS);
#undef TPQ_ARGS
}

}  // namespace

// Plain C entry point (bound with ctypes). qtable [nq, d] (the cache's
// dtype, bf16-rounded values), penalty [cap] f32, decoded [cap, d] bf16 or
// f32; split slots per CTA (a multiple of 64; n_splits * split >= cap, the
// slots past cap are dead pads); part_v / part_a [n_splits, nq, r_keep]
// scratch; out_v / out_a [nq, r_keep]. Returns 0 or the CUDA error code of
// the attribute call or a launch. Launches on `stream`, does not
// synchronize and allocates nothing.
extern "C" int torchpq_flat_scan(const void* qtable, const float* penalty,
                                 const void* decoded, float* part_v,
                                 int* part_a, float* out_v, int* out_a,
                                 int nq, int cap, int d, int r_keep,
                                 int split, int n_splits, int euclidean,
                                 int is_bf16, int pt, void* stream) {
  if (nq <= 0 || cap <= 0 || d <= 0 || d % 4 || r_keep < 1 || r_keep > 32 ||
      pt < TS || split <= 0 || split % BUCKET ||
      (long long)split * n_splits < cap ||
      (long long)split * (n_splits - 1) >= cap) {
    return (int)cudaErrorInvalidValue;
  }
  const float factor = euclidean ? 2.0f : 1.0f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch<__nv_bfloat16>(qtable, penalty, decoded, part_v, part_a,
                                   out_v, out_a, nq, cap, d, r_keep, split,
                                   n_splits, factor, pt, st);
  }
  return dispatch<float>(qtable, penalty, decoded, part_v, part_a, out_v,
                         out_a, nq, cap, d, r_keep, split, n_splits, factor,
                         pt, st);
}

// Dynamic shared memory one flat-scan CTA of `pt` queries needs.
extern "C" long long torchpq_flat_scan_smem(int pt, int d, int is_bf16) {
  return (long long)core_smem_bytes(pt, d, 0, 0, is_bf16 ? 2 : 4);
}
