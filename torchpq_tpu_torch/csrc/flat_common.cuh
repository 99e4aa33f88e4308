// What the fused flat scans share (flat_scan.cu on the CUDA cores,
// flat_scan_tc.cu and flat_scan_wg.cu on the tensor cores): the bucket
// width and the merge of the per-split partial lists.
//
// Both kernels split the cache into runs of whole buckets, one run per CTA
// row of the grid, and write each query's sorted top-r_keep of the run to
// part_v / part_a [n_splits, nq, r_keep]. The top R is associative over
// address ranges, so merging the partial lists in split (address) order,
// ties to the earlier entry, gives the top R of the whole cache.

#pragma once

#include "scan_common.cuh"

namespace tpq {

constexpr int BUCKET = 64;  // slots per bucket; every split starts on one

// Merge the n_splits sorted partial lists of each query, in split order.
template <int KMAX>
__global__ void flat_merge_kernel(const float* __restrict__ part_v,
                                  const int* __restrict__ part_a,
                                  float* __restrict__ out_v,
                                  int* __restrict__ out_a, int nq,
                                  int r_keep, int n_splits) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= nq) return;
  float vals[KMAX];
  int slots[KMAX];
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    vals[i] = neg_inf();
    slots[i] = -1;
  }
  for (int s = 0; s < n_splits; ++s) {
    const size_t o = ((size_t)s * nq + q) * r_keep;
    for (int i = 0; i < r_keep; ++i) {
      insert<KMAX>(vals, slots, part_v[o + i], part_a[o + i]);
    }
  }
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    if (i < r_keep) {
      out_v[(size_t)q * r_keep + i] = vals[i];
      out_a[(size_t)q * r_keep + i] = slots[i];
    }
  }
}

// Launch the merge on `stream`; returns the CUDA error code of the launch.
template <int KMAX>
int launch_flat_merge(const float* part_v, const int* part_a, float* out_v,
                      int* out_a, int nq, int r_keep, int n_splits,
                      cudaStream_t stream) {
  flat_merge_kernel<KMAX><<<(nq + 127) / 128, 128, 0, stream>>>(
      part_v, part_a, out_v, out_a, nq, r_keep, n_splits);
  return (int)cudaGetLastError();
}

}  // namespace tpq
