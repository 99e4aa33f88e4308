// Row gather for Hopper (sm_90a): the CUDA counterpart of
// torchpq_tpu/ops/pallas_gather.py:gather_rows.
//
//   out[i] = table[clip(idx[i], 0, n - 1)]
//
// for tables of any element type (f32, bf16, int8 rows: the kernel moves
// bytes). The TPU kernel kept the whole table in VMEM (<= 8 MiB) because a
// generic TPU gather ran at ~1 GB/s; on Hopper a row is read straight from
// device memory, so there is no table bound. Each thread copies one vector
// of a row: 16 bytes where the row width and both base addresses allow it,
// else 8, 4, 2 or 1, so neighbouring threads read neighbouring addresses.
// What bounds it on an H100: bytes, m * row_bytes read and as many written
// (plus the indices) at 3.35 TB/s; there is no arithmetic to speak of.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <typename V, typename I>
__global__ void gather_rows_kernel(const V* __restrict__ table,
                                   const I* __restrict__ idx,
                                   V* __restrict__ out, long long m,
                                   long long n, int vpr) {
  const long long total = m * vpr;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long i = e / vpr;
    const int c = (int)(e - i * vpr);
    long long r = (long long)idx[i];
    r = r < 0 ? 0 : (r > n - 1 ? n - 1 : r);
    out[e] = table[r * vpr + c];
  }
}

template <typename V, typename I>
int launch(const void* table, const void* idx, void* out, long long m,
           long long n, long long row_bytes, cudaStream_t stream) {
  const int vpr = (int)(row_bytes / sizeof(V));
  const long long total = m * vpr;
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond this
  gather_rows_kernel<V, I><<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const V*>(table), static_cast<const I*>(idx),
      static_cast<V*>(out), m, n, vpr);
  return (int)cudaGetLastError();
}

template <typename I>
int dispatch(const void* table, const void* idx, void* out, long long m,
             long long n, long long row_bytes, cudaStream_t stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(table) |
                      reinterpret_cast<uintptr_t>(out) |
                      (uintptr_t)row_bytes;
  if (a % 16 == 0) return launch<uint4, I>(table, idx, out, m, n, row_bytes,
                                          stream);
  if (a % 8 == 0) return launch<uint2, I>(table, idx, out, m, n, row_bytes,
                                         stream);
  if (a % 4 == 0) return launch<uint32_t, I>(table, idx, out, m, n,
                                             row_bytes, stream);
  if (a % 2 == 0) return launch<uint16_t, I>(table, idx, out, m, n,
                                             row_bytes, stream);
  return launch<uint8_t, I>(table, idx, out, m, n, row_bytes, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes). table [n, row_bytes] bytes, idx
// [m] int32 (idx64 = 0) or int64 (idx64 = 1), out [m, row_bytes] bytes.
// Returns 0 or the CUDA error code of the launch. Launches on `stream`,
// does not synchronize and allocates nothing.
extern "C" int torchpq_gather_rows(const void* table, const void* idx,
                                   void* out, long long m, long long n,
                                   long long row_bytes, int idx64,
                                   void* stream) {
  if (m <= 0 || n <= 0 || row_bytes <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (idx64) return dispatch<int64_t>(table, idx, out, m, n, row_bytes, st);
  return dispatch<int32_t>(table, idx, out, m, n, row_bytes, st);
}
