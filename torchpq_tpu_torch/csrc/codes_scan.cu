// IVF block scan over PQ codes for Hopper (sm_90a): the CUDA counterpart of
// torchpq_tpu/ops/pallas_codes_scan.py:scan_blocks_pallas_codes, the scan of
// the code-domain tier (an index that keeps only its uint8 PQ codes and
// norms, no decoded cache).
//
// For block b, prober p and window column c < s_eff holding slot j:
//
//   y_j   = concat_i bf16(codebook)[i, code[start_c[b] + j, i], :]
//   score = factor * <bf16(q_p), y_j> - pen_j,   factor = 2 (euclidean) or 1
//   pen_j = penalty[start_c[b] + j] + (off[b] <= j < off[b] + cap[b] ? 0 : BIG)
//
// summed in f32. Codes come from the packed [cap/g, g*m] uint8 storage (row
// r holds slots r*g .. r*g+g-1, m bytes each, so slot s is bytes s*m ..
// s*m+m-1). Columns follow the TPU kernel's order: it scores per in-row
// offset q and concatenates, so column c = q*s_rows + r holds slot r*g + q
// (s_rows = s_eff / g). The exact select breaks ties by that column order
// and pack32 groups columns {j, j+G, ...}; both are scan_common.cuh's, with
// block_scan.cu's wire format, so ops/adc.py:_merge_pairs takes the output
// unchanged.
//
// Design (first, simple version): block_scan.cu's CTA (one prober per
// thread, query rows in shared memory, f32 FMA chain, register or shared
// group selects) with another window: the CTA stages the whole bf16
// codebook (m * 256 * dsub * 2 B = 64 KB at d = 128) in shared memory once,
// and each tile of TS columns is decoded from the codes into the f32 tile
// by lookups in it, each thread reading its 8-byte chunks of codes at once.
// Candidates are bf16(codebook) rows exactly, so the scores equal
// block_scan.cu's over a bf16 decoded cache bit for bit.
// What bounds it on an H100: the same f32 FMA issue as block_scan.cu (every
// decoded element feeds pt FMAs), plus the codebook's 64 KB of shared
// memory, which leaves one pack32 CTA per SM at pt = 128. It reads m bytes
// of codes per slot where the decoded tier reads 2d.

#include <cstdint>

#include "scan_common.cuh"

namespace {

using namespace tpq;

constexpr int MAX_CHUNKS = 8;  // 8-byte code chunks per thread and tile:
                               // TS * 128 / 8 / 32 at most (m <= 128)

// A window of PQ codes, decoded tile by tile against the shared codebook.
struct CodesWindow {
  const unsigned char* __restrict__ codes;  // codes + s0 * m: slot s at
                                            // bytes s*m .. s*m + m - 1
  const __nv_bfloat16* cb_s;   // [m * 256][dsub] in shared memory
  const float* pen;            // penalty + s0
  int m, dsub, d, s_rows, g, o0, o1;

  __device__ __forceinline__ int slot(int c) const {
    return (c % s_rows) * g + c / s_rows;
  }

  __device__ __forceinline__ void load(int ts, int nrow, float* y_s,
                                       float* pen_s, int* slot_s) const {
    const int t = threadIdx.x;
    const int pt = blockDim.x;
    // The tile's codes are TS * m bytes in 8-byte chunks (m % 8 == 0):
    // chunk e is bytes 8*(e % cpc) .. of column e / cpc. Every chunk of
    // this thread is read before any is decoded, so the reads are in
    // flight together rather than one after another.
    const int cpc = m / 8;
    const int nchunk = nrow * cpc;
    uint2 raw[MAX_CHUNKS];
#pragma unroll
    for (int r = 0; r < MAX_CHUNKS; ++r) {
      const int e = t + r * pt;
      if (e < nchunk) {
        const int cl = e / cpc;
        raw[r] = __ldg(reinterpret_cast<const uint2*>(
            codes + (size_t)slot(ts + cl) * m + 8 * (e - cl * cpc)));
      }
    }
#pragma unroll
    for (int r = 0; r < MAX_CHUNKS; ++r) {
      const int e = t + r * pt;
      if (e < TS * cpc) {
        const int cl = e / cpc;
        const int i0 = 8 * (e - cl * cpc);
        float* y = y_s + cl * d + i0 * dsub;
        if (e < nchunk) {
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            const unsigned int code =
                ((b < 4 ? raw[r].x : raw[r].y) >> (8 * (b & 3))) & 0xFFu;
            const __nv_bfloat16* src =
                cb_s + ((size_t)(i0 + b) * 256 + code) * dsub;
            for (int u = 0; u < dsub; ++u) {
              y[b * dsub + u] = __bfloat162float(src[u]);
            }
          }
        } else {
          for (int u = 0; u < 8 * dsub; ++u) y[u] = 0.0f;
        }
      }
    }
    if (t < TS) {
      float pv = 0.0f;
      int j = 0;
      if (t < nrow) {
        j = slot(ts + t);
        pv = pen[j] + ((j >= o0 && j < o1) ? 0.0f : big_penalty());
      }
      pen_s[t] = pv;
      slot_s[t] = j;
    }
  }
};

size_t codes_smem_bytes(int pt, int d, int pack32, int n_groups) {
  // core (bf16 query rows) + the bf16 codebook [m*256][dsub] = 256*d values
  return core_smem_bytes(pt, d, pack32, n_groups, 2) +
         sizeof(__nv_bfloat16) * 256 * (size_t)d;
}

template <bool PACK, int KMAX>
__global__ void codes_scan_kernel(
    const __nv_bfloat16* __restrict__ qtable,
    const int* __restrict__ probers, const int* __restrict__ start_c,
    const int* __restrict__ off, const int* __restrict__ capb,
    const float* __restrict__ penalty, const unsigned char* __restrict__ codes,
    const __nv_bfloat16* __restrict__ codebook, int* __restrict__ out,
    int p_tile, int m, int dsub, int g, int s_eff, int k_pair, float factor,
    int slot_mask, int n_groups) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = m * dsub;
  const int pack = PACK ? 1 : 0;
  __nv_bfloat16* cb_s = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + core_smem_bytes(blockDim.x, d, pack, n_groups, 2));
  // the codebook, 16 bytes per thread step (256*d*2 bytes, d % 4 == 0)
  const uint4* src = reinterpret_cast<const uint4*>(codebook);
  uint4* dst = reinterpret_cast<uint4*>(cb_s);
  for (int i = threadIdx.x; i < 32 * d; i += blockDim.x) dst[i] = src[i];
  // (scan_block synchronizes before the first tile reads it)

  const int b = blockIdx.x;
  const int s0 = start_c[b];
  const CodesWindow win{codes + (size_t)s0 * m, cb_s, penalty + s0, m,
                        dsub, d, s_eff / g, g, off[b], off[b] + capb[b]};
  scan_block<__nv_bfloat16, PACK, KMAX>(win, smem_raw, qtable, probers, out,
                                        p_tile, d, s_eff, k_pair, factor,
                                        slot_mask, n_groups, s0);
}

template <bool PACK, int KMAX>
int launch(const void* qtable, const int* probers, const int* start_c,
           const int* off, const int* capb, const float* penalty,
           const unsigned char* codes, const void* codebook, int* out,
           int n_blocks, int p_tile, int m, int dsub, int g, int s_eff,
           int k_pair, float factor, int slot_mask, int n_groups, int pt,
           cudaStream_t stream) {
  const size_t smem = codes_smem_bytes(pt, m * dsub, PACK, n_groups);
  return launch_kernel(
      codes_scan_kernel<PACK, KMAX>, dim3(n_blocks, p_tile / pt), pt, smem,
      stream, static_cast<const __nv_bfloat16*>(qtable), probers, start_c,
      off, capb, penalty, codes,
      static_cast<const __nv_bfloat16*>(codebook), out, p_tile, m, dsub, g,
      s_eff, k_pair, factor, slot_mask, n_groups);
}

}  // namespace

// Plain C entry point (bound with ctypes). qtable [nq, m*dsub] bf16,
// probers [n_blocks, p_tile] int32, start_c / off / capb [n_blocks] int32,
// penalty [capacity] f32, codes the packed uint8 storage (capacity * m
// bytes, m % 8 == 0, 8-byte aligned), codebook [m, 256, dsub] bf16
// (16-byte aligned), out int32.
// Returns 0 or the CUDA error code of the attribute call or the launch.
// Launches on `stream`, does not synchronize and allocates nothing.
extern "C" int torchpq_codes_scan(
    const void* qtable, const int* probers, const int* start_c,
    const int* off, const int* capb, const float* penalty,
    const unsigned char* codes, const void* codebook, int* out,
    int n_blocks, int p_tile, int m, int dsub, int g, int s_eff, int k_pair,
    int euclidean, int pack32, int slot_mask, int n_groups, int pt,
    void* stream) {
  if (n_blocks <= 0 || pt < 32 || p_tile % pt || m <= 0 || m % 8 ||
      m > 128 || dsub <= 0 || (m * dsub) % 4 || g <= 0 || s_eff % g ||
      k_pair < 1 || k_pair > 64 ||
      k_pair > s_eff || (pack32 && n_groups < k_pair) ||
      reinterpret_cast<uintptr_t>(codebook) % 16 ||
      reinterpret_cast<uintptr_t>(codes) % 8) {
    return (int)cudaErrorInvalidValue;
  }
  const float factor = euclidean ? 2.0f : 1.0f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TPQ_ARGS                                                           \
  qtable, probers, start_c, off, capb, penalty, codes, codebook, out,      \
      n_blocks, p_tile, m, dsub, g, s_eff, k_pair, factor, slot_mask,      \
      n_groups, pt, st
  if (pack32) return launch<true, 1>(TPQ_ARGS);
  if (k_pair <= 16) return launch<false, 16>(TPQ_ARGS);
  if (k_pair <= 32) return launch<false, 32>(TPQ_ARGS);
  return launch<false, 64>(TPQ_ARGS);
#undef TPQ_ARGS
}

// Dynamic shared memory one CTA of `pt` probers needs at width d (the
// wrapper checks it against the card's limit before launching).
extern "C" long long torchpq_codes_scan_smem(int pt, int d, int pack32,
                                             int n_groups) {
  return (long long)codes_smem_bytes(pt, d, pack32, n_groups);
}
