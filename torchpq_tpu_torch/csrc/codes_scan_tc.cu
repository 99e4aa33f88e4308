// IVF block scan over PQ codes on Hopper's tensor cores (sm_90a), mma.sync
// instance: the counterpart of
// torchpq_tpu/ops/pallas_codes_scan.py:scan_blocks_pallas_codes for the
// pack32 selects above k_pair 16 that block_scan_wg.cu's codes instances
// leave (ops/codes_scan.py:pick_route): k_pair 49-64, the IVFPQR code
// domain's base scan at k' = 400, and k_pair 17-48 where their shared
// memory does not fit. Those take exact k_pair <= 16 and pack32 k_pair <=
// 48 on wgmma, the window decoded by a producer warpgroup; codes_scan.cu,
// on the CUDA cores, serves the rest. For block b, prober p and window
// column c < s_eff holding slot j = (c % s_rows) * g + c / s_rows:
//
//   y_j   = concat_i bf16(codebook)[i, code[start_c[b] + j, i], :]
//   score = factor * <bf16(q_p), y_j> - pen_j,   factor = 2 (euclidean) or 1
//   pen_j = penalty[start_c[b] + j] + (off[b] <= j < off[b] + cap[b] ? 0 : BIG)
//
// summed in f32, then the pack32 select over the columns (one maximal key
// per strided group of columns {j, j+G, ...}, then the k_pair largest) in
// block_scan.cu's wire format. Rows whose prober is -1 are not scored but
// written dead (INT_MIN); ops/adc.py:_merge_pairs never reads them.
//
// Design: scan_tc.cuh's body (persistent CTAs of 8 warps, live 16-prober
// tiles only, mma.sync over tiles of 128 window columns, warps split by
// column slices, pack32 maxima in registers), its phase ends sorted
// (scan_tc.cuh:sort_slice), fed by CodesSource below: the bf16 codebook
// (256 * d * 2 bytes, 64 KB at d = 128) staged in shared memory once per
// CTA; each tile's raw codes copied by cp.async into a ring of shared
// memory [TN][m] (8 KB at m = 64) while the warps score; one decoded tile
// (scan_tc.cuh's ONE_TILE): a __syncthreads once the warps are done with
// the tile, then the decode from the ring into it. Each thread decodes the
// very 8-byte chunks it copied, so its own cp.async wait makes them
// visible, and one ring serves: the land that reads it precedes the
// stage's closing barrier, the next fetch follows it. Two tiles, the
// codebook and the deep lists do not fit (237,600 B at k_pair 64, d =
// 128), and the sort leaves no registers for codes prefetched into
// registers. Budget at d = 128, k_pair 64: 65,536 B codebook + 8,192 B
// ring (16,384 at m = 128, dsub 1) + 34,816 B tile + 2,048 B penalties and
// slots + 544 B prober rows and tile flags + 33,280 B slice lists + 66,560
// B running lists = 210,976 B (219,168 at m = 128), one CTA of 8 warps per
// SM. What bounds it is the deep select (the sort and the serial merge of
// the lists, ~half a deep scan) plus the decode, behind a barrier instead
// of beside the scoring.

#include <cstdint>

#include "scan_tc.cuh"
#include "wg_layout.cuh"

namespace {

using namespace tpq;
using namespace tpq::tc;

using tpq::wg::chunk_item;
using tpq::wg::col_slot;

// Shared memory: the codebook [256 * d] bf16, the raw codes' ring [TN][m],
// then the body's with one tile.
__host__ __device__ inline size_t tc_smem_bytes(int m, int dsub,
                                                int k_pair) {
  const int d = m * dsub;
  return (size_t)512 * d + (size_t)TN * m +
         body_smem_bytes(2 * d, true, k_pair, true);
}

__device__ __forceinline__ uint32_t code_byte(uint2 raw, int b) {
  return ((b < 4 ? raw.x : raw.y) >> (8 * (b & 3))) & 0xFFu;
}

// The window tiles of the packed codes, decoded against the shared
// codebook. One thread's share of a tile's inputs is brought before the
// tile is needed (fetch: its code chunks, copied into the ring [TN][m] of
// shared memory by cp.async, and (threads < TN) one column's penalty and
// slot) and written to the tile after (land), see the note above.
struct CodesSource {
  static constexpr bool ONE_TILE = true;
  const unsigned char* __restrict__ codes;
  const float* __restrict__ penalty;
  const __nv_bfloat16* cb_s;  // the staged codebook, then the ring
  int m, dsub, s_rows, g;
  float inv;
  float pen;
  int slt;

  // The raw codes [TN][m] after the codebook. The registers are full (the
  // sort), so what the loops need is worked out where they run rather than
  // kept, and they are not unrolled.
  __device__ __forceinline__ unsigned char* ring() const {
    return reinterpret_cast<unsigned char*>(
        const_cast<__nv_bfloat16*>(cb_s) + 256 * m * dsub);
  }

  __device__ __forceinline__ void fetch(int s0, int o0, int o1, int ts,
                                        int nrow, unsigned char*) {
    const int t = threadIdx.x;
    const int lc = 31 - __clz(m / 8);
    const int items = (nrow + 1) / 2 * 2 << lc;
    unsigned char* rg = ring();
#pragma unroll 1
    for (int e = t; e < items; e += THREADS) {
      int cl, ch;
      chunk_item(e, lc, cl, ch);
      if (cl < nrow) {
        const int j = col_slot(ts + cl, s_rows, g, inv);
        cp_async8(rg + cl * m + 8 * ch, codes + ((size_t)s0 + j) * m + 8 * ch);
      }
    }
    cp_async_commit();
    if (t < TN) {
      pen = 0.0f;
      slt = 0;
      if (t < nrow) {
        slt = col_slot(ts + t, s_rows, g, inv);
        pen = __ldg(penalty + s0 + slt) +
              ((slt >= o0 && slt < o1) ? 0.0f : big_penalty());
      }
    }
  }

  // Chunk ch (8 codes) of column cl, decoded into tile [TN][ldt].
  __device__ __forceinline__ void decode(uint2 raw_c, int cl, int ch,
                                         __nv_bfloat16* tile, int ldt) const {
    const int i0 = 8 * ch;  // first subspace of the chunk
    __nv_bfloat16* dst = tile + cl * ldt + i0 * dsub;
    if (dsub == 2) {  // a codeword is one 4-byte word
      const uint32_t* cb = reinterpret_cast<const uint32_t*>(cb_s) + i0 * 256;
      uint32_t w[8];
#pragma unroll
      for (int b = 0; b < 8; ++b) w[b] = cb[b * 256 + code_byte(raw_c, b)];
      uint4* d16 = reinterpret_cast<uint4*>(dst);
      d16[0] = make_uint4(w[0], w[1], w[2], w[3]);
      d16[1] = make_uint4(w[4], w[5], w[6], w[7]);
    } else if (dsub == 1) {  // two codewords per word
      const unsigned short* cb =
          reinterpret_cast<const unsigned short*>(cb_s) + i0 * 256;
      uint32_t h[8];
#pragma unroll
      for (int b = 0; b < 8; ++b) h[b] = cb[b * 256 + code_byte(raw_c, b)];
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16,
                     h[4] | h[5] << 16, h[6] | h[7] << 16);
    } else if (dsub == 4) {  // a codeword is 8 bytes
      const uint2* cb = reinterpret_cast<const uint2*>(cb_s) + i0 * 256;
      uint2 w[8];
#pragma unroll
      for (int b = 0; b < 8; ++b) w[b] = cb[b * 256 + code_byte(raw_c, b)];
      uint4* d16 = reinterpret_cast<uint4*>(dst);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        d16[k] = make_uint4(w[2 * k].x, w[2 * k].y, w[2 * k + 1].x,
                            w[2 * k + 1].y);
      }
    } else {
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const __nv_bfloat16* src =
            cb_s + ((i0 + b) * 256 + code_byte(raw_c, b)) * dsub;
        for (int u = 0; u < dsub; ++u) dst[b * dsub + u] = src[u];
      }
    }
  }

  // Decode into the tile [TN][ld] and write the tile's penalties and
  // slots, once this thread's own copies have landed (each thread decodes
  // the chunks it copied).
  __device__ __forceinline__ void land(int, int nrow, unsigned char* tile_b,
                                       float* pen_s, int* slot_s) const {
    __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(tile_b);
    const int t = threadIdx.x;
    const int lc = 31 - __clz(m / 8);
    const int items = (nrow + 1) / 2 * 2 << lc;
    const unsigned char* rg = ring();
    cp_async_wait<0>();
#pragma unroll 1
    for (int e = t; e < items; e += THREADS) {
      int cl, ch;
      chunk_item(e, lc, cl, ch);
      if (cl < nrow) {
        decode(*reinterpret_cast<const uint2*>(rg + cl * m + 8 * ch), cl, ch,
               tile, row_ld(2 * m * dsub) / 2);
      }
    }
    if (t < TN) {
      pen_s[t] = pen;
      slot_s[t] = slt;
    }
  }

};

// The sorted pack32 instance (PACK, KMAX = MAX_PACK_K: the only one).
template <bool PACK, int KMAX>
__global__ void __launch_bounds__(THREADS, 1) codes_scan_tc_kernel(
    const __nv_bfloat16* __restrict__ qtable,
    const int* __restrict__ probers, const int* __restrict__ start_c,
    const int* __restrict__ off, const int* __restrict__ capb,
    const float* __restrict__ penalty, const unsigned char* __restrict__ codes,
    const __nv_bfloat16* __restrict__ codebook, int* __restrict__ out,
    int n_blocks, int p_tile, int m, int dsub, int g, int s_eff, int k_pair,
    float factor, int slot_mask, int n_groups) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  static_assert(PACK && KMAX == MAX_PACK_K, "the sorted pack32 instance");
  const int d = m * dsub;
  __nv_bfloat16* cb_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  // the codebook, 16 bytes per thread step (256 * d * 2 bytes); the body's
  // first __syncthreads publishes it
  {
    const uint4* src = reinterpret_cast<const uint4*>(codebook);
    uint4* dst = reinterpret_cast<uint4*>(cb_s);
    for (int i = threadIdx.x; i < 32 * d; i += THREADS) dst[i] = src[i];
  }
  const int s_rows = s_eff / g;
  CodesSource src;
  src.codes = codes;
  src.penalty = penalty;
  src.cb_s = cb_s;
  src.m = m;
  src.dsub = dsub;
  src.s_rows = s_rows;
  src.g = g;
  src.inv = 1.0f / (float)s_rows;
  scan_blocks(
      src, smem_raw + (size_t)512 * d + TN * m,
      reinterpret_cast<const unsigned char*>(qtable), probers, start_c, off,
      capb, out, n_blocks, p_tile, 2 * d, s_eff, k_pair, factor, slot_mask,
      n_groups);
}

}  // namespace

// Plain C entry point (bound with ctypes). qtable [nq, m*dsub] bf16 (4-byte
// aligned), probers [n_blocks, p_tile] int32 (p_tile % 16 == 0, p_tile <=
// 128), start_c / off / capb [n_blocks] int32, penalty [capacity] f32,
// codes the packed uint8 storage (capacity * m bytes, m a power of two
// from 8 to 128, 8-byte aligned), codebook [m, 256, dsub] bf16 (16-byte
// aligned), d = m * dsub <= 128, out int32; pack32 only (the exact select
// is block_scan_wg.cu's or codes_scan.cu's): k_pair <= 64 (210,976 B at
// d = 128, m = 64, k_pair 64) and n_groups % 8 == 0, either n_groups ==
// s_eff <= 128, or n_groups a multiple of 128 that divides s_eff. n_ctas:
// the persistent grid (at most n_blocks). Returns 0 or the CUDA error code
// of an attribute call or the launch (cudaErrorInvalidValue, without
// launching, for other shapes or a shared memory above SMEM_LIMIT).
// Launches on `stream`, does not synchronize and allocates nothing.
extern "C" int torchpq_codes_scan_tc(
    const void* qtable, const int* probers, const int* start_c,
    const int* off, const int* capb, const float* penalty,
    const unsigned char* codes, const void* codebook, int* out,
    int n_blocks, int p_tile, int m, int dsub, int g, int s_eff, int k_pair,
    int euclidean, int pack32, int slot_mask, int n_groups, int n_ctas,
    void* stream) {
  const int d = m * dsub;
  const size_t smem = tc_smem_bytes(m, dsub, k_pair);
  if (!pack32 ||
      !shape_ok(n_blocks, n_ctas, p_tile, 2 * d, MAX_ROW, s_eff, k_pair,
                pack32, n_groups) ||
      smem > SMEM_LIMIT || m < 8 || (m & (m - 1)) || m > 128 || dsub <= 0 ||
      g <= 0 || s_eff % g || reinterpret_cast<uintptr_t>(qtable) % 4 ||
      reinterpret_cast<uintptr_t>(codebook) % 16 ||
      reinterpret_cast<uintptr_t>(codes) % 8) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_kernel(
      codes_scan_tc_kernel<true, MAX_PACK_K>, dim3(n_ctas), THREADS, smem,
      static_cast<cudaStream_t>(stream),
      static_cast<const __nv_bfloat16*>(qtable), probers, start_c, off, capb,
      penalty, codes, static_cast<const __nv_bfloat16*>(codebook), out,
      n_blocks, p_tile, m, dsub, g, s_eff, k_pair, euclidean ? 2.0f : 1.0f,
      slot_mask, n_groups);
}

// Dynamic shared memory of one CTA (d = m * dsub; pack32 alone is served).
extern "C" long long torchpq_codes_scan_tc_smem(int m, int dsub, int,
                                               int k_pair) {
  return (long long)tc_smem_bytes(m, dsub, k_pair);
}

// CTAs one SM holds at once (registers and shared memory permitting), or
// minus the CUDA error code.
extern "C" int torchpq_codes_scan_tc_occupancy(int m, int dsub, int,
                                               int k_pair) {
  return occupancy(codes_scan_tc_kernel<true, MAX_PACK_K>,
                   tc_smem_bytes(m, dsub, k_pair));
}
