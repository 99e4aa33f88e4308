// IVF block scan over PQ codes on Hopper's tensor cores (sm_90a): the
// counterpart of torchpq_tpu/ops/pallas_codes_scan.py:scan_blocks_pallas_codes
// for rows of d <= 128 (codes_scan.cu, on the CUDA cores, serves the rest).
// It computes what codes_scan.cu computes, for block b, prober p and window
// column c < s_eff holding slot j = (c % s_rows) * g + c / s_rows:
//
//   y_j   = concat_i bf16(codebook)[i, code[start_c[b] + j, i], :]
//   score = factor * <bf16(q_p), y_j> - pen_j,   factor = 2 (euclidean) or 1
//   pen_j = penalty[start_c[b] + j] + (off[b] <= j < off[b] + cap[b] ? 0 : BIG)
//
// summed in f32, then scan_common.cuh's selects over the columns (exact:
// value descending, column ascending; pack32: one maximal key per strided
// group of columns {j, j+G, ...}, then the k_pair largest) in block_scan.cu's
// wire format. One difference: rows whose prober is -1 are not scored but
// written dead (exact: sortable(-inf) keys and -1 addresses; pack32:
// INT_MIN). ops/adc.py:_merge_pairs never reads them.
//
// What bounds it on an H100: at the code-domain plans' arguments (4,507
// blocks of 128 probers, s_eff 1,024, PQ64 at d = 128) the bytes are ~0.3 GB
// of codes (~0.1 ms at 3.35 TB/s) and the products of the live probers
// ~9.4e10 operations (~0.1 ms at 989 TFLOP/s bf16). Each block decodes
// s_eff * m codebook lookups from shared memory whatever its live count,
// ~3e8 lookups per call, and every live score passes through the select,
// ~3.7e8 scores: instruction issue, shared-memory traffic and latency, not
// bytes or products. codes_scan.cu spent its time on what this design
// drops: an f32 FMA chain per prober (every decoded element feeds 128
// FMAs), pad probers scored in full (15% of rows are live at n_probe 8),
// one CTA of 4 warps per SM at pt = 128 in pack32 (173,696 B of shared
// memory), and the 64 KB codebook staged for every block.
//
// Design:
// - Persistent CTAs of 8 warps, one per SM (the wrapper sizes the grid from
//   the occupancy), each walking the blocks b = blockIdx.x + i * gridDim.x.
//   The bf16 codebook (256 * d * 2 bytes, 64 KB at d = 128) is staged in
//   shared memory once per CTA.
// - Only live m tiles: a block's p_tile <= 128 probers are up to 8 m tiles
//   of 16 rows; a ballot finds the nm tiles that hold a prober >= 0. Every
//   -1 row is written dead as the block starts. The 8 warps split the live
//   tiles' work: S = 8 / next_pow2(nm) warps per live tile, each taking a
//   slice of 128 / S columns of every window tile, so at n_probe 8 (~2 live
//   tiles a block) every warp scores and selects. A warp's A fragments (its
//   tile's 16 query rows, zero for -1 rows and past d) stay in registers for
//   the block (32 registers at d = 128).
// - Decode once per tile of TN = 128 window columns, shared by every live m
//   tile: each thread reads its 8-byte chunks of codes (at most 8) into
//   registers, and later writes each chunk's 8 codewords, looked up in the
//   shared codebook (all 8 loads before any store), into the tile
//   [column][k] with 16-byte stores (bf16, rows of round16(d) + 8 elements:
//   an odd multiple of 16 bytes, so the 8 row addresses of an ldmatrix
//   phase fall on distinct banks; the K padding is zero; a quarter warp's
//   stores cover 2 columns x 4 chunks, distinct bank groups at m = 64). The
//   tile is B as it lies (tc_ptx.cuh). Two tiles alternate: while the warps
//   score tile t, the next tile's codes are in flight, and every warp then
//   decodes its share into the other buffer; one __syncthreads per tile.
// - Products: mma.sync m16n8k16 bf16 x bf16 -> f32 (tc_ptx.cuh), B by
//   ldmatrix.x4 (16 columns x 16 k), up to 8 accumulator tiles (64 columns)
//   at a time, the first k step from a zero accumulator.
// - pack32 in registers along the C fragment layout: lane (g, t) holds rows
//   g and g + 8 of its m tile and, of every 8 columns of its slice, columns
//   2t and 2t + 1, so each (row, group) has one owner and no atomics are
//   needed: at most 32 group maxima per row of a 128-column phase. At a
//   phase's end the quad extracts its slice's k_pair largest keys per row
//   by 4-lane shuffles into shared memory, and one thread per live row
//   merges the S slices' lists and the running list of earlier phases.
//   With G = 256 or 512 (deep selects) the tiles are visited phase by phase
//   (columns == phase * 128 mod G), so a lane never holds more than 32
//   groups per row.
// - exact through shared memory: a warp writes the scores of its 64-column
//   group to its staging rows [16][SLD], and lane l takes row l / 2 over
//   its half of the group's columns, in ascending order, into a sorted list
//   of k_pair (rounded up to 10 or 16) entries (scan_common.cuh:insert keeps
//   column order on ties). Inserting score by score costs the whole warp an
//   insert whenever any lane has one, so a score enters only at or above a
//   bound on the row's k_pair-th value (the largest k_pair-th entry of the
//   row's lists, shared across its slices through shared memory), waits in
//   a short per-lane queue, and the queues are inserted together; a lane's
//   first 8 or 16 columns of a block are sorted at once by a bitonic
//   network. At the block's end each slice's list per row (the two lanes'
//   merged by shuffles) goes to shared memory, and one thread per live row
//   merges the S slices' lists in (value descending, column ascending)
//   order.
// - Budget at d = 128: shared memory 65,536 B codebook + 2 x 34,816 B tiles
//   + 2,048 B penalties and slots + 544 B prober rows and tile flags + the
//   slice lists (8 x 16 x k_pair entries) + exact: 36,864 B staging rows and
//   512 B row bounds; pack32: running lists (2 x 128 x k_pair keys):
//   185,376 B exact and 153,120 B pack32 at k_pair 10, one CTA of 8 warps
//   per SM. Registers: 32 A + 32 accumulators + 16 of prefetched codes + 64
//   pack32 maxima or 20 exact list entries, under the 255 that
//   __launch_bounds__(256, 1) allows (read -Xptxas -v for spills).

#include <cstdint>

#include "scan_common.cuh"
#include "tc_ptx.cuh"

namespace {

using namespace tpq;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int TN = 128;             // window columns per decoded tile
constexpr int MAX_D = 128;          // widest row the A fragments hold
constexpr int KSTEPS = MAX_D / 16;  // k16 steps of the widest row
constexpr int MAX_PT = 16 * WARPS;  // probers per block: up to 8 m tiles
constexpr int MAX_EXACT_K = 16;     // exact k_pair the lane lists take
constexpr int MAX_PACK_K = 48;      // pack32 k_pair the shared lists fit
constexpr int NGRP = TN / 4;        // pack32 group maxima per lane and row
constexpr int SLD = 72;             // exact staging row stride, floats
constexpr int MAX_CHUNKS = TN * 128 / 8 / THREADS;  // 8-byte code chunks
                                                    // per thread (m <= 128)

__host__ __device__ inline int round16(int d) { return (d + 15) / 16 * 16; }

// Shared memory: codebook [256 * d] bf16, tiles [2][TN][round16(d) + 8]
// bf16, penalties [2][TN] f32, slots [2][TN], prober rows [MAX_PT], tile
// flags [MAX_PT / 16], slice lists [WARPS][16][k_pair] (exact: values and
// columns; pack32: keys), then exact: score staging rows [WARPS][16][SLD]
// f32 and row bounds [WARPS][16] f32; pack32: running lists
// [2][MAX_PT][k_pair]. Each part is a multiple of 16 bytes (d % 8 == 0).
__host__ __device__ inline size_t tc_smem_bytes(int d, int pack32,
                                                int k_pair) {
  return (size_t)512 * d + (size_t)4 * TN * (round16(d) + 8) +
         (size_t)16 * TN + 4 * MAX_PT + 4 * (MAX_PT / 16) +
         (size_t)WARPS * 16 * k_pair * (pack32 ? 4 : 8) +
         (pack32 ? (size_t)2 * MAX_PT * k_pair * 4
                 : (size_t)WARPS * 16 * (SLD + 1) * 4);
}

// The column -> slot map of the packed codes (see the note above), without
// an integer division: the quotient from the f32 reciprocal inv = 1 /
// s_rows is off by at most one for c < 2^22, and the remainder corrects it.
__device__ __forceinline__ int col_slot(int c, int s_rows, int g, float inv) {
  int q = __float2int_rz((float)c * inv);
  int r = c - q * s_rows;
  if (r < 0) {
    --q;
    r += s_rows;
  } else if (r >= s_rows) {
    ++q;
    r -= s_rows;
  }
  return r * g + q;
}

// Column `cl` (of the tile) and chunk `ch` (of the column's cpc = 2^lc
// 8-byte chunks) of chunk item e. A warp's 32 items cover whole columns
// (the reads coalesce); with cpc >= 4, every 8 consecutive items are 2
// columns x 4 chunks, so a quarter warp's 16-byte stores fall on distinct
// bank groups (row stride = 16 mod 128 bytes, chunk stride 32 bytes at
// dsub = 2).
__device__ __forceinline__ void chunk_item(int e, int lc, int& cl, int& ch) {
  if (lc >= 2) {
    ch = (e & 3) | (((e >> 3) & ((1 << (lc - 2)) - 1)) << 2);
    cl = ((e >> 2) & 1) | ((e >> (lc + 1)) << 1);
  } else {
    cl = e >> lc;
    ch = e & ((1 << lc) - 1);
  }
}

__device__ __forceinline__ uint32_t code_byte(uint2 raw, int b) {
  return ((b < 4 ? raw.x : raw.y) >> (8 * (b & 3))) & 0xFFu;
}

// One thread's share of a tile's inputs, read from global memory before
// the tile is needed and written to shared memory after: its code chunks,
// and (threads < TN) one column's penalty and slot.
struct Prefetch {
  uint2 raw[MAX_CHUNKS];
  float pen;
  int slot;

  __device__ __forceinline__ void load(const unsigned char* __restrict__ codes,
                                       const float* __restrict__ penalty,
                                       int s0, int o0, int o1, int ts,
                                       int nrow, int m, int lc, int s_rows,
                                       int g, float inv) {
    const int t = threadIdx.x;
    const int items = (nrow + 1) / 2 * 2 << lc;
#pragma unroll
    for (int r = 0; r < MAX_CHUNKS; ++r) {
      const int e = t + r * THREADS;
      int cl, ch;
      chunk_item(e, lc, cl, ch);
      if (e < items && cl < nrow) {
        const int j = col_slot(ts + cl, s_rows, g, inv);
        raw[r] = __ldg(reinterpret_cast<const uint2*>(
            codes + ((size_t)s0 + j) * m + 8 * ch));
      }
    }
    if (t < TN) {
      pen = 0.0f;
      slot = 0;
      if (t < nrow) {
        slot = col_slot(ts + t, s_rows, g, inv);
        pen = __ldg(penalty + s0 + slot) +
              ((slot >= o0 && slot < o1) ? 0.0f : big_penalty());
      }
    }
  }

  // Decode into tile [TN][ld] and the tile's penalties and slots.
  __device__ __forceinline__ void store(__nv_bfloat16* tile, float* pen_s,
                                        int* slot_s,
                                        const __nv_bfloat16* cb_s, int nrow,
                                        int lc, int dsub, int ld) const {
    const int t = threadIdx.x;
    const int items = (nrow + 1) / 2 * 2 << lc;
#pragma unroll
    for (int r = 0; r < MAX_CHUNKS; ++r) {
      const int e = t + r * THREADS;
      int cl, ch;
      chunk_item(e, lc, cl, ch);
      if (e < items && cl < nrow) {
        const int i0 = 8 * ch;  // first subspace of the chunk
        __nv_bfloat16* dst = tile + cl * ld + i0 * dsub;
        if (dsub == 2) {  // a codeword is one 4-byte word
          const uint32_t* cb =
              reinterpret_cast<const uint32_t*>(cb_s) + i0 * 256;
          uint32_t w[8];
#pragma unroll
          for (int b = 0; b < 8; ++b) w[b] = cb[b * 256 + code_byte(raw[r], b)];
          uint4* d16 = reinterpret_cast<uint4*>(dst);
          d16[0] = make_uint4(w[0], w[1], w[2], w[3]);
          d16[1] = make_uint4(w[4], w[5], w[6], w[7]);
        } else if (dsub == 1) {  // two codewords per word
          const unsigned short* cb =
              reinterpret_cast<const unsigned short*>(cb_s) + i0 * 256;
          uint32_t h[8];
#pragma unroll
          for (int b = 0; b < 8; ++b) h[b] = cb[b * 256 + code_byte(raw[r], b)];
          *reinterpret_cast<uint4*>(dst) =
              make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16,
                         h[4] | h[5] << 16, h[6] | h[7] << 16);
        } else if (dsub == 4) {  // a codeword is 8 bytes
          const uint2* cb = reinterpret_cast<const uint2*>(cb_s) + i0 * 256;
          uint2 w[8];
#pragma unroll
          for (int b = 0; b < 8; ++b) w[b] = cb[b * 256 + code_byte(raw[r], b)];
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
                cb_s + ((i0 + b) * 256 + code_byte(raw[r], b)) * dsub;
            for (int u = 0; u < dsub; ++u) dst[b * dsub + u] = src[u];
          }
        }
      }
    }
    if (t < TN) {
      pen_s[t] = pen;
      slot_s[t] = slot;
    }
  }
};

// (x, i) comes before (y, j): value descending, then column ascending.
__device__ __forceinline__ bool before(float x, int i, float y, int j) {
  return x > y || (x == y && i < j);
}

// exact: a lane's candidates that passed the bound, queued in visit
// (column) order and inserted into its sorted list in one go when some
// lane's queue may overflow. Inserting one score at a time costs the whole warp
// an insert whenever any of its 32 lanes has a candidate; a flush lets
// every lane insert its own queued candidates together.
constexpr int QUEUE = 6;

struct ExactQueue {
  float v[QUEUE];  // indexed by the count: local memory, one insert's code
  int c[QUEUE];
  int n;

  __device__ __forceinline__ void push(float x, int col) {
    v[n] = x;
    c[n] = col;
    ++n;
  }

  template <int KMAX>
  __device__ __forceinline__ void flush(float (&vals)[KMAX],
                                        int (&cols)[KMAX]) {
#pragma unroll 1
    for (int j = 0; j < n; ++j) insert<KMAX>(vals, cols, v[j], c[j]);
    n = 0;
  }
};

// exact: the first N candidates of a lane's empty list, sorted at once (a
// bitonic network, value descending then column ascending: a total order,
// the columns being distinct) rather than inserted one by one.
template <int N, int KMAX>
__device__ __forceinline__ void first_fill(float (&vals)[KMAX],
                                           int (&cols)[KMAX],
                                           const float* sr, int c0, int col0,
                                           int nrow) {
  float v[N];
  int c[N];
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    const float4 s4 = *reinterpret_cast<const float4*>(sr + j);
    v[j] = s4.x;
    v[j + 1] = s4.y;
    v[j + 2] = s4.z;
    v[j + 3] = s4.w;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    c[j] = col0 + j;
    if (c0 + j >= nrow) {
      v[j] = neg_inf();
      c[j] = INT_MAX;
    }
  }
#pragma unroll
  for (int k = 2; k <= N; k *= 2) {
#pragma unroll
    for (int h = k / 2; h > 0; h /= 2) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int l = i ^ h;
        if (l > i) {
          const bool first = (i & k) == 0;  // this run sorts descending
          if (first ? before(v[l], c[l], v[i], c[i])
                    : before(v[i], c[i], v[l], c[l])) {
            const float tv = v[i];
            const int tc = c[i];
            v[i] = v[l];
            c[i] = c[l];
            v[l] = tv;
            c[l] = tc;
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    vals[j] = j < N ? v[j < N ? j : 0] : neg_inf();
    cols[j] = j < N ? c[j < N ? j : 0] : INT_MAX;
  }
}

// Global index (of the block's m tiles) of the n-th live one.
__device__ __forceinline__ int nth_live(const int* live_s, int n) {
  int k = 0;
  for (int i = 0; i < MAX_PT / 16; ++i) {
    if (live_s[i]) {
      if (k == n) return i;
      ++k;
    }
  }
  return -1;
}

// KMAX: the exact lists' length, k_pair rounded up to 10 or 16 (shorter
// lists make each insert cheaper; pack32 does not use them).
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
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  const int t4 = lane % 4;
  const int d = m * dsub;
  const int dpad = round16(d);
  const int ld = dpad + 8;
  const int ksteps = dpad / 16;
  const int s_rows = s_eff / g;
  const float inv = 1.0f / (float)s_rows;
  const int lc = 31 - __clz(m / 8);  // log2 of the code chunks per slot
  const int width = PACK ? k_pair : 2 * k_pair;  // output ints per row

  __nv_bfloat16* cb_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* tiles = cb_s + 256 * d;                  // [2][TN][ld]
  float* pen_s = reinterpret_cast<float*>(tiles + 2 * TN * ld);  // [2][TN]
  int* slot_s = reinterpret_cast<int*>(pen_s + 2 * TN);          // [2][TN]
  int* prow_s = slot_s + 2 * TN;                                 // [MAX_PT]
  int* live_s = prow_s + MAX_PT;                          // [MAX_PT / 16]
  int* keys_s = live_s + MAX_PT / 16;  // slice lists [WARPS][16][k_pair]
  float* vals_s = reinterpret_cast<float*>(keys_s + WARPS * 16 * k_pair);
  int* run_s = keys_s + WARPS * 16 * k_pair;  // pack32 [2][MAX_PT][k_pair]
  float* stage_s = vals_s + WARPS * 16 * k_pair;  // exact [WARPS][16][SLD]
  volatile float* rowb_s = stage_s + WARPS * 16 * SLD;  // exact [WARPS][16]

  // the codebook, 16 bytes per thread step (256 * d * 2 bytes)
  {
    const uint4* src = reinterpret_cast<const uint4*>(codebook);
    uint4* dst = reinterpret_cast<uint4*>(cb_s);
    for (int i = t; i < 32 * d; i += THREADS) dst[i] = src[i];
  }
  // the K padding of both tiles, zero once (the decode writes [0, d))
  if (dpad > d) {
    const int pad = dpad - d;
    unsigned short* raw = reinterpret_cast<unsigned short*>(tiles);
    for (int i = t; i < 2 * TN * pad; i += THREADS) {
      raw[(i / pad) * ld + d + i % pad] = 0;
    }
  }

  // Tile order: ts(i) = (i % tpp) * stride + (i / tpp) * TN. Deep pack32
  // groups (G > TN) take the tiles phase by phase: phase f holds the
  // columns == f * TN (mod G), and a phase ends every tpp tiles.
  const bool phased = PACK && n_groups > TN;
  const int n_tiles = (s_eff + TN - 1) / TN;
  const int tpp = phased ? s_eff / n_groups : n_tiles;
  const int stride = phased ? n_groups : TN;

  for (int b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    __syncthreads();  // the previous block is done with the shared arrays
    const int s0 = start_c[b];
    const int o0 = off[b];
    const int o1 = o0 + capb[b];
    const int pr = t < p_tile ? probers[(size_t)b * p_tile + t] : -1;
    if (t < MAX_PT) {
      prow_s[t] = pr;
      if (!PACK) rowb_s[t] = neg_inf();
    }
    if (t < p_tile && pr < 0) {  // pad rows: dead, never scored
      int* o = out + ((size_t)b * p_tile + t) * width;
      for (int i = 0; i < k_pair; ++i) {
        if (PACK) {
          o[i] = INT_MIN;
        } else {
          o[i] = sortable(neg_inf());
          o[k_pair + i] = -1;
        }
      }
    }
    const unsigned live = __ballot_sync(0xffffffffu, pr >= 0);
    if (lane == 0 && warp < MAX_PT / 32) {
      live_s[2 * warp] = (live & 0xFFFFu) != 0u;
      live_s[2 * warp + 1] = (live >> 16) != 0u;
    }
    Prefetch pf;
    pf.load(codes, penalty, s0, o0, o1, 0, min(TN, s_eff), m, lc, s_rows, g,
            inv);
    __syncthreads();

    // The live tiles' work: S warps per live tile, warp w takes slice
    // w % S (pairs of n8 tiles [slice * np_s, (slice + 1) * np_s) of every
    // window tile) of live tile w / S (warp-uniform).
    int nm = 0;
    for (int i = 0; i < MAX_PT / 16; ++i) nm += live_s[i];
    const int S = nm <= 1 ? 8 : nm <= 2 ? 4 : nm <= 4 ? 2 : 1;
    const int np_s = 8 / S;  // 16-column pairs per slice and tile
    const int lt = warp / S;
    const int slice = warp % S;
    const bool busy = lt < nm;
    const int mt = busy ? nth_live(live_s, lt) : 0;

    // A: the m tile's query rows, zero for -1 rows and past d
    uint32_t a[KSTEPS][4];
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[ks][i] = 0u;
        if (busy && ks < ksteps) {
          const int q = prow_s[16 * mt + frag_a_row(lane, i)];
          const int col = 16 * ks + frag_a_col(lane, i);
          if (q >= 0 && col < d) {
            a[ks][i] = __ldg(reinterpret_cast<const unsigned int*>(
                qtable + (size_t)q * d + col));
          }
        }
      }
    }

    pf.store(tiles, pen_s, slot_s, cb_s, min(TN, s_eff), lc, dsub, ld);

    // select state: exact lists and the quad's bound, or pack32 group
    // maxima of the phase
    // (exact: lane l keeps row l / 2 of the warp's 16, over its half of
    // each group of columns)
    float vals[KMAX];
    int cols[KMAX];
    // a -1 row of a live tile is scored but selects nothing
    const bool dead_row = busy && prow_s[16 * mt + lane / 2] < 0;
    float bound = dead_row ? -neg_inf() : neg_inf();
    int mx[2][NGRP];
    ExactQueue queue;
    queue.n = 0;
    if constexpr (PACK) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
        for (int j = 0; j < NGRP; ++j) mx[rr][j] = INT_MIN;
      }
    } else {
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        vals[j] = neg_inf();
        cols[j] = INT_MAX;
      }
    }
    int phase = 0;
    __syncthreads();

    for (int it = 0; it < n_tiles; ++it) {
      const int buf = it & 1;
      const int ts = (it % tpp) * stride + (it / tpp) * TN;
      const int nrow = min(TN, s_eff - ts);
      if (it + 1 < n_tiles) {
        const int tn = ((it + 1) % tpp) * stride + ((it + 1) / tpp) * TN;
        pf.load(codes, penalty, s0, o0, o1, tn, min(TN, s_eff - tn), m, lc,
                s_rows, g, inv);
      }
      if (busy) {
        const __nv_bfloat16* tile = tiles + buf * TN * ld;
        const float* pen = pen_s + buf * TN;
        const int* slt = slot_s + buf * TN;
#pragma unroll
        for (int gq = 0; gq < 2; ++gq) {  // up to 4 pairs (64 columns)
          const int p0 = slice * np_s + 4 * gq;  // first pair of the group
          if (4 * gq < np_s && 16 * p0 < nrow) {
            float acc[8][4];
#pragma unroll
            for (int ks = 0; ks < KSTEPS; ++ks) {
              if (ks < ksteps) {
#pragma unroll
                for (int np = 0; np < 4; ++np) {
                  const int c0 = 16 * (p0 + np);
                  if (4 * gq + np < np_s && c0 < nrow) {
                    uint32_t bf[4];
                    ldmatrix_x4(bf, tile + (c0 + ldm_b_row(lane)) * ld +
                                        16 * ks + ldm_b_col(lane));
                    if (ks == 0) {
                      mma_bf16_16816_zero(acc[2 * np], a[0], bf[0], bf[1]);
                      mma_bf16_16816_zero(acc[2 * np + 1], a[0], bf[2],
                                          bf[3]);
                    } else {
                      mma_bf16_16816(acc[2 * np], a[ks], bf[0], bf[1]);
                      mma_bf16_16816(acc[2 * np + 1], a[ks], bf[2], bf[3]);
                    }
                  }
                }
              }
            }
            // the scores of this lane's columns, in ascending order
            if constexpr (PACK) {
#pragma unroll
              for (int nt = 0; nt < 8; ++nt) {
                const int base = 16 * p0 + 8 * nt;  // the n8 tile's column
                const int cl = base + frag_c_col(lane, 0);
                if (4 * gq + nt / 2 < np_s && base < nrow) {
                  const float2 p =
                      *reinterpret_cast<const float2*>(pen + cl);
#pragma unroll
                  for (int i = 0; i < 2; ++i) {
                    if (cl + i < nrow) {
#pragma unroll
                      for (int rr = 0; rr < 2; ++rr) {
                        const float sc =
                            factor * acc[nt][2 * rr + i] - (i ? p.y : p.x);
                        const int key =
                            (sortable(sc) & ~slot_mask) | slt[cl + i];
                        int& best = mx[rr][2 * (8 * gq + nt) + i];
                        best = max(best, key);
                      }
                    }
                  }
                }
              }
            } else {
              // exact: the group's scores through the warp's staging rows
              // [16][SLD]; lane l then takes row l / 2 over its half of the
              // group's columns, in ascending order
              float* st = stage_s + warp * 16 * SLD;
#pragma unroll
              for (int nt = 0; nt < 8; ++nt) {
                const int base = 16 * p0 + 8 * nt;
                const int cl = base + frag_c_col(lane, 0);
                if (4 * gq + nt / 2 < np_s && base < nrow) {
                  const float2 p =
                      *reinterpret_cast<const float2*>(pen + cl);
#pragma unroll
                  for (int rr = 0; rr < 2; ++rr) {
                    *reinterpret_cast<float2*>(
                        st + frag_c_row(lane, 2 * rr) * SLD + 8 * nt +
                        frag_c_col(lane, 0)) =
                        make_float2(factor * acc[nt][2 * rr] - p.x,
                                    factor * acc[nt][2 * rr + 1] - p.y);
                  }
                }
              }
              __syncwarp();
              const int hw = 8 * min(4, np_s - 4 * gq);  // half the group
              const int c0 = 16 * p0 + (lane % 2) * hw;  // lane's first
              const float* sr = st + (lane / 2) * SLD + (lane % 2) * hw;
              // the block's first group: the lists are empty, so its first
              // 16 (or 8) columns are sorted into them at once
              int j0 = 0;
              if (it == 0 && gq == 0) {
                if (hw >= 16) {
                  first_fill<16, KMAX>(vals, cols, sr, c0, ts + c0, nrow);
                  j0 = 16;
                } else {
                  first_fill<8, KMAX>(vals, cols, sr, c0, ts + c0, nrow);
                  j0 = 8;
                }
                float kth = vals[0];
#pragma unroll
                for (int j = 1; j < KMAX; ++j) {
                  if (j == k_pair - 1) kth = vals[j];
                }
                bound = fmaxf(bound,
                              fmaxf(kth, __shfl_xor_sync(0xffffffffu, kth, 1)));
              }
#pragma unroll 1
              for (int j = j0; j < hw; j += 4) {  // hw % 8 == 0
                if (__any_sync(0xffffffffu, queue.n > QUEUE - 4)) {
                  queue.flush(vals, cols);
                }
                const float4 s4 = *reinterpret_cast<const float4*>(sr + j);
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                  const float sc = u == 0 ? s4.x : u == 1 ? s4.y
                                 : u == 2 ? s4.z : s4.w;
                  if (c0 + j + u < nrow && sc >= bound &&
                      sc > vals[KMAX - 1]) {
                    queue.push(sc, ts + c0 + j + u);
                  }
                }
              }
              __syncwarp();  // the staging rows are free again
              // a bound on the row's k_pair-th value: the largest k_pair-th
              // entry of the lists of its lanes, published per slice (a
              // slice holding k_pair entries >= x bounds the row's k_pair-th
              // by x; another slice's value read stale is a lower bound too)
              float kth = vals[0];
#pragma unroll
              for (int j = 1; j < KMAX; ++j) {
                if (j == k_pair - 1) kth = vals[j];
              }
              kth = fmaxf(kth, __shfl_xor_sync(0xffffffffu, kth, 1));
              if (lane % 2 == 0) rowb_s[warp * 16 + lane / 2] = kth;
              bound = kth;
              for (int sl = 0; sl < S; ++sl) {
                bound = fmaxf(bound, rowb_s[(lt * S + sl) * 16 + lane / 2]);
              }
              if (dead_row) bound = -neg_inf();
            }
          }
        }
      }
      if constexpr (PACK) {
        if ((it + 1) % tpp == 0) {
          // phase end: each slice's k_pair largest keys per row, by the
          // quad's shuffles, into its shared list
          if (busy) {
            for (int i = 0; i < k_pair; ++i) {
#pragma unroll
              for (int rr = 0; rr < 2; ++rr) {
                int best = INT_MIN;
                int bi = 0;
#pragma unroll
                for (int j = 0; j < NGRP; ++j) {
                  if (mx[rr][j] > best) {
                    best = mx[rr][j];
                    bi = j;
                  }
                }
                int q = max(best, __shfl_xor_sync(0xffffffffu, best, 1));
                q = max(q, __shfl_xor_sync(0xffffffffu, q, 2));
                if (best == q) {  // keys are unique in a row: the owner
#pragma unroll
                  for (int j = 0; j < NGRP; ++j) {
                    if (j == bi) mx[rr][j] = INT_MIN;
                  }
                }
                if (t4 == 0) {
                  keys_s[(warp * 16 + frag_c_row(lane, 2 * rr)) * k_pair +
                         i] = q;
                }
              }
            }
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
              for (int j = 0; j < NGRP; ++j) mx[rr][j] = INT_MIN;
            }
          }
          __syncthreads();
          // one thread per live row: the k_pair largest of its slices'
          // lists and the running list of the earlier phases
          if (t < 16 * nm) {
            const int* cur = run_s + ((phase & 1) * MAX_PT + t) * k_pair;
            int* nxt = run_s + (((phase + 1) & 1) * MAX_PT + t) * k_pair;
            const int* sl = keys_s + ((t / 16) * S * 16 + t % 16) * k_pair;
            int h[WARPS + 1] = {};
            for (int i = 0; i < k_pair; ++i) {
              int best = phase > 0 ? cur[h[WARPS]] : INT_MIN;
              int bs = WARPS;
              for (int s = 0; s < S; ++s) {
                const int v = h[s] < k_pair ? sl[s * 16 * k_pair + h[s]]
                                            : INT_MIN;
                if (v > best) {
                  best = v;
                  bs = s;
                }
              }
              ++h[bs];
              nxt[i] = best;
            }
          }
          ++phase;
        }
      }
      if (it + 1 < n_tiles) {
        const int tn = ((it + 1) % tpp) * stride + ((it + 1) / tpp) * TN;
        pf.store(tiles + (buf ^ 1) * TN * ld, pen_s + (buf ^ 1) * TN,
                 slot_s + (buf ^ 1) * TN, cb_s, min(TN, s_eff - tn), lc,
                 dsub, ld);
      }
      __syncthreads();
    }

    // the live rows' outputs
    if constexpr (PACK) {
      if (t < 16 * nm) {
        const int p = 16 * nth_live(live_s, t / 16) + t % 16;
        if (prow_s[p] >= 0) {
          const int* fin = run_s + ((phase & 1) * MAX_PT + t) * k_pair;
          int* o = out + ((size_t)b * p_tile + p) * k_pair;
          for (int i = 0; i < k_pair; ++i) o[i] = fin[i];
        }
      }
    } else {
      // each slice's k_pair best per row: the better head of the row's
      // two lanes, then its owner pops it
      if (busy) {
        queue.flush(vals, cols);
        for (int i = 0; i < k_pair; ++i) {
          float v = vals[0];
          int c = cols[0];
          const float ov = __shfl_xor_sync(0xffffffffu, v, 1);
          const int oc = __shfl_xor_sync(0xffffffffu, c, 1);
          const bool mine = !before(ov, oc, v, c);
          if (mine) {
#pragma unroll
            for (int j = 0; j < KMAX - 1; ++j) {
              vals[j] = vals[j + 1];
              cols[j] = cols[j + 1];
            }
            vals[KMAX - 1] = neg_inf();
            cols[KMAX - 1] = INT_MAX;
          } else {
            v = ov;
            c = oc;
          }
          if (lane % 2 == 0) {
            const int e = (warp * 16 + lane / 2) * k_pair + i;
            vals_s[e] = v;
            keys_s[e] = c;
          }
        }
      }
      __syncthreads();
      // one thread per live row: merge its slices' lists
      if (t < 16 * nm) {
        const int p = 16 * nth_live(live_s, t / 16) + t % 16;
        if (prow_s[p] >= 0) {
          const int e0 = ((t / 16) * S * 16 + t % 16) * k_pair;
          int* o = out + ((size_t)b * p_tile + p) * 2 * k_pair;
          const float dead = -big_penalty() / 2.0f;
          int h[WARPS] = {};
          for (int i = 0; i < k_pair; ++i) {
            float v = neg_inf();
            int c = INT_MAX;
            int bs = 0;
            for (int s = 0; s < S; ++s) {
              if (h[s] < k_pair) {
                const int e = e0 + s * 16 * k_pair + h[s];
                if (before(vals_s[e], keys_s[e], v, c)) {
                  v = vals_s[e];
                  c = keys_s[e];
                  bs = s;
                }
              }
            }
            ++h[bs];
            const bool alive = v > dead;
            o[i] = sortable(alive ? v : neg_inf());
            o[k_pair + i] = alive ? s0 + col_slot(c, s_rows, g, inv) : -1;
          }
        }
      }
    }
  }
}

template <bool PACK, int KMAX>
int occupancy(int d, int k_pair) {
  const auto kern = codes_scan_tc_kernel<PACK, KMAX>;
  const size_t smem = tc_smem_bytes(d, PACK, k_pair);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  }
  int n = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, THREADS,
                                                        smem);
  }
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace

// Plain C entry point (bound with ctypes). qtable [nq, m*dsub] bf16 (4-byte
// aligned), probers [n_blocks, p_tile] int32 (p_tile % 16 == 0, p_tile <=
// 128), start_c / off / capb [n_blocks] int32, penalty [capacity] f32,
// codes the packed uint8 storage (capacity * m bytes, m a power of two
// from 8 to 128, 8-byte aligned), codebook [m, 256, dsub] bf16 (16-byte aligned), d =
// m * dsub <= 128, out int32; exact: k_pair <= 16; pack32: k_pair <= 48 and
// n_groups % 8 == 0, either n_groups == s_eff <= 128, or n_groups == 128
// with s_eff % 128 == 0, or n_groups a multiple of 128 that divides s_eff.
// n_ctas: the persistent grid (at most n_blocks). Returns 0 or the CUDA
// error code of an attribute call or the launch. Launches on `stream`,
// does not synchronize and allocates nothing.
extern "C" int torchpq_codes_scan_tc(
    const void* qtable, const int* probers, const int* start_c,
    const int* off, const int* capb, const float* penalty,
    const unsigned char* codes, const void* codebook, int* out,
    int n_blocks, int p_tile, int m, int dsub, int g, int s_eff, int k_pair,
    int euclidean, int pack32, int slot_mask, int n_groups, int n_ctas,
    void* stream) {
  const int d = m * dsub;
  const bool groups_ok =
      n_groups >= k_pair && n_groups % 8 == 0 &&
      (n_groups == s_eff ? s_eff <= TN
                         : (n_groups % TN == 0 && s_eff % n_groups == 0));
  if (n_blocks <= 0 || n_ctas <= 0 || n_ctas > n_blocks || p_tile <= 0 ||
      p_tile % 16 || p_tile > MAX_PT || m < 8 || (m & (m - 1)) || m > 128 ||
      dsub <= 0 || d > MAX_D || g <= 0 || s_eff <= 0 || s_eff % g ||
      k_pair < 1 || k_pair > s_eff || (!pack32 && k_pair > MAX_EXACT_K) ||
      (pack32 && (k_pair > MAX_PACK_K || !groups_ok)) ||
      reinterpret_cast<uintptr_t>(qtable) % 4 ||
      reinterpret_cast<uintptr_t>(codebook) % 16 ||
      reinterpret_cast<uintptr_t>(codes) % 8) {
    return (int)cudaErrorInvalidValue;
  }
  const float factor = euclidean ? 2.0f : 1.0f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = tc_smem_bytes(d, pack32, k_pair);
#define TPQ_ARGS                                                           \
  static_cast<const __nv_bfloat16*>(qtable), probers, start_c, off, capb, \
      penalty, codes, static_cast<const __nv_bfloat16*>(codebook), out,    \
      n_blocks, p_tile, m, dsub, g, s_eff, k_pair, factor, slot_mask,      \
      n_groups
  if (pack32) {
    return launch_kernel(codes_scan_tc_kernel<true, 1>, dim3(n_ctas),
                         THREADS, smem, st, TPQ_ARGS);
  }
  if (k_pair <= 10) {
    return launch_kernel(codes_scan_tc_kernel<false, 10>, dim3(n_ctas),
                         THREADS, smem, st, TPQ_ARGS);
  }
  return launch_kernel(codes_scan_tc_kernel<false, 16>, dim3(n_ctas),
                       THREADS, smem, st, TPQ_ARGS);
#undef TPQ_ARGS
}

// Dynamic shared memory of one CTA at width d.
extern "C" long long torchpq_codes_scan_tc_smem(int d, int pack32,
                                               int k_pair) {
  return (long long)tc_smem_bytes(d, pack32, k_pair);
}

// CTAs one SM holds at once (registers and shared memory permitting), or
// minus the CUDA error code.
extern "C" int torchpq_codes_scan_tc_occupancy(int d, int pack32,
                                               int k_pair) {
  if (pack32) return occupancy<true, 1>(d, k_pair);
  return k_pair <= 10 ? occupancy<false, 10>(d, k_pair)
                      : occupancy<false, 16>(d, k_pair);
}
