// The mma.sync IVF block scan of codes_scan_tc.cu: one kernel body over bf16
// rows of at most 256 bytes (d <= 128), templated over the source of its
// window tiles (the codes' decode), for its one kind of instance, the
// sorted pack32 select (k_pair <= 64); and the select helpers that
// block_scan_wg.cu's consumers share (the pack32 maxima's phase-end
// extraction pass by pass up to k_pair 16, the exact lists, queue and first
// fill; deeper pack32 selects are deep_select.cuh's).
//
// For block b, prober p and window column c < s_eff holding in-window slot
// j (the source says which):
//
//   score = factor * <bf16(q_p), y_j> - pen_j    (f32 sums)
//   pen_j = penalty[start_c[b] + j] + (off[b] <= j < off[b] + cap[b] ? 0 : BIG)
//
// factor = 2 (euclidean) or 1; then scan_common.cuh's pack32 select over
// the columns (one maximal key per strided group of columns {c, c+G, ...},
// then the k_pair largest), in block_scan.cu's wire format. Rows whose
// prober is -1 are not scored but written dead (INT_MIN);
// ops/adc.py:_merge_pairs never reads them.
//
// Design:
// - Persistent CTAs of 8 warps, one per SM (the wrapper sizes the grid from
//   the occupancy), each walking the blocks b = blockIdx.x + i * gridDim.x.
// - Only live m tiles: a block's p_tile <= 128 probers are up to 8 m tiles
//   of 16 rows; a ballot finds the nm tiles that hold a prober >= 0. Every
//   -1 row is written dead as the block starts. The 8 warps split the live
//   tiles' work: S = 8 / next_pow2(nm) warps per live tile, each taking a
//   slice of 128 / S columns of every window tile, so at n_probe 8 (~2 live
//   tiles a block) every warp scores and selects.
// - Rows in bytes: a row of d elements is rb = 2 d bytes, a k step 32
//   bytes (mma.sync m16n8k16 bf16: tc_ptx.cuh). A warp's A fragments (its
//   tile's 16 query rows, zero for -1 rows and past d) stay in registers
//   for the block (32 registers at 256 bytes). The window in tiles of TN =
//   128 columns, shared by every live m tile: [column][byte] with rows of
//   round32(rb) + 16 bytes (an odd multiple of 16 bytes, so the 8 row
//   addresses of an ldmatrix phase fall on distinct banks; the K padding
//   is zero), which is B as it lies (tc_ptx.cuh).
// - Two ring stages alternate: the source's fetch() starts the next stage
//   before the warps score this one, and its land() finishes it after; one
//   __syncthreads per stage. A block's last stage brings the CTA's next
//   block's first one and this thread's prober of it, so a block waits at
//   its start only for its window's bounds and its A fragments.
// - One tile (a source whose ONE_TILE is true: the codes instance, whose
//   codebook leaves no room for a second decoded tile beside the deep
//   lists): the source keeps the next stage's raw inputs in shared memory
//   of its own while the warps score the one tile, then a __syncthreads
//   (the warps are done with the tile; at a phase end the select's own
//   barrier serves), then land() writes the tile: two __syncthreads per
//   stage, the land no longer overlapped by scoring.
// - Products: mma.sync (tc_ptx.cuh), B by ldmatrix.x4 (16 columns x 32
//   bytes), up to 8 accumulator tiles (64 columns) at a time, the first k
//   step from a zero accumulator.
// - pack32 in registers along the C fragment layout: lane (g, t) holds rows
//   g and g + 8 of its m tile and, of every 8 columns of its slice, columns
//   2t and 2t + 1, so each (row, group) has one owner and no atomics are
//   needed: at most 32 group maxima per row of a 128-column phase (32 / S
//   in a slice of 128 / S columns). At a phase's end the quad sorts its
//   slice's maxima of each row by a bitonic network (sort_slice; a pass
//   per key, extract_slice, costs ~3 instructions per maximum, so 64
//   passes over 128 groups cost ~4x the sort) and writes the first k_pair
//   into shared memory. One thread per live row merges the S slices'
//   lists and the running list of earlier phases (lists of an odd row
//   stride, so those threads hit distinct banks; the heads in registers,
//   loops over the 8 slices unrolled), and each warp writes two rows of
//   every live tile, its lanes on consecutive keys. With G = 256 or 512
//   the tiles are visited phase by phase (columns == phase * 128 mod G), so
//   a lane never holds more than 32 groups per row.
// - Registers: 32 A + 32 accumulators + 64 pack32 maxima + the sort, under
//   the 255 that __launch_bounds__(256, 1) allows (read -Xptxas -v for
//   spills and stack frames).
//
// The exact select's helpers (block_scan_wg.cu's exact instances): a warp
// writes the scores of its 64 columns to its staging rows [16][SLD], and
// lane l takes row l / 2 over its half of them, in ascending order, into a
// sorted list of k_pair (rounded up to 10 or 16) entries
// (scan_common.cuh:insert keeps column order on ties). Inserting score by
// score costs the whole warp an insert whenever any lane has one, so a
// score enters only at or above a bound on the row's k_pair-th value (the
// largest k_pair-th entry of the row's lists, shared across its slices
// through shared memory), waits in a short per-lane queue (ExactQueue),
// and the queues are inserted together; a lane's first 16 columns of a
// block are sorted at once (first_fill). The queue lives in shared memory
// and the lists in registers: no per-thread array may be indexed by a
// value the compiler cannot unroll, or it lands in local memory, which has
// little L1 beside these kernels' shared memory (see kth_of).
//
// A tile source is a struct with
//   ONE_TILE: whether the body keeps one tile (see above) or two;
//   fetch(s0, o0, o1, ts, nrow, tile): start bringing window columns [ts,
//       ts + nrow) of the block whose window starts at slot s0 (its cell's
//       slots [o0, o1) of the window) into `tile`;
//   land(ts, nrow, tile, pen_s, slot_s): finish them, and write each
//       column's penalty and in-window slot; after a
//       __syncthreads the tile holds the columns' bytes [0, rb) of each.

#pragma once

#include <cstdint>

#include "scan_common.cuh"
#include "tc_ptx.cuh"

namespace tpq {
namespace tc {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int TN = 128;                // window columns per tile
constexpr int MAX_ROW = 256;           // widest row (bytes) A registers hold
constexpr int KSTEPS = MAX_ROW / 32;   // 32-byte k steps of the widest row
constexpr int MAX_PT = 16 * WARPS;     // probers per block: up to 8 m tiles
constexpr int MAX_EXACT_K = 16;        // exact k_pair the lane lists take
constexpr int MAX_PACK_K = 64;         // pack32 k_pair (where the shared
                                       // memory fits: body_smem_bytes)
constexpr size_t SMEM_LIMIT = 232448;  // dynamic shared memory of a CTA
constexpr int NGRP = TN / 4;           // pack32 group maxima per lane and row
constexpr int PASS_K = 16;             // pack32 k_pair extracted pass by pass
                                       // (deeper: sort_slice here,
                                       // deep_select.cuh in block_scan_wg.cu)
constexpr int SLD = 72;                // exact staging row stride, floats
constexpr int QUEUE = 6;               // exact: a lane's queued candidates

__host__ __device__ inline int round32(int b) { return (b + 31) / 32 * 32; }

// Row stride (bytes) of the tiles of rows of rb bytes.
__host__ __device__ inline int row_ld(int rb) { return round32(rb) + 16; }

// The score of a bf16 product sum x (block_scan_wg.cu's bf16 rows too).
__device__ __forceinline__ float score(float x, float factor, float pen) {
  return factor * x - pen;
}

// Row stride (entries) of the slice and running lists: pack32 rows of an
// odd stride, so that the merge's thread-per-row reads and writes fall on
// distinct banks (at k_pair 64 a stride of 64 put a warp's 32 rows on one).
__host__ __device__ inline int list_ld(int k_pair, int pack32) {
  return pack32 ? (k_pair | 1) : k_pair;
}

// Shared memory of the body: tiles [2][TN][row_ld] bytes (one_tile:
// [1][TN][row_ld]), penalties [2][TN] f32, slots [2][TN], prober rows
// [MAX_PT], tile flags [MAX_PT / 16], slice
// lists [WARPS][16][list_ld] (exact: values and columns; pack32: keys),
// then exact: score staging rows [WARPS][16][SLD] f32, row bounds
// [WARPS][16] f32 and the lanes' queues [QUEUE][THREADS] f32 and int;
// pack32: running lists [2][MAX_PT][list_ld]. Each part is a multiple of 16
// bytes (rb % 16 == 0).
__host__ __device__ inline size_t body_smem_bytes(int rb, int pack32,
                                                  int k_pair,
                                                  bool one_tile = false) {
  const size_t kls = list_ld(k_pair, pack32);
  return (size_t)(one_tile ? 1 : 2) * TN * row_ld(rb) + (size_t)16 * TN +
         4 * MAX_PT + 4 * (MAX_PT / 16) +
         (size_t)WARPS * 16 * kls * (pack32 ? 4 : 8) +
         (pack32 ? (size_t)2 * MAX_PT * kls * 4
                 : (size_t)WARPS * 16 * (SLD + 1) * 4 +
                       (size_t)QUEUE * THREADS * 8);
}

// The shapes the body takes (the sources' own terms apart): rows of rb
// bytes, rb % 16 == 0 and rb <= max_rb; blocks of whole m tiles, at most 8;
// exact k_pair <= 16; pack32 k_pair <= 64 with G % 8 == 0, either G ==
// s_eff <= TN, or G a multiple of TN that divides s_eff. The entry points
// also refuse a shared memory above SMEM_LIMIT: the pack32 lists take
// 1,536 bytes per entry of their row stride, so k_pair 64 fits the codes
// source with its codebook in one tile (d <= 128: at most 219,168 B).
__host__ inline bool shape_ok(int n_blocks, int n_ctas, int p_tile, int rb,
                              int max_rb, int s_eff, int k_pair, int pack32,
                              int n_groups) {
  const bool groups_ok =
      n_groups >= k_pair && n_groups % 8 == 0 &&
      (n_groups == s_eff ? s_eff <= TN
                         : (n_groups % TN == 0 && s_eff % n_groups == 0));
  return n_blocks > 0 && n_ctas > 0 && n_ctas <= n_blocks && p_tile > 0 &&
         p_tile % 16 == 0 && p_tile <= MAX_PT && rb > 0 && rb % 16 == 0 &&
         rb <= max_rb && s_eff > 0 && k_pair >= 1 && k_pair <= s_eff &&
         (pack32 ? (k_pair <= MAX_PACK_K && groups_ok)
                 : k_pair <= MAX_EXACT_K);
}

// (x, i) comes before (y, j): value descending, then column ascending.
__device__ __forceinline__ bool before(float x, int i, float y, int j) {
  return x > y || (x == y && i < j);
}

// exact: a lane's candidates that passed the bound, queued in visit
// (column) order and inserted into its sorted list in one go when some
// lane's queue may overflow. Inserting one score at a time costs the whole warp
// an insert whenever any of its 32 lanes has a candidate; a flush lets
// every lane insert its own queued candidates together. The queue is the
// thread's column of [QUEUE][THREADS] arrays in shared memory (conflict
// free; indexed by the count, so neither registers nor local memory, which
// gets little L1 beside the kernels' shared memory).

struct ExactQueue {
  float* v;  // &values[0][threadIdx.x]
  int* c;    // &columns[0][threadIdx.x]
  int n;

  __device__ __forceinline__ void push(float x, int col) {
    v[n * THREADS] = x;
    c[n * THREADS] = col;
    ++n;
  }

  template <int KMAX>
  __device__ __forceinline__ void flush(float (&vals)[KMAX],
                                        int (&cols)[KMAX]) {
#pragma unroll 1
    for (int j = 0; j < n; ++j) {
      insert<KMAX>(vals, cols, v[j * THREADS], c[j * THREADS]);
    }
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

// Largest of v[0..N), N % 4 == 0, in four independent running maxima.
template <int N>
__device__ __forceinline__ int max_of(const int (&v)[NGRP]) {
  int b0 = v[0], b1 = v[1], b2 = v[2], b3 = v[3];
#pragma unroll
  for (int j = 4; j < N; j += 4) {
    b0 = max(b0, v[j]);
    b1 = max(b1, v[j + 1]);
    b2 = max(b2, v[j + 2]);
    b3 = max(b3, v[j + 3]);
  }
  return max(max(b0, b1), max(b2, b3));
}

// pack32 phase end, k_pair <= PASS_K: the slice's k_pair largest keys of
// each of the lane's two rows (rows g and g + 8 of the warp's m tile), by
// the quad's shuffles, into the warp's list keys_s [16][kls]; the maxima
// reset. NU: the group maxima a lane holds per row, 32 / S (a slice of
// 128 / S columns), so the scans run over those only, with register
// indices. Keys are unique in a row, so the lane holding the quad's maximum
// clears it by value. A pass costs ~3 NU instructions and two dependent
// shuffles per row, so deeper selects sort instead (sort_slice).
template <int NU>
__device__ __forceinline__ void extract_slice(int (&mx)[2][NGRP], int* keys_s,
                                              int lane, int k_pair, int kls) {
  for (int i = 0; i < k_pair; ++i) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int best = max_of<NU>(mx[rr]);
      int q = max(best, __shfl_xor_sync(0xffffffffu, best, 1));
      q = max(q, __shfl_xor_sync(0xffffffffu, q, 2));
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        if (mx[rr][j] == q) mx[rr][j] = INT_MIN;
      }
      if (lane % 4 == 0) keys_s[frag_c_row(lane, 2 * rr) * kls + i] = q;
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
    for (int j = 0; j < NU; ++j) mx[rr][j] = INT_MIN;
  }
}

// The quad's 4 * NU values of one row sorted descending by a bitonic
// network: lane lq = lane % 4 holds elements lq * NU + j in v[j], before and
// after (so lane lq ends with ranks lq * NU .. lq * NU + NU - 1). Partners
// closer than NU lie in the lane (register indices), farther ones in lane
// lq ^ (distance / NU) of the quad (a shuffle per element).
template <int NU>
__device__ __forceinline__ void quad_sort_desc(int (&v)[NGRP], int lq) {
  constexpr int N = 4 * NU;
#pragma unroll
  for (int k = 2; k <= N; k *= 2) {
#pragma unroll
    for (int jj = k / 2; jj > 0; jj /= 2) {
      if (jj >= NU) {
        const int m = jj / NU;
        const bool lower = (lq & m) == 0;
#pragma unroll
        for (int j = 0; j < NU; ++j) {
          const bool desc = ((lq * NU + j) & k) == 0;  // this run descends
          const int p = __shfl_xor_sync(0xffffffffu, v[j], m);
          v[j] = lower == desc ? max(v[j], p) : min(v[j], p);
        }
      } else {
#pragma unroll
        for (int i = 0; i < NU; ++i) {
          const int l = i ^ jj;
          if (l > i) {
            const bool desc = ((lq * NU + i) & k) == 0;
            const int a = v[i], b = v[l];
            v[i] = desc ? max(a, b) : min(a, b);
            v[l] = desc ? min(a, b) : max(a, b);
          }
        }
      }
    }
  }
}

// pack32 phase end, k_pair > PASS_K: extract_slice's result by sorting the
// quad's maxima of each row (quad_sort_desc: ~1,500 instructions a row at
// NU = 32 against ~100 per pass) and writing its first k_pair; where the
// slice holds fewer groups than k_pair, one INT_MIN ends the list (the
// merge never passes it).
template <int NU>
__device__ __forceinline__ void sort_slice(int (&mx)[2][NGRP], int* keys_s,
                                           int lane, int k_pair, int kls) {
  const int lq = lane % 4;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    quad_sort_desc<NU>(mx[rr], lq);
    int* row = keys_s + frag_c_row(lane, 2 * rr) * kls;
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      if (lq * NU + j < k_pair) row[lq * NU + j] = mx[rr][j];
      mx[rr][j] = INT_MIN;
    }
    if (4 * NU < k_pair && lq == 0) row[4 * NU] = INT_MIN;
  }
}

// The k-th entry of a list sorted descending: the least of its first k,
// taken with register indices (an equality pick vals[k - 1] is compiled
// into a load from a copy of the list in local memory).
template <int KMAX>
__device__ __forceinline__ float kth_of(const float (&vals)[KMAX], int k) {
  float m = -neg_inf();
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k) m = fminf(m, vals[j]);
  }
  return m;
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

// `a` when C, else `b` (a reference bound at compile time, so the
// accumulators stay in registers).
template <bool C, typename A>
__device__ __forceinline__ A& pick(A& a, A& b) {
  if constexpr (C) {
    return a;
  } else {
    return b;
  }
}

// The sorted pack32 scan of the blocks b = blockIdx.x + i * gridDim.x
// (see the notes above; k_pair <= MAX_PACK_K, phase ends by sort_slice).
// smem: the body's shared memory (body_smem_bytes), 16-byte aligned.
// qtable: the query rows [nq][rb] bytes.
template <typename Source>
__device__ __forceinline__ void scan_blocks(
    Source& src, unsigned char* smem, const unsigned char* __restrict__ qtable,
    const int* __restrict__ probers, const int* __restrict__ start_c,
    const int* __restrict__ off, const int* __restrict__ capb,
    int* __restrict__ out, int n_blocks, int p_tile, int rb, int s_eff,
    int k_pair, float factor, int slot_mask, int n_groups) {
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  const int ld = row_ld(rb);              // tile row stride, bytes
  const int ksteps = round32(rb) / 32;    // the rows' k steps
  const int kls = list_ld(k_pair, true);  // the lists' row stride
  constexpr bool ONE = Source::ONE_TILE;  // one tile, landed after a barrier

  unsigned char* tiles = smem;  // [2][TN][ld] (ONE: [1][TN][ld])
  float* pen_s = reinterpret_cast<float*>(
      tiles + (ONE ? 1 : 2) * TN * ld);  // [2][TN]
  int* slot_s = reinterpret_cast<int*>(pen_s + 2 * TN);  // [2][TN]
  int* prow_s = slot_s + 2 * TN;                         // [MAX_PT]
  int* live_s = prow_s + MAX_PT;                          // [MAX_PT / 16]
  int* keys_s = live_s + MAX_PT / 16;  // slice lists [WARPS][16][kls]
  int* run_s = keys_s + WARPS * 16 * kls;  // running [2][MAX_PT][kls]

  // the K padding of the tiles (16 bytes or none), zero once (the sources
  // write [0, rb))
  if (round32(rb) > rb) {
    for (int i = t; i < (ONE ? 1 : 2) * TN; i += THREADS) {
      *reinterpret_cast<uint4*>(tiles + i * ld + rb) = make_uint4(0, 0, 0, 0);
    }
  }

  // Tile order: ts(i) = (i % tpp) * stride + (i / tpp) * TN. Deep pack32
  // groups (G > TN) take the tiles phase by phase: phase f holds the
  // columns == f * TN (mod G), and a phase ends every tpp tiles.
  const bool phased = n_groups > TN;
  const int n_tiles = (s_eff + TN - 1) / TN;
  const int tpp = phased ? s_eff / n_groups : n_tiles;
  const int stride = phased ? n_groups : TN;

  // The first block's first stage and this thread's prober; a block's last
  // stage brings the next block's (its tile 0 into the other buffer), so
  // a block waits on global memory only for its window's
  // bounds and its A fragments. Stage buffer: gt & 1, gt counting the
  // stages of the CTA's blocks.
  int pr = -1, gt = 0;
  __syncthreads();  // what the kernel staged before the body (a codebook)
  if ((int)blockIdx.x < n_blocks) {
    const int b = blockIdx.x;
    pr = t < p_tile ? probers[(size_t)b * p_tile + t] : -1;
    src.fetch(start_c[b], off[b], off[b] + capb[b], 0, min(TN, s_eff),
              tiles);
    src.land(0, min(TN, s_eff), tiles, pen_s, slot_s);
  }

  for (int b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    __syncthreads();  // the previous block is done with the shared arrays
                      // and this block's first stage has landed
    const int nb = b + gridDim.x;  // the CTA's next block
    const int s0 = start_c[b];
    const int o0 = off[b];
    const int o1 = o0 + capb[b];
    int npr = -1;  // this thread's prober of the next block
    if (t < MAX_PT) prow_s[t] = pr;
    if (t < p_tile && pr < 0) {  // pad rows: dead, never scored
      int* o = out + ((size_t)b * p_tile + t) * k_pair;
      for (int i = 0; i < k_pair; ++i) o[i] = INT_MIN;
    }
    const unsigned live = __ballot_sync(0xffffffffu, pr >= 0);
    if (lane == 0 && warp < MAX_PT / 32) {
      live_s[2 * warp] = (live & 0xFFFFu) != 0u;
      live_s[2 * warp + 1] = (live >> 16) != 0u;
    }
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

    // A: the m tile's query rows, zero for -1 rows and past d. A lane
    // reads two rows (frag_a_row: g and g + 8) and keeps all their
    // fragments in registers, loaded together from the rows of query
    // max(q, 0).
    const int q0 = busy ? prow_s[16 * mt + frag_a_row(lane, 0)] : -1;
    const int q1 = busy ? prow_s[16 * mt + frag_a_row(lane, 1)] : -1;
    uint32_t a[KSTEPS][4];
    const unsigned int* r0 = reinterpret_cast<const unsigned int*>(
        qtable + (size_t)max(q0, 0) * rb);
    const unsigned int* r1 = reinterpret_cast<const unsigned int*>(
        qtable + (size_t)max(q1, 0) * rb);
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int byte = 32 * ks + 2 * frag_a_col(lane, i);
        uint32_t v = 0u;
        if (busy && ks < ksteps && byte < rb) {
          v = __ldg((i % 2 ? r1 : r0) + byte / 4);
        }
        a[ks][i] = (i % 2 ? q1 : q0) >= 0 ? v : 0u;
      }
    }

    // the pack32 group maxima of the phase
    int mx[2][NGRP];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
      for (int j = 0; j < NGRP; ++j) mx[rr][j] = INT_MIN;
    }
    int phase = 0;

    for (int it = 0; it < n_tiles; ++it, ++gt) {
      const int ts = (it % tpp) * stride + (it / tpp) * TN;
      const int nrow = min(TN, s_eff - ts);
      const int buf = gt & 1;
      // the next stage: this block's next tile, or the next block's first
      const bool more = it + 1 < n_tiles;
      const int tn =
          more ? ((it + 1) % tpp) * stride + ((it + 1) / tpp) * TN : 0;
      const bool ahead = more || nb < n_blocks;
      if (more) {
        src.fetch(s0, o0, o1, tn, min(TN, s_eff - tn),
                  tiles + (ONE ? 0 : (buf ^ 1) * TN * ld));
      } else if (ahead) {
        npr = t < p_tile ? probers[(size_t)nb * p_tile + t] : -1;
        src.fetch(start_c[nb], off[nb], off[nb] + capb[nb], 0,
                  min(TN, s_eff), tiles + (ONE ? 0 : (buf ^ 1) * TN * ld));
      }
      if (busy) {
        const unsigned char* tile = tiles + (ONE ? 0 : buf * TN * ld);
        const float* pen = pen_s + buf * TN;
        const int* slt = slot_s + buf * TN;
#pragma unroll
        for (int gq = 0; gq < 2; ++gq) {  // up to 4 pairs (64 columns)
          const int p0 = slice * np_s + 4 * gq;  // first pair of the group
          if (4 * gq < np_s && 16 * p0 < nrow) {
            float sum[8][4];  // the group's sums
#pragma unroll
            for (int ks = 0; ks < KSTEPS; ++ks) {
              if (ks < ksteps) {
                const uint32_t(&ak)[4] = a[ks];
                const bool fresh = ks == 0;
#pragma unroll
                for (int np = 0; np < 4; ++np) {
                  const int c0 = 16 * (p0 + np);
                  if (4 * gq + np < np_s && c0 < nrow) {
                    uint32_t bf[4];
                    ldmatrix_x4(bf, tile + (c0 + ldm_b_row(lane)) * ld +
                                        32 * ks + 2 * ldm_b_col(lane));
                    if (fresh) {
                      mma_bf16_16816_zero(sum[2 * np], ak, bf[0], bf[1]);
                      mma_bf16_16816_zero(sum[2 * np + 1], ak, bf[2], bf[3]);
                    } else {
                      mma_bf16_16816(sum[2 * np], ak, bf[0], bf[1]);
                      mma_bf16_16816(sum[2 * np + 1], ak, bf[2], bf[3]);
                    }
                  }
                }
              }
            }
            // the scores of this lane's columns, in ascending order
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
              const int base = 16 * p0 + 8 * nt;  // the n8 tile's
              const int cl = base + frag_c_col(lane, 0);
              if (4 * gq + nt / 2 < np_s && base < nrow) {
                const float2 p = *reinterpret_cast<const float2*>(pen + cl);
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                  if (cl + i < nrow) {
#pragma unroll
                    for (int rr = 0; rr < 2; ++rr) {
                      const float sc =
                          score(sum[nt][2 * rr + i], factor, i ? p.y : p.x);
                      const int key =
                          (sortable(sc) & ~slot_mask) | slt[cl + i];
                      int& best = mx[rr][2 * (8 * gq + nt) + i];
                      best = max(best, key);
                    }
                  }
                }
              }
            }
          }
        }
      }
      if ((it + 1) % tpp == 0) {
        // phase end: each slice's k_pair largest keys per row, sorted by
        // the quad's shuffles, into its shared list
        if (busy) {
          int* ks_w = keys_s + warp * 16 * kls;
          switch (S) {  // a lane holds the first 32 / S maxima of a row
            case 8:
              sort_slice<NGRP / 8>(mx, ks_w, lane, k_pair, kls);
              break;
            case 4:
              sort_slice<NGRP / 4>(mx, ks_w, lane, k_pair, kls);
              break;
            case 2:
              sort_slice<NGRP / 2>(mx, ks_w, lane, k_pair, kls);
              break;
            default:
              sort_slice<NGRP>(mx, ks_w, lane, k_pair, kls);
          }
        }
        __syncthreads();
        // one thread per live row: the k_pair largest of its slices'
        // lists (each of k_pair keys, or ended by an INT_MIN) and the
        // running list of the earlier phases
        if (t < 16 * nm) {
          const int* cur = run_s + ((phase & 1) * MAX_PT + t) * kls;
          int* nxt = run_s + (((phase + 1) & 1) * MAX_PT + t) * kls;
          const int* sl = keys_s + ((t / 16) * S * 16 + t % 16) * kls;
          int h[WARPS];  // the slices' heads (unrolled: registers)
          int hc = 0;    // the running list's head
#pragma unroll
          for (int s = 0; s < WARPS; ++s) h[s] = 0;
          for (int i = 0; i < k_pair; ++i) {
            int best = phase > 0 ? cur[hc] : INT_MIN;
            int bs = WARPS;
#pragma unroll
            for (int s = 0; s < WARPS; ++s) {
              if (s < S) {
                const int v =
                    h[s] < k_pair ? sl[s * 16 * kls + h[s]] : INT_MIN;
                if (v > best) {
                  best = v;
                  bs = s;
                }
              }
            }
#pragma unroll
            for (int s = 0; s < WARPS; ++s) h[s] += s == bs;
            hc += bs == WARPS;
            nxt[i] = best;
          }
        }
        ++phase;
      }
      if (ahead) {
        if constexpr (ONE) {
          // the warps are done with the tile (a phase end's barrier has
          // seen to it already)
          if ((it + 1) % tpp != 0) __syncthreads();
        }
        src.land(tn, min(TN, s_eff - tn),
                 tiles + (ONE ? 0 : (buf ^ 1) * TN * ld),
                 pen_s + (buf ^ 1) * TN, slot_s + (buf ^ 1) * TN);
      }
      __syncthreads();
    }

    // the live rows' outputs: warp w writes rows w and w + 8 of each live
    // tile, its lanes on consecutive keys (coalesced stores)
    int lt2 = 0;  // the live tile's index among the live ones
    for (int m2 = 0; m2 < MAX_PT / 16; ++m2) {
      if (!live_s[m2]) continue;
#pragma unroll
      for (int h = 0; h < 16 / WARPS; ++h) {
        const int rw = warp + WARPS * h;  // the row in the tile
        if (prow_s[16 * m2 + rw] >= 0) {
          const int* fin =
              run_s + ((phase & 1) * MAX_PT + 16 * lt2 + rw) * kls;
          int* o = out + ((size_t)b * p_tile + 16 * m2 + rw) * k_pair;
          for (int i = lane; i < k_pair; i += 32) o[i] = fin[i];
        }
      }
      ++lt2;
    }
    pr = npr;
  }
}

// CTAs of `kern` one SM holds at once with `smem` bytes of dynamic shared
// memory (registers and shared memory permitting), or minus the CUDA error
// code.
template <typename Kernel>
int occupancy(Kernel kern, size_t smem) {
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

}  // namespace tc
}  // namespace tpq
