// The select helpers of block_scan_wg.cu's consumers (bf16, int8 and codes
// rows): the pack32 maxima's phase-end extraction pass by pass up to k_pair
// 16 (deeper pack32 selects are deep_select.cuh's), the exact lists, their
// queue and first fill, the score of a bf16 product sum, the lists' row
// stride and the shapes the scans take. They index the consumers' shared
// arrays in the layout of the m16n8 accumulators (tc_ptx.cuh: frag_c_row /
// frag_c_col), which the m64nN wgmma accumulators share warp by warp.
//
// pack32: lane (g, t) of a warp holds rows g and g + 8 of its 16 probers
// and, of every 8 columns of its slice, columns 2t and 2t + 1, so each
// (row, group) has one owner and no atomics are needed: at most 32 group
// maxima per row of a 128-column phase (32 / S in a slice of 128 / S
// columns). With G = 256 or 512 the tiles are visited phase by phase
// (columns == phase * 128 mod G), so a lane never holds more than 32 groups
// per row.
//
// The exact select's helpers: a warp writes the scores of its 64 columns to
// its staging rows [16][SLD], and lane l takes row l / 2 over its half of
// them, in ascending order, into a sorted list of k_pair (rounded up to 10
// or 16) entries (scan_common.cuh:insert keeps column order on ties).
// Inserting score by score costs the whole warp an insert whenever any lane
// has one, so a score enters only at or above a bound on the row's k_pair-th
// value (the largest k_pair-th entry of the row's lists, shared across its
// slices through shared memory), waits in a short per-lane queue
// (ExactQueue), and the queues are inserted together; a lane's first 16
// columns of a block are sorted at once (first_fill). The queue lives in
// shared memory and the lists in registers: no per-thread array may be
// indexed by a value the compiler cannot unroll, or it lands in local
// memory, which has little L1 beside these kernels' shared memory (see
// kth_of).

#pragma once

#include <cstdint>

#include "scan_common.cuh"
#include "tc_ptx.cuh"

namespace tpq {
namespace tc {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int TN = 128;                // window columns per tile
constexpr int MAX_PT = 16 * WARPS;     // probers per block: up to 8 m tiles
constexpr int MAX_EXACT_K = 16;        // exact k_pair the lane lists take
constexpr int MAX_PACK_K = 64;         // pack32 k_pair
constexpr int NGRP = TN / 4;           // pack32 group maxima per lane and row
constexpr int PASS_K = 16;             // pack32 k_pair extracted pass by pass
                                       // (deeper: deep_select.cuh)
constexpr int SLD = 72;                // exact staging row stride, floats
constexpr int QUEUE = 6;               // exact: a lane's queued candidates

// The score of a bf16 product sum x.
__device__ __forceinline__ float score(float x, float factor, float pen) {
  return factor * x - pen;
}

// Row stride (entries) of the slice and running lists: pack32 rows of an
// odd stride, so that the merge's thread-per-row reads and writes fall on
// distinct banks (at k_pair 64 a stride of 64 put a warp's 32 rows on one).
__host__ __device__ inline int list_ld(int k_pair, int pack32) {
  return pack32 ? (k_pair | 1) : k_pair;
}

// The shapes the scans take (the row sources' own terms apart): rows of rb
// bytes, rb % 16 == 0 and rb <= max_rb; blocks of whole 16-prober tiles, at
// most 8; exact k_pair <= 16; pack32 k_pair <= 64 with G % 8 == 0, either G
// == s_eff <= TN, or G a multiple of TN that divides s_eff. The entry
// points also refuse a shared memory above the limit (wg_layout.cuh:
// SMEM_LIMIT).
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
// shuffles per row, so deeper selects stage and merge instead
// (deep_select.cuh).
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

}  // namespace tc
}  // namespace tpq
