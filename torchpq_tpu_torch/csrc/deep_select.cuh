// The deep pack32 select of the warp-specialised block scan (block_scan_wg.cu's
// bf16 and int8 instances of pack32 k_pair 17-64 and its codes instance of
// 33-64, template argument KMAX = MAX_K): the phase end that merges a
// phase's strided-group maxima into each row's running list of its k_pair
// largest keys, and the arithmetic of its shared arrays. Plain C++ over a warp's lanes, callable from host and device
// code: a lane's exchanges with the others go through a policy object W (the
// kernel's: warp shuffles, __syncwarp and a named barrier of two warps;
// tests/test_torch_deep_select.py's: the lanes run as coroutines on the host),
// so that g++ runs the very code the kernel compiles.
//
// What it computes is the reference's (torchpq_tpu/ops/pallas_scan.py:103
// _select_topk over the strided group maxima): the k_pair largest pack32 keys
// of a row, descending, INT_MIN where the row has fewer groups with a key.
// A key carries its slot in its low bits, so the keys of a row are unique and
// its k_pair largest are one set in one order, whatever the merge order.
//
// The deep groups (G = 128, 256 or 512) come phase by phase: a phase covers
// 128 of them, each lane holding NU = 32 / S maxima of each of its two rows
// (S = 1: one warp holds a row's 128; S = 2: two warps, one in each consumer
// warpgroup, hold 64 each). At the phase end, in two rounds (each lane's
// first row, then its second):
// - Pruning. After a row's first phase its running list's k_pair-th key is a
//   bound: a group maximum at or below it can never enter. Each lane reads
//   the bound of its row from the list itself (shared memory) and drops its
//   maxima at or below it before anything else is done with them.
// - Staging. The survivors of a row go to a staging row in shared memory
//   (stage_row: a quad's prefix sum gives each lane its first slot), room
//   for all of a phase's 128; the lanes clear their maxima.
// - Merging. One warp merges a row at a time, MERGE_ROWS rows at once for
//   independent shuffle chains (merge_at): the row's candidates, one, two
//   or four a lane as the count needs, sorted ascending by a bitonic
//   network across the warp (sort_asc); the larger of each pair of the
//   list's i-th key and the candidates' (K2 - 1 - i)-th largest (K2 = 32 or
//   64, the list rounded up to a power of two with INT_MIN) makes a bitonic
//   sequence that holds the K2 largest of both, which a bitonic merge sorts
//   descending; its first k_pair are the new list. Each lane writes back
//   only the entries of the list it read, so the one list per row is merged
//   in place without a hazard. S = 1: a warp merges its 8 rows of a round;
//   S = 2: each warp of the pair 4 of them.
// The staging holds a warp's 8 rows of a round ([8][129] a warp, 33,024 B
// for the CTA, about what one of the two running lists it replaces took),
// so no survivor waits in registers for a later round: the maxima of a
// staged row are dead through the merges, and the consumers stay within
// their 232 registers (the codes instance's 224 too). A first design staged 64 a row and kept the
// survivors past them in registers for another round (the first phase's
// 128 always took two): ptxas spilled 16-32 B in every deep instance
// (chip_variants.py --ptxas-only; more at 240 registers, as many with the
// merge one row at a time or the stores volatile), though it ran 2-8%
// faster on the narrow rows (chip_variants.py --deep, NVIDIA H100 80GB
// HBM3, 700.00 W).
//
// Cost at k_pair 64, S = 1 (a lane's 32 maxima of each of two rows): the pass
// by pass extraction it replaces (scan_tc.cuh:extract_slice) ran 64 passes
// of ~100 instructions a row in every phase whatever the data (~12,800 a lane
// and phase); here the staging is a few instructions a maximum (~300 a
// lane), and a row's merge 21-34 dependent stages of one to four shuffles a
// lane: a first phase's 128 candidates about a third of the passes, a late
// phase's ~20 survivors a tenth. A sort of the quad's 32 maxima in
// registers (scan_tc.cuh:sort_slice) costs fewer instructions but spilled
// 40-352 B at the consumers' 232 registers, where this select holds at most
// 8 candidates a lane beside the other row's maxima.

#pragma once

#include <climits>
#include <cstddef>

#ifndef TPQ_HD
#ifdef __CUDACC__
#define TPQ_HD __host__ __device__
#define TPQ_UNROLL _Pragma("unroll")
#define TPQ_NO_UNROLL _Pragma("unroll 1")
#else
#define TPQ_HD
#define TPQ_UNROLL
#define TPQ_NO_UNROLL
#endif
#endif
// the select's functions inlined into the kernel: a call would pass the
// lanes' maxima by reference, through local memory
#ifdef __CUDACC__
#define TPQ_INLINE __forceinline__
#else
#define TPQ_INLINE inline
#endif

namespace tpq {
namespace ds {

constexpr int SHALLOW_K = 16;  // deepest k_pair of the pass by pass select
constexpr int MAX_K = 64;      // deepest k_pair of this one
constexpr int ROWS = 128;      // rows (probers) of a block
constexpr int WARPS = 8;       // consumer warps
constexpr int SLOTS = 8;       // a warp's staging rows: one a quad
constexpr int SEG = 64;        // a warp's share of a staging row where two
                               // warps stage it (S = 2)
constexpr int SST = 2 * SEG + 1;  // a staging row's stride (ints): a
                                  // phase's 128 groups, made odd
constexpr int MERGE_ROWS = 2;  // rows a warp merges at once

// The running lists' row stride: k_pair made odd, so that the quads'
// reads of their rows' bounds fall on distinct banks.
TPQ_HD constexpr int list_ld(int k_pair) { return k_pair | 1; }

// The select's shared arrays (ints, after the prober rows and tile flags):
// the warps' staging rows [WARPS][SLOTS][SST], the running lists
// [ROWS][list_ld] and the staged counts [ROWS][2] (a row's two segments
// where two warps stage it).
TPQ_HD constexpr int run_offset() { return WARPS * SLOTS * SST; }
TPQ_HD constexpr int count_offset(int k_pair) {
  return run_offset() + ROWS * list_ld(k_pair);
}
TPQ_HD constexpr size_t select_bytes(int k_pair) {
  return (size_t)4 * (count_offset(k_pair) + 2 * ROWS);
}

TPQ_HD inline int imin(int a, int b) { return a < b ? a : b; }
TPQ_HD inline int imax(int a, int b) { return a > b ? a : b; }

// Stage one row's survivors from a quad (lanes 4q .. 4q + 3, each holding NU
// of the row's group maxima in v): the maxima above `bound` go to dst[0 ..
// 4 NU), the quad's lanes in order (a lane's first slot after its lower
// lanes' survivors), and every maximum is cleared to INT_MIN. Returns the
// row's survivors on every lane of the quad.
template <int NU, int N, class W>
TPQ_HD TPQ_INLINE int stage_row(W w, int (&v)[N], int bound, int* dst) {
  static_assert(NU <= N, "a lane's maxima");
  const int lq = w.lane() % 4;
  int c = 0;
  TPQ_UNROLL
  for (int j = 0; j < NU; ++j) c += v[j] > bound;
  int inc = c;  // the quad's inclusive prefix
  int x = w.up4(inc, 1);
  if (lq >= 1) inc += x;
  x = w.up4(inc, 2);
  if (lq >= 2) inc += x;
  int o = inc - c;
  TPQ_UNROLL
  for (int j = 0; j < NU; ++j) {
    if (v[j] > bound) dst[o++] = v[j];
    v[j] = INT_MIN;
  }
  return w.idx4(inc, 3);
}

// A lane's value against its partner's at lane distance j < 32: the smaller
// where keep_min, else the larger.
template <class W>
TPQ_HD TPQ_INLINE int exchange(W w, int v, int j, bool keep_min) {
  const int x = w.xor_(v, j);
  return keep_min ? imin(v, x) : imax(v, x);
}

// Bitonic sort, ascending, of each of RN rows' 32 E elements across the warp
// (E = 1, 2 or 4): element e = 32 u + lane in c[r][u] (u < E); partners 32
// or 64 apart lie in the lane.
template <int E, int RN, class W>
TPQ_HD TPQ_INLINE void sort_asc(W w, int (&c)[RN][4]) {
  const int l = w.lane();
  TPQ_UNROLL
  for (int k = 2; k <= 32 * E; k *= 2) {
    TPQ_UNROLL
    for (int j = k / 2; j > 0; j /= 2) {
      TPQ_UNROLL
      for (int u = 0; u < E; ++u) {
        // the lower of the pair keeps the smaller in an ascending run
        const bool asc = ((32 * u + l) & k) == 0;
        if (j >= 32) {
          const int v = u | (j / 32);
          if (v != u) {
            TPQ_UNROLL
            for (int r = 0; r < RN; ++r) {
              const int a = c[r][u], b = c[r][v];
              c[r][u] = asc ? imin(a, b) : imax(a, b);
              c[r][v] = asc ? imax(a, b) : imin(a, b);
            }
          }
        } else {
          const bool keep_min = ((l & j) == 0) == asc;
          TPQ_UNROLL
          for (int r = 0; r < RN; ++r) {
            c[r][u] = exchange(w, c[r][u], j, keep_min);
          }
        }
      }
    }
  }
}

// Into each of RN rows' running lists run[r][0 .. k_pair) (descending; empty
// where fresh) its candidates c[r] (sorted ascending, E a lane): the k_pair
// largest of both, descending. The list's entry i (INT_MIN past k_pair) and
// the candidates' (K2 - 1 - i)-th largest, the larger of the two, for i <
// K2 (the first power of two, 32 or 64, at or above k_pair): a bitonic
// sequence holding the K2 largest of both, sorted by a bitonic merge.
template <int E, int RN, class W>
TPQ_HD TPQ_INLINE void merge_rows(W w, int* const (&run)[RN],
                                  const int (&c)[RN][4], int k_pair,
                                  bool fresh) {
  const int l = w.lane();
  const bool wide = k_pair > 32;  // K2 = 64: two entries a lane
  int m[RN][2];
  TPQ_UNROLL
  for (int r = 0; r < RN; ++r) {
    const int r0 = !fresh && l < k_pair ? run[r][l] : INT_MIN;
    const int r1 = !fresh && 32 + l < k_pair ? run[r][32 + l] : INT_MIN;
    // the candidates ascending: their K2 largest in reverse are the last
    // K2 (E = 1, K2 = 64: 32 INT_MIN, then the 32)
    if (wide) {
      m[r][0] = E >= 2 ? imax(r0, c[r][E >= 2 ? E - 2 : 0]) : r0;
      m[r][1] = imax(r1, c[r][E - 1]);
    } else {
      m[r][0] = imax(r0, c[r][E - 1]);
      m[r][1] = INT_MIN;
    }
  }
  if (wide) {  // distance 32: the lane's two entries, the larger first
    TPQ_UNROLL
    for (int r = 0; r < RN; ++r) {
      const int a = m[r][0], b = m[r][1];
      m[r][0] = imax(a, b);
      m[r][1] = imin(a, b);
    }
  }
  TPQ_UNROLL
  for (int j = 16; j > 0; j /= 2) {
    const bool keep_min = (l & j) != 0;  // descending: the upper the smaller
    TPQ_UNROLL
    for (int u = 0; u < 2; ++u) {
      if (u == 0 || wide) {
        TPQ_UNROLL
        for (int r = 0; r < RN; ++r) {
          m[r][u] = exchange(w, m[r][u], j, keep_min);
        }
      }
    }
  }
  TPQ_UNROLL
  for (int r = 0; r < RN; ++r) {
    if (l < k_pair) run[r][l] = m[r][0];
    if (32 + l < k_pair) run[r][32 + l] = m[r][1];
  }
}

// The candidates of MERGE_ROWS rows, E a lane (element e = 32 u + lane of
// row i: its staging row's entry e, past the first segment's n0[i] the
// second's at SEG; INT_MIN past n[i]), sorted and merged into their lists.
template <int E, class W>
TPQ_HD TPQ_INLINE void merge_staged(W w, int* const (&rows)[MERGE_ROWS],
                                    const int* src, const int (&n0)[MERGE_ROWS],
                                    const int (&n)[MERGE_ROWS], int k_pair,
                                    bool fresh) {
  const int l = w.lane();
  int c[MERGE_ROWS][4];
  TPQ_UNROLL
  for (int i = 0; i < MERGE_ROWS; ++i) {
    TPQ_UNROLL
    for (int u = 0; u < 4; ++u) {
      const int e = 32 * u + l;
      c[i][u] = u < E && e < n[i]
                    ? src[i * SST + (e < n0[i] ? e : SEG + e - n0[i])]
                    : INT_MIN;
    }
  }
  sort_asc<E>(w, c);
  merge_rows<E>(w, rows, c, k_pair, fresh);
}

// Merge block rows p .. p + MERGE_ROWS - 1, staged in src (a row a staging
// row: one segment, or two at 0 and SEG where split), into their running
// lists: the candidates one, two or four a lane, as the rows' largest
// count needs. A dead row (prober -1) takes no candidate; the rows are
// skipped where none is live with a candidate (or fresh: its list is
// written even empty).
template <class W>
TPQ_HD TPQ_INLINE void merge_at(W w, const int* prow, int p, const int* src,
                                int* run, const int* cnt, bool split,
                                int k_pair, bool fresh) {
  const int kls = list_ld(k_pair);
  int* rows[MERGE_ROWS];
  int n0[MERGE_ROWS], n[MERGE_ROWS];
  bool work = false;
  int most = 0;
  TPQ_UNROLL
  for (int i = 0; i < MERGE_ROWS; ++i) {
    const int q = p + i;
    rows[i] = run + q * kls;
    const bool live = prow[q] >= 0;
    n0[i] = live ? cnt[2 * q] : 0;
    n[i] = n0[i] + (live && split ? cnt[2 * q + 1] : 0);
    work = work || (live && (fresh || n[i] > 0));
    most = imax(most, n[i]);
  }
  if (!work) return;
  if (most > 2 * 32) {
    merge_staged<4>(w, rows, src, n0, n, k_pair, fresh);
  } else if (most > 32) {
    merge_staged<2>(w, rows, src, n0, n, k_pair, fresh);
  } else {
    merge_staged<1>(w, rows, src, n0, n, k_pair, fresh);
  }
}

// One consumer warp's part of a phase end. Lane l holds the group maxima of
// block rows p0 + l / 4 (mx[0]) and p0 + l / 4 + 8 (mx[1]), NU a lane. In
// two rounds (mx[0]'s rows, then mx[1]'s) each quad stages its row's
// survivors of the lists' bounds into staging row l / 4 of the warp's
// `region`, and the warp merges the round's rows. split (S = 2): the warp
// and its partner (the other consumer warpgroup's warp of the same rows)
// hold half of the rows' groups each, stage into segment `seg` of the
// partner pair's region, synchronise by w.pair_sync(), and merge half of
// the round's rows each (the first four or the last). prow: the block's
// prober rows (-1: dead); arrays: the select's shared arrays
// (select_bytes); first: the block's first phase, its lists still empty.
// The maxima are INT_MIN on return.
template <int NU, int N, class W>
TPQ_HD TPQ_INLINE void phase_end(W w, int (&mx)[2][N], const int* prow,
                                 int p0, bool split, int seg, int region,
                                 int* arrays, int k_pair, bool first) {
  const int l = w.lane();
  const int kls = list_ld(k_pair);
  int* stg = arrays + region * SLOTS * SST;
  int* run = arrays + run_offset();
  int* cnt = arrays + count_offset(k_pair);
  const int lo = split ? SLOTS / 2 * seg : 0;  // the rows this warp merges
  const int hi = split ? lo + SLOTS / 2 : SLOTS;
  TPQ_UNROLL
  for (int rr = 0; rr < 2; ++rr) {
    // the lists' last merges (their bounds) and the staging rows' last
    // reads are done
    if (split) {
      w.pair_sync();
    } else {
      w.sync();
    }
    const int p = p0 + l / 4 + 8 * rr;
    const int bound = prow[p] < 0 ? INT_MAX
                      : first     ? INT_MIN
                                  : run[p * kls + k_pair - 1];
    const int n =
        stage_row<NU>(w, mx[rr], bound, stg + l / 4 * SST + seg * SEG);
    if (l % 4 == 0) cnt[2 * p + seg] = n;
    if (split) {
      w.pair_sync();
    } else {
      w.sync();
    }
    TPQ_NO_UNROLL
    for (int r = lo; r < hi; r += MERGE_ROWS) {
      merge_at(w, prow, p0 + 8 * rr + r, stg + r * SST, run, cnt, split,
               k_pair, first);
    }
  }
}

}  // namespace ds
}  // namespace tpq
