// The fused flat scan's select (flat_scan_wg.cu, d <= 128; flat_scan_tc.cu,
// 128 < d <= 1024, takes its top 2 and quad merge) and the
// warp-specialised kernel's shared-memory arithmetic. Plain
// C++ over a quad's lanes, callable from host and device code: a lane's
// exchanges with the others go through a policy object W (the kernels':
// CudaWarp below, warp shuffles, ballots and votes;
// tests/test_torch_flat_select.py's: the lanes run as coroutines on the
// host), so that g++ runs the very code the kernels compile.
//
// What it computes is torchpq_tpu/ops/pallas_flat.py:flat_scan_pallas's
// select (`:88-107`): each bucket of 64 slots offers its top 2 (the first
// maximal slot, then the first maximum of the rest), and each query keeps
// the top r_keep of those candidates by value descending, then address
// ascending.
//
// Layout: a lane holds, of a bucket, 16 columns of each of two rows (the
// m16n8 accumulator fragment's, which wgmma's and mma.sync's share: value u
// is column lane_col(u, lane % 4), ascending in u), and the quad (lanes 4q
// .. 4q + 3) holds the two rows' 64 columns. Each row's running list,
// r_keep <= 32 values and addresses in memory (shared memory in
// flat_scan_wg.cu), sorted by value descending, then visit order, has an
// owner among the quad's lanes, which offers the row's pairs; the warp
// inserts them together, a row at a time (insert_pairs: entry i on lane
// i), so an insert costs one round of loads, ballots and shuffles however
// far it moves the entries, where a lane shifting its own list entry by
// entry waited for a load at every step.
//
// The thinned epilogue (tile_votes, then tile_offers): per score one
// subtraction (the caller's) and one max into the row's bucket maximum, the
// two buckets' two row halves as four independent chains; a quad's maximum
// by two exchanges. A row's bound is its list's r_keep-th value (-inf until
// the list is full), and a bucket whose maximum is not strictly above its
// row's bound offers nothing: an equal value ranks after every listed
// entry, since a run visits its buckets in address order, and a later
// insert only raises the bound. Only a bucket that beats its bound (in any
// of the warp's 16 rows: the exchanges are the warp's) goes through the top
// 2 (a tree over the lane's columns; a row half with no passing row skips
// it), the quad merge and the inserts, recomputed from the scores still in
// registers. After the list fills, about r_keep ln(buckets / r_keep) of a
// run's buckets pass a row on random data. Dead candidates (about -BIG)
// still enter an unfilled list, as in the TPU kernel. A run that starts
// with an empty list pays that fill again, so the runs of a query share a
// bound too (key_of, floor_of): each run's full list publishes its
// r_keep-th value, and every run's candidates below the largest published
// one are dropped, those equal to it kept (their run may lie earlier). The
// result is exact: the merged runs' top r_keep are those of every bucket's
// top 2 offered in turn; a run's own list may lack entries that rank below
// another run's r_keep.

#pragma once

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstring>

#include "wg_layout.cuh"  // TPQ_HD, TPQ_INLINE and the swizzled stages

namespace tpq {
namespace fsel {

constexpr float NEG_INF = -INFINITY;
constexpr int LANE_COLS = 16;  // a lane's columns of a bucket, per row

// Column (of the bucket's 64) of a lane's value u, lane % 4 = t4: the m16n8
// fragment's column 8 (u / 2) + 2 t4 + u % 2 (tc_ptx.cuh: frag_c_col).
TPQ_HD constexpr int lane_col(int u, int t4) {
  return 8 * (u / 2) + 2 * t4 + u % 2;
}

// (x, i) comes before (y, j): value descending, then address ascending.
TPQ_HD inline bool before(float x, int i, float y, int j) {
  return x > y || (x == y && i < j);
}

// A row's top 2 over some of its columns: (m1, a1) before (m2, a2).
struct Top2 {
  float m1, m2;
  int a1, a2;
};

TPQ_HD inline Top2 top2_empty() { return Top2{NEG_INF, NEG_INF, 0, 0}; }

// Offer score s of column j, columns visited in ascending order: strict >
// keeps the first maximal column first. No branch.
TPQ_HD TPQ_INLINE void top2_push(Top2& t, float s, int j) {
  const bool p1 = s > t.m1;
  const bool p2 = s > t.m2;
  t.m2 = p1 ? t.m1 : (p2 ? s : t.m2);
  t.a2 = p1 ? t.a1 : (p2 ? j : t.a2);
  t.m1 = p1 ? s : t.m1;
  t.a1 = p1 ? j : t.a1;
}

// Merge this lane's top 2 with that of lane ^ mask, without branches; both
// lanes end with the top 2 of the union: the first of the winning pair,
// then the better of its second and the other pair's first.
template <class W>
TPQ_HD TPQ_INLINE void merge_lanes(W w, Top2& t, int mask) {
  const float o1 = w.xor_(t.m1, mask);
  const int b1 = w.xor_(t.a1, mask);
  const float o2 = w.xor_(t.m2, mask);
  const int b2 = w.xor_(t.a2, mask);
  const bool mine = before(t.m1, t.a1, o1, b1);
  const float w2 = mine ? t.m2 : o2;  // the winner's second
  const int wa2 = mine ? t.a2 : b2;
  const float l1 = mine ? o1 : t.m1;  // the loser's first
  const int la1 = mine ? b1 : t.a1;
  const bool keep = before(w2, wa2, l1, la1);
  t.m1 = mine ? t.m1 : o1;
  t.a1 = mine ? t.a1 : b1;
  t.m2 = keep ? w2 : l1;
  t.a2 = keep ? wa2 : la1;
}

// The quad's top 2 of a row on each of its lanes (lanes ^ 1, then ^ 2).
template <class W>
TPQ_HD TPQ_INLINE void quad_merge(W w, Top2& t) {
  merge_lanes(w, t, 1);
  merge_lanes(w, t, 2);
}

// The top 2 of two neighbouring column ranges, l's columns before r's: a
// tie goes left (the first maximal column first), with no address compare.
TPQ_HD TPQ_INLINE Top2 merge_ranges(const Top2& l, const Top2& r) {
  const bool lf = l.m1 >= r.m1;
  const float x = lf ? l.m2 : l.m1;  // the left candidate for second
  const int xa = lf ? l.a2 : l.a1;
  const float y = lf ? r.m1 : r.m2;  // and the right one
  const int ya = lf ? r.a1 : r.a2;
  const bool lx = x >= y;
  return Top2{lf ? l.m1 : r.m1, lx ? x : y, lf ? l.a1 : r.a1, lx ? xa : ya};
}

// The top 2 of a lane's 16 scores of a row, s[u] at column lane_col(u, t4)
// (ascending in u), as a tree of merge_ranges: depth 4 where a running
// top2_push is a chain of 16.
TPQ_HD TPQ_INLINE Top2 lane_top2(const float (&s)[LANE_COLS], int t4) {
  Top2 t[LANE_COLS / 2];
  TPQ_UNROLL
  for (int i = 0; i < LANE_COLS / 2; ++i) {
    const float x = s[2 * i];
    const float y = s[2 * i + 1];
    const int cx = lane_col(2 * i, t4);
    const bool l = x >= y;
    t[i] = Top2{l ? x : y, l ? y : x, l ? cx : cx + 1, l ? cx + 1 : cx};
  }
  TPQ_UNROLL
  for (int w = 1; w < LANE_COLS / 2; w *= 2) {
    TPQ_UNROLL
    for (int i = 0; i < LANE_COLS / 2; i += 2 * w) {
      t[i] = merge_ranges(t[i], t[i + w]);
    }
  }
  return t[0];
}

TPQ_HD inline int popc(unsigned x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}
TPQ_HD inline int lowest(unsigned x) {  // the lowest set bit's index
#ifdef __CUDA_ARCH__
  return __ffs(x) - 1;
#else
  return __builtin_ctz(x);
#endif
}

// Insert the warp's pairs into their rows' lists (values descending, visit
// order on ties; r_keep <= 32 entries a row at lst_v / lst_a + off), one
// row at a time, every lane on each: lane i holds entry i. A lane whose
// `go` is set offers its row's pair x1 = (m1, base + a1) before x2 = (m2,
// base + a2) (so m1 >= m2, and the first of equal ones), x1 known to enter
// (m1 above the list's last entry), x2 where it still ranks within r_keep
// and lies above fl. x1 goes after the p1 entries at or above it, x2 after
// the p2 at or above it and x1: entry i takes old entry i below p1, x1 at
// p1, old entry i - 1 up to p2, x2 at p2 + 1, old entry i - 2 after. The
// lists are read back (w.sync) before a lane reads its own.
template <class W>
TPQ_HD TPQ_INLINE void insert_pairs(W w, bool go, float m1, int a1,
                                    float m2, int a2, float fl, int off,
                                    float* lst_v, int* lst_a, int r_keep) {
  const int i = w.lane();
  unsigned todo = w.ballot(go);
  while (todo) {
    const int src = lowest(todo);
    todo &= todo - 1;
    const float x1 = w.idx(m1, src);
    const float x2 = w.idx(m2, src);
    const int j1 = w.idx(a1, src);
    const int j2 = w.idx(a2, src);
    const float f = w.idx(fl, src);
    const int o = w.idx(off, src);
    const bool in = i < r_keep;
    const float v = in ? lst_v[o + i] : NEG_INF;
    const int a = in ? lst_a[o + i] : -1;
    const int p1 = popc(w.ballot(in && v >= x1));
    const int p2 = popc(w.ballot(in && v >= x2));
    const bool two = x2 > f && p2 + 1 < r_keep;
    const float v1 = w.up(v, 1);
    const int u1 = w.up(a, 1);
    const float v2 = w.up(v, 2);
    const int u2 = w.up(a, 2);
    if (in && i >= p1) {
      const bool shift1 = i > p1 && (!two || i <= p2);
      lst_v[o + i] = i == p1 ? x1 : shift1 ? v1 : i == p2 + 1 ? x2 : v2;
      lst_a[o + i] = i == p1 ? j1 : shift1 ? u1 : i == p2 + 1 ? j2 : u2;
    }
  }
  w.sync();
}

// The bound a query row's runs share: each run whose list holds r_keep
// entries publishes its r_keep-th value, as an ordered key (atomicMax on
// the keys orders the floats); NO_KEY where none has yet. A candidate below
// a published value can never be among the row's top r_keep (that run holds
// r_keep at or above it); an equal one can, where its run lies earlier, so
// a row's floor is the float just below the largest published value, and a
// candidate must be strictly above it.
constexpr int NO_KEY = INT_MIN;

TPQ_HD inline int float_bits(float x) {
#ifdef __CUDA_ARCH__
  return __float_as_int(x);
#else
  int i;
  std::memcpy(&i, &x, 4);
  return i;
#endif
}
TPQ_HD inline float bits_float(int i) {
#ifdef __CUDA_ARCH__
  return __int_as_float(i);
#else
  float x;
  std::memcpy(&x, &i, 4);
  return x;
#endif
}
// The ordered key of x (scan_common.cuh's sortable) and its inverse.
TPQ_HD inline int key_of(float x) {
  const int i = float_bits(x);
  return i < 0 ? (i ^ 0x7FFFFFFF) : i;
}
TPQ_HD inline float floor_of(int key) {
  return key == NO_KEY
             ? NEG_INF
             : nextafterf(bits_float(key < 0 ? (key ^ 0x7FFFFFFF) : key),
                          NEG_INF);
}

// Phase 2 for a bucket whose vote passed: s[rr][u], the lane's scores of
// the quad's two rows (row halves rr of the warp's 16, column lane_col(u,
// lane % 4)); pass: the rows' bits (row rr beat its bound); bound[rr], the
// rows' list bounds, the same on the quad's four lanes; floors[rr], their
// floors from the shared bound (floor_of; -inf where none). The top 2 of
// each row (lane_top2, quad_merge), the warp's inserts of the passing
// rows' pairs (a candidate at or below its row's floor stays out), the
// rows' new bounds. own: the row half whose list this lane owns (quad lane
// rr), or -1; off: the owned row's list offset in lst_v / lst_a (r_keep
// entries a row); base: the bucket's first address.
template <class W>
TPQ_HD TPQ_INLINE void offer_rows(W w, const float (&s)[2][LANE_COLS],
                                  unsigned pass, float (&bound)[2],
                                  const float (&floors)[2], int own,
                                  float* lst_v, int* lst_a, int off,
                                  int r_keep, int base) {
  const int t4 = w.lane() % 4;
  Top2 t[2];
  TPQ_UNROLL
  for (int rr = 0; rr < 2; ++rr) {
    t[rr] = top2_empty();
    // a row half with no passing row offers nothing: its top 2 is skipped
    if (w.any((pass >> rr) & 1)) {
      t[rr] = lane_top2(s[rr], t4);
      quad_merge(w, t[rr]);
    }
  }
  // the owned row's pair, picked by value (a reference into t would put
  // the array in local memory)
  const int o1 = own > 0;
  const float fl = o1 ? floors[1] : floors[0];
  const float m1 = o1 ? t[1].m1 : t[0].m1;
  insert_pairs(w, own >= 0 && ((pass >> o1) & 1) && m1 > fl, m1,
               base + (o1 ? t[1].a1 : t[0].a1), o1 ? t[1].m2 : t[0].m2,
               base + (o1 ? t[1].a2 : t[0].a2), fl, off, lst_v, lst_a,
               r_keep);
  const float nb = own >= 0 ? lst_v[off + r_keep - 1] : NEG_INF;
  const int q = w.lane() & ~3;
  bound[0] = w.idx(nb, q);
  bound[1] = w.idx(nb, q + 1);
}

// A tile of 128 slots (two buckets) of a warp's 16 rows (an m64 tile's),
// in two phases: vote b for bucket b, bit 2 b + rr of a pass mask for its
// row half rr.
//
// Phase 1: the maxima of the two buckets' two row halves (four independent
// chains over score(b, rr, u): this lane's value u of row half rr of bucket
// b, at column lane_col(u, lane % 4)), the quad's maxima, their tests
// against the larger of bound and floor (into pass), and the warp's vote on
// each bucket's 16 rows (into vote).
template <class W, class S>
TPQ_HD TPQ_INLINE void tile_votes(W w, const S& score,
                                  const float (&bound)[2],
                                  const float (&floors)[2], unsigned& pass,
                                  unsigned& vote) {
  float m[2][2];
  TPQ_UNROLL
  for (int b = 0; b < 2; ++b) {
    TPQ_UNROLL
    for (int rr = 0; rr < 2; ++rr) m[b][rr] = score(b, rr, 0);
  }
  TPQ_UNROLL
  for (int u = 1; u < LANE_COLS; ++u) {
    TPQ_UNROLL
    for (int b = 0; b < 2; ++b) {
      TPQ_UNROLL
      for (int rr = 0; rr < 2; ++rr) {
        m[b][rr] = fmaxf(m[b][rr], score(b, rr, u));
      }
    }
  }
  TPQ_UNROLL
  for (int b = 0; b < 2; ++b) {
    bool p[2];
    TPQ_UNROLL
    for (int rr = 0; rr < 2; ++rr) {
      m[b][rr] = fmaxf(m[b][rr], w.xor_(m[b][rr], 1));
      m[b][rr] = fmaxf(m[b][rr], w.xor_(m[b][rr], 2));
      p[rr] = m[b][rr] > fmaxf(bound[rr], floors[rr]);
      pass |= (unsigned)p[rr] << (2 * b + rr);
    }
    vote |= (unsigned)w.any(p[0] || p[1]) << b;
  }
}

// Phase 2 of a tile: offer_rows for each vote that passed, bucket 0 before
// bucket 1 (address order), one copy of it in the code for both; rows(b,
// s) gives bucket b's scores s[rr][u].
template <class W, class R>
TPQ_HD TPQ_INLINE void tile_offers(W w, const R& rows, unsigned pass,
                                   unsigned vote, float (&bound)[2],
                                   const float (&floors)[2], int own,
                                   float* lst_v, int* lst_a, int off,
                                   int r_keep, int base) {
  TPQ_NO_UNROLL
  while (vote) {
    const int b = lowest(vote);
    vote &= vote - 1;
    float s[2][LANE_COLS];
    rows(b, s);
    offer_rows(w, s, (pass >> (2 * b)) & 3u, bound, floors, own, lst_v,
               lst_a, off, r_keep, base + 64 * b);
  }
}

#ifdef __CUDACC__
// The kernels' exchanges: warp shuffles and a vote over the whole warp.
struct CudaWarp {
  int l;  // lane
  __device__ __forceinline__ int lane() const { return l; }
  __device__ __forceinline__ float xor_(float v, int m) const {
    return __shfl_xor_sync(0xffffffffu, v, m);
  }
  __device__ __forceinline__ int xor_(int v, int m) const {
    return __shfl_xor_sync(0xffffffffu, v, m);
  }
  __device__ __forceinline__ float idx(float v, int src) const {
    return __shfl_sync(0xffffffffu, v, src);
  }
  __device__ __forceinline__ int idx(int v, int src) const {
    return __shfl_sync(0xffffffffu, v, src);
  }
  __device__ __forceinline__ float up(float v, int d) const {
    return __shfl_up_sync(0xffffffffu, v, d);
  }
  __device__ __forceinline__ int up(int v, int d) const {
    return __shfl_up_sync(0xffffffffu, v, d);
  }
  __device__ __forceinline__ unsigned ballot(bool p) const {
    return __ballot_sync(0xffffffffu, p);
  }
  __device__ __forceinline__ bool any(bool p) const {
    return __any_sync(0xffffffffu, p);
  }
  __device__ __forceinline__ void sync() const { __syncwarp(); }
};
#endif

// ---- flat_scan_wg.cu's shared memory -------------------------------------
//
// From a 1,024-byte aligned base (the first SW_ATOM bytes are the slack that
// aligns it): the CTA's query rows [halves][QROWS][128 B] (one 128-byte
// swizzled k half per 64 elements of d), the ring's window tiles
// [ring][128][128 B] (a tile's k half each), their penalties [ring][128]
// f32, the full and empty barriers [2][ring] and the query rows' two, then
// the rows' lists: values [QROWS][list_ld] f32 and addresses [QROWS][list_ld]
// int32. The ring holds as many stages as the rest leaves room for, at most
// MAX_RING.
constexpr int QROWS = 192;   // query rows of a CTA: three consumer warpgroups
constexpr int WG_ROWS = 64;   // of a consumer warpgroup: one m64 tile
constexpr int MAX_D = 128;    // widest row (elements)
constexpr int MAX_RING = 8;  // at d 128, R 16 a ninth stage ran 3% slower
constexpr size_t RING_STAGE = (size_t)wg::STAGE_BYTES + 4 * wg::BOX_ROWS + 16;

// A list's row stride: r_keep made odd, so that the owners' reads of their
// rows' entries fall on distinct banks.
TPQ_HD constexpr int list_ld(int r_keep) { return r_keep | 1; }
// The k halves of a row of d elements: ring stages a tile, query buffers.
TPQ_HD constexpr int halves(int d) { return wg::stages_of(d); }
TPQ_HD constexpr size_t fixed_bytes(int d, int r_keep) {
  return (size_t)wg::SW_ATOM + (size_t)halves(d) * QROWS * wg::SW_ROW + 16 +
         (size_t)8 * QROWS * list_ld(r_keep);
}
// The stages the rest of the shared memory leaves room for, and the ring's.
TPQ_HD constexpr int ring_fit(int d, int r_keep) {
  return (int)((wg::SMEM_LIMIT - fixed_bytes(d, r_keep)) / RING_STAGE);
}
TPQ_HD constexpr int ring_of(int d, int r_keep) {
  return ring_fit(d, r_keep) > MAX_RING ? MAX_RING : ring_fit(d, r_keep);
}
TPQ_HD constexpr size_t smem_bytes(int d, int r_keep) {
  return fixed_bytes(d, r_keep) + (size_t)ring_of(d, r_keep) * RING_STAGE;
}

}  // namespace fsel
}  // namespace tpq
