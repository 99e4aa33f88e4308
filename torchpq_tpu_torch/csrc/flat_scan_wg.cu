// Fused flat (exhaustive) scan on Hopper (sm_90a): warpgroup products
// (wgmma) over cache tiles brought by the tensor memory accelerator (TMA)
// into a ring of shared-memory stages tracked by mbarriers, one producer
// warpgroup and three consumer warpgroups. The counterpart of
// torchpq_tpu/ops/pallas_flat.py:flat_scan_pallas for bf16 caches with
// d % 8 == 0 and d <= 128 (flat_scan_tc.cu takes 128 < d <= 1024,
// flat_scan.cu f32 caches and the other widths). It computes, for query q
// and slot j (slots past cap, up to the glue's 2048-slot window, are dead:
// zero rows, penalty BIG):
//
//   score = c * <bf16(q), y_j> - penalty[j],   c = 2 (euclidean) or 1
//
// summed in f32; each bucket of 64 slots offers its top 2 (the first
// maximal slot, then the first maximum of the rest); the result per query
// is the top R of those candidates by value descending then address
// ascending -> values [nq, R] f32, addresses [nq, R] int32. The wrapper
// folds c into the bf16 query (x 2 is exact, so every f32 partial sum, and
// the sum, is c times the unscaled one bit for bit) and the score is one
// subtraction, acc - penalty[j], as flat_scan_ref's c * sum - penalty.
//
// What bounds it on an H100: 2 * nq * cap * d operations on cap * d * 2
// bytes of cache. At the flat plan's arguments (nq 10,000, cap 1,048,576,
// d 128) that is 2.68e12 operations over the tensor cores' 989 TFLOP/s
// bf16 = 2.71 ms, against 0.08 ms for the bytes. The mma.sync kernel this
// replaces (flat_scan_tc.cu's register path) took 14.1 ms there: ~5.4 ms of
// products at about half of mma.sync's peak and ~8.7 ms of an epilogue of
// ~7 instructions a score (an FMA and a bucket top 2 on every one of the
// 1.05e10 scores), issued by the same 8 warps that issued the serial MMAs.
//
// Design:
// - Persistent CTAs, one per SM (the wrapper sizes the grid), 512 threads:
//   warpgroup 0 the producer (setmaxnreg down to PRODUCER_REGS), warpgroups
//   1-3 the consumers (up to CONSUMER_REGS). A work unit is a tile of QROWS
//   = 192 queries over a run of whole windows (split slots); unit u takes
//   run u / n_qt and query tile u % n_qt, and CTA b walks u = b, b +
//   gridDim.x, ..., so the CTAs resident at once walk the same few runs in
//   step and device memory reads the cache about once a wave. Each unit
//   writes its queries' sorted top R of its run; flat_common.cuh merges the
//   runs in address order.
// - The producer: the unit's query rows (c * bf16(q), [nq][d]) by TMA boxes
//   {64, 192} (one a k half) into the resident query buffer, once the
//   unit's first tile is on its way and the consumers released the last
//   unit's; the cache tiles by TMA boxes {64, 128} (128 slots, two buckets,
//   a k half each: one stage a tile at d <= 64, two at d <= 128) from a 2-D
//   tensor map over decoded [cap][d] (rows past cap and elements past d
//   filled with zeros), in wgmma's 128-byte swizzled K-major layout
//   (wg_layout.cuh); its threads write the tile's penalties (BIG past cap,
//   where TMA's zero fill would leave 0) beside the tile's last stage. A
//   stage's full barrier completes on the producer's 128 arrivals and the
//   TMA's bytes, its empty barrier on the 12 consumer warps' arrivals.
// - Products: consumer warpgroup h holds query rows 64 h .. 64 h + 63, one
//   m64 tile; per cache tile one chain of ceil(d / 16) wgmma.m64n128k16 (at
//   most 8) from a zero sum, both operands in shared memory, waited for
//   (wait_group 0), then its scores. The overlap chosen is the three
//   warpgroups': while one scores, the others' products run, with no order
//   imposed. What sets the pace is a warpgroup's scoring, the slowest of its
//   four warps (wgmma is the warpgroup's): on the flat plan's arguments a
//   consumer warp spends a tile ~1,550 cycles from its products' issue to
//   their end, ~710 waiting for the tile's stages, ~610 on the votes and
//   ~350 on the offers, ~1,600 for each vote that passes (chip_variants.py
//   --flat, fwg_clock). Tried there and dropped: the warpgroups' products
//   in turns (a ping-pong of three, fwg_rotate: 3% slower, its turns
//   stalling behind those scores); four consumer warpgroups (256 queries,
//   640 threads, fwg_wg4: ptxas spills 16 B at 112 registers, for 2%); and
//   drafts with two warpgroups of two m64 tiles (256 queries, 7.6 ms, half
//   the SM's warps stalled at once) and with the next bucket's products in
//   flight while a bucket was scored (wait_group 1: 9.8 ms, two
//   warpgroup-wide issue points a tile instead of one).
// - The thinned epilogue (flat_select.cuh: tile_votes, tile_offers): per
//   score one subtraction and one max into the row's bucket maximum; per
//   bucket and row two exchanges for the quad's maximum and one compare
//   with the row's bound, its list's R-th value (-inf until the list holds
//   R). A bucket whose maximum is not strictly above the bound offers
//   nothing; only where a row of the warp beats its bound does the warp run
//   the top 2, the quad merge and the inserts, from the scores still in
//   registers, in address order, by one copy of that code in a loop over
//   the votes that passed. Quad lanes 0 and 1 own the lists of the quad's
//   two rows (R values and addresses in shared memory) and offer their
//   pairs, which the warp inserts together, a row at a time (insert_pairs).
//   On the flat plan's arguments 10.9% of the warps' votes pass; with none
//   passing (fwg_novote) the kernel runs in the time of its products alone
//   (fwg_noepi), the votes hidden beside them; every bucket's top 2
//   (fwg_noprune) takes 1.7x the time.
// - The bound a query's runs share (flat_select.cuh: key_of, floor_of): a
//   run's list starts empty and fills again, so once a window (SHARE_TILES
//   tiles) each owner lane publishes its full list's R-th value to gkey[q]
//   (atomicMax on ordered keys) and every lane reads its quad's rows' keys
//   back (L2): a row's candidates below the largest published value are
//   dropped, those equal to it kept. Units of later waves start with the
//   bound of the runs before them, and the units running at once share
//   theirs; without it (fwg_noshare) the kernel takes 1.3x the time.
// - Three limits, at the chosen shapes:
//   1. L2 traffic. Each read of the cache is cap * d * 2 = 268 MB at the
//      flat plan, made once per query tile: ceil(10,000 / 192) = 53 reads,
//      14.2 GB. With the epilogue elided the kernel runs at ~4 TB/s of
//      them (3.6 ms; at 256 queries a CTA 3.0 ms), its products' floor.
//   2. Shared-memory reads by wgmma. A k step reads A (64 rows x 32 B = 2
//      KB) and B (128 rows x 32 B = 4 KB) for 262,144 operations: at the
//      tensor cores' full rate ~98 B a clock of an SM's ~128 (m64n64 would
//      need ~134); the TMA's writes add ~16.
//   3. Registers. The tile's accumulators (64 a thread), a bucket's scores
//      (32), the top 2, the rows' bounds and floors fit CONSUMER_REGS, the
//      lists being in shared memory; the producer keeps no address across
//      its stage loop. ptxas must report no spill and no stack frame
//      (chip_smoke's FLAT_WG_KERNEL).
// - Shared memory (flat_select.cuh: smem_bytes): 1,024 bytes of alignment
//   slack, the query buffer (24 KB a k half), ring stages of 16,384 B + 512
//   B of penalties + 16 B of barriers, as many as fit up to eight, and the
//   lists 192 x (R | 1) x 8 B: at d 128, R 16, 8 stages (211,600 B); R 32,
//   7 stages (219,264 B).
// - Numerics: f32 sums of bf16 products in one chain of at most 8 k16 steps
//   of the tensor cores, as the mma.sync kernel's; on integer-valued inputs
//   every sum is exact, and the kernel equals flat_scan_ref bit for bit,
//   ties and addresses included.

#include <cstdint>

#include <cuda.h>

#include "flat_common.cuh"
#include "flat_select.cuh"
#include "wg_ptx.cuh"

namespace {

using namespace tpq::wg;
namespace fsel = tpq::fsel;
using tpq::big_penalty;
using tpq::smem_u32;

constexpr int THREADS = 512;        // producer warpgroup + three consumers
constexpr int PRODUCER_REGS = 32;   // setmaxnreg: 128 x 32 + 384 x 160
constexpr int CONSUMER_REGS = 160;  // = 65,536 (128 x 512 at launch)
constexpr int CONSUMERS = 3;  // consumer warpgroups
constexpr int CONSUMER_WARPS = 4 * CONSUMERS;
constexpr int WINDOW = 2048;  // the glue's window: the cache pads to it
constexpr int QHALF = fsel::QROWS * SW_ROW;  // a k half of the query rows
// tiles between a consumer's exchanges with the shared bound (one window)
constexpr int SHARE_TILES = WINDOW / BOX_ROWS;

// The m64 tile's products over a cache tile: lo / hi (the tile's first and
// second 64 slots: buckets 0 and 1) = A (the warpgroup's query rows at qa,
// k half 1 at qa + QHALF) x B (the tile's k halves at the stages b0, b1),
// one chain of ceil(d / 16) k16 steps, the first from a zero sum.
__device__ __forceinline__ void tile_chain(float (&lo)[8][4],
                                           float (&hi)[8][4], uint32_t qa,
                                           uint32_t b0, uint32_t b1, int d) {
  wgmma_n128_zero(lo, hi, kmajor_desc(qa, 0), kmajor_desc(b0, 0));
#pragma unroll
  for (int ks = 1; ks < 4; ++ks) {
    if (ks < ksteps_of(d, 0)) {
      wgmma_n128(lo, hi, kmajor_desc(qa, ks), kmajor_desc(b0, ks));
    }
  }
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if (ks < ksteps_of(d, 1)) {
      wgmma_n128(lo, hi, kmajor_desc(qa + QHALF, ks), kmajor_desc(b1, ks));
    }
  }
}

// A tile's scores as flat_select.cuh's phases read them: value u of bucket
// b of row half rr, acc[b] (acc_row / acc_col: register 2 rr + u % 2 of n8
// tile u / 2) minus the column's penalty; phase 1 one at a time, phase 2
// bucket b's two row halves, picked out of the accumulators by value (an
// index into them would put them in local memory).
struct TileScores {
  const float (&acc)[2][8][4];
  const float* pen;  // the tile's 128 penalties
  int t4;            // lane % 4
  __device__ __forceinline__ float operator()(int b, int rr, int u) const {
    const float2 p = *reinterpret_cast<const float2*>(
        pen + 64 * b + 8 * (u / 2) + 2 * t4);
    return acc[b][u / 2][2 * rr + u % 2] - (u % 2 ? p.y : p.x);
  }
  __device__ __forceinline__ void operator()(
      int b, float (&s)[2][fsel::LANE_COLS]) const {
    const float* pb = pen + 64 * b + 2 * t4;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 p = *reinterpret_cast<const float2*>(pb + 8 * j);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i / 2][2 * j + i % 2] =
            (b ? acc[1][j][i] : acc[0][j][i]) - (i % 2 ? p.y : p.x);
      }
    }
  }
};

// The shared bounds of the consumer lane's quad's two rows (row half rr:
// CTA row p0 + 8 rr) from gkey, -inf past nq.
__device__ __forceinline__ void read_floors(float (&floors)[2],
                                            const int* gkey, int q0, int p0,
                                            int nq) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int q = q0 + p0 + 8 * rr;
    floors[rr] = fsel::floor_of(q < nq ? __ldcg(gkey + q) : fsel::NO_KEY);
  }
}

// nring: ring stages (fsel::ring_of); split: slots a run (a multiple of the
// window), n_splits runs; gkey [nq]: the rows' shared bounds (fsel::key_of,
// NO_KEY at the launch).
__global__ void __launch_bounds__(THREADS, 1) flat_scan_wg_kernel(
    const __grid_constant__ CUtensorMap cmap,
    const __grid_constant__ CUtensorMap qmap,
    const float* __restrict__ penalty, float* __restrict__ part_v,
    int* __restrict__ part_a, int* __restrict__ gkey, int nq, int cap,
    int d, int r_keep, int split, int n_splits, int nring) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((SW_ATOM - (smem_u32(smem_raw) & (SW_ATOM - 1))) &
                  (SW_ATOM - 1));
  const int nst = fsel::halves(d);  // ring stages a tile, query k halves
  const int ld = fsel::list_ld(r_keep);
  unsigned char* qbuf = base;                 // [nst][QROWS][128 B]
  unsigned char* ring = qbuf + nst * QHALF;   // [nring][128][128 B]
  float* pen_s = reinterpret_cast<float*>(ring + nring * STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(pen_s + nring * BOX_ROWS);
  uint64_t* empty = full + nring;
  uint64_t* qfull = empty + nring;
  uint64_t* qempty = qfull + 1;
  float* lst_v = reinterpret_cast<float*>(qempty + 1);  // [QROWS][ld]
  int* lst_a = reinterpret_cast<int*>(lst_v + fsel::QROWS * ld);

  const int t = threadIdx.x;
  // the warpgroup, uniform in the compiler's eyes (so that the wgmma
  // instructions sit in no path it must treat as divergent)
  const int wgi = __shfl_sync(0xffffffffu, t / 128, 0);
  const int n_qt = (nq + fsel::QROWS - 1) / fsel::QROWS;
  const int n_units = n_qt * n_splits;
  const int cap_pad = (cap + WINDOW - 1) / WINDOW * WINDOW;

  if (t == 0) {
    for (int i = 0; i < nring; ++i) {
      mbar_init(full + i, 128);  // the producer's arrivals and TMA's bytes
      mbar_init(empty + i, CONSUMER_WARPS);
    }
    mbar_init(qfull, 1);
    mbar_init(qempty, CONSUMER_WARPS);
    mbar_init_fence();
  }
  __syncthreads();

  if (wgi == 0) {
    // ---- producer: the cache tiles and the query rows by TMA ----
    setmaxnreg_dec<PRODUCER_REGS>();
    int g = 0;   // stages filled
    int ui = 0;  // units
    for (int u = blockIdx.x; u < n_units; u += gridDim.x, ++ui) {
      const int run = u / n_qt;
      const int s0 = run * split;
      const int n_tiles = min(split, cap_pad - s0) / BOX_ROWS;
      for (int it = 0; it < n_tiles; ++it) {
        const int ts = s0 + BOX_ROWS * it;  // the tile's first slot
        for (int st = 0; st < nst; ++st, ++g) {
          const int slot = g % nring;
          uint64_t* fb = full + slot;
          mbar_wait(empty + slot, ((g / nring) & 1) ^ 1);
          if (t == 0) {
            mbar_expect_tx(fb, STAGE_BYTES);
            tma_load_2d(ring + slot * STAGE_BYTES, &cmap, fb, box_x(st), ts);
          }
          if (st == nst - 1) {  // slot ts + t's penalty, BIG past cap
            const int j = ts + t;
            pen_s[slot * BOX_ROWS + t] =
                j < cap ? __ldg(penalty + j) : big_penalty();
          }
          mbar_arrive(fb);
        }
        if (it == 0 && t == 0) {
          // the unit's query rows, once its first tile is on its way, into
          // the buffer the consumers have released (rows past nq and
          // elements past d filled with zeros)
          mbar_wait(qempty, (ui & 1) ^ 1);
          mbar_expect_tx(qfull, nst * QHALF);
          for (int hh = 0; hh < nst; ++hh) {
            tma_load_2d(qbuf + hh * QHALF, &qmap, qfull, box_x(hh),
                        (u - run * n_qt) * fsel::QROWS);
          }
          mbar_arrive(qfull);
        }
      }
    }
  } else {
    // ---- consumers: products, scores and selects ----
    setmaxnreg_inc<CONSUMER_REGS>();
    const int ct = t - 128;
    const int lane = ct % 32;
    const int h = wgi - 1;  // consumer warpgroup: rows 64 h .. 64 h + 63
    const int wq = (ct / 32) % 4;  // warp of the warpgroup
    const int t4 = lane % 4;
    // the quad's rows (acc_row: CTA rows p0 and p0 + 8); lanes 0 and 1 of
    // the quad own their lists, the others none
    const int p0 = fsel::WG_ROWS * h + 16 * wq + lane / 4;
    const int own = t4 < 2 ? t4 : -1;
    const int prow = p0 + 8 * (t4 & 1);
    const int off = prow * ld;  // the owned row's list's
    float* lv = lst_v + off;
    int* la = lst_a + off;
    const uint32_t q_u = smem_u32(qbuf) + fsel::WG_ROWS * h * SW_ROW;
    const uint32_t r_u = smem_u32(ring);
    float acc[2][8][4];  // [bucket]
    int g = 0;   // stages consumed
    int ui = 0;  // units
    for (int u = blockIdx.x; u < n_units; u += gridDim.x, ++ui) {
      const int run = u / n_qt;
      const int q0 = (u - run * n_qt) * fsel::QROWS;
      const int s0 = run * split;
      const int n_tiles = min(split, cap_pad - s0) / BOX_ROWS;
      // this warpgroup's m64 tile holds a query
      const bool live = q0 + fsel::WG_ROWS * h < nq;
      const int q = q0 + prow;
      const bool owner = own >= 0 && q < nq;
      if (own >= 0) {
        for (int i = 0; i < r_keep; ++i) {
          lv[i] = fsel::NEG_INF;
          la[i] = -1;
        }
      }
      float bound[2] = {fsel::NEG_INF, fsel::NEG_INF};
      float floors[2];
      read_floors(floors, gkey, q0, p0, nq);
      int pub = fsel::NO_KEY;  // the owned row's key last published
      mbar_wait(qfull, ui & 1);
      for (int it = 0; it < n_tiles; ++it) {
        const int sa = g % nring;
        const int sb = (g + 1) % nring;
        mbar_wait(full + sa, (g / nring) & 1);
        if (nst > 1) mbar_wait(full + sb, ((g + 1) / nring) & 1);
        const float* pen = pen_s + (nst > 1 ? sb : sa) * BOX_ROWS;
        const int ts = s0 + BOX_ROWS * it;
        if (live) {
          wgmma_fence();
          tile_chain(acc[0], acc[1], q_u, r_u + sa * STAGE_BYTES,
                     r_u + sb * STAGE_BYTES, d);
          wgmma_commit();
          wgmma_wait_all();
          fence_acc(acc[0]);
          fence_acc(acc[1]);
          const fsel::CudaWarp w{lane};
          const TileScores sc{acc, pen, t4};
          unsigned pass = 0, vote = 0;
          fsel::tile_votes(w, sc, bound, floors, pass, vote);
          fsel::tile_offers(w, sc, pass, vote, bound, floors, own, lst_v,
                            lst_a, off, r_keep, ts);
        }
        __syncwarp();
        if (lane == 0) {  // the tile's stages are free again
          mbar_arrive(empty + sa);
          if (nst > 1) mbar_arrive(empty + sb);
          // and the query buffer, after the unit's last products
          if (it + 1 == n_tiles) mbar_arrive(qempty);
        }
        g += nst;
        if ((it + 1) % SHARE_TILES == 0 || it + 1 == n_tiles) {
          // the owned row's list bound, where the list is full and it rose,
          // to the runs' shared bound; then the quad's rows' floors anew
          const int key = fsel::key_of(lv[r_keep - 1]);
          if (owner && lv[r_keep - 1] > fsel::NEG_INF && key > pub) {
            atomicMax(gkey + q, key);
            pub = key;
          }
          read_floors(floors, gkey, q0, p0, nq);
        }
      }
      // the owned row's sorted top R of the run
      if (owner) {
        const size_t o = ((size_t)run * nq + q) * r_keep;
        for (int i = 0; i < r_keep; ++i) {
          part_v[o + i] = lv[i];
          part_a[o + i] = la[i];
        }
      }
    }
  }
}

// The 2-D tensor map of a bf16 matrix [rows][d] for boxes {64, box_rows}
// (128 bytes of k: one 128-byte swizzle span), elements past the matrix
// filled with zeros.
bool encode_map(CUtensorMap* map, const void* ptr, int d, int rows,
                int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t box[2] = {(cuuint32_t)(SW_ROW / 2), (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// CTAs one SM holds at once at (d, r_keep), or minus the CUDA error code.
int occupancy(int d, int r_keep) {
  const size_t smem = fsel::smem_bytes(d, r_keep);
  cudaError_t err = cudaFuncSetAttribute(
      flat_scan_wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flat_scan_wg_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  }
  int n = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, flat_scan_wg_kernel, THREADS, smem);
  }
  return err == cudaSuccess ? n : -(int)err;
}

bool shape_ok(int nq, int cap, int d, int r_keep) {
  return nq > 0 && cap > 0 && d > 0 && d % 8 == 0 && d <= fsel::MAX_D &&
         r_keep >= 1 && r_keep <= 32;
}

}  // namespace

// Plain C entry point (bound with ctypes). qtable [nq, d] bf16: c * bf16(q)
// (c = 2 for euclidean, else 1: the kernel's sums are then c times the
// query's, exactly); penalty [cap] f32; decoded [cap, d] bf16; both bf16
// arrays 16-byte aligned; d % 8 == 0 and d <= 128; r_keep <= 32; split slots
// a run (a multiple of 128; n_splits * split >= cap, the slots past cap up
// to the 2048-slot window are dead pads); n_ctas the persistent grid (at
// least one); part_v / part_a [n_splits, nq, r_keep] scratch; gkey [nq]
// int32 scratch, NO_KEY (INT_MIN) on every row; out_v / out_a [nq,
// r_keep]. Returns 0 or the CUDA error code of a tensor map, an
// attribute call or a launch (cudaErrorInvalidValue, without launching, for
// other shapes). Launches on `stream`, does not synchronize and allocates
// nothing.
extern "C" int torchpq_flat_scan_wg(const void* qtable, const float* penalty,
                                    const void* decoded, float* part_v,
                                    int* part_a, int* gkey, float* out_v,
                                    int* out_a, int nq, int cap, int d,
                                    int r_keep, int split, int n_splits,
                                    int n_ctas, void* stream) {
  if (!shape_ok(nq, cap, d, r_keep) || split <= 0 || split % BOX_ROWS ||
      (long long)split * n_splits < cap ||
      (long long)split * (n_splits - 1) >= cap || n_ctas < 1 ||
      (reinterpret_cast<uintptr_t>(qtable) |
       reinterpret_cast<uintptr_t>(decoded)) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap cmap, qmap;
  if (!encode_map(&cmap, decoded, d, cap, BOX_ROWS) ||
      !encode_map(&qmap, qtable, d, nq, fsel::QROWS)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = tpq::launch_kernel(
      flat_scan_wg_kernel, dim3(n_ctas), THREADS,
      fsel::smem_bytes(d, r_keep), st, cmap, qmap, penalty, part_v, part_a,
      gkey, nq, cap, d, r_keep, split, n_splits, fsel::ring_of(d, r_keep));
  if (rc != 0) return rc;
  return r_keep <= 16
             ? tpq::launch_flat_merge<16>(part_v, part_a, out_v, out_a, nq,
                                          r_keep, n_splits, st)
             : tpq::launch_flat_merge<32>(part_v, part_a, out_v, out_a, nq,
                                          r_keep, n_splits, st);
}

// Dynamic shared memory of one CTA (flat_select.cuh: smem_bytes).
extern "C" long long torchpq_flat_scan_wg_smem(int d, int r_keep) {
  return (long long)fsel::smem_bytes(d, r_keep);
}

// CTAs one SM holds at once (registers and shared memory permitting), or
// minus the CUDA error code; cudaErrorInvalidValue's for other shapes.
extern "C" int torchpq_flat_scan_wg_occupancy(int d, int r_keep) {
  if (!shape_ok(1, 1, d, r_keep)) return -(int)cudaErrorInvalidValue;
  return occupancy(d, r_keep);
}
