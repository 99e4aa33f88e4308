// Fused flat (exhaustive) scan on the tensor cores (mma.sync, sm_90a): the
// counterpart of torchpq_tpu/ops/pallas_flat.py:flat_scan_pallas for bf16
// caches with d % 8 == 0 and 128 < d <= 1024 (flat_scan_wg.cu, wgmma + TMA,
// takes d <= 128; flat_scan.cu, on the CUDA cores, f32 caches and the
// other widths). It computes what flat_scan.cu computes, for query q and
// slot j (slots past cap, up to the glue's 2048-slot window, are dead: zero
// rows, penalty BIG):
//
//   score = c * <bf16(q), y_j> - penalty[j],   c = 2 (euclidean) or 1
//
// summed in f32; each bucket of 64 slots offers its top 2 (the first
// maximal slot, then the first maximum of the rest); the result per query
// is the top R of those candidates by value descending then address
// ascending -> values [nq, R] f32, addresses [nq, R] int32.
//
// What bounds it on an H100: 2 * nq * cap * d operations on cap * d * 2
// bytes of cache, so operations. The epilogue sets a floor of its own: each
// instruction per score on the CUDA cores costs ~0.35 ms across the card
// per 1e10 scores (132 SMs x 128 lanes x ~1.75 GHz = 3e13
// lane-instructions/s), and this kernel's bucket top 2 takes an FMA and ~6
// compares and selects a score. The note's first estimate put that epilogue
// at ~2 ms at the flat plan's arguments (nq 10,000, cap 1,048,576, d 128);
// the card measured ~8.7 ms of its 14.1 there (the same queries and slots
// at d 64 kept 81% of the time): the warps that issue the serial MMAs also
// issue the epilogue, two of them a scheduler, and its latency is not
// hidden. flat_scan_wg.cu took those widths over with wgmma, a producer
// warpgroup and an epilogue that tests each bucket's maximum against the
// row's bound (flat_select.cuh); this kernel keeps the wider rows, whose
// products outweigh the epilogue (d / 16 k steps a bucket).
//
// Design:
// - Grid and split as flat_scan.cu: CTA (x, y) takes 32 * warps queries
//   (32 per warp) and the run of whole buckets [y * split, (y + 1) * split);
//   flat_common.cuh merges the partial lists in split (address) order.
// - Main loop: mma.sync m16n8k16 bf16 x bf16 -> f32 (tc_ptx.cuh). A is the
//   warp's 32 query rows, two m16 tiles, so every B fragment feeds two
//   MMAs; A is resident in shared memory for the whole run, read by
//   ldmatrix per K chunk, and B is the cache tile by ldmatrix: [slot][k]
//   row-major is the .col operand as it lies. A warp keeps a whole
//   bucket's 16 accumulator tiles (64 registers) across the K chunks.
// - Copies: a ring of 4 slots in shared memory, each one bucket x 128
//   columns (a K chunk) and, with the bucket's last chunk, its 64
//   penalties, fetched three stages ahead. cp.async fills them (16 B; zero
//   bytes past d and past cap, whose penalty is BIG); one
//   cp.async.wait_group and one __syncthreads per stage. Shared rows are
//   136 elements (272 B, an odd multiple of 16 B), so the 8 row addresses
//   of an ldmatrix phase fall on 32 distinct banks.
// - Epilogue per bucket, in registers: in the C layout a thread holds 4
//   query rows (rows g and g + 8 of each m tile) x 16 of the bucket's
//   columns. It takes the top 2 of each row over its own columns, in
//   ascending order with strict > (the first maximal slot first), then the
//   quad's merge (flat_select.cuh: top2_push, quad_merge), which gives the
//   bucket's top 2 by the TPU kernel's rule. Lane t of the quad then owns
//   the running top-KMAX list of row t of its 4, so each query's list
//   lives in one thread, and inserts the pair after a test against the
//   list's last entry (scan_common.cuh:insert keeps visit order, which is
//   address order, on ties).

#include <cstdint>

#include "flat_common.cuh"
#include "flat_select.cuh"
#include "tc_ptx.cuh"

namespace {

using namespace tpq;

constexpr int W = 2048;          // the glue's window: the cache pads to it
constexpr int KC = 128;          // cache columns per stage (a K chunk)
constexpr int KSTEPS = KC / 16;  // k16 steps per stage
constexpr int LDS = KC + 8;      // shared row stride of a stage, elements
constexpr int STAGES = 4;        // ring slots, one stage each
constexpr int STAGE_BYTES = BUCKET * LDS * 2 + BUCKET * 4;  // rows + pens
constexpr int MAX_WARPS = 8;
constexpr int MIN_D = 136;  // narrower rows are flat_scan_wg.cu's
constexpr int MAX_D = 1024;

__host__ __device__ inline int round16(int d) { return (d + 15) / 16 * 16; }

// Dynamic shared memory: the query rows [32 * warps][round16(d) + 8] bf16
// and the ring.
__host__ __device__ inline size_t tc_smem_bytes(int warps, int d) {
  return (size_t)32 * warps * (round16(d) + 8) * 2 +
         (size_t)STAGES * STAGE_BYTES;
}

template <typename T>
__device__ __forceinline__ T pick4(const T (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// The bucket top 2 of a thread's 4 rows. Row r of the 4 is row
// g + 8 * (r % 2) of m tile r / 2: C registers 2 * (r % 2) + {0, 1} of
// that tile's fragments. Columns are kept without their lane part
// (frag_c_col(lane, 0) = 2 * t4), added in finish().
struct BucketTop2 {
  fsel::Top2 t[4];

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int r = 0; r < 4; ++r) t[r] = fsel::top2_empty();
  }

  // The scores of n8 tile nt of the bucket, from its C fragments c0 (m
  // tile 0) and c1 (m tile 1) and the penalties p of this thread's two
  // columns, visited in ascending column order.
  __device__ __forceinline__ void add(const float (&c0)[4],
                                      const float (&c1)[4], int nt, float2 p,
                                      float factor) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float* cr = (r < 2 ? c0 : c1) + 2 * (r % 2);
      fsel::top2_push(t[r], fmaf(factor, cr[0], -p.x), 8 * nt);
      fsel::top2_push(t[r], fmaf(factor, cr[1], -p.y), 8 * nt + 1);
    }
  }

  // The quad's merge, then lane t4 offers row t4's pair to its list.
  template <int KMAX>
  __device__ __forceinline__ void finish(float (&vals)[KMAX],
                                         int (&slots)[KMAX], int bucket0,
                                         int lane) {
    const int col0 = frag_c_col(lane, 0);
    const fsel::CudaWarp w{lane};
    float m1[4], m2[4];
    int a1[4], a2[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      t[r].a1 += col0;
      t[r].a2 += col0;
      fsel::quad_merge(w, t[r]);
      m1[r] = t[r].m1;
      m2[r] = t[r].m2;
      a1[r] = t[r].a1;
      a2[r] = t[r].a2;
    }
    const int t4 = lane % 4;
    insert<KMAX>(vals, slots, pick4(m1, t4), bucket0 + pick4(a1, t4));
    insert<KMAX>(vals, slots, pick4(m2, t4), bucket0 + pick4(a2, t4));
  }
};

// One CTA's run of the cache: rows and penalties from the run's first
// slot; n_live of its slots exist (the rest are dead pads).
struct Run {
  const __nv_bfloat16* rows;
  const float* pen;
  int d, n_live, nchunk;

  // Issue the copies of piece t (bucket t / nchunk, K chunk t % nchunk)
  // into ring slot t % STAGES.
  __device__ __forceinline__ void load(unsigned char* ring, int t) const {
    const int b = t / nchunk;
    const int c = t - b * nchunk;
    unsigned char* base = ring + (size_t)(t % STAGES) * STAGE_BYTES;
    __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(base);
    const int slot0 = b * BUCKET;
    constexpr int SEGS = KC / 8;  // 16-byte segments per row of a stage
    for (int i = threadIdx.x; i < BUCKET * SEGS; i += blockDim.x) {
      const int r = i / SEGS;
      const int k = 8 * (i % SEGS);
      const int col = c * KC + k;
      const bool ok = slot0 + r < n_live && col < d;
      const __nv_bfloat16* src =
          ok ? rows + (size_t)(slot0 + r) * d + col : rows;
      cp_async16(tile + r * LDS + k, src, ok ? 16 : 0);
    }
    if (c == nchunk - 1) {
      float* pen_s = reinterpret_cast<float*>(base + BUCKET * LDS * 2);
      for (int i = threadIdx.x; i < BUCKET; i += blockDim.x) {
        if (slot0 + i < n_live) {
          cp_async4(pen_s + i, pen + slot0 + i);
        } else {
          pen_s[i] = big_penalty();
        }
      }
    }
  }
};

template <int KMAX>
__global__ void __launch_bounds__(32 * MAX_WARPS)
    flat_scan_tc_kernel(const __nv_bfloat16* __restrict__ qtable,
                        const float* __restrict__ penalty,
                        const __nv_bfloat16* __restrict__ decoded,
                        float* __restrict__ part_v, int* __restrict__ part_a,
                        int nq, int cap, int d, int r_keep, int split,
                        float factor) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int t4 = lane % 4;
  const int rows = blockDim.x;         // 32 queries per warp
  const int q0 = blockIdx.x * rows;    // the CTA's first query
  const int qw = q0 + 32 * warp;       // the warp's first query
  const int s0 = blockIdx.y * split;
  const int cap_pad = (cap + W - 1) / W * W;
  const int n_buckets = min(split, cap_pad - s0) / BUCKET;
  const int dpad = round16(d);
  const int ldq = dpad + 8;  // odd multiple of 16 bytes, as LDS
  const Run run{decoded + (size_t)s0 * d, penalty + s0, d, cap - s0,
                (dpad + KC - 1) / KC};
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  unsigned char* ring = smem_raw + (size_t)rows * ldq * 2;

  // A, resident for the run: zero past nq and past d
  const int segs = dpad / 8;
  for (int i = threadIdx.x; i < rows * segs; i += blockDim.x) {
    const int r = i / segs;
    const int col = 8 * (i % segs);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < nq && col < d) {
      v = *reinterpret_cast<const uint4*>(qtable + (size_t)(q0 + r) * d +
                                          col);
    }
    *reinterpret_cast<uint4*>(q_s + (size_t)r * ldq + col) = v;
  }

  float vals[KMAX];
  int slots[KMAX];
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    vals[i] = neg_inf();
    slots[i] = -1;
  }
  BucketTop2 top;
  // the bucket's columns in K chunks of KC, one stage each, fetched
  // STAGES - 1 ahead; its scores are complete after the last chunk
  const int n_stages = n_buckets * run.nchunk;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_stages) run.load(ring, s);
    cp_async_commit();
  }
  float acc[2][8][4];
  int b = 0;
  int c = 0;
  for (int t = 0; t < n_stages; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (t + STAGES - 1 < n_stages) run.load(ring, t + STAGES - 1);
    cp_async_commit();
    const unsigned char* base = ring + (size_t)(t % STAGES) * STAGE_BYTES;
    const __nv_bfloat16* tile = reinterpret_cast<const __nv_bfloat16*>(base);
    if (c == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
        }
      }
    }
    const int nks = min(KSTEPS, (dpad - c * KC) / 16);
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      if (ks < nks) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          ldmatrix_x4(a[mt], q_s + (size_t)(32 * warp + 16 * mt +
                                            ldm_a_row(lane)) * ldq +
                                 c * KC + 16 * ks + ldm_a_col(lane));
        }
#pragma unroll
        for (int np = 0; np < 4; ++np) {  // pairs of n8 tiles
          uint32_t bf[4];
          ldmatrix_x4(bf, tile + (16 * np + ldm_b_row(lane)) * LDS + 16 * ks +
                              ldm_b_col(lane));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16_16816(acc[mt][2 * np], a[mt], bf[0], bf[1]);
            mma_bf16_16816(acc[mt][2 * np + 1], a[mt], bf[2], bf[3]);
          }
        }
      }
    }
    if (c < run.nchunk - 1) {
      ++c;
      continue;
    }
    const float* pen_s =
        reinterpret_cast<const float*>(base + BUCKET * LDS * 2);
    top.reset();
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      top.add(acc[0][nt], acc[1][nt], nt,
              *reinterpret_cast<const float2*>(pen_s + 8 * nt +
                                               frag_c_col(lane, 0)),
              factor);
    }
    top.finish<KMAX>(vals, slots, b * BUCKET, lane);
    ++b;
    c = 0;
  }

  // lane t4 owns row t4 of its four: m tile t4 / 2, C register row
  // frag_c_row(lane, 2 * (t4 % 2))
  const int q = qw + 16 * (t4 / 2) + frag_c_row(lane, 2 * (t4 % 2));
  if (q < nq) {
    const size_t o = ((size_t)blockIdx.y * nq + q) * r_keep;
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      if (i < r_keep) {
        part_v[o + i] = vals[i];
        part_a[o + i] = slots[i] < 0 ? -1 : s0 + slots[i];
      }
    }
  }
}

template <int KMAX>
int launch(const void* qtable, const float* penalty, const void* decoded,
           float* part_v, int* part_a, float* out_v, int* out_a, int nq,
           int cap, int d, int r_keep, int split, int n_splits, float factor,
           int warps, cudaStream_t stream) {
  const int threads = 32 * warps;
  const dim3 grid((nq + threads - 1) / threads, n_splits);
  int rc = launch_kernel(flat_scan_tc_kernel<KMAX>, grid, threads,
                         tc_smem_bytes(warps, d), stream,
                         static_cast<const __nv_bfloat16*>(qtable), penalty,
                         static_cast<const __nv_bfloat16*>(decoded), part_v,
                         part_a, nq, cap, d, r_keep, split, factor);
  if (rc != 0) return rc;
  return launch_flat_merge<KMAX>(part_v, part_a, out_v, out_a, nq, r_keep,
                                 n_splits, stream);
}

// Blocks of `warps` warps one SM holds at once, or minus the CUDA error.
template <int KMAX>
int occupancy(int warps, int d) {
  const auto kern = flat_scan_tc_kernel<KMAX>;
  const size_t smem = tc_smem_bytes(warps, d);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  }
  int n = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, 32 * warps,
                                                        smem);
  }
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace

// Plain C entry point (bound with ctypes). qtable [nq, d] bf16 (the query
// rounded to bf16), penalty [cap] f32, decoded [cap, d] bf16, both bf16
// arrays 16-byte aligned; d % 8 == 0 and 128 < d <= 1024; split slots per
// CTA row (a multiple of 64; n_splits * split >= cap, the slots past cap
// are dead pads); warps per CTA (1, 2, 4 or 8; 32 queries each); part_v /
// part_a [n_splits, nq, r_keep] scratch; out_v / out_a [nq, r_keep].
// Returns 0 or the CUDA error code of an attribute call or a launch.
// Launches on `stream`, does not synchronize and allocates nothing.
extern "C" int torchpq_flat_scan_tc(const void* qtable, const float* penalty,
                                    const void* decoded, float* part_v,
                                    int* part_a, float* out_v, int* out_a,
                                    int nq, int cap, int d, int r_keep,
                                    int split, int n_splits, int euclidean,
                                    int warps, void* stream) {
  if (nq <= 0 || cap <= 0 || d < MIN_D || d % 8 || d > MAX_D || r_keep < 1 ||
      r_keep > 32 || warps < 1 || warps > MAX_WARPS || (warps & (warps - 1)) ||
      split <= 0 || split % BUCKET || (long long)split * n_splits < cap ||
      (long long)split * (n_splits - 1) >= cap ||
      (reinterpret_cast<uintptr_t>(qtable) |
       reinterpret_cast<uintptr_t>(decoded)) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const float factor = euclidean ? 2.0f : 1.0f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TPQ_ARGS                                                           \
  qtable, penalty, decoded, part_v, part_a, out_v, out_a, nq, cap, d,      \
      r_keep, split, n_splits, factor, warps, st
  if (r_keep <= 16) return launch<16>(TPQ_ARGS);
  return launch<32>(TPQ_ARGS);
#undef TPQ_ARGS
}

// Dynamic shared memory of one CTA of `warps` warps.
extern "C" long long torchpq_flat_scan_tc_smem(int warps, int d,
                                               int r_keep) {
  return (long long)tc_smem_bytes(warps, d);
}

// CTAs of `warps` warps one SM holds at once (registers and shared memory
// permitting), or minus the CUDA error code.
extern "C" int torchpq_flat_scan_tc_occupancy(int warps, int d, int r_keep) {
  if (r_keep <= 16) return occupancy<16>(warps, d);
  return occupancy<32>(warps, d);
}
