// IVF block scan for Hopper (sm_90a): the CUDA counterpart of
// torchpq_tpu/ops/pallas_scan.py:scan_blocks_pallas.
//
// A block is up to p_tile probers (queries) of one IVF cell. For block b,
// prober p and window slot j in [0, s_eff):
//
//   score = c * <q_p, y_{start_c[b] + j}> - pen,   c = 2 (euclidean) or 1
//   pen   = penalty[start_c[b] + j] + (off[b] <= j < off[b] + cap[b] ? 0 : BIG)
//
// with f32 accumulation over bf16 (or f32) operands, BIG = FLT_MAX / 4 and
// penalty = norm-or-BIG per slot. Then the top k_pair per prober, in the JAX
// package's wire format, which ops/adc.py:_merge_pairs consumes unchanged:
//
//   exact  -> [B, p_tile, 2*k_pair] int32: sortable keys ++ absolute
//             addresses, ordered by value descending then slot ascending
//             (the "first maximal column per pass" order); entries with
//             value <= -BIG/2 are dead: sortable(-inf) and -1.
//   pack32 -> [B, p_tile, k_pair] int32: key = (sortable(score) & ~slot_mask)
//             | slot, reduced to one winner per strided group
//             (group g holds slots g, g+G, g+2G, ...), then the k_pair
//             largest group winners, descending. Keys are unique per row.
//
// Design (first, simple version): one CTA per (block, slice of pt probers);
// each thread owns one prober. The CTA reads its query rows by prober id
// from the [nq, d] query table into shared memory (in the cache's dtype),
// streams the cell window through shared memory in f32 tiles of TS slots,
// and each thread scores U slots at a time from registers. The exact select keeps a sorted top-KMAX
// list in registers; the pack32 select keeps its G group maxima in shared
// memory. What bounds it on an H100: every window element read from memory
// feeds p_tile (128) FMAs, so the kernel is bound by f32 FMA issue and
// shared-memory bandwidth, not by HBM; tensor cores (wgmma) and TMA are for
// later versions.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cfloat>
#include <climits>
#include <cstddef>

namespace {

constexpr int TS = 16;  // window slots per shared-memory tile
constexpr int U = 8;    // slots scored per register tile

__device__ __forceinline__ int sortable(float x) {
  const int i = __float_as_int(x);
  return i < 0 ? (i ^ 0x7FFFFFFF) : i;
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// four consecutive elements as f32 (8-byte aligned for bf16, 16 for f32)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Keep v[0..KMAX) sorted by value descending, slot ascending on ties:
// a new entry goes after every entry whose value is >= its own.
template <int KMAX>
__device__ __forceinline__ void insert(float (&v)[KMAX], int (&s)[KMAX],
                                       float x, int j) {
  if (!(x > v[KMAX - 1])) return;
#pragma unroll
  for (int i = KMAX - 1; i > 0; --i) {
    if (v[i - 1] < x) {
      v[i] = v[i - 1];
      s[i] = s[i - 1];
    } else if (v[i] < x) {
      v[i] = x;
      s[i] = j;
    }
  }
  if (v[0] < x) {
    v[0] = x;
    s[0] = j;
  }
}

size_t smem_bytes(int pt, int d, int pack32, int n_groups, int elem_size) {
  return (size_t)elem_size * pt * (d + 4) +
         sizeof(float) * ((size_t)TS * d + TS) +
         sizeof(int) * ((size_t)pt + (pack32 ? (size_t)n_groups * pt : 0));
}

template <typename T, bool PACK, int KMAX>
__global__ void block_scan_kernel(
    const T* __restrict__ qtable, const int* __restrict__ probers,
    const int* __restrict__ start_c, const int* __restrict__ off,
    const int* __restrict__ capb, const float* __restrict__ penalty,
    const T* __restrict__ decoded, int* __restrict__ out, int p_tile, int d,
    int s_eff, int k_pair, float factor, int slot_mask, int n_groups) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pt = blockDim.x;
  const int ldq = d + 4;  // padded rows: 4-element reads of q_s are
                          // conflict-free
  T* q_s = reinterpret_cast<T*>(smem_raw);                       // [pt][ldq]
  float* y_s = reinterpret_cast<float*>(q_s + (size_t)pt * ldq);  // [TS][d]
  float* pen_s = y_s + TS * d;                      // [TS]
  int* prow_s = reinterpret_cast<int*>(pen_s + TS);  // [pt]
  int* best_s = prow_s + pt;                         // [n_groups][pt]

  const float big = FLT_MAX / 4.0f;
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int p = blockIdx.y * pt + t;
  const int s0 = start_c[b];
  const int o0 = off[b];
  const int o1 = o0 + capb[b];

  const int pr = probers[(size_t)b * p_tile + p];
  prow_s[t] = pr < 0 ? 0 : pr;  // padding rows score query 0, never read
  if (PACK) {
    for (int g = 0; g < n_groups; ++g) best_s[g * pt + t] = INT_MIN;
  }
  __syncthreads();
  for (int r = 0; r < pt; ++r) {
    const T* src = qtable + (size_t)prow_s[r] * d;
    for (int k = t; k < d; k += pt) q_s[r * ldq + k] = src[k];
  }

  float vals[KMAX];
  int slots[KMAX];
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    vals[i] = neg_inf();
    slots[i] = 0;
  }

  const T* qrow = q_s + (size_t)t * ldq;
  for (int ts = 0; ts < s_eff; ts += TS) {
    __syncthreads();  // previous tile fully consumed
    const int nrow = min(TS, s_eff - ts);
    const T* win = decoded + (size_t)(s0 + ts) * d;
    for (int i = 4 * t; i < TS * d; i += 4 * pt) {  // d % 4 == 0
      *reinterpret_cast<float4*>(y_s + i) =
          (i / d) < nrow ? load4(win + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (t < TS) {
      const int j = ts + t;
      float pv = 0.0f;
      if (t < nrow) {
        pv = penalty[s0 + j] + ((j >= o0 && j < o1) ? 0.0f : big);
      }
      pen_s[t] = pv;
    }
    __syncthreads();
    for (int u0 = 0; u0 < nrow; u0 += U) {
      float acc[U];
#pragma unroll
      for (int u = 0; u < U; ++u) acc[u] = 0.0f;
      for (int k = 0; k < d; k += 4) {
        const float4 qv = load4(qrow + k);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float4 yv =
              *reinterpret_cast<const float4*>(y_s + (u0 + u) * d + k);
          acc[u] = fmaf(qv.x, yv.x, acc[u]);
          acc[u] = fmaf(qv.y, yv.y, acc[u]);
          acc[u] = fmaf(qv.z, yv.z, acc[u]);
          acc[u] = fmaf(qv.w, yv.w, acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int jl = u0 + u;
        if (jl < nrow) {
          const int j = ts + jl;
          const float sc = factor * acc[u] - pen_s[jl];
          if (PACK) {
            const int key = (sortable(sc) & ~slot_mask) | j;
            int* bp = best_s + (j % n_groups) * pt + t;
            *bp = max(*bp, key);
          } else {
            insert<KMAX>(vals, slots, sc, j);
          }
        }
      }
    }
  }

  if (PACK) {
    int* o = out + ((size_t)b * p_tile + p) * k_pair;
    for (int i = 0; i < k_pair; ++i) {
      int m = INT_MIN;
      int gi = 0;
      for (int g = 0; g < n_groups; ++g) {
        const int v = best_s[g * pt + t];
        if (v > m) {
          m = v;
          gi = g;
        }
      }
      o[i] = m;
      best_s[gi * pt + t] = INT_MIN;
    }
  } else {
    int* o = out + ((size_t)b * p_tile + p) * 2 * k_pair;
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      if (i < k_pair) {
        const bool alive = vals[i] > -big / 2.0f;
        o[i] = sortable(alive ? vals[i] : neg_inf());
        o[k_pair + i] = alive ? s0 + slots[i] : -1;
      }
    }
  }
}

template <typename T, bool PACK, int KMAX>
int launch(const void* qtable, const int* probers, const int* start_c,
           const int* off, const int* capb, const float* penalty,
           const void* decoded, int* out, int n_blocks, int p_tile, int d,
           int s_eff, int k_pair, float factor, int slot_mask, int n_groups,
           int pt, cudaStream_t stream) {
  auto kern = block_scan_kernel<T, PACK, KMAX>;
  const size_t smem = smem_bytes(pt, d, PACK, n_groups, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // all of L1 as shared memory, so two pack32 CTAs fit one SM
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_blocks, p_tile / pt);
  kern<<<grid, pt, smem, stream>>>(
      static_cast<const T*>(qtable), probers, start_c, off, capb, penalty,
      static_cast<const T*>(decoded), out, p_tile, d, s_eff, k_pair, factor,
      slot_mask, n_groups);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* qtable, const int* probers, const int* start_c,
             const int* off, const int* capb, const float* penalty,
             const void* decoded, int* out, int n_blocks, int p_tile, int d,
             int s_eff, int k_pair, float factor, int pack32, int slot_mask,
             int n_groups, int pt, cudaStream_t stream) {
#define TPQ_ARGS                                                          \
  qtable, probers, start_c, off, capb, penalty, decoded, out, n_blocks,   \
      p_tile, d, s_eff, k_pair, factor, slot_mask, n_groups, pt, stream
  if (pack32) return launch<T, true, 1>(TPQ_ARGS);
  if (k_pair <= 16) return launch<T, false, 16>(TPQ_ARGS);
  if (k_pair <= 32) return launch<T, false, 32>(TPQ_ARGS);
  return launch<T, false, 64>(TPQ_ARGS);
#undef TPQ_ARGS
}

}  // namespace

// Plain C entry point (bound with ctypes). Returns 0 or the CUDA error code
// of the attribute call or the launch. Launches on `stream`, does not
// synchronize and allocates nothing.
extern "C" int torchpq_block_scan(
    const void* qtable, const int* probers, const int* start_c,
    const int* off, const int* capb, const float* penalty,
    const void* decoded, int* out, int n_blocks, int p_tile, int d,
    int s_eff, int k_pair, int euclidean, int pack32, int slot_mask,
    int n_groups, int is_bf16, int pt, void* stream) {
  if (n_blocks <= 0 || pt <= 0 || p_tile % pt || d % 4 || k_pair < 1 ||
      k_pair > 64 || k_pair > s_eff || (pack32 && n_groups < k_pair)) {
    return (int)cudaErrorInvalidValue;
  }
  const float factor = euclidean ? 2.0f : 1.0f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch<__nv_bfloat16>(qtable, probers, start_c, off, capb,
                                   penalty, decoded, out, n_blocks, p_tile,
                                   d, s_eff, k_pair, factor, pack32,
                                   slot_mask, n_groups, pt, st);
  }
  return dispatch<float>(qtable, probers, start_c, off, capb, penalty,
                         decoded, out, n_blocks, p_tile, d, s_eff, k_pair,
                         factor, pack32, slot_mask, n_groups, pt, st);
}

// Dynamic shared memory one CTA of `pt` probers needs (the wrapper checks it
// against the card's limit before launching).
extern "C" long long torchpq_block_scan_smem(int pt, int d, int pack32,
                                             int n_groups, int is_bf16) {
  return (long long)smem_bytes(pt, d, pack32, n_groups, is_bf16 ? 2 : 4);
}
