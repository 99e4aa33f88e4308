// Shared core of the CUDA-core IVF block scans (block_scan.cu,
// codes_scan.cu) and of the fused flat scan (flat_scan.cu, which runs
// scan_rows over runs of the whole cache with its own select); the
// tensor-core kernels (block_scan_wg.cu, through scan_tc.cuh too, and
// flat_scan_tc.cu) take only its helpers (sortable, insert,
// launch_kernel).
//
// A block is up to p_tile probers (queries) of one IVF cell; one CTA scores
// `pt` of them (one prober per thread) against the block's window of s_eff
// columns. A Window type fills one shared-memory tile of TS columns at a
// time: the candidate rows as f32 [TS][d], the penalty of each column
// (norm-or-BIG plus the out-of-cell mask) and the in-window slot each column
// holds. block_scan.cu's window reads decoded cache rows, column c = slot c;
// codes_scan.cu's decodes PQ codes against a shared-memory codebook and
// visits the slots in the packed column order. Scoring and both selects are
// this file's, so those two kernels' scores agree bit for bit on equal rows
// (the tensor-core codes scan, block_scan_wg.cu's codes instances, sums in
// another order).
//
//   score = factor * <q_p, y_c> - pen_c      (f32 FMA chain, k ascending)
//
//   exact  -> [B, p_tile, 2*k_pair] int32: sortable keys ++ absolute
//             addresses (start_c + slot), ordered by value descending then
//             by visit (column) order — the "first maximal column per pass"
//             order; entries with value <= -BIG/2 are dead: sortable(-inf)
//             and -1.
//   pack32 -> [B, p_tile, k_pair] int32: key = (sortable(score) & ~slot_mask)
//             | slot, reduced to one winner per strided group of COLUMNS
//             (group j holds columns j, j+G, j+2G, ...), then the k_pair
//             largest group winners, descending. Keys are unique per row.
//
// The int8 cache mode (scan_rows_int8, below) scores exact integer products
// dequantized by one fused multiply-add, with the same selects.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cfloat>
#include <climits>
#include <cstddef>

namespace tpq {

constexpr int TS = 16;  // window columns per shared-memory tile
constexpr int U = 8;    // columns scored per register tile

__device__ __forceinline__ int sortable(float x) {
  const int i = __float_as_int(x);
  return i < 0 ? (i ^ 0x7FFFFFFF) : i;
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float big_penalty() { return FLT_MAX / 4.0f; }

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

// Keep v[0..KMAX) sorted by value descending, visit order on ties: a new
// entry goes after every entry whose value is >= its own.
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

// Dynamic shared memory of the core: query rows [pt][d+4] (elem_size
// bytes each), the f32 tile [TS][d], penalties and slots [TS], prober rows
// [pt], pack32 group maxima [n_groups][pt]. 16-byte multiple, so a kernel
// may place its own data right after it.
__host__ __device__ inline size_t core_smem_bytes(int pt, int d, int pack32,
                                                  int n_groups,
                                                  int elem_size) {
  const size_t bytes =
      (size_t)elem_size * pt * (d + 4) +
      sizeof(float) * ((size_t)TS * d + TS) +
      sizeof(int) * ((size_t)TS + pt + (pack32 ? (size_t)n_groups * pt : 0));
  return (bytes + 15) / 16 * 16;
}

// The two selects of the block scans. Each thread owns one row (prober)
// and offers the scores of its columns in visit order with push(score,
// slot, column); write() emits the row in the wire format.
//
// exact: a sorted top-KMAX list in registers (ties keep visit order).
template <int KMAX>
struct ExactSelect {
  float vals[KMAX];
  int slots[KMAX];

  __device__ __forceinline__ ExactSelect() {
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      vals[i] = neg_inf();
      slots[i] = 0;
    }
  }
  __device__ __forceinline__ void push(float sc, int j, int) {
    insert<KMAX>(vals, slots, sc, j);
  }
  // o: the row's 2*k_pair outputs; s0: the window's absolute start
  __device__ __forceinline__ void write(int* o, int k_pair, int s0) const {
    const float big = big_penalty();
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      if (i < k_pair) {
        const bool alive = vals[i] > -big / 2.0f;
        o[i] = sortable(alive ? vals[i] : neg_inf());
        o[k_pair + i] = alive ? s0 + slots[i] : -1;
      }
    }
  }
};

// pack32: one maximal key per strided group of columns, kept in shared
// memory (best points at this thread's column of the [n_groups][pt] maxima).
struct PackSelect {
  int* best;
  int pt, n_groups, slot_mask;

  __device__ __forceinline__ PackSelect(int* best_, int pt_, int n_groups_,
                                        int slot_mask_)
      : best(best_), pt(pt_), n_groups(n_groups_), slot_mask(slot_mask_) {
    for (int g = 0; g < n_groups; ++g) best[g * pt] = INT_MIN;
  }
  __device__ __forceinline__ void push(float sc, int j, int col) {
    const int key = (sortable(sc) & ~slot_mask) | j;
    int* bp = best + (col % n_groups) * pt;
    *bp = max(*bp, key);
  }
  // o: the row's k_pair outputs
  __device__ __forceinline__ void write(int* o, int k_pair) const {
    for (int i = 0; i < k_pair; ++i) {
      int m = INT_MIN;
      int gi = 0;
      for (int g = 0; g < n_groups; ++g) {
        const int v = best[g * pt];
        if (v > m) {
          m = v;
          gi = g;
        }
      }
      o[i] = m;
      best[gi * pt] = INT_MIN;
    }
  }
};

// The scan of one CTA's rows over one window of s_eff columns, f32 tiles.
// Every thread of the CTA calls it with its own query row `prow` (>= 0;
// padding rows pass 0 and discard the result); `smem` is the core's shared
// memory. Window::load(ts, nrow, y_s, pen_s, slot_s) fills columns
// [ts, ts + nrow) of the tile (rows past nrow zero) and the penalty and slot
// of each. Each column's score goes to sel.push(score, slot, column).
template <typename T, typename Window, typename Select>
__device__ __forceinline__ void scan_rows(const Window& win,
                                          unsigned char* smem,
                                          const T* __restrict__ qtable,
                                          int prow, int d, int s_eff,
                                          float factor, Select& sel) {
  const int pt = blockDim.x;
  const int ldq = d + 4;  // padded rows: 4-element reads of q_s are
                          // conflict-free
  T* q_s = reinterpret_cast<T*>(smem);                            // [pt][ldq]
  float* y_s = reinterpret_cast<float*>(q_s + (size_t)pt * ldq);  // [TS][d]
  float* pen_s = y_s + TS * d;                         // [TS]
  int* slot_s = reinterpret_cast<int*>(pen_s + TS);    // [TS]
  int* prow_s = slot_s + TS;                           // [pt]
  const int t = threadIdx.x;

  prow_s[t] = prow;
  __syncthreads();
  for (int r = 0; r < pt; ++r) {
    const T* src = qtable + (size_t)prow_s[r] * d;
    for (int k = t; k < d; k += pt) q_s[r * ldq + k] = src[k];
  }

  const T* qrow = q_s + (size_t)t * ldq;
  for (int ts = 0; ts < s_eff; ts += TS) {
    __syncthreads();  // previous tile fully consumed
    const int nrow = min(TS, s_eff - ts);
    win.load(ts, nrow, y_s, pen_s, slot_s);
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
          sel.push(factor * acc[u] - pen_s[jl], slot_s[jl], ts + jl);
        }
      }
    }
  }
}

// Start of the pack32 group maxima in the core's shared memory (after the
// query rows, tile, penalties, slots and prober rows).
template <typename T>
__device__ __forceinline__ int* core_best(unsigned char* smem, int pt,
                                          int d) {
  float* y_s = reinterpret_cast<float*>(reinterpret_cast<T*>(smem) +
                                        (size_t)pt * (d + 4));
  return reinterpret_cast<int*>(y_s + TS * d + TS) + TS + pt;
}

// The scan of one CTA's probers over one block's window: scan_rows with the
// block's prober rows and the select of the mode, then the row's output.
template <typename T, bool PACK, int KMAX, typename Window>
__device__ __forceinline__ void scan_block(
    const Window& win, unsigned char* smem, const T* __restrict__ qtable,
    const int* __restrict__ probers, int* __restrict__ out, int p_tile,
    int d, int s_eff, int k_pair, float factor, int slot_mask, int n_groups,
    int s0) {
  const int pt = blockDim.x;
  const int t = threadIdx.x;
  const int p = blockIdx.y * pt + t;
  const size_t row = (size_t)blockIdx.x * p_tile + p;
  const int pr = probers[row];
  const int prow = pr < 0 ? 0 : pr;  // padding rows score query 0, never read
  if constexpr (PACK) {
    PackSelect sel(core_best<T>(smem, pt, d) + t, pt, n_groups, slot_mask);
    scan_rows<T>(win, smem, qtable, prow, d, s_eff, factor, sel);
    sel.write(out + row * k_pair, k_pair);
  } else {
    ExactSelect<KMAX> sel;
    scan_rows<T>(win, smem, qtable, prow, d, s_eff, factor, sel);
    sel.write(out + row * 2 * k_pair, k_pair, s0);
  }
}

// ---- int8 cache (the block scan's int8 mode) ----
//
//   ab    = sum_k q8[p, k] * y8[j, k]          (exact, int32 via __dp4a)
//   m     = (factor * q_scale[p]) * scale[j]   (f32, in that order)
//   score = fmaf(float(ab), m, -pen_j)         (one rounding)
//
// The products run on __dp4a (four int8 products summed into an int32 per
// instruction) rather than on the f32 FMA chain of scan_rows: it is exact
// at any d, where f32 sums of int8 products are exact only while
// d * 127^2 < 2^24 (d <= 1040, and the GIST-class cache is 1024 wide); it
// needs a quarter of the instructions; and the window tile stays int8 in
// shared memory ([TS][d] bytes, 16 KB at d = 1024 against 64 KB of f32),
// with int8 query rows ([pt][d + 16] bytes), so a d = 1024 cache fits 128
// probers per CTA with the pack32 group maxima. Converting ab to f32 rounds
// as the JAX package's astype(float32) does.

// Dynamic shared memory of the int8 core: query rows [pt][d+16] int8, the
// int8 tile [TS][d], penalties, scales and slots [TS], prober rows [pt],
// pack32 group maxima [n_groups][pt]. d % 16 == 0.
__host__ __device__ inline size_t int8_smem_bytes(int pt, int d, int pack32,
                                                  int n_groups) {
  const size_t bytes =
      (size_t)pt * (d + 16) + (size_t)TS * d +
      sizeof(float) * 2 * (size_t)TS +
      sizeof(int) * ((size_t)TS + pt + (pack32 ? (size_t)n_groups * pt : 0));
  return (bytes + 15) / 16 * 16;
}

template <typename Window, typename Select>
__device__ __forceinline__ void scan_rows_int8(
    const Window& win, unsigned char* smem,
    const signed char* __restrict__ qtable, int prow, float qmul, int d,
    int s_eff, Select& sel) {
  const int pt = blockDim.x;
  const int ldq = d + 16;  // 16-byte reads of the rows, odd 16-byte stride
  signed char* q_s = reinterpret_cast<signed char*>(smem);  // [pt][ldq]
  signed char* y_s = q_s + (size_t)pt * ldq;                 // [TS][d]
  float* pen_s = reinterpret_cast<float*>(y_s + TS * d);     // [TS]
  float* sc_s = pen_s + TS;                                  // [TS]
  int* slot_s = reinterpret_cast<int*>(sc_s + TS);           // [TS]
  int* prow_s = slot_s + TS;                                 // [pt]
  const int t = threadIdx.x;

  prow_s[t] = prow;
  __syncthreads();
  const int nv = d / 16;
  for (int e = t; e < pt * nv; e += pt) {
    const int r = e / nv;
    const int c = e - r * nv;
    *reinterpret_cast<int4*>(q_s + (size_t)r * ldq + 16 * c) =
        __ldg(reinterpret_cast<const int4*>(
            qtable + (size_t)prow_s[r] * d + 16 * c));
  }

  const signed char* qrow = q_s + (size_t)t * ldq;
  for (int ts = 0; ts < s_eff; ts += TS) {
    __syncthreads();  // previous tile fully consumed
    const int nrow = min(TS, s_eff - ts);
    win.load(ts, nrow, y_s, pen_s, sc_s, slot_s);
    __syncthreads();
    for (int u0 = 0; u0 < nrow; u0 += U) {
      int acc[U];
#pragma unroll
      for (int u = 0; u < U; ++u) acc[u] = 0;
      for (int k = 0; k < d; k += 16) {
        const int4 qv = *reinterpret_cast<const int4*>(qrow + k);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int4 yv =
              *reinterpret_cast<const int4*>(y_s + (u0 + u) * d + k);
          acc[u] = __dp4a(qv.x, yv.x, acc[u]);
          acc[u] = __dp4a(qv.y, yv.y, acc[u]);
          acc[u] = __dp4a(qv.z, yv.z, acc[u]);
          acc[u] = __dp4a(qv.w, yv.w, acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int jl = u0 + u;
        if (jl < nrow) {
          const float m = qmul * sc_s[jl];
          sel.push(fmaf(__int2float_rn(acc[u]), m, -pen_s[jl]), slot_s[jl],
                   ts + jl);
        }
      }
    }
  }
}

// Start of the pack32 group maxima in the int8 core's shared memory.
__device__ __forceinline__ int* int8_best(unsigned char* smem, int pt,
                                          int d) {
  return reinterpret_cast<int*>(smem + (size_t)pt * (d + 16) +
                                (size_t)TS * d + 2 * sizeof(float) * TS) +
         TS + pt;
}

// Raise the kernel's dynamic shared-memory limit to `smem`, with all of L1
// as shared memory, then launch it; returns the CUDA error code.
template <typename Kernel, typename... Args>
int launch_kernel(Kernel kern, dim3 grid, int pt, size_t smem,
                  cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, pt, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace tpq
