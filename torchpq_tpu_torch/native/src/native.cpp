// Host-side native data plane of torchpq_tpu_torch: a copy of the JAX
// package's torchpq_tpu/native/src/native.cpp, so both packages run the same
// code (the spill greedy must give the same cells bit for bit).
//   * fvecs/bvecs/ivecs dataset readers (texmex/ann-benchmarks formats,
//     what SIFT1M/GIST1M ship as) — sequential mmap-speed parsing;
//   * the greedy capacity-bounded (spill) cell assigner used by
//     IVFPQIndex.add with spill_impl="host" — a tight sequential loop that
//     is pathological in Python at millions of rows.
// Exposed as a plain C ABI consumed through ctypes; built with g++ by
// torchpq_tpu_torch/native/__init__.py.

#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// .fvecs / .bvecs / .ivecs readers.
// Format: each row is [int32 d][d * sizeof(T) payload].
// Returns rows read, or -1 on error. Caller allocates out (n_max * d_expect).
// ---------------------------------------------------------------------------

static int64_t read_vecs(const char* path, int64_t n_max, int32_t d_expect,
                         int64_t elem_size, void* out,
                         int64_t offset_rows = 0) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    if (offset_rows > 0) {
        // rows are fixed-size ([int32 d][payload]) -> direct seek; lets
        // callers stream files bigger than RAM chunk by chunk
        const int64_t stride =
            sizeof(int32_t) + static_cast<int64_t>(d_expect) * elem_size;
        if (fseeko(f, offset_rows * stride, SEEK_SET) != 0) {
            fclose(f);
            return -1;
        }
    }
    int64_t row = 0;
    char* dst = static_cast<char*>(out);
    const int64_t row_bytes = static_cast<int64_t>(d_expect) * elem_size;
    while (row < n_max) {
        int32_t d = 0;
        if (fread(&d, sizeof(int32_t), 1, f) != 1) break;  // EOF
        if (d != d_expect) { fclose(f); return -1; }
        if (fread(dst, 1, row_bytes, f) != static_cast<size_t>(row_bytes)) {
            fclose(f);
            return -1;
        }
        dst += row_bytes;
        ++row;
    }
    fclose(f);
    return row;
}

int64_t read_fvecs(const char* path, int64_t n_max, int32_t d, float* out,
                   int64_t offset_rows) {
    return read_vecs(path, n_max, d, sizeof(float), out, offset_rows);
}

int64_t read_bvecs(const char* path, int64_t n_max, int32_t d, uint8_t* out,
                   int64_t offset_rows) {
    return read_vecs(path, n_max, d, sizeof(uint8_t), out, offset_rows);
}

int64_t read_ivecs(const char* path, int64_t n_max, int32_t d, int32_t* out,
                   int64_t offset_rows) {
    return read_vecs(path, n_max, d, sizeof(int32_t), out, offset_rows);
}

// Peek the dimensionality of the first row (-1 on error).
int32_t vecs_dim(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    int32_t d = 0;
    size_t got = fread(&d, sizeof(int32_t), 1, f);
    fclose(f);
    return got == 1 ? d : -1;
}

// ---------------------------------------------------------------------------
// Greedy capacity-bounded cell assignment (spill).
// top: [n, l] candidate cells per item (best first); counts: [n_cells]
// running occupancy (updated in place); cap: per-cell capacity bound.
// out: [n] chosen cell per item. Items whose candidates are all full take
// their best candidate (the container will expand that cell).
// ---------------------------------------------------------------------------

void spill_assign(const int32_t* top, int64_t n, int32_t l,
                  int64_t* counts, int64_t cap, int64_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        const int32_t* row = top + i * l;
        int32_t chosen = -1;
        for (int32_t j = 0; j < l; ++j) {
            int32_t c = row[j];
            if (counts[c] < cap) {
                chosen = c;
                break;
            }
        }
        if (chosen < 0) {
            // all candidates full: take the least-occupied one so cell
            // sizes stay bounded (the container would otherwise expand)
            chosen = row[0];
            for (int32_t j = 1; j < l; ++j) {
                if (counts[row[j]] < counts[chosen]) chosen = row[j];
            }
        }
        counts[chosen] += 1;
        out[i] = chosen;
    }
}

}  // extern "C"
