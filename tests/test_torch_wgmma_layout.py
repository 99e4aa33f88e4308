"""The index math of the warp-specialised block scan (csrc/wg_layout.cuh),
compiled with the host's g++ and checked without a card.

The header's functions are plain constexpr C++ of integers, so a small
harness built here exercises the very code the kernel (csrc/block_scan_wg.cu)
compiles: the 128-byte swizzle is a bijection of a [128][128 B] tile that
keeps each row in its line and spreads the 8 rows of an atom over 8 bank
groups; the m64nN accumulator map is a bijection of (thread, register) onto
the tile and, per warp, PTX ISA's m16n8 C fragment layout; the wgmma
descriptor's fields decode back; the TMA boxes of a block's tiles and
stages cover its window [s_eff rows][d elements] once each, in the phase
order of the deep pack32 groups, at the k-chunked widths and at the narrow
ones (d <= 128: one or two stages a tile); the k16 steps cover d; the
narrow rows' resident query buffer [2][128][128 B] is a bijection of a
block's 128 rows of 256 bytes whose 64-prober tiles' k16 steps start where
wgmma's descriptors point; and the header's shared-memory formulas (the
k-chunked and the narrow instances') equal ops/block_scan.py's mirror.
The int8 rows (one byte an element, s8 wgmma k32 steps of 32 bytes) take
the same maps in bytes: their TMA boxes {128 elements, 128 rows} cover the
window [s_eff rows][d bytes] once each at d 16 to 1024 (narrow up to 256,
k-chunked above), the k32 steps cover d, the narrow query buffer holds a
block's rows of d bytes once each where the k32 descriptors point, and
the int8 shared-memory formulas (each stage also carrying its columns'
scales) equal the mirror's. The codes rows (the codes scan's instances of
the same kernel, whose producer decodes the window) take the header's
decode map: a tile's decoded stages equal the codebook's rows of its
columns' codes in sw128_offset order, where the k16 descriptors read them,
with no byte past d written; the producer's 8-byte code copies of a
block's tiles cover the window's codes once each in column_slots order (m
8 to 128, s_eff / g below and above 128, the deep groups' phase order);
and the codes instances' shared-memory formula equals
ops/codes_scan.py's mirror."""

import shutil
import subprocess

import pytest

from torchpq_tpu_torch.ops import block_scan as bs
from torchpq_tpu_torch.ops import codes_scan as cs

from pathlib import Path

_CSRC = Path(bs.__file__).resolve().parents[1] / "csrc"

_HARNESS = r"""
#include <cstdio>
#include <cstring>
#include <random>
#include <set>
#include <utility>
#include <vector>

#include "wg_layout.cuh"

using namespace tpq::wg;

static int fails = 0;
#define CHECK(name, cond)                                   \
  do {                                                      \
    if (!(cond)) {                                          \
      if (fails++ < 20) std::printf("%s FAIL %s\n", name, #cond); \
    }                                                       \
  } while (0)

// PTX ISA, mma.m16n8k16 C fragment: lane l, c[i] at row l / 4 + 8 (i / 2),
// column 2 (l % 4) + i % 2
static int m16n8_row(int lane, int i) { return lane / 4 + 8 * (i / 2); }
static int m16n8_col(int lane, int i) { return 2 * (lane % 4) + i % 2; }

static void swizzle() {
  std::vector<int> seen(STAGE_BYTES, 0);
  for (int r = 0; r < BOX_ROWS; ++r) {
    for (int kb = 0; kb < SW_ROW; ++kb) {
      const int o = sw128_offset(r, kb);
      CHECK("swizzle", o >= 0 && o < STAGE_BYTES);
      if (o < 0 || o >= STAGE_BYTES) continue;
      seen[o] += 1;
      CHECK("swizzle", o / SW_ROW == r);    // the row keeps its line
      CHECK("swizzle", o % 16 == kb % 16);  // 16-byte pieces stay whole
    }
  }
  for (int o = 0; o < STAGE_BYTES; ++o) CHECK("swizzle", seen[o] == 1);
  // a piece column of the 8 rows of an atom: 8 distinct 16-byte groups of
  // the 128-byte line (no bank conflict among them)
  for (int a = 0; a < BOX_ROWS / 8; ++a) {
    for (int c = 0; c < 8; ++c) {
      std::set<int> groups;
      for (int r = 8 * a; r < 8 * a + 8; ++r) {
        groups.insert(sw128_offset(r, 16 * c) % SW_ROW / 16);
      }
      CHECK("swizzle", groups.size() == 8);
    }
  }
  std::printf("swizzle %s\n", fails ? "FAIL" : "OK");
}

static void accumulator() {
  const int before = fails;
  for (int n = 8; n <= 256; n *= 2) {  // m64nN: N / 2 registers a thread
    std::vector<int> seen(64 * n, 0);
    for (int t = 0; t < 128; ++t) {
      for (int r = 0; r < n / 2; ++r) {
        const int row = acc_row(t, r), col = acc_col(t, r);
        CHECK("accumulator", row >= 0 && row < 64 && col >= 0 && col < n);
        if (row < 0 || row >= 64 || col < 0 || col >= n) continue;
        seen[row * n + col] += 1;
        // warp t / 32 holds rows 16 w .. 16 w + 15 as the m16n8 fragments
        // of its n8 tiles r / 4
        CHECK("accumulator", row == 16 * (t / 32) + m16n8_row(t % 32, r % 4));
        CHECK("accumulator", col == 8 * (r / 4) + m16n8_col(t % 32, r % 4));
      }
    }
    for (int i = 0; i < 64 * n; ++i) CHECK("accumulator", seen[i] == 1);
  }
  std::printf("accumulator %s\n", fails > before ? "FAIL" : "OK");
}

static void descriptor() {
  const int before = fails;
  for (uint32_t addr = 0; addr < (1u << 18); addr += 16 * 37) {
    for (uint32_t lbo : {16u, 128u, 1024u, 8192u}) {
      for (uint32_t sbo : {16u, 1024u, 2048u, 65520u}) {
        for (uint32_t layout = 0; layout < 4; ++layout) {
          const uint64_t d = make_desc(addr, lbo, sbo, layout);
          CHECK("descriptor", desc_start(d) == addr);
          CHECK("descriptor", desc_lbo(d) == lbo);
          CHECK("descriptor", desc_sbo(d) == sbo);
          CHECK("descriptor", desc_layout(d) == layout);
          CHECK("descriptor", desc_base_offset(d) == 0);
          CHECK("descriptor", ((d >> 14) & 3) == 0 && ((d >> 30) & 3) == 0);
          CHECK("descriptor", ((d >> 46) & 7) == 0 && ((d >> 52) & 1023) == 0);
        }
      }
    }
  }
  // the k16 steps of a K-major swizzled tile: 32 bytes apart inside the
  // 128-byte row, one atom of 8 rows per stride, 128-byte swizzle
  for (uint32_t tile = 0; tile < (1u << 18); tile += SW_ATOM) {
    for (int ks = 0; ks < BOX_K / KSTEP; ++ks) {
      const uint64_t d = kmajor_desc(tile, ks);
      CHECK("descriptor", desc_start(d) == tile + 32 * ks);
      CHECK("descriptor", desc_sbo(d) == SW_ATOM);
      CHECK("descriptor", desc_layout(d) == LAYOUT_SW128);
      CHECK("descriptor", desc_base_offset(d) == 0);
    }
  }
  std::printf("descriptor %s\n", fails > before ? "FAIL" : "OK");
}

// the window's TMA boxes at widths ds (elements of e bytes): each (cache
// row, k element) of a block's window once, tiles in the deep groups'
// phase order
template <int N>
static void boxes_at(const char* name, const int (&ds)[N], int e = 2) {
  // (s_eff, G): the records' k = 10 (G = 128) and deep k = 100 (G = 512),
  // a G = 256 window and ragged ones
  const int shapes[][2] = {{2048, 128}, {2048, 512}, {512, 256},
                           {640, 128}, {200, 128}, {4096, 512}};
  const int bk = SW_ROW / e;          // k elements of a stage's box
  const int kstep = KSTEP_BYTES / e;  // k elements of a wgmma step
  for (int d : ds) {
    const int nst = stages_of(d, e);
    int covered = 0;
    for (int st = 0; st < nst; ++st) covered += kstep * ksteps_of(d, st, e);
    CHECK(name, nst * bk >= d && (nst - 1) * bk < d);
    CHECK(name, covered >= d && covered < d + kstep);
    for (int st = 0; st + 1 < nst; ++st) CHECK(name, ksteps_of(d, st, e) == 4);
    for (const auto& sh : shapes) {
      const int s_eff = sh[0], G = sh[1];
      const bool phased = G > BOX_ROWS;
      const int n_tiles = (s_eff + BOX_ROWS - 1) / BOX_ROWS;
      const int tpp = phased ? s_eff / G : n_tiles;
      const int stride = phased ? G : BOX_ROWS;
      const int s0 = 7 * BOX_ROWS + 16;  // a block's first cache row
      // every (cache row, k element) of the window once
      std::vector<int> seen((size_t)n_tiles * BOX_ROWS * nst * bk, 0);
      for (int it = 0; it < n_tiles; ++it) {
        const int ts = tile_start(it, tpp, stride);
        CHECK(name, ts % BOX_ROWS == 0 && ts < n_tiles * BOX_ROWS);
        if (phased) CHECK(name, ts % G == (it / tpp) * BOX_ROWS);
        for (int st = 0; st < nst; ++st) {
          for (int r = 0; r < BOX_ROWS; ++r) {
            for (int k = 0; k < bk; ++k) {
              const int y = box_y(s0, ts) + r - s0, x = box_x(st, e) + k;
              if (y < 0 || y >= n_tiles * BOX_ROWS || x >= nst * bk) {
                CHECK(name, false);
                continue;
              }
              seen[(size_t)y * nst * bk + x] += 1;
            }
          }
        }
      }
      for (size_t i = 0; i < seen.size(); ++i) CHECK(name, seen[i] == 1);
    }
  }
}

static void boxes() {
  const int before = fails;
  const int ds[] = {136, 160, 200, 384, 960, 1024};
  boxes_at("boxes", ds);
  std::printf("boxes %s\n", fails > before ? "FAIL" : "OK");
}

// narrow rows: d <= 128, one stage a tile up to d = 64, two above
static void narrow_boxes() {
  const int before = fails;
  const int ds[] = {8, 32, 64, 72, 128};
  boxes_at("narrow_boxes", ds);
  for (int d : ds) CHECK("narrow_boxes", stages_of(d) == (d <= 64 ? 1 : 2));
  std::printf("narrow_boxes %s\n", fails > before ? "FAIL" : "OK");
}

// the resident query buffer: byte kb of row r at qbuf_offset(r, kb), a
// bijection of [128 rows][256 bytes] onto the buffer that keeps 16-byte
// pieces whole; k half h of 64-prober tile m is the K-major swizzled
// operand at h * STAGE_BYTES + m * 8 KB (1,024-byte aligned), whose k16
// step ks starts (kmajor_desc) at row 64 m's byte 32 ks of that half
static void qbuf() {
  const int before = fails;
  std::vector<int> seen(QBUF_BYTES, 0);
  for (int r = 0; r < 128; ++r) {
    for (int kb = 0; kb < NARROW_ROW; ++kb) {
      const int o = qbuf_offset(r, kb);
      CHECK("qbuf", o >= 0 && o < QBUF_BYTES);
      if (o < 0 || o >= QBUF_BYTES) continue;
      seen[o] += 1;
      CHECK("qbuf", o % 16 == kb % 16);
      CHECK("qbuf", o / STAGE_BYTES == kb / SW_ROW);
    }
  }
  for (int o = 0; o < QBUF_BYTES; ++o) CHECK("qbuf", seen[o] == 1);
  for (int m = 0; m < 2; ++m) {
    for (int h = 0; h < 2; ++h) {
      const uint32_t tile = h * STAGE_BYTES + m * (STAGE_BYTES / 2);
      CHECK("qbuf", tile % SW_ATOM == 0);
      for (int ks = 0; ks < BOX_K / KSTEP; ++ks) {
        const uint64_t d = kmajor_desc(tile, ks);
        CHECK("qbuf", (int)desc_start(d) ==
                          qbuf_offset(64 * m, SW_ROW * h + 2 * KSTEP * ks));
      }
    }
  }
  std::printf("qbuf %s\n", fails > before ? "FAIL" : "OK");
}

// int8 rows: boxes of 128 one-byte elements, k-chunked above 256 bytes
// (three to eight stages a tile), narrow up to 256 (one or two)
static void boxes_i8() {
  const int before = fails;
  const int ds[] = {272, 288, 384, 960, 1024};
  boxes_at("boxes_i8", ds, 1);
  for (int d : ds) CHECK("boxes_i8", stages_of(d, 1) == (d + 127) / 128);
  CHECK("boxes_i8", box_x(3, 1) == 384 && box_x(3) == 192);
  std::printf("boxes_i8 %s\n", fails > before ? "FAIL" : "OK");
}

static void narrow_boxes_i8() {
  const int before = fails;
  const int ds[] = {16, 32, 128, 160, 256};
  boxes_at("narrow_boxes_i8", ds, 1);
  for (int d : ds) {
    CHECK("narrow_boxes_i8", d <= NARROW_ROW);
    CHECK("narrow_boxes_i8", stages_of(d, 1) == (d <= 128 ? 1 : 2));
    // the k32 steps: 32 bytes each, the last one's bytes past d zeros
    CHECK("narrow_boxes_i8", ksteps_of(d, 0, 1) == (d >= 128 ? 4 : (d + 31) / 32));
  }
  std::printf("narrow_boxes_i8 %s\n", fails > before ? "FAIL" : "OK");
}

// the narrow query buffer of int8 rows of d bytes (d <= 256): each byte of
// a block's 128 rows once, inside k half kb / 128, 16-byte pieces whole;
// the k32 step ks of half h of 64-prober tile m starts (kmajor_desc) at
// row 64 m's byte 128 h + 32 ks, for the ksteps_of(d, h, 1) steps a row
// of d bytes takes
static void qbuf_i8() {
  const int before = fails;
  for (int d : {16, 48, 128, 160, 256}) {
    std::vector<int> seen(QBUF_BYTES, 0);
    for (int r = 0; r < 128; ++r) {
      for (int kb = 0; kb < d; ++kb) {
        const int o = qbuf_offset(r, kb);
        CHECK("qbuf_i8", o >= 0 && o < QBUF_BYTES);
        if (o < 0 || o >= QBUF_BYTES) continue;
        seen[o] += 1;
        CHECK("qbuf_i8", o % 16 == kb % 16);
        CHECK("qbuf_i8", o / STAGE_BYTES == kb / SW_ROW);
      }
    }
    for (int o = 0; o < QBUF_BYTES; ++o) CHECK("qbuf_i8", seen[o] <= 1);
    for (int m = 0; m < 2; ++m) {
      for (int h = 0; h < stages_of(d, 1); ++h) {
        const uint32_t tile = h * STAGE_BYTES + m * (STAGE_BYTES / 2);
        for (int ks = 0; ks < ksteps_of(d, h, 1); ++ks) {
          const uint64_t desc = kmajor_desc(tile, ks);
          CHECK("qbuf_i8", (int)desc_start(desc) ==
                               qbuf_offset(64 * m, SW_ROW * h + 32 * ks));
          CHECK("qbuf_i8", SW_ROW * h + 32 * ks < d);
        }
      }
    }
  }
  std::printf("qbuf_i8 %s\n", fails > before ? "FAIL" : "OK");
}

// codes rows: the decode of a tile (every pass, every producer thread's
// chunk items) against a random codebook, at each (m, dsub) with d = m dsub
// <= 128, d % 8 == 0: element k of column cl lies at byte 2k % 128 of row
// cl in stage 2k / 128 (sw128_offset: where a k16 descriptor of the row's
// 64-row half reads it), and every byte past 2d keeps its fill
static void codes_decode() {
  const int before = fails;
  const int shapes[][2] = {{8, 4},  {8, 5},  {8, 13}, {8, 16}, {16, 2},
                           {16, 6}, {32, 3}, {32, 4}, {64, 2}, {64, 1},
                           {128, 1}};
  std::mt19937 rng(7);
  for (const auto& sh : shapes) {
    const int m = sh[0], dsub = sh[1], d = m * dsub;
    std::vector<uint16_t> cb((size_t)m * 256 * dsub);
    for (auto& x : cb) x = (uint16_t)rng();
    std::vector<unsigned char> codes((size_t)BOX_ROWS * m);
    for (auto& x : codes) x = (unsigned char)rng();
    std::vector<unsigned char> st(2 * STAGE_BYTES, 0xAB);
    const int lc = __builtin_ctz(pass_chunks(m));
    CHECK("codes_decode", codes_passes(m) * pass_chunks(m) * CODE_CHUNK == m);
    for (int ps = 0; ps < codes_passes(m); ++ps) {
      for (int t = 0; t < 128; ++t) {
        for (int e = t; e < (BOX_ROWS << lc); e += 128) {
          int cl, ch;
          chunk_item(e, lc, cl, ch);
          const int chunk = (ps << lc) + ch;
          uint32_t w[2];
          std::memcpy(w, &codes[(size_t)cl * m + CODE_CHUNK * chunk], 8);
          decode_chunk(w[0], w[1], cb.data(), dsub, chunk, cl, st.data(),
                       st.data() + STAGE_BYTES);
        }
      }
    }
    for (int cl = 0; cl < BOX_ROWS; ++cl) {
      for (int kb = 0; kb < 2 * SW_ROW; ++kb) {
        const unsigned char got =
            st[(kb / SW_ROW) * STAGE_BYTES + sw128_offset(cl, kb % SW_ROW)];
        if (kb >= 2 * d) {
          CHECK("codes_decode", got == 0xAB);
          continue;
        }
        const int k = kb / 2, i = k / dsub;
        const uint16_t want =
            cb[((size_t)i * 256 + codes[(size_t)cl * m + i]) * dsub +
               k % dsub];
        CHECK("codes_decode", got == ((kb % 2) ? want >> 8 : want & 0xFF));
      }
    }
    // the rows' k16 steps as the consumers' descriptors address them:
    // 64-row half h of a stage, step ks, at row 64 h's byte 32 ks
    for (int h = 0; h < 2; ++h) {
      for (int ks = 0; ks < ksteps_of(d, 0); ++ks) {
        CHECK("codes_decode",
              (int)desc_start(kmajor_desc(h * STAGE_BYTES / 2, ks)) ==
                  sw128_offset(64 * h, KSTEP_BYTES * ks));
      }
    }
  }
  std::printf("codes_decode %s\n", fails > before ? "FAIL" : "OK");
}

// codes rows: the producer's cp.async copies of a block's tiles (tile
// order as the kernel's, every pass, every thread's items of columns <
// nrow) read each byte of the window's codes [s0 m, (s0 + s_eff) m) once,
// column c of the window from slot (c % s_rows) g + c / s_rows, and land
// inside the raw slot at distinct bytes within a pass
static void codes_fetch() {
  const int before = fails;
  for (int m : {8, 16, 32, 64, 128}) {
    const int g = 128 / m;
    // (s_eff, G): s_rows below 128, at it, above it and ragged; one tile;
    // the deep groups' phase order
    const int shapes[][2] = {{64 * g, 128}, {128 * g, 128}, {1024, 128},
                             {1024, 512}, {2048, 256}, {200 * g, 128},
                             {96, 96}};
    const int lc = __builtin_ctz(pass_chunks(m));
    for (const auto& sh : shapes) {
      const int s_eff = sh[0], G = sh[1];
      if (s_eff % g) continue;
      const int s_rows = s_eff / g;
      const float inv = 1.0f / (float)s_rows;
      const bool phased = G > BOX_ROWS;
      const int n_tiles = (s_eff + BOX_ROWS - 1) / BOX_ROWS;
      const int tpp = phased ? s_eff / G : n_tiles;
      const int stride = phased ? G : BOX_ROWS;
      const int s0 = 48;  // a block's first slot (16-aligned)
      std::vector<int> seen((size_t)s_eff * m, 0);
      for (int it = 0; it < n_tiles; ++it) {
        const int ts = tile_start(it, tpp, stride);
        const int nrow = BOX_ROWS < s_eff - ts ? BOX_ROWS : s_eff - ts;
        for (int ps = 0; ps < codes_passes(m); ++ps) {
          std::vector<int> raw(codes_raw_bytes(m), 0);
          for (int t = 0; t < 128; ++t) {
            for (int e = t; e < (BOX_ROWS << lc); e += 128) {
              int cl, ch;
              chunk_item(e, lc, cl, ch);
              CHECK("codes_fetch", cl >= 0 && cl < BOX_ROWS && ch >= 0 &&
                                       ch < (1 << lc));
              if (cl >= nrow) continue;
              const int c = ts + cl;
              const int j = col_slot(c, s_rows, g, inv);
              CHECK("codes_fetch", j == (c % s_rows) * g + c / s_rows);
              const long src = ((long)s0 + j) * m +
                               CODE_CHUNK * ((ps << lc) + ch) - (long)s0 * m;
              const int dst = cl * (CODE_CHUNK << lc) + CODE_CHUNK * ch;
              CHECK("codes_fetch", dst >= 0 && dst + 8 <= codes_raw_bytes(m));
              CHECK("codes_fetch", src >= 0 && src + 8 <= (long)s_eff * m);
              if (src < 0 || src + 8 > (long)s_eff * m || dst < 0 ||
                  dst + 8 > codes_raw_bytes(m)) {
                continue;
              }
              for (int x = 0; x < 8; ++x) {
                seen[src + x] += 1;
                raw[dst + x] += 1;
              }
            }
          }
          for (int x : raw) CHECK("codes_fetch", x <= 1);
        }
      }
      for (int x : seen) CHECK("codes_fetch", x == 1);
    }
  }
  // col_slot's f32 quotient, corrected, over a wide range of columns
  for (int s_rows : {1, 3, 64, 100, 127, 128, 200, 512, 1000, 4096}) {
    const float inv = 1.0f / (float)s_rows;
    for (int c = 0; c < (1 << 16); c += 7) {
      CHECK("codes_fetch",
            col_slot(c, s_rows, 5, inv) == (c % s_rows) * 5 + c / s_rows);
    }
  }
  std::printf("codes_fetch %s\n", fails > before ? "FAIL" : "OK");
}

int main() {
  swizzle();
  accumulator();
  descriptor();
  boxes();
  narrow_boxes();
  qbuf();
  boxes_i8();
  narrow_boxes_i8();
  qbuf_i8();
  codes_decode();
  codes_fetch();
  for (int pack32 = 0; pack32 < 2; ++pack32) {
    for (int k_pair = 1; k_pair <= 64; ++k_pair) {
      if (!pack32 && k_pair > 16) break;
      for (const auto& md : {std::pair<int, int>{64, 2}, {32, 4}, {128, 1},
                             {8, 4}, {8, 5}, {16, 8}}) {
        std::printf("codes_smem %d %d %d %d %zu %d\n", md.first, md.second,
                    pack32, k_pair,
                    codes_smem_bytes(md.first, md.second, pack32, k_pair),
                    codes_ring_of(pack32, k_pair));
      }
    }
  }
  for (int pack32 = 0; pack32 < 2; ++pack32) {
    for (int k_pair = 1; k_pair <= 64; ++k_pair) {
      if (!pack32 && k_pair > 16) break;
      std::printf("smem %d %d %zu\n", pack32, k_pair,
                  smem_bytes(pack32, k_pair));
      std::printf("narrow_smem %d %d %zu %d %d\n", pack32, k_pair,
                  narrow_smem_bytes(pack32, k_pair),
                  narrow_ring_of(pack32, k_pair),
                  narrow_qbufs_of(pack32, k_pair));
      std::printf("i8_smem %d %d %zu\n", pack32, k_pair,
                  smem_bytes(pack32, k_pair, 0, 1));
      std::printf("i8_narrow_smem %d %d %zu %d %d\n", pack32, k_pair,
                  narrow_smem_bytes(pack32, k_pair, 0, 1),
                  narrow_ring_of(pack32, k_pair, 1),
                  narrow_qbufs_of(pack32, k_pair));
    }
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """The harness built with g++ against csrc/ and run once: its lines."""
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to compile csrc/wg_layout.cuh"
    work = tmp_path_factory.mktemp("wg_layout")
    src = work / "harness.cpp"
    src.write_text(_HARNESS)
    exe = work / "harness"
    subprocess.run([gxx, "-std=c++17", "-O1", "-Wall", "-Werror",
                    f"-I{_CSRC}", str(src), "-o", str(exe)], check=True,
                   capture_output=True, text=True)
    res = subprocess.run([str(exe)], check=True, capture_output=True,
                         text=True, timeout=120)
    return res.stdout.splitlines()


@pytest.mark.parametrize("check", ["swizzle", "accumulator", "descriptor",
                                   "boxes", "narrow_boxes", "qbuf",
                                   "boxes_i8", "narrow_boxes_i8", "qbuf_i8",
                                   "codes_decode", "codes_fetch"])
def test_layout_map(harness, check):
    """Each map of the header holds its properties (see the module
    docstring); the harness prints the first failing condition."""
    lines = [x for x in harness if x.split()[0] == check]
    assert lines and lines[-1] == f"{check} OK", "\n".join(lines)


def test_smem_formula_matches_mirror(harness):
    """csrc/wg_layout.cuh:smem_bytes equals ops/block_scan.py:wg_smem_bytes
    at every exact k_pair 1-16 and pack32 k_pair 1-64, and every such shape
    fits the limit (four ring stages above pack32 k_pair 16)."""
    rows = [x.split() for x in harness if x.startswith("smem ")]
    assert len(rows) == 16 + 64
    for _, pack32, k_pair, nbytes in rows:
        pack32, k_pair, nbytes = int(pack32), int(k_pair), int(nbytes)
        assert bs.wg_smem_bytes(pack32, k_pair) == nbytes, (pack32, k_pair)
        assert nbytes <= bs._SMEM_LIMIT


def test_narrow_smem_formula_matches_mirror(harness):
    """csrc/wg_layout.cuh:narrow_smem_bytes, and the ring stages and query
    buffers of the narrow instance that serves each k_pair, equal
    ops/block_scan.py's mirror (wg_smem_bytes at d <= 128,
    wg_narrow_instance) at every exact k_pair 1-16 and pack32 k_pair 1-64;
    every such shape fits the limit, and one more ring stage would not at
    each instance's largest k_pair."""
    rows = [x.split() for x in harness if x.startswith("narrow_smem ")]
    assert len(rows) == 16 + 64
    for _, pack32, k_pair, nbytes, ring, qbufs in rows:
        pack32, k_pair = int(pack32), int(k_pair)
        for d in (8, 72, 128):
            assert bs.wg_smem_bytes(pack32, k_pair, d) == int(nbytes), \
                (pack32, k_pair, d)
        assert bs.wg_narrow_instance(pack32, k_pair)[1:] \
            == (int(ring), int(qbufs)), (pack32, k_pair)
        assert int(nbytes) <= bs._SMEM_LIMIT
        if k_pair in ((10, 16) if not pack32 else (16, 64)):
            stage = bs._WG_STAGE_BYTES + 4 * bs._WG_BOX_ROWS + 16
            assert int(nbytes) + stage > bs._SMEM_LIMIT, (pack32, k_pair)


def test_int8_smem_formula_matches_mirror(harness):
    """The int8 instances' shared memory (csrc/wg_layout.cuh:smem_bytes and
    narrow_smem_bytes with i8, each stage carrying its columns' scales
    beside their penalties) equals ops/block_scan.py:wg_smem_bytes over an
    int8 cache at every exact k_pair 1-16 and pack32 k_pair 1-64, k-chunked
    (d 272 and 1024) and narrow (d 16, 128 and 256); the narrow ring
    stages and query buffers equal wg_narrow_instance's; every such shape
    fits the limit, and one more ring stage would not at each instance's
    largest k_pair (the narrow pack32 instance of k_pair <= 16: seven
    stages, where the bf16 one has eight)."""
    k_rows = [x.split() for x in harness if x.startswith("i8_smem ")]
    n_rows = [x.split() for x in harness if x.startswith("i8_narrow_smem ")]
    assert len(k_rows) == len(n_rows) == 16 + 64
    i8 = bs.torch.int8
    stage = bs._WG_STAGE_BYTES + 4 * bs._WG_BOX_ROWS + bs._WG_SCALE_BYTES + 16
    for _, pack32, k_pair, nbytes in k_rows:
        pack32, k_pair, nbytes = int(pack32), int(k_pair), int(nbytes)
        for d in (272, 1024):
            assert bs.wg_smem_bytes(pack32, k_pair, d, i8) == nbytes, \
                (pack32, k_pair, d)
        assert nbytes <= bs._SMEM_LIMIT
        assert nbytes == bs.wg_smem_bytes(pack32, k_pair) + \
            bs.wg_ring(pack32, k_pair) * bs._WG_SCALE_BYTES
        if k_pair in ((10, 16) if not pack32 else (16, 64)):
            assert nbytes + stage + bs._WG_STAGE_BYTES > bs._SMEM_LIMIT
    for _, pack32, k_pair, nbytes, ring, qbufs in n_rows:
        pack32, k_pair = int(pack32), int(k_pair)
        for d in (16, 128, 256):
            assert bs.wg_smem_bytes(pack32, k_pair, d, i8) == int(nbytes), \
                (pack32, k_pair, d)
        assert bs.wg_narrow_instance(pack32, k_pair, i8)[1:] \
            == (int(ring), int(qbufs)), (pack32, k_pair)
        assert int(nbytes) <= bs._SMEM_LIMIT
        if k_pair in ((10, 16) if not pack32 else (16, 64)):
            assert int(nbytes) + stage > bs._SMEM_LIMIT, (pack32, k_pair)
    assert bs.wg_narrow_instance(1, 16, i8)[1] == 7
    assert bs.wg_narrow_instance(1, 16)[1] == 8


def test_codes_smem_formula_matches_mirror(harness):
    """csrc/wg_layout.cuh:codes_smem_bytes (the codes instances of
    block_scan_wg.cu) and its ring stages equal ops/codes_scan.py's mirror
    (wg_smem_bytes, wg_ring) at every exact k_pair 1-16 and pack32 k_pair
    1-64, at PQ64, the 4-bit byte pairs, PQ128, PQ8 and PQ16 of d 32-128;
    every shape fits the limit with its ring, and the next stage would not
    at the exact k_pair 16 and pack32 k_pair 16 instances' largest select
    at d = 128 (PQ64)."""
    rows = [x.split() for x in harness if x.startswith("codes_smem ")]
    assert len(rows) == 6 * (16 + 64)
    for _, m, dsub, pack32, k_pair, nbytes, ring in rows:
        m, dsub, pack32, k_pair = int(m), int(dsub), int(pack32), int(k_pair)
        assert cs.wg_smem_bytes(m=m, dsub=dsub, pack32=pack32,
                                k_pair=k_pair) == int(nbytes), \
            (m, dsub, pack32, k_pair)
        assert cs.wg_ring(pack32, k_pair) == int(ring)
        assert int(nbytes) <= cs._SMEM_LIMIT
    stage = bs._WG_STAGE_BYTES + 4 * bs._WG_BOX_ROWS + 16
    for pack32 in (0, 1):
        got = cs.wg_smem_bytes(m=64, dsub=2, pack32=pack32, k_pair=16)
        assert got + stage + 4 * bs._WG_BOX_ROWS * pack32 > cs._SMEM_LIMIT


# A tile's decode as the codes instances' producer runs it (every pass,
# every thread's chunk items, wg_layout.cuh:chunk_item and decode_chunk):
# argv m dsub; stdin the codebook [m][256][dsub] bf16 bits, then the codes
# [128][m]; stdout the two stages [2][128][128 B], 0xAB where not written.
_DECODE = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>

#include "wg_layout.cuh"

using namespace tpq::wg;

int main(int argc, char** argv) {
  const int m = std::atoi(argv[1]), dsub = std::atoi(argv[2]);
  std::vector<uint16_t> cb((size_t)m * 256 * dsub);
  std::vector<unsigned char> codes((size_t)BOX_ROWS * m);
  if (std::fread(cb.data(), 2, cb.size(), stdin) != cb.size() ||
      std::fread(codes.data(), 1, codes.size(), stdin) != codes.size()) {
    return 1;
  }
  std::vector<unsigned char> st(2 * STAGE_BYTES, 0xAB);
  const int lc = __builtin_ctz(pass_chunks(m));
  for (int ps = 0; ps < codes_passes(m); ++ps) {
    for (int t = 0; t < 128; ++t) {
      for (int e = t; e < (BOX_ROWS << lc); e += 128) {
        int cl, ch;
        chunk_item(e, lc, cl, ch);
        const int chunk = (ps << lc) + ch;
        const unsigned char* c = &codes[(size_t)cl * m + CODE_CHUNK * chunk];
        const uint32_t lo = c[0] | c[1] << 8 | c[2] << 16 | (uint32_t)c[3] << 24;
        const uint32_t hi = c[4] | c[5] << 8 | c[6] << 16 | (uint32_t)c[7] << 24;
        decode_chunk(lo, hi, cb.data(), dsub, chunk, cl, st.data(),
                     st.data() + STAGE_BYTES);
      }
    }
  }
  std::fwrite(st.data(), 1, st.size(), stdout);
  return 0;
}
"""


@pytest.fixture(scope="module")
def decoder(tmp_path_factory):
    """The tile decoder built with g++ against csrc/."""
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to compile csrc/wg_layout.cuh"
    work = tmp_path_factory.mktemp("wg_decode")
    (work / "decode.cpp").write_text(_DECODE)
    exe = work / "decode"
    subprocess.run([gxx, "-std=c++17", "-O1", "-Wall", "-Werror",
                    f"-I{_CSRC}", str(work / "decode.cpp"), "-o", str(exe)],
                   check=True, capture_output=True, text=True)
    return exe


def _sw128(row, kb):
    return ((row // 8) * 1024 + (row % 8) * 128
            + ((kb // 16) ^ (row % 8)) * 16 + kb % 16)


@pytest.mark.parametrize("m,dsub", [(64, 2), (32, 4), (128, 1), (8, 9),
                                    (16, 5), (8, 3)])
def test_decoded_stages_equal_decode_codes(decoder, m, dsub):
    """The codes instances' decode of a tile of 128 columns (the producer's
    every pass and thread) holds ops/codes_scan.py:decode_codes' bf16 rows:
    byte kb of column cl's row in stage kb / 128 at sw128_offset(cl, kb %
    128), where the k16 descriptors read it (test_layout_map[qbuf]); the
    bytes past the row's 2 d untouched. PQ64, the 4-bit byte pairs, PQ128
    (two passes), and rows of d 72, 80 and 24 (a ragged k half)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(m * 100 + dsub)
    cb = rng.integers(0, 1 << 16, (m, 256, dsub), dtype=np.uint16)
    codes = rng.integers(0, 256, (128, m), dtype=np.uint8)
    res = subprocess.run([str(decoder), str(m), str(dsub)], check=True,
                         input=cb.tobytes() + codes.tobytes(),
                         capture_output=True, timeout=60)
    got = np.frombuffer(res.stdout, dtype=np.uint8)
    assert got.size == 2 * bs._WG_STAGE_BYTES
    rows = cs.decode_codes(
        torch.from_numpy(codes),
        torch.from_numpy(cb.view(np.int16)).view(torch.bfloat16))
    want = rows.view(torch.int16).numpy().view(np.uint8).reshape(128, -1)
    d = m * dsub
    assert want.shape[1] == 2 * d
    for cl in range(128):
        for kb in range(256):
            o = (kb // 128) * bs._WG_STAGE_BYTES + _sw128(cl, kb % 128)
            assert got[o] == (want[cl, kb] if kb < 2 * d else 0xAB), (cl, kb)
