// The index math of the warp-specialised block scan (block_scan_wg.cu, bf16
// and int8 rows): pure functions of integers, callable from host and device
// code, so that tests/test_torch_wgmma_layout.py compiles this header with
// the host's g++ and checks each map without a card. Nothing here touches a
// GPU. The maps are in bytes wherever the operand's element size enters: a
// swizzled row is 128 bytes (64 bf16 or 128 int8 elements) and a k step 32
// bytes (wgmma k16 for bf16, k32 for s8), so e = 2 (bf16) or 1 (int8)
// changes only how many elements a stage and a step cover.
//
// - The 128-byte swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_128B and wgmma's
//   layout type 1) of a tile of 128-byte rows: 16-byte piece c of row r
//   lies in piece c ^ (r % 8) of the row, and eight rows make a 1,024-byte
//   atom (PTX ISA, "Shared Memory Matrix Layout", 128B swizzling mode; the
//   tile starts on a 1,024-byte boundary, so the hardware's address bits and
//   these offsets agree).
// - The wgmma shared-memory matrix descriptor (PTX ISA, "Matrix Descriptor
//   Format"): start address >> 4 in bits 0-13, leading byte offset >> 4 in
//   16-29, stride byte offset >> 4 in 32-45, base offset 0 in 49-51, layout
//   type in 62-63 (1: 128-byte swizzle). A K-major operand in 128-byte
//   swizzled rows takes the stride byte offset 1,024 (one atom of 8 rows)
//   and ignores the leading one (its k16 step, 32 bytes, lies inside a
//   row); the k-th k16 step of a row starts 32 k bytes further.
// - The accumulator of wgmma.m64nNk16 with f32 output, and of
//   wgmma.m64nNk32 with s32 output, which is laid out alike (PTX ISA,
//   "Register Fragments and Shared Memory Matrix Layouts", wgmma D):
//   thread T of the warpgroup, register r holds row 16 (T / 32) + (T % 32)
//   / 4 + 8 ((r / 2) % 2), column 8 (r / 4) + 2 (T % 4) + r % 2; so warp w
//   holds rows 16w .. 16w + 15, and its registers 4j .. 4j + 3 are the
//   m16n8 C fragment (tc_ptx.cuh: frag_c_row / frag_c_col) of columns
//   8j .. 8j + 7.
// - The TMA boxes of the window: tile it of a block (window columns ts =
//   tile_start(it) .. + 128, phase by phase for the deep pack32 groups, as
//   scan_tc.cuh orders them), ring stage st of that tile (row bytes 128 st
//   .. 128 st + 127), box {128 / e elements, 128 rows} at tensor
//   coordinates (x = 128 st / e, y = start_c[b] + ts) of the cache
//   [capacity][d].

#pragma once

#include <cstddef>
#include <cstdint>

#include "deep_select.cuh"  // TPQ_HD and the deep select's arrays

namespace tpq {
namespace wg {

constexpr int SW_ROW = 128;    // bytes of a swizzled row: 64 bf16, 128 int8
constexpr int SW_ATOM = 1024;  // bytes of a swizzle atom: 8 rows
constexpr int BOX_K = 64;      // bf16 k elements per ring stage (one row)
constexpr int BOX_ROWS = 128;  // window columns (cache rows) per tile
constexpr int KSTEP = 16;      // bf16 k elements of one wgmma (32 bytes)
constexpr int KSTEP_BYTES = 32;  // the bytes of a k step, bf16 or int8
constexpr int MAX_ROW_BF16 = 2048;  // widest row (bytes): bf16 d <= 1024
constexpr int MAX_ROW_I8 = 1024;    // and int8 d <= 1024
constexpr int STAGE_BYTES = BOX_ROWS * SW_ROW;  // one operand of a stage
constexpr int LAYOUT_SW128 = 1;                 // descriptor layout type
constexpr size_t SMEM_LIMIT = 232448;  // dynamic shared memory of a CTA

// Byte offset of byte kb (< 128) of row `row` in a tile of 128-byte rows
// under the 128-byte swizzle.
TPQ_HD constexpr int sw128_offset(int row, int kb) {
  return (row / 8) * SW_ATOM + (row % 8) * SW_ROW +
         (((kb / 16) ^ (row % 8)) * 16) + kb % 16;
}

// The wgmma descriptor of the operand at shared address `addr`.
TPQ_HD constexpr uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                    uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) |
         ((uint64_t)(layout & 3u) << 62);
}
TPQ_HD constexpr uint32_t desc_start(uint64_t d) {
  return (uint32_t)(d & 0x3FFFu) << 4;
}
TPQ_HD constexpr uint32_t desc_lbo(uint64_t d) {
  return (uint32_t)((d >> 16) & 0x3FFFu) << 4;
}
TPQ_HD constexpr uint32_t desc_sbo(uint64_t d) {
  return (uint32_t)((d >> 32) & 0x3FFFu) << 4;
}
TPQ_HD constexpr uint32_t desc_base_offset(uint64_t d) {
  return (uint32_t)((d >> 49) & 7u);
}
TPQ_HD constexpr uint32_t desc_layout(uint64_t d) {
  return (uint32_t)(d >> 62);
}

// The descriptor of k step ks (32 bytes: k16 bf16, k32 int8) of a K-major
// 128-byte swizzled operand whose 64 rows start at shared address `tile`
// (1,024-byte aligned).
TPQ_HD constexpr uint64_t kmajor_desc(uint32_t tile, int ks) {
  return make_desc(tile + KSTEP_BYTES * ks, 16, SW_ATOM, LAYOUT_SW128);
}

// Row and column of the m64nN f32 accumulator that register r of thread t
// (of the warpgroup's 128) holds.
TPQ_HD constexpr int acc_row(int t, int r) {
  return 16 * (t / 32) + (t % 32) / 4 + 8 * ((r / 2) % 2);
}
TPQ_HD constexpr int acc_col(int t, int r) {
  return 8 * (r / 4) + 2 * (t % 4) + r % 2;
}

// Window column of the first slot of tile `it` (tiles phase by phase: tpp
// tiles a phase, phase f holding the columns == f * 128 mod stride).
TPQ_HD constexpr int tile_start(int it, int tpp, int stride) {
  return (it % tpp) * stride + (it / tpp) * BOX_ROWS;
}
// The TMA box of ring stage st of the tile starting at window column ts of
// the block whose window starts at cache row s0: inner (k element, of e
// bytes) and outer (cache row) coordinates.
TPQ_HD constexpr int box_x(int st, int e = 2) { return SW_ROW / e * st; }
TPQ_HD constexpr int box_y(int s0, int ts) { return s0 + ts; }

// Ring stages of a tile at width d (elements of e bytes), and the 32-byte
// k steps of stage st (the last one's past d are skipped: TMA fills the
// window's bytes past d with zeros and the query copies write zeros there).
TPQ_HD constexpr int stages_of(int d, int e = 2) {
  return (d * e + SW_ROW - 1) / SW_ROW;
}
TPQ_HD constexpr int ksteps_of(int d, int st, int e = 2) {
  return (d * e - SW_ROW * st) >= SW_ROW
             ? SW_ROW / KSTEP_BYTES
             : (d * e - SW_ROW * st + KSTEP_BYTES - 1) / KSTEP_BYTES;
}

// The kernel's shared memory, from a 1,024-byte aligned base (the first
// SW_ATOM bytes are the slack that aligns it): the ring's window tiles
// [RING][128][128 B] and query tiles [RING][128][128 B], the penalties of
// each stage's columns [RING][128] f32, the full and empty barriers
// [2][RING] (8 bytes each), the prober rows [MAX_PT] (the instances in
// turns: the consumer warps' copies [WARPS][16]), the tile flags [8],
// then the select's arrays: the deep pack32 instances' (k_pair 17-64,
// deep_select.cuh: staging rows, one running list per row, counts and round
// flags); else the slice lists [WARPS][16][kls] (pack32 keys; exact
// columns), then pack32: the running lists [2][MAX_PT][kls]; exact: the
// slice lists' values [WARPS][16][kls] f32, the score staging rows
// [WARPS][16][SLD] and row bounds [WARPS][16] f32, and the queues
// [QUEUE][CONSUMERS] f32 and int. kls: the lists' row stride, k_pair
// (pack32: made odd, scan_tc.cuh's list_ld). The ring holds as many stages
// as the select's arrays of an instance's largest k_pair leave room for:
// exact k_pair <= 10 five, exact four; pack32 k_pair <= 16 six, deeper
// four. int8 rows (i8): each stage also carries its columns' scales [128]
// f32 beside their penalties (SCALE_BYTES), and the same depths fit.
constexpr int RING_EXACT_10 = 5;
constexpr int RING_EXACT = 4;
constexpr int RING_PACK_16 = 6;
constexpr int RING_DEEP = 4;
constexpr int MAX_PT = 128;     // probers per block
constexpr int WARPS = 8;        // consumer warps
constexpr int CONSUMERS = 256;  // consumer threads
constexpr int SLD = 72;         // exact staging row stride (floats)
constexpr int QUEUE = 6;        // exact: a lane's queued candidates
constexpr int SCALE_BYTES = 4 * BOX_ROWS;  // int8: a stage's column scales

TPQ_HD constexpr int ring_of(int pack32, int k_pair) {
  return pack32 ? (k_pair <= 16 ? RING_PACK_16 : RING_DEEP)
                : (k_pair <= 10 ? RING_EXACT_10 : RING_EXACT);
}
// The pass by pass and exact selects' shared arrays after the prober rows
// and tile flags: the slice lists, then pack32's two running lists or
// exact's values, staging rows, row bounds and queues (the codes instances'
// selects too).
TPQ_HD constexpr size_t list_bytes(int pack32, int k_pair) {
  return (size_t)4 * WARPS * 16 * (pack32 ? (k_pair | 1) : k_pair) +
         (pack32 ? (size_t)2 * 4 * MAX_PT * (k_pair | 1)
                 : (size_t)4 * WARPS * 16 * k_pair +
                       (size_t)4 * WARPS * 16 * (SLD + 1) +
                       (size_t)8 * QUEUE * CONSUMERS);
}
// The select's arrays of the instance that serves inst_k (0: k_pair),
// writing k_pair entries a row: the deep select's above pack32 k_pair 16.
TPQ_HD constexpr size_t select_bytes(int pack32, int k_pair, int inst_k = 0) {
  return pack32 && (inst_k ? inst_k : k_pair) > ds::SHALLOW_K
             ? ds::select_bytes(k_pair)
             : list_bytes(pack32, k_pair);
}
// The shared memory of the k-chunked instance that serves inst_k (0:
// k_pair), writing k_pair entries a row: its ring (ring_of) and its select's
// arrays; i8: int8 rows, whose stages carry the column scales.
TPQ_HD constexpr size_t smem_bytes(int pack32, int k_pair, int inst_k = 0,
                                   int i8 = 0) {
  return (size_t)SW_ATOM +
         (size_t)ring_of(pack32, inst_k ? inst_k : k_pair) *
             (2 * STAGE_BYTES + 4 * BOX_ROWS + (i8 ? SCALE_BYTES : 0) + 16) +
         4 * MAX_PT + 4 * 8 + select_bytes(pack32, k_pair, inst_k);
}

// Narrow rows (rows of at most 256 bytes, bf16 d <= 128 and int8 d <= 256:
// the instances whose QB > 0). The block's query rows stay resident while
// its window tiles go by, in QB buffers of two k halves [2][128][128 B]
// (half h: row bytes 128 h .. 128 h + 127, in the 128-byte swizzle), each
// with a full and an empty barrier; a ring stage holds the window's 128
// bytes of k and the tile's penalties only. Per instance as many stages as
// the select's arrays leave room for, each instance with two query buffers
// (the next block's rows copied while this one's are scored): exact k_pair
// <= 10 six, exact five, pack32 k_pair <= 16 eight, the deep pack32
// instance (k_pair 17-64) five (one buffer would leave room for seven:
// chip_variants.py --narrow, wgn_deep_q1). int8 rows (d <= 256: 256 bytes)
// take the same buffers, their stages the column scales too: the same
// depths but pack32 k_pair <= 16's, seven (eight would take 232,640 B).
constexpr int NARROW_ROW = 256;  // widest narrow row (bytes)
constexpr int QBUF_BYTES = 2 * STAGE_BYTES;
constexpr int NRING_EXACT_10 = 6;
constexpr int NRING_EXACT = 5;
constexpr int NRING_PACK_16 = 8;
constexpr int NRING_PACK_16_I8 = 7;
constexpr int NRING_DEEP = 5;
constexpr int NQB = 2;       // query buffers, the deep instance's too
constexpr int NQB_DEEP = 2;

TPQ_HD constexpr int narrow_ring_of(int pack32, int k_pair, int i8 = 0) {
  return pack32 ? (k_pair <= 16 ? (i8 ? NRING_PACK_16_I8 : NRING_PACK_16)
                                : NRING_DEEP)
                : (k_pair <= 10 ? NRING_EXACT_10 : NRING_EXACT);
}
TPQ_HD constexpr int narrow_qbufs_of(int pack32, int k_pair) {
  return pack32 && k_pair > 16 ? NQB_DEEP : NQB;
}
// Byte offset of byte kb (< 256) of query row `row` in a query buffer.
TPQ_HD constexpr int qbuf_offset(int row, int kb) {
  return (kb / SW_ROW) * STAGE_BYTES + sw128_offset(row, kb % SW_ROW);
}
// The shared memory of the narrow instance that serves inst_k (0: k_pair),
// writing k_pair entries a row: alignment slack, the query buffers and
// their barriers, the ring's stages (window tile, penalties, int8 (i8): the
// column scales, full and empty barriers), prober rows, tile flags and the
// select's arrays.
TPQ_HD constexpr size_t narrow_smem_bytes(int pack32, int k_pair,
                                          int inst_k = 0, int i8 = 0) {
  return (size_t)SW_ATOM +
         (size_t)narrow_qbufs_of(pack32, inst_k ? inst_k : k_pair) *
             (QBUF_BYTES + 16) +
         (size_t)narrow_ring_of(pack32, inst_k ? inst_k : k_pair, i8) *
             (STAGE_BYTES + 4 * BOX_ROWS + (i8 ? SCALE_BYTES : 0) + 16) +
         4 * MAX_PT + 4 * 8 + select_bytes(pack32, k_pair, inst_k);
}

// Codes rows (the narrow instances whose CODES is true: the codes scan's
// window decoded by the producer warpgroup). Packed uint8 codes, m a power
// of two from 8 to 128 subspaces of dsub bf16 elements, d = m dsub <= 128:
// slot j of a block's window holds its codes at bytes j m .. j m + m - 1
// past start_c[b] m, and window column c = q s_rows + r (s_rows = s_eff /
// g, g = 128 / m codes of a packed row) holds slot r g + q. A tile's 128
// columns are decoded into the ring's stages in the 128-byte swizzled
// K-major layout the bf16 rows' TMA boxes give, the codebook [m][256][dsub]
// bf16 staged once per CTA. The producer's threads copy a column's codes
// in 8-byte chunks of 8 subspaces (cp.async, into a raw slot of [128][8
// cpp] bytes), up to 8 chunks (64 subspaces) a column per pass: one pass,
// or two at m = 128. A chunk's decoded bytes are dsub whole 16-byte pieces
// of the row (16 dsub bytes from byte 16 dsub chunk), piece p in the
// tile's stage p / 8 at byte 16 (p % 8) of the row. Instances: exact
// k_pair <= 10 and <= 16 on three stages, pack32 k_pair <= 16 on five and
// 17-CODES_PASS_K on four (extracted pass by pass), deeper pack32 by the
// deep select (deep_select.cuh) on three, each with one query buffer. A
// stage carries its columns' penalties and, pack32, their slots (the keys'
// low bits).
constexpr int CRING_EXACT = 3;
constexpr int CRING_PACK_16 = 5;
constexpr int CRING_PACK = 4;
constexpr int CRING_DEEP = 3;
constexpr int CQB = 1;
constexpr int CODES_PASS_K = 32;  // deepest pack32 k_pair of the passes
constexpr int CODE_CHUNK = 8;  // codes (bytes) of a chunk
constexpr int PASS_CHUNKS = 8;  // a pass's chunks of a column, at most

TPQ_HD constexpr int codes_ring_of(int pack32, int k_pair) {
  return !pack32                   ? CRING_EXACT
         : k_pair <= ds::SHALLOW_K ? CRING_PACK_16
         : k_pair <= CODES_PASS_K  ? CRING_PACK
                                   : CRING_DEEP;
}
// The passes of a tile at m subspaces and the chunks a pass brings of a
// column.
TPQ_HD constexpr int codes_passes(int m) {
  return m > CODE_CHUNK * PASS_CHUNKS ? m / (CODE_CHUNK * PASS_CHUNKS) : 1;
}
TPQ_HD constexpr int pass_chunks(int m) {
  return m / CODE_CHUNK / codes_passes(m);
}
// The raw slot: a pass's codes of the tile's 128 columns.
TPQ_HD constexpr int codes_raw_bytes(int m) {
  return BOX_ROWS * CODE_CHUNK * pass_chunks(m);
}
// The shared memory of the codes instance that serves this select:
// alignment slack, the query buffer and its barriers, the ring's stages (a
// decoded tile's k half, penalties, pack32: slots, full and empty
// barriers), the codebook [m][256][dsub] bf16, the raw slot, prober rows,
// tile flags and the select's arrays (above CODES_PASS_K the deep
// select's).
TPQ_HD constexpr size_t codes_smem_bytes(int m, int dsub, int pack32,
                                         int k_pair) {
  return (size_t)SW_ATOM + (size_t)CQB * (QBUF_BYTES + 16) +
         (size_t)codes_ring_of(pack32, k_pair) *
             (STAGE_BYTES + 4 * BOX_ROWS + (pack32 ? 4 * BOX_ROWS : 0) + 16) +
         (size_t)512 * m * dsub + codes_raw_bytes(m) + 4 * MAX_PT + 4 * 8 +
         (pack32 && k_pair > CODES_PASS_K ? ds::select_bytes(k_pair)
                                          : list_bytes(pack32, k_pair));
}

// The in-window slot of window column c, without an integer division: the
// quotient from the f32 reciprocal inv = 1 / s_rows (truncated, as
// __float2int_rz) is off by at most one for c < 2^22, and the remainder
// corrects it.
TPQ_HD inline int col_slot(int c, int s_rows, int g, float inv) {
  int q = (int)((float)c * inv);
  int r = c - q * s_rows;
  if (r < 0) {
    --q;
    r += s_rows;
  } else if (r >= s_rows) {
    ++q;
    r -= s_rows;
  }
  return r * g + q;
}

// Column `cl` (of the tile) and chunk `ch` (of the pass's 2^lc chunks of a
// column) of chunk item e. A warp's 32 items cover whole columns (the
// copies coalesce); with 2^lc >= 4, every 8 consecutive items are 2
// columns x 4 chunks.
TPQ_HD inline void chunk_item(int e, int lc, int& cl, int& ch) {
  if (lc >= 2) {
    ch = (e & 3) | (((e >> 3) & ((1 << (lc - 2)) - 1)) << 2);
    cl = ((e >> 2) & 1) | ((e >> (lc + 1)) << 1);
  } else {
    cl = e >> lc;
    ch = e & ((1 << lc) - 1);
  }
}

// The consumers' schedules (block_scan_wg.cu; tests/test_torch_wg_schedule.py
// runs the turns as a model of a CTA's eight consumer warps). Named
// barriers: 0 is __syncthreads', BAR_CONSUMERS the eight consumer warps'
// (lockstep instances only), BAR_PRODUCER the producer warpgroup's,
// BAR_PAIR + w (w < 4) the pair of consumer warps w and w + 4 (one in each
// warpgroup, the same rows at S = 2), BAR_TURN + h warpgroup h's turn. In
// the instances that take turns no barrier holds all eight consumer warps
// inside the block loop.
constexpr int BAR_CONSUMERS = 1;
constexpr int BAR_PRODUCER = 2;
constexpr int BAR_PAIR = 3;      // 3 .. 6
constexpr int BAR_TURN = 7;      // 7, 8
constexpr int PAIR_THREADS = 64;
constexpr int TURN_THREADS = 256;

TPQ_HD constexpr int pair_bar(int cw) { return BAR_PAIR + cw % 4; }

// The turns (a ping-pong of the two consumer warpgroups): warpgroup h waits
// on turn_wait(h) before it issues a chunk's chain and arrives on
// turn_pass(h), the other's, once it has, so that one's chain runs on the
// tensor cores while the other scores and selects. Each completes on
// TURN_THREADS: the waiting warpgroup's 128 threads and the other's 128
// arrivals. Both take a turn at every chunk of every live block, whether
// they issue a chain there or not (takes_chain). Warpgroup 1 opens
// warpgroup 0's first turn with one arrival before its own first
// (turn_opens: where the CTA has a live block) and hands the turn on after
// every chunk but the CTA's last (turn_hands_on), so that no arrival is
// left on a turn barrier when the CTA ends. (Balanced the other way, by one
// more wait of warpgroup 0 after its last chunk, a barrier after the block
// loop, ptxas spilled 16-736 B in 13 of the 21 instances.)
TPQ_HD constexpr int turn_wait(int h) { return BAR_TURN + h; }
TPQ_HD constexpr int turn_pass(int h) { return BAR_TURN + 1 - h; }
TPQ_HD constexpr bool turn_opens(int h) { return h == 1; }
TPQ_HD constexpr bool turn_hands_on(int h, bool cta_last) {
  return h == 0 || !cta_last;
}
// Whether an instance's consumers take turns, decoupled (the pass-by-pass
// pack32 instances), or run in lockstep: the exact and deep pack32 ones ran
// 1.6-15% slower in turns and 4-7% slower decoupled without them
// (PERF.md), so they keep the lockstep schedule.
TPQ_HD constexpr bool takes_turns(bool pack32, bool deep) {
  return pack32 && !deep;
}

// A block's work for consumer warp cw (of 8; warpgroup cw / 4), from its
// live 64-prober tiles l0 (rows 0-63) and l1 (64-127): S, the slices of a
// 16-prober tile (0: no live tile, the block skipped; 1: two live tiles,
// warpgroup h takes tile h over both column halves of each window tile; 2:
// one, both warpgroups take it, a column half each, warp cw and its pair
// cw ^ 4 the same rows); m64, the warpgroup's tile; p0, the first of the
// warp's 16 rows (p0 .. p0 + 15).
struct WarpRows {
  int S, m64, p0;
};
TPQ_HD constexpr WarpRows warp_rows(bool l0, bool l1, int cw) {
  return (l0 && l1) ? WarpRows{1, cw / 4, 16 * cw}
         : (l0 || l1)
             ? WarpRows{2, l0 ? 0 : 1, 64 * (l0 ? 0 : 1) + 16 * (cw % 4)}
             : WarpRows{0, 0, 0};
}
// Whether warpgroup h issues a chain at a chunk of a tile of nrow window
// columns: with two live tiles always, with one for its column half (none
// where the tile ends before it).
TPQ_HD constexpr bool takes_chain(int S, int h, int nrow) {
  return S == 1 || 64 * h < nrow;
}
// The rows (of the warp's 16) whose lists warp cw of warpgroup h merges and
// writes at a phase end: its 16 (S = 1), or 8 of the pair's (S = 2:
// warpgroup h's half, after a pair barrier).
TPQ_HD constexpr int merge_first(int S, int h) { return S == 2 ? 8 * h : 0; }
TPQ_HD constexpr int merge_count(int S) { return S == 2 ? 8 : 16; }
// The slice lists' region (rows of 16) of warp cw.
TPQ_HD constexpr int slice_region(int cw) { return cw; }

// One 16-byte store (the kernel's uint4; four words on the host).
TPQ_HD inline void store16(unsigned char* p, uint32_t a, uint32_t b,
                           uint32_t c, uint32_t d) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4*>(p) = make_uint4(a, b, c, d);
#else
  uint32_t* w = reinterpret_cast<uint32_t*>(p);
  w[0] = a;
  w[1] = b;
  w[2] = c;
  w[3] = d;
#endif
}

// Code b (< 8) of a chunk held as two words.
TPQ_HD inline uint32_t chunk_code(uint32_t lo, uint32_t hi, int b) {
  return ((b < 4 ? lo : hi) >> (8 * (b & 3))) & 0xFFu;
}

// Where piece p (16 bytes, p < 16) of tile column cl lies: in the tile's
// stage p / 8 (stage0 or stage1), at byte 16 (p % 8) of the swizzled row.
TPQ_HD inline unsigned char* piece_at(unsigned char* stage0,
                                      unsigned char* stage1, int cl, int p) {
  return (p < 8 ? stage0 : stage1) + sw128_offset(cl, 16 * (p % 8));
}

// Chunk `chunk` (subspaces 8 chunk .. + 7, codes in lo / hi) of tile
// column cl decoded against the codebook cb [m][256][dsub] (bf16 bits)
// into its dsub 16-byte pieces p = dsub chunk + u (piece_at). The codebook
// words are loaded before the stores they fill, all of a chunk's at once
// where they fit in 8 words (dsub 1 and 2: more loads in flight); dsub 1,
// 2 and 4 read whole codewords, others element by element.
TPQ_HD inline void decode_chunk(uint32_t lo, uint32_t hi, const uint16_t* cb,
                                int dsub, int chunk, int cl,
                                unsigned char* stage0,
                                unsigned char* stage1) {
  const int i0 = CODE_CHUNK * chunk;  // the chunk's first subspace
  const int p0 = dsub * chunk;        // and piece
  if (dsub == 2) {  // a codeword is one word: 4 a piece
    const uint32_t* cw = reinterpret_cast<const uint32_t*>(cb) + i0 * 256;
    uint32_t w[8];
    TPQ_UNROLL
    for (int b = 0; b < 8; ++b) w[b] = cw[b * 256 + chunk_code(lo, hi, b)];
    store16(piece_at(stage0, stage1, cl, p0), w[0], w[1], w[2], w[3]);
    store16(piece_at(stage0, stage1, cl, p0 + 1), w[4], w[5], w[6], w[7]);
  } else if (dsub == 1) {  // two codewords a word: one piece
    const uint16_t* ch = cb + i0 * 256;
    uint32_t h[8];
    TPQ_UNROLL
    for (int b = 0; b < 8; ++b) h[b] = ch[b * 256 + chunk_code(lo, hi, b)];
    store16(piece_at(stage0, stage1, cl, p0), h[0] | h[1] << 16,
            h[2] | h[3] << 16, h[4] | h[5] << 16, h[6] | h[7] << 16);
  } else if (dsub == 4) {  // a codeword is two words: 2 a piece
    const uint32_t* cw = reinterpret_cast<const uint32_t*>(cb) + 2 * i0 * 256;
    TPQ_UNROLL
    for (int u = 0; u < 4; ++u) {
      const uint32_t* a = cw + 2 * (2 * u * 256 + chunk_code(lo, hi, 2 * u));
      const uint32_t* b =
          cw + 2 * ((2 * u + 1) * 256 + chunk_code(lo, hi, 2 * u + 1));
      const uint32_t a0 = a[0], a1 = a[1], b0 = b[0], b1 = b[1];
      store16(piece_at(stage0, stage1, cl, p0 + u), a0, a1, b0, b1);
    }
  } else {  // element by element: piece u holds elements 8 u .. 8 u + 7
    int b = 0, e = 0;  // code b of the chunk, element e of its codeword
    TPQ_NO_UNROLL
    for (int u = 0; u < dsub; ++u) {
      uint32_t w[4];
      TPQ_UNROLL
      for (int x = 0; x < 8; ++x) {
        const uint32_t h =
            cb[((i0 + b) * 256 + chunk_code(lo, hi, b)) * dsub + e];
        w[x / 2] = x % 2 ? w[x / 2] | h << 16 : h;
        if (++e == dsub) {
          e = 0;
          ++b;
        }
      }
      store16(piece_at(stage0, stage1, cl, p0 + u), w[0], w[1], w[2], w[3]);
    }
  }
}

}  // namespace wg
}  // namespace tpq
