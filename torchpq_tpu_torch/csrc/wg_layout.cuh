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

#ifdef __CUDACC__
#define TPQ_HD __host__ __device__
#else
#define TPQ_HD
#endif

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
// [2][RING] (8 bytes each), the prober rows [MAX_PT], the tile flags [8],
// the slice lists [WARPS][16][kls] (pack32 keys; exact columns), then
// pack32: the running lists [2][MAX_PT][kls]; exact: the slice lists'
// values [WARPS][16][kls] f32, the score staging rows [WARPS][16][SLD] and
// row bounds [WARPS][16] f32, and the queues [QUEUE][CONSUMERS] f32 and int.
// kls: the lists' row stride, k_pair (pack32: made odd, scan_tc.cuh's
// list_ld). The ring holds as many stages as the lists of an instance's
// largest k_pair leave room for: exact k_pair <= 10 five, exact four;
// pack32 k_pair <= 16 six, <= DEEP_K four, deeper three. int8 rows (i8):
// each stage also carries its columns' scales [128] f32 beside their
// penalties (SCALE_BYTES), and the same depths fit.
constexpr int RING_EXACT_10 = 5;
constexpr int RING_EXACT = 4;
constexpr int RING_PACK_16 = 6;
constexpr int RING_PACK = 4;
constexpr int RING_DEEP = 3;
constexpr int DEEP_K = 48;
constexpr int MAX_PT = 128;     // probers per block
constexpr int WARPS = 8;        // consumer warps
constexpr int CONSUMERS = 256;  // consumer threads
constexpr int SLD = 72;         // exact staging row stride (floats)
constexpr int QUEUE = 6;        // exact: a lane's queued candidates
constexpr int SCALE_BYTES = 4 * BOX_ROWS;  // int8: a stage's column scales

TPQ_HD constexpr int ring_of(int pack32, int k_pair) {
  return pack32 ? (k_pair <= 16       ? RING_PACK_16
                   : k_pair <= DEEP_K ? RING_PACK
                                      : RING_DEEP)
                : (k_pair <= 10 ? RING_EXACT_10 : RING_EXACT);
}
// The select's shared arrays after the prober rows and tile flags: the
// slice lists, then pack32's running lists or exact's values, staging rows,
// row bounds and queues.
TPQ_HD constexpr size_t select_bytes(int pack32, int k_pair) {
  return (size_t)4 * WARPS * 16 * (pack32 ? (k_pair | 1) : k_pair) +
         (pack32 ? (size_t)2 * 4 * MAX_PT * (k_pair | 1)
                 : (size_t)4 * WARPS * 16 * k_pair +
                       (size_t)4 * WARPS * 16 * (SLD + 1) +
                       (size_t)8 * QUEUE * CONSUMERS);
}
// ring: the instance's stages (0: ring_of's, those of the instance that
// serves k_pair); i8: int8 rows, whose stages carry the column scales.
TPQ_HD constexpr size_t smem_bytes(int pack32, int k_pair, int ring = 0,
                                   int i8 = 0) {
  return (size_t)SW_ATOM +
         (size_t)(ring ? ring : ring_of(pack32, k_pair)) *
             (2 * STAGE_BYTES + 4 * BOX_ROWS + (i8 ? SCALE_BYTES : 0) + 16) +
         4 * MAX_PT + 4 * 8 + select_bytes(pack32, k_pair);
}

// Narrow rows (rows of at most 256 bytes, bf16 d <= 128 and int8 d <= 256:
// the instances whose QB > 0). The block's query rows stay resident while
// its window tiles go by, in QB buffers of two k halves [2][128][128 B]
// (half h: row bytes 128 h .. 128 h + 127, in the 128-byte swizzle), each
// with a full and an empty barrier; a ring stage holds the window's 128
// bytes of k and the tile's penalties only. Per instance as many stages as the lists leave room for:
// exact k_pair <= 10 six, exact five, pack32 k_pair <= 16 eight, each with
// two query buffers (the next block's rows copied while this one's are
// scored); the deep pack32 instance (k_pair 17-64) five stages and one
// buffer (two would leave three stages). int8 rows (d <= 256: 256 bytes)
// take the same buffers, their stages the column scales too: the same
// depths but pack32 k_pair <= 16's, seven (eight would take 232,640 B).
constexpr int NARROW_ROW = 256;  // widest narrow row (bytes)
constexpr int QBUF_BYTES = 2 * STAGE_BYTES;
constexpr int NRING_EXACT_10 = 6;
constexpr int NRING_EXACT = 5;
constexpr int NRING_PACK_16 = 8;
constexpr int NRING_PACK_16_I8 = 7;
constexpr int NRING_DEEP = 5;
constexpr int NQB = 2;       // query buffers, but the deep instance's
constexpr int NQB_DEEP = 1;

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
         4 * MAX_PT + 4 * 8 + select_bytes(pack32, k_pair);
}

}  // namespace wg
}  // namespace tpq
