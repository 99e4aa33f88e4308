// IVF block scan over the bf16 decoded cache (d <= 1024, d % 8 == 0) and
// the int8 scan cache (d <= 1024, d % 16 == 0; see "Int8 rows" below) on
// Hopper (sm_90a): warpgroup products (wgmma), window tiles brought by the
// tensor memory accelerator (TMA) into a ring of shared-memory stages
// tracked by mbarriers, one producer warpgroup and two consumer
// warpgroups. The counterpart of torchpq_tpu/ops/pallas_scan.py:
// scan_blocks_pallas in bf16 and int8 modes, in two families of instances: narrow
// rows (d <= 128: the main path's cache, 128 wide; the query rows stay
// resident, see "Narrow rows" below) and rows in k chunks (128 < d <=
// 1024: the GIST-class cache, 1,024 wide). It computes, for block b,
// prober p and window slot j < s_eff:
//
//   score = factor * <q_p, y_{start_c[b] + j}> - pen_j,   factor = 2 or 1
//   pen_j = penalty[start_c[b] + j] + (off[b] <= j < off[b] + cap[b] ? 0 : BIG)
//
// summed in f32 over bf16 operands: a narrow row in one chain of k16
// steps (at most 8); a wider one in 256-byte k chunks, 128 elements, each
// summed from zero on the tensor cores, then added into the running f32
// sum (the tensor cores' f32 accumulation truncates, and one chain of 64 k
// steps lost keys at d = 1024). Then the selects of block_scan.cu in its wire
// format (exact: value descending, slot ascending, k_pair <= 16, through
// scan_tc.cuh's functions; pack32: one maximal key per strided group of
// slots, then the k_pair largest, k_pair <= 64: up to k_pair 16 (codes
// rows: 32) extracted pass by pass, scan_tc.cuh:extract_slice, deeper by
// deep_select.cuh, see "Deep pack32 selects" below). Rows whose prober is
// -1 are written dead
// (exact: sortable(-inf) keys and -1 addresses; pack32: INT_MIN) and never
// output.
//
// What bounds the k-chunked rows on an H100: at the GIST bf16 record's
// arguments (s_eff 2048, d 1024; pack32 at n_probe 32: 2,677 blocks,
// 276,019 live probers)
// the window bytes the blocks cover, ~4.3 GB (~1.3 ms at 3.35 TB/s), and
// about as long the products of the live probers, ~1.2e12 operations
// (~1.2 ms at 989 TFLOP/s; the pad rows of live 64-prober tiles add 11%
// there, 31% at n_probe 8, whose 1,032 blocks are 57% live).
// An earlier mma.sync kernel took 4.8-16.7 ms there: serial mma.sync chains
// fed by ldmatrix (the window tile read from shared memory once per
// 16-prober tile), one CTA of 8 warps per SM, and per-thread cp.async
// copies of the window chunk and of the block's query chunk into a
// two-stage ring by the threads that score.
//
// Design:
// - One persistent CTA per SM (the wrapper sizes the grid), 384 threads:
//   warpgroup 0 the producer (setmaxnreg down to PRODUCER_REGS), warpgroups
//   1 and 2 the consumers (up to CONSUMER_REGS), in one if / else that
//   never reconverges. The CTA walks the blocks b = blockIdx.x + i *
//   gridDim.x; the producer and each consumer warp read the block's
//   probers themselves and skip a block with no live prober alike.
// - A ring of NST stages (as many as the select's arrays of the instance's
//   largest k_pair leave room for: exact k_pair <= 10 5, exact 4; pack32
//   k_pair <= 16 6, deeper 4 (a fifth fits up to k_pair 48 and gained
//   nothing there; one stage fewer took 20% longer on the GIST k = 100
//   shape's bf16 rows, 12% on its int8 ones: chip_variants.py --deep,
//   wgd_ring_less), each 64 k elements (128 bytes of a row, one
//   128-byte swizzle span) of one window tile: the window's 128 rows
//   [128][128 B] by one TMA box {64, 128} from a 2-D tensor map over the
//   cache [capacity][d] (rows past the cache and elements past d filled
//   with zeros), and the block's query rows [128][128 B], a gather by prober
//   index that a tiled box cannot do, by cp.async from the producer's 128
//   threads (warp w: rows 32w .. 32w + 31, four whole 128-byte lines a
//   copy; zeros for -1 rows and past d; only the rows of live 64-prober
//   tiles), both in wgmma's 128-byte swizzled K-major
//   layout (wg_layout.cuh). The stage of a tile's last 64 k also carries
//   its columns' penalties. A stage's full barrier completes on 128
//   arrivals, 128 arrivals of the producer threads' landed copies and the
//   TMA's bytes; its empty barrier on the 8 consumer warps' arrivals. A
//   numeric chunk is two stages; the consumers release both after the
//   chunk's products (and, at a tile's last chunk, its scores) are done.
// - The query rows are copied anew with every window tile: the block's 128
//   rows of 2,048 bytes (256 KB) do not fit beside the ring, and k chunks
//   outside the tile loop would need every tile's sums at once. They come
//   from L2 (a block's rows are read 16 times within microseconds), and
//   no consumer thread spends an instruction on them.
// - Products: wgmma.m64n64k16 (bf16 x bf16 -> f32), A = a 64-prober tile
//   of the query stage, B = 64 window rows [slot][k] as they lie in the
//   cache, both from shared memory by descriptor. A block's probers are 1
//   or 2 live 64-prober tiles (a tile with any prober >= 0): with 2, each
//   consumer warpgroup takes one tile over both 64-column halves of every
//   window tile (S = 1 slice per 16-prober tile); with 1, both take that
//   tile, one column half each (S = 2 slices). Warp w of a warpgroup holds
//   rows 16w .. 16w + 15 of the tile in the layout of scan_tc.cuh's m16n8
//   accumulators (wg_layout.cuh: acc_row / acc_col), so the pack32 maxima,
//   the exact staging and the phase-end selects are scan_tc.cuh's, with
//   the warps of a 16-prober tile's slices at s * 4 + tile.
//   A chunk: its k steps (8, fewer where d ends inside the chunk) into a
//   zeroed accumulator (the first wgmma's scale-d false, so the compiler
//   keeps no old value alive), one commit and wait, then the f32 add into
//   the tile's running sums (64 registers for two halves, reset to -0 at
//   each tile). With 2 live tiles a warpgroup's chunk is one chain of
//   m64n128k16 over both halves (64 accumulator registers; two chains of
//   m64n64k16 with a wait between took 2-4% longer), with 1 one chain of
//   m64n64k16 over its half. At the records'
//   arguments a 64-prober tile with few live probers still costs its 64
//   rows of products, but no bytes: the pad rows' query copies are zeros
//   from no address, and the window is read once per warpgroup whatever
//   the live count.
// - The consumers' schedules, two by family (wg_layout.cuh: takes_turns).
//   The pass-by-pass pack32 instances (k_pair <= 16; codes rows <= 32)
//   take turns: no barrier holds all eight consumer warps in the block
//   loop. Each warp reads the block's probers itself and keeps its rows' in
//   a copy of its own (prow_s [WARPS][16]); a phase end synchronises at
//   most the pair of warps cw and cw ^ 4 that hold a row's two column
//   halves at S = 2 (BAR_PAIR + cw % 4), to merge the halves' lists, and
//   the pair meets once more before either starts its next live block, so
//   that neither overwrites a list or row the other still reads. The two
//   warpgroups take turns at every chunk (a ping-pong, as
//   FlashAttention-3's warpgroups; turn_wait / turn_pass, named barriers
//   BAR_TURN + h): warpgroup h waits for its turn, issues its chain,
//   commits it, hands the turn on (an arrival, no wait) and only then
//   waits for its products, so that one warpgroup's chain runs on the
//   tensor cores while the other scores and selects; both take a turn at
//   every chunk of every live block, with or without a chain of their own,
//   and warpgroup 1 hands none on after the CTA's last chunk (the CTA's
//   last live block, found by warp 0 as the kernel starts).
//   tests/test_torch_wg_schedule.py runs this schedule as a model of a
//   CTA's warps under random interleavings. The exact and deep pack32
//   instances run in lockstep: both warpgroups issue as their stages land,
//   two barriers of all 256 consumers (BAR_CONSUMERS) open every block
//   (the block's probers and tile flags in prow_s / live_s) and one or two
//   close the exact outputs; the deep select's phase ends meet as a pair.
//   Measured in turns with the lockstep body on every family (a consumer
//   warp's cycles a tile at the main path's window, chip_variants.py
//   --narrow, wgp_clock: products 27-35%, under none of its scores; NVIDIA
//   H100 80GB HBM3, 700.00 W; PERF.md): the turns ran the long
//   pass-by-pass windows 1.07-1.16x and the main pack32 window 1.04x, but
//   the exact rows 0.93-0.95x decoupled and 1.6-1.8% slower again in turns
//   (each turn waits for the other warpgroup's slowest warp, and the exact
//   inserts keep both warps of an SMSP issuing), the deep rows 0.95-1.03x
//   decoupled and the k-chunked k = 100 row 0.85x in turns.
// - Registers: sums 64, the chunk's accumulators 64 (dead between chunks),
//   the pack32 group maxima 64 or the exact lists 32, under CONSUMER_REGS
//   (232; the producer's 40 hold no address across its stage loop, which
//   is worked out anew each stage); ptxas must report no spill and no
//   stack frame (chip_smoke's CHECKED_KERNELS). At 224 / 56 the pack32
//   instances spilled 28 B; the deep phase ends sorted in registers
//   (scan_tc.cuh:sort_slice) spilled 84-352 B at 232, and staged with the
//   survivors past a row's room kept in registers for another round 16-32
//   B (deep_select.cuh); a chain a column half (m64n64k16 into the same
//   chunk accumulators) in place of the m64n128k16 one also made room in
//   the k-chunked bf16 instance but took 11% longer on the GIST k = 100
//   shape (chip_variants.py --deep).
// - Shared memory (wg_layout.cuh: smem_bytes): 1,024 bytes of alignment
//   slack, a stage's 32,768 B of tiles + 512 B of penalties + 16 B of
//   barriers, prober rows and tile flags, then the select's arrays:
//   227,952 B exact at k_pair 10 (5 stages), 200,800 B at 16 (4); pack32
//   227,456 B at 16 (6), 202,080 B at 64 (4).
//
// Narrow rows (d <= 128, d % 8 == 0; the instances whose QB > 0): the main
// path's kernel, which replaced an mma.sync one for every bf16 shape it
// took (the pack32 selects above k_pair 16 whose phases cover fewer than
// 8 window tiles last, once deep_select.cuh made their phase ends cheap).
// - What bounds it: at the main path's arguments (1M x 128, s_eff 640 over
//   the compacted layout, 4,075 blocks of 128 probers at n_probe 8, 4,507
//   at n_probe 32, 15% / 56% of their rows live) the window bytes the
//   blocks cover, ~0.3 GB (~0.09 ms at 3.35 TB/s), and the products of the
//   live probers, ~1e10-4e10 operations (~0.01-0.04 ms at 989 TFLOP/s; the
//   pad rows of live 64-prober tiles add as much again at n_probe 8). The
//   rest is the select: every live score passes through the pack32 maxima
//   or the exact staging, then the phase ends' extraction and merges.
//   The mma.sync kernel ran at 6-10% of the bound on every narrow row,
//   this design at 11-14% (1.35-1.58x in turns on the rows it took; NVIDIA
//   H100 80GB HBM3, 700.00 W), where the products, the scores and the
//   phase-end extraction each take about a third (chip_variants.py
//   --narrow).
// - The block's query rows are copied once per block, by the producer's
//   cp.async right after the block's first window tile is on its way (a
//   gather by prober index; only the rows of live 64-prober tiles; zeros
//   for -1 rows and past d), into one of QB resident buffers [2][128][128 B]
//   (wg_layout.cuh: qbuf_offset; 32 KB), with a full barrier (landed
//   copies and arrivals) and an empty one (the consumer warps release it
//   after the block's last products). Two buffers let the next block's
//   rows land while this one's are scored (the deep pack32 instance on one
//   buffer and seven stages ran within 1% of two and five:
//   chip_variants.py --deep, wgn_deep_q1). A ring stage is then the
//   window's [128][128 B] tile of one k half and its penalties: d <= 64
//   takes one stage a tile, d <= 128 two. A in registers (wgmma's
//   register-A form, 32 registers a thread at d = 128) would free the
//   buffers' shared memory, but each consumer thread would load its
//   fragments from global memory at every block start, a latency no
//   producer covers, and hold 32 more registers beside the sums and the
//   group maxima; the resident buffers cost shared memory the lists leave.
// - Products: one chain of ceil(d / 16) k16 steps into the tile's sums
//   themselves (the first wgmma's scale-d false), m64n128k16 with two live
//   64-prober tiles and m64n64k16 over a column half with one: no chunk
//   sums and no add (APART false). That frees no register where the
//   consumers' pressure peaks, the phase end's select, where the k-chunked
//   rows' chunk sums are dead too: phase ends sorted in registers
//   (scan_tc.cuh:sort_slice) spilled 40-64 B at 232 and at 240 registers,
//   so the pack32 instances extract pass by pass up to k_pair 16 and stage
//   their survivors in shared memory above (deep_select.cuh).
// - A 16-prober warp slice of no live prober joins its warpgroup's
//   products (wgmma is collective) but runs neither the pack32 maxima nor
//   the exact staging and inserts, extracts no phase end and writes no
//   list: its rows were written dead as the block started.
// - Shared memory (wg_layout.cuh: narrow_smem_bytes): 1,024 B of slack,
//   QB x (32,768 B + 16 B of barriers), a stage's 16,384 B tile + 512 B of
//   penalties + 16 B of barriers, prober rows, tile flags and the select's
//   arrays: exact 228,512 B at k_pair 10 (6 stages), 217,744 B at 16 (5);
//   pack32 228,544 B at 16 (8), 219,024 B at 64 (5).
//
// Int8 rows (I8; the int8 scan cache with per-slot scales and int8 query
// rows with per-query scales, d <= 1024, d % 16 == 0):
//
//   ab    = sum_k q8[p, k] * y8[start_c[b] + j, k]          (exact, s32)
//   m     = (factor * q_scale[p]) * scale[start_c[b] + j]   (f32, that order)
//   score = fmaf(float(ab), m, -pen_j)
//
// in the same body, byte for byte: an s8 wgmma k32 step covers 32 bytes as
// a bf16 k16 step does, so a 128-byte swizzled row is 128 int8 elements,
// the descriptors advance alike and a TMA box {128 elements, 128 rows}
// (the map over the cache as bytes) fills the same 16,384 B stage. Rows of
// at most 256 bytes (d <= 256) take the narrow instances (the query rows
// resident, 16 KB a buffer's k half); wider ones (256 < d <= 1024) the
// k-chunked instances, a tile in up to 8 stages where a bf16 row of the
// same d takes 16. Products: wgmma.m64n128k32 / m64n64k32 .s32.s8.s8 (both
// operands K-major, as 8-bit wgmma requires), whose s32 accumulators lie
// as the f32 ones, so the selects are unchanged. The sums are exact
// integers (|ab| <= 1024 * 128^2 = 2^24, exact in f32 too), so the
// k-chunked rows keep one chain over the whole row (no chunk sums, 64
// registers fewer than bf16's) and the scores are block_scan_ref's bit for
// bit, ties included, on every input. The stage that carries a tile's
// penalties carries its columns' scales [128] f32 too (SCALE_BYTES a
// stage: the narrow pack32 instance of k_pair <= 16 keeps 7 stages, eight
// would take 232,640 B); each consumer lane reads its two accumulator
// rows' factor * q_scale once per block. What bounds it is the bf16
// rows': at the int8 tier's arguments (1M x 128) the window bytes, ~0.05
// ms, and the select over every live score; the GIST-class rows' bytes
// and products are half the bf16 ones'. It serves every int8 shape the
// tensor cores take, in place of an mma.sync m16n8k32 s8 kernel it beat
// in turns on the int8 rows' own arguments, 1.28x / 1.21x at d 128
// (exact / pack32), 1.63x / 2.25x at d_cache 1024, 1.85x on the GIST int8
// record's k = 100 scan (9.588 against 5.192 ms; NVIDIA H100 80GB HBM3,
// 700.00 W; PERF.md). Its pack32 selects above k_pair 16 are the bf16
// rows' (deep_select.cuh).
//
// Deep pack32 selects (KMAX = ds::MAX_K: pack32 k_pair 17-64, both families
// and dtypes, and the codes rows' 33-64; deep_select.cuh): the phase ends
// that pass by pass extraction
// made cost k_pair passes over every group maximum. Each row's running list
// (one a row, in shared memory) bounds the next phase's maxima; the
// survivors are staged in shared memory and merged by a warp's bitonic
// networks into the list. What the design buys, on random inputs at the
// deep rows' shapes in turns with the passes (chip_variants.py --deep;
// NVIDIA H100 80GB HBM3, 700.00 W): the GIST k = 100 shape's bf16 rows
// 0.82x their time, int8 0.79x, the deep-k head's 0.83x, and below the
// sorted mma.sync kernel's on every shorter phase (untapered deep-k 0.89x,
// pqr3 k = 100 0.80x, pq4 0.79x, residual 0.85x), which it replaced there.
// The pruning is worth up to 13% (none on one-phase rows: wgd_noprune),
// merging two rows at once 2-19% (wgd_rows1), the k-chunked instances'
// fourth ring stage (the list that went) 20% on bf16 and 12% on int8 rows
// (wgd_ring_less). The phase end runs in each warp (S = 1) or in the pair
// of warps cw and cw ^ 4 that hold a row's two column halves (S = 2: named
// barrier BAR_PAIR + cw % 4); no barrier of all consumers.
//
// Codes rows (CODES; the codes scan, ops/codes_scan.py, the counterpart of
// torchpq_tpu/ops/pallas_codes_scan.py:scan_blocks_pallas_codes for d <=
// 128): the window is not read from a cache but decoded from the packed
// uint8 codes against the codebook by the producer warpgroup, in the same
// narrow body; window column c = q s_rows + r holds slot r g + q
// (ops/codes_scan.py:column_slots):
//
//   y_j   = concat_i bf16(codebook)[i, code[start_c[b] + j, i], :]
//   score = factor * <bf16(q_p), y_j> - pen_j
//
// summed in f32 as the bf16 narrow rows are; pack32 keys carry the
// column's slot in their low bits, the exact lists hold columns (ties: the
// first column) and write their slots; pad rows dead. Exact k_pair <= 16;
// pack32 k_pair <= 32 pass by pass (wg_layout.cuh: CODES_PASS_K), 33-64 by
// deep_select.cuh. Up to k_pair 32 the code domain's window (s_eff 1,024)
// is G = 128 groups, one phase, so the deep select would sort every row's
// 128 maxima with no bound yet: the passes ran 1.11-1.31x faster there
// (wgc_deep_all), the deep select 1.11-1.20x faster at 33 and 35 (G = 512,
// four phases; wgc_passes35). The deep instance replaced an mma.sync kernel
// with sorted phase ends and its decode behind a barrier on one decoded
// tile: 1.47x at the IVFPQR code domain's k = 100 scan at n_probe 32
// (k_pair 52, 71 live probers a block: 3.983 against 2.703 ms on random
// codes), 1.57x at n_probe 8 (k_pair 64, 20 live: 2.959 against 1.882),
// 1.25-1.45x at k_pair 33-64 (chip_variants.py --codes --parent; NVIDIA
// H100 80GB HBM3, 700.00 W).
// - What bounds it: at the code domain's arguments (4,507 blocks of 128
//   probers, s_eff 1,024, PQ64 at d = 128) the codes' bytes, ~0.3 GB
//   (~0.1 ms at 3.35 TB/s), and the live probers' products, ~1e11
//   operations (~0.1 ms at 989 TFLOP/s); beside them every block decodes
//   s_eff * m codebook lookups from shared memory whatever its live count
//   (~3e8 a call) and every live score passes through the select.
// - The producer, per tile: its threads' cp.async copies of the tile's
//   codes (8-byte chunks of 8 subspaces, wg_layout.cuh:chunk_item, slot by
//   col_slot) into a raw slot [128][min(m, 64) B] (m = 128 in two passes),
//   issued for the next tile as soon as this thread has decoded the last
//   one; the wait for the tile's stages to be released; each thread's
//   cp.async wait (it decodes the very chunks it copied); the decode
//   against the codebook (staged once per CTA, 64 KB at d = 128) straight
//   into the stages' 128-byte swizzled K-major rows (decode_chunk: a
//   chunk's dsub 16-byte pieces, codebook words loaded before their
//   stores); the columns' penalties and (pack32) slots in the tile's last
//   stage, the last k step's bytes past d zeroed; fence.proxy.async (the
//   generic proxy's stores, for wgmma's reads), then its arrivals. The
//   block's query rows as the narrow rows' (one buffer).
// - The consumers release a tile's first stage right after its products,
//   its last after the scores and selects: the producer decodes the next
//   tile beside them (released with the last, the exact instances, on
//   three stages, ran 32-33% longer, pack32 0-2%: chip_variants.py
//   --codes, wgc_noearly; a fourth exact stage in a raw slot half as large
//   gained 1-2%, wgc_pass4). The decode is not wholly hidden: a producer
//   that decodes nothing (wgc_nodecode, wrong keys) ran 9-16% faster, with
//   its pointers __restrict__ and its loop unrolled by two no faster
//   (wgc_restrict2; NVIDIA H100 80GB HBM3, 700.00 W).
// - Registers: the producer's decode takes 56 (at 40 ptxas spilled 16-20
//   B in every codes instance, the deep one too, and the scans ran
//   0.97-1.09x the time: wgc_regs40), the consumers 224, the deep select's
//   too (no
//   spill: they hold no TMA or query-copy state); 128 x 56 + 256 x 224 =
//   64,512, the launch's 168 x 384 that setmaxnreg moves between the
//   warpgroups (48 / 232 would need 65,536).
// - Shared memory (wg_layout.cuh: codes_smem_bytes): 1,024 B of slack, one
//   query buffer, the stages (a decoded k half, penalties, pack32 slots,
//   barriers), the codebook 512 d B, the raw slot, prober rows and flags
//   and the select's arrays: at PQ64, exact k_pair 10 218,720 B (3
//   stages), 16 224,864 B (3); pack32 16 221,312 B (5), 32 228,464 B (4),
//   64 227,680 B (3, the deep select's arrays). Four stages of the deep
//   instance fit up to k_pair 39 at PQ64 and ran 0.93-1.10x the time of
//   three (wgc_deep_ring4).

#include <cstdint>
#include <type_traits>

#include <cuda.h>

#include "deep_select.cuh"
#include "scan_tc.cuh"
#include "wg_ptx.cuh"

namespace {

using namespace tpq::wg;
namespace ds = tpq::ds;
namespace tc = tpq::tc;
using tpq::big_penalty;
using tpq::neg_inf;
using tpq::smem_u32;
using tpq::sortable;

static_assert(WARPS == tc::WARPS && CONSUMERS == tc::THREADS &&
                  MAX_PT == tc::MAX_PT && SLD == tc::SLD &&
                  QUEUE == tc::QUEUE && BOX_ROWS == tc::TN,
              "scan_tc.cuh's selects index the consumers' shared arrays");
static_assert(ds::SHALLOW_K == tc::PASS_K && ds::MAX_K == tc::MAX_PACK_K &&
                  ds::ROWS == MAX_PT && ds::WARPS == WARPS,
              "deep_select.cuh's select serves the pack32 k_pair past the "
              "passes, over the consumers' rows and warps");

constexpr int THREADS = 384;        // producer warpgroup + two consumers
constexpr int PRODUCER_REGS = 40;   // setmaxnreg: 128 x 40 + 256 x 232
constexpr int CONSUMER_REGS = 232;  // <= 64,512 (168 x 384 at launch)
// narrow rows: the same split (56 / 224 spilled in the pack32 instances,
// chip_variants.py --variants wgn_regs224 --ptxas-only; the producer's
// query gather fits 40 one copy at a time)
constexpr int NARROW_PRODUCER_REGS = 40;
constexpr int NARROW_CONSUMER_REGS = 232;
// codes rows: the producer decodes (its loops at 40 spilled 16-20 B, at 56
// none), and the consumers fit 224, the deep select too (they hold no TMA
// or query-copy state)
constexpr int CODES_PRODUCER_REGS = 56;
constexpr int CODES_CONSUMER_REGS = 224;
constexpr int FULL_ARRIVALS = 2 * 128;  // a producer thread's arrival, and
                                        // its landed copies'
constexpr int HALF = STAGE_BYTES / 2;   // 64 rows of a stage's operand

// The score of a product sum x: bf16, factor * x - pen (rowm = factor);
// int8, one rounding of float(x) * m - pen with m = rowm * colm rounded
// first, rowm = factor * q_scale[p] and colm = scale[j] (block_scan_ref's
// order: ops/block_scan.py:fma_f32), explicit so that no contraction moves
// a bit.
__device__ __forceinline__ float wg_score(float x, float rowm, float,
                                          float pen) {
  return tc::score(x, rowm, pen);
}
__device__ __forceinline__ float wg_score(int x, float rowm, float colm,
                                          float pen) {
  return __fmaf_rn(__int2float_rn(x), __fmul_rn(rowm, colm), -pen);
}

// The codes rows' inputs (CODES): the packed codes (slot j's m bytes at j
// m), the codebook [m][256][dsub] bf16 (d = m dsub), the pack group g, the
// column -> slot map's s_rows = s_eff / g and inv = 1 / s_rows, a tile's
// passes and log2 of a pass's chunks of a column (wg_layout.cuh:
// codes_passes, pass_chunks): kernel parameters, so that the producer
// keeps none of them in its registers.
struct CodesArgs {
  const unsigned char* codes;
  const uint16_t* codebook;
  int m, dsub, g, s_rows;
  float inv;
  int passes, lc;
};

// CODES: this thread's cp.async copies of pass ps of the tile of window
// columns ts .. ts + nrow - 1 (chunks ps * 2^lc .. of each column's codes)
// of the block whose window starts at slot s0, into the raw slot [128][8 *
// 2^lc], committed as one group; the decode (codes_decode) reads the very
// chunks this thread copied.
__device__ __forceinline__ void codes_fetch(const CodesArgs& ca,
                                            unsigned char* raw, int s0,
                                            int ts, int nrow, int ps) {
  const int t = threadIdx.x;
#pragma unroll 1
  for (int e = t; e < (BOX_ROWS << ca.lc); e += 128) {
    int cl, ch;
    chunk_item(e, ca.lc, cl, ch);
    if (cl < nrow) {
      const int j = col_slot(ts + cl, ca.s_rows, ca.g, ca.inv);
      tpq::cp_async8(raw + cl * (CODE_CHUNK << ca.lc) + CODE_CHUNK * ch,
                     ca.codes + ((size_t)s0 + j) * ca.m +
                         CODE_CHUNK * ((ps << ca.lc) + ch));
    }
  }
  tpq::cp_async_commit();
}

// CODES: pass ps of the tile decoded from the raw slot into its stages
// (stage0, stage1: k halves 0 and 1), once this thread's copies of it have
// landed.
__device__ __forceinline__ void codes_decode(const CodesArgs& ca,
                                             const unsigned char* raw,
                                             const uint16_t* cb_s, int nrow,
                                             int ps, unsigned char* stage0,
                                             unsigned char* stage1) {
  const int t = threadIdx.x;
  tpq::cp_async_wait<0>();
#pragma unroll 1
  for (int e = t; e < (BOX_ROWS << ca.lc); e += 128) {
    int cl, ch;
    chunk_item(e, ca.lc, cl, ch);
    if (cl < nrow) {
      const uint2 rc = *reinterpret_cast<const uint2*>(
          raw + cl * (CODE_CHUNK << ca.lc) + CODE_CHUNK * ch);
      decode_chunk(rc.x, rc.y, cb_s, ca.dsub, (ps << ca.lc) + ch, cl,
                   stage0, stage1);
    }
  }
}

// Consumer warpgroup h's turn (wg_layout.cuh: turn_wait, turn_pass), the
// barrier ids immediates of a branch on h (uniform in the warpgroup).
__device__ __forceinline__ void turn_take(int h) {
  if (h == 0) {
    named_barrier_imm<turn_wait(0), TURN_THREADS>();
  } else {
    named_barrier_imm<turn_wait(1), TURN_THREADS>();
  }
}
__device__ __forceinline__ void turn_hand_on(int h) {
  if (h == 0) {
    named_barrier_arrive_imm<turn_pass(0), TURN_THREADS>();
  } else {
    named_barrier_arrive_imm<turn_pass(1), TURN_THREADS>();
  }
}

// The deep select's exchanges among a consumer warp's lanes (deep_select.cuh's
// policy): warp shuffles, __syncwarp, and the named barrier of the warp and
// its partner, the other consumer warpgroup's warp of the same rows.
struct DeepWarp {
  int l;     // lane
  int pair;  // the pair's named barrier
  __device__ __forceinline__ int lane() const { return l; }
  __device__ __forceinline__ int xor_(int v, int m) const {
    return __shfl_xor_sync(0xffffffffu, v, m);
  }
  __device__ __forceinline__ int up4(int v, int d) const {
    return __shfl_up_sync(0xffffffffu, v, d, 4);
  }
  __device__ __forceinline__ int idx4(int v, int s) const {
    return __shfl_sync(0xffffffffu, v, s, 4);
  }
  __device__ __forceinline__ bool any(bool p) const {
    return __any_sync(0xffffffffu, p);
  }
  __device__ __forceinline__ void sync() const { __syncwarp(); }
  __device__ __forceinline__ void pair_sync() const {
    named_barrier(pair, PAIR_THREADS);
  }
};

// PACK: the select; KMAX: exact lists' length, or pack32's largest k_pair:
// extracted pass by pass (PASS_K) or by deep_select.cuh (MAX_K); NST: ring
// stages; QB: the narrow rows' resident query buffers (rows of at most 256
// bytes), 0 for the k-chunked rows' query copies with every stage; I8:
// int8 rows (s8 wgmma k32, exact s32 sums, q_scale and scale read), else
// bf16 (wgmma k16, f32 sums; q_scale and scale unused); CODES (narrow, bf16):
// the window decoded from the codes by the producer (ca; tmap unused).
template <bool PACK, int KMAX, int NST, int QB, bool I8, bool CODES>
__global__ void __launch_bounds__(THREADS, 1) block_scan_wg_kernel(
    const __grid_constant__ CUtensorMap tmap,
    const unsigned char* __restrict__ qtable,
    const float* __restrict__ q_scale, const int* __restrict__ probers,
    const int* __restrict__ start_c, const int* __restrict__ off,
    const int* __restrict__ capb, const float* __restrict__ penalty,
    const float* __restrict__ scale, int* __restrict__ out, int n_blocks,
    int p_tile, int d, int s_eff, int k_pair, float factor, int slot_mask,
    int n_groups, const CodesArgs ca) {
  static_assert(!CODES || (QB > 0 && !I8), "codes rows are narrow bf16");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((SW_ATOM - (smem_u32(smem_raw) & (SW_ATOM - 1))) &
                  (SW_ATOM - 1));
  constexpr bool NARROW = QB > 0;
  constexpr int NQ = NARROW ? QB : 1;  // query buffers, as a modulus
  // the consumers' schedule: pass-by-pass pack32 decoupled, the warpgroups
  // in turns; exact and deep pack32 in lockstep (wg_layout.cuh:
  // takes_turns)
  constexpr bool TURNS = takes_turns(PACK, KMAX > tc::PASS_K);
  unsigned char* win = base;                      // [NST][128][128 B]
  // the query rows: k-chunked [NST][128][128 B], a stage's with it;
  // narrow [QB][2][128][128 B], a block's (qbuf_offset)
  unsigned char* aq = win + NST * STAGE_BYTES;
  float* pen_s = reinterpret_cast<float*>(
      aq + (NARROW ? QB * QBUF_BYTES : NST * STAGE_BYTES));  // [NST][128]
  float* scl_s = pen_s + NST * BOX_ROWS;  // int8: [NST][128]
  // codes pack32: the columns' slots [NST][128]
  int* slt_s = reinterpret_cast<int*>(scl_s + (I8 ? NST * BOX_ROWS : 0));
  // codes: the codebook [m][256][dsub] bf16, the raw slot [128][8 * cpp]
  uint16_t* cb_s =
      reinterpret_cast<uint16_t*>(slt_s + (CODES && PACK ? NST * BOX_ROWS : 0));
  unsigned char* raw_s =
      reinterpret_cast<unsigned char*>(cb_s) + (CODES ? 512 * d : 0);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      raw_s + (CODES ? codes_raw_bytes(ca.m) : 0));
  uint64_t* empty = full + NST;
  uint64_t* qfull = empty + NST;  // narrow: [QB] each
  uint64_t* qempty = qfull + QB;
  // the block's probers [MAX_PT]: lockstep, row p's at p; turns, each
  // consumer warp's copy of its 16 rows' [WARPS][16]
  int* prow_s = reinterpret_cast<int*>(qempty + QB);
  // lockstep, the consumers' tile flags [4]; turns, the CTA's last live
  // block [1], 3 spare; then the producer's tile flags [4]
  int* live_s = prow_s + MAX_PT;
  int* keys_s = live_s + 8;       // slice lists [WARPS][16][kls]
  const int kls = tc::list_ld(k_pair, PACK);
  float* vals_s = reinterpret_cast<float*>(keys_s + WARPS * 16 * kls);
  int* run_s = keys_s + WARPS * 16 * kls;  // pack32 [2][MAX_PT][kls]
  float* stage_s = vals_s + WARPS * 16 * kls;  // exact [WARPS][16][SLD]
  // exact: a row's bound, shared at S = 2 with the pair's other warp
  volatile float* rowb_s = stage_s + WARPS * 16 * SLD;  // [WARPS][16]
  float* qv_s = stage_s + WARPS * 16 * (SLD + 1);  // [QUEUE][CONSUMERS]
  int* qc_s = reinterpret_cast<int*>(qv_s + QUEUE * CONSUMERS);

  const int t = threadIdx.x;
  // the warpgroup, uniform in the compiler's eyes (so that the wgmma
  // instructions sit in no path it must treat as divergent)
  const int wgi = __shfl_sync(0xffffffffu, t / 128, 0);
  constexpr int E = I8 ? 1 : 2;              // element bytes
  const int rb = E * d;                      // row bytes
  const int nst = stages_of(d, E);           // ring stages per tile
  const int nch = (nst + 1) / 2;             // 128-element k chunks
  // tile order as scan_tc.cuh's: deep pack32 groups (G > 128) phase by
  // phase, a phase ending every tpp tiles
  const bool phased = PACK && n_groups > BOX_ROWS;
  const int n_tiles = (s_eff + BOX_ROWS - 1) / BOX_ROWS;
  const int tpp = phased ? s_eff / n_groups : n_tiles;
  const int stride = phased ? n_groups : BOX_ROWS;

  if (t == 0) {
    for (int i = 0; i < NST; ++i) {
      // narrow stages: the producer threads' arrivals and the TMA's bytes
      mbar_init(full + i, NARROW ? 128 : FULL_ARRIVALS);
      mbar_init(empty + i, WARPS);
    }
    for (int i = 0; i < QB; ++i) {
      mbar_init(qfull + i, FULL_ARRIVALS);
      mbar_init(qempty + i, WARPS);
    }
    mbar_init_fence();
  }
  // the consumers' turns: the CTA's last block with a live prober (-1:
  // none), whose last chunk is the last turn (wg_layout.cuh: turn_hands_on),
  // in a spare flag (a register holding it across the block loop made
  // ptxas spill)
  volatile int* b_last_s = live_s;
  if (TURNS && t < 32) {
    int b_last = -1;
    for (int b = blockIdx.x + (n_blocks - 1 - blockIdx.x) / gridDim.x *
                                  gridDim.x;
         b >= (int)blockIdx.x && b_last < 0; b -= gridDim.x) {
      bool live = false;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = 32 * j + t;
        live |= p < p_tile && probers[(size_t)b * p_tile + p] >= 0;
      }
      if (__any_sync(0xffffffffu, live)) b_last = b;
    }
    if (t == 0) *b_last_s = b_last;
  }
  if constexpr (CODES) {  // the codebook, 16 bytes a thread step
    const uint4* src = reinterpret_cast<const uint4*>(ca.codebook);
    uint4* dst = reinterpret_cast<uint4*>(cb_s);
    for (int i = t; i < 32 * d; i += THREADS) dst[i] = src[i];
  }
  __syncthreads();

  if (wgi == 0) {
    // ---- producer: the window by TMA, the query rows by cp.async ----
    setmaxnreg_dec<(CODES    ? CODES_PRODUCER_REGS
                    : NARROW ? NARROW_PRODUCER_REGS
                             : PRODUCER_REGS)>();
    const int lane = t % 32;
    const int warp = t / 32;
    int g = 0;   // stages filled
    int qi = 0;  // narrow: query buffers filled
    for (int b = blockIdx.x; b < n_blocks; b += gridDim.x) {
      const int pr = t < p_tile ? probers[(size_t)b * p_tile + t] : -1;
      const unsigned live = __ballot_sync(0xffffffffu, pr >= 0);
      named_barrier(BAR_PRODUCER, 128);  // the last block's flags are read
      if (lane == 0) live_s[4 + warp] = live != 0u;
      named_barrier(BAR_PRODUCER, 128);
      const bool l0 = live_s[4] | live_s[5];
      const bool l1 = live_s[6] | live_s[7];
      if (!l0 && !l1) continue;
      // this warp's rows (32 warp .. + 31) lie in a live 64-row tile
      const bool copy = warp < 2 ? l0 : l1;
      const int s0 = start_c[b];
      const int o0 = off[b];
      const int o1 = o0 + capb[b];
      if constexpr (CODES) {  // the block's first tile's codes
        codes_fetch(ca, raw_s, s0, 0, min(BOX_ROWS, s_eff), 0);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int ts = tile_start(it, tpp, stride);
        const int nrow = min(BOX_ROWS, s_eff - ts);
        if constexpr (CODES) {
          // the tile's nst stages, decoded by the producer's threads once
          // the consumers have released them: pass by pass from the raw
          // slot, the next pass's (or the next tile's) codes copied as soon
          // as this thread's reads of the slot are done
#pragma unroll 1
          for (int st = 0; st < nst; ++st) {
            mbar_wait(empty + (g + st) % NST, (((g + st) / NST) & 1) ^ 1);
          }
          unsigned char* st0 = win + (g % NST) * STAGE_BYTES;
          unsigned char* st1 = win + ((g + 1) % NST) * STAGE_BYTES;
#pragma unroll 1
          for (int ps = 0; ps < ca.passes; ++ps) {
            codes_decode(ca, raw_s, cb_s, nrow, ps, st0, st1);
            if (ps + 1 < ca.passes) {
              codes_fetch(ca, raw_s, s0, ts, nrow, ps + 1);
            } else if (it + 1 < n_tiles) {
              const int tn = tile_start(it + 1, tpp, stride);
              codes_fetch(ca, raw_s, s0, tn, min(BOX_ROWS, s_eff - tn), 0);
            }
          }
          // column t's penalty (and pack32 slot) in the tile's last stage,
          // and the bytes of the row's last k step past d zeros (the query
          // rows' are too: no stale bits of an earlier tile enter a sum)
          const int last = (g + nst - 1) % NST;
          float p = 0.0f;
          int sl = 0;
          if (t < nrow) {
            sl = col_slot(ts + t, ca.s_rows, ca.g, ca.inv);
            p = __ldg(penalty + s0 + sl) +
                ((sl >= o0 && sl < o1) ? 0.0f : big_penalty());
          }
          pen_s[last * BOX_ROWS + t] = p;
          if constexpr (PACK) slt_s[last * BOX_ROWS + t] = sl;
          if ((2 * d) % KSTEP_BYTES) {
            store16(win + last * STAGE_BYTES +
                        sw128_offset(t, (2 * d) % SW_ROW),
                    0u, 0u, 0u, 0u);
          }
          // the generic proxy's stores, for the consumers' wgmma reads
          fence_proxy_async();
#pragma unroll 1
          for (int st = 0; st < nst; ++st) mbar_arrive(full + (g + st) % NST);
          g += nst;
        } else {
          for (int st = 0; st < nst; ++st, ++g) {
            const int slot = g % NST;
            uint64_t* fb = full + slot;
            mbar_wait(empty + slot, ((g / NST) & 1) ^ 1);
            if (t == 0) {
              mbar_expect_tx(fb, STAGE_BYTES);
              tma_load_2d(win + slot * STAGE_BYTES, &tmap, fb, box_x(st, E),
                          box_y(s0, ts));
            }
            if (!NARROW && copy) {
              // the warp's 32 rows, 4 a copy: lane l takes 16-byte piece
              // l % 8 of row 32 warp + 4 i + l / 8 (whole 128-byte lines).
              // The prober and the thread index pass through an opaque move,
              // so the addresses are worked out anew each stage rather than
              // kept across the loop in registers the producer lacks.
              int pv, tv;
              asm volatile("mov.b32 %0, %1;" : "=r"(pv) : "r"(pr));
              asm volatile("mov.b32 %0, %1;" : "=r"(tv) : "r"(t));
              unsigned char* dst = aq + slot * STAGE_BYTES;
              const int c = tv % 8;
              const int kb = st * SW_ROW + 16 * c;  // the piece's row byte
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                const int rr = 4 * i + (tv % 32) / 8;  // of the warp's 32
                const int q = __shfl_sync(0xffffffffu, pv, rr);
                tpq::cp_async16(
                    dst + sw128_offset((tv / 32) * 32 + rr, 16 * c),
                    reinterpret_cast<const unsigned char*>(qtable) +
                        (size_t)max(q, 0) * rb + kb,
                    q >= 0 && kb < rb ? 16 : 0);
              }
            }
            if (st == nst - 1) {  // the tile's penalties (int8: and scales)
              float p = 0.0f;
              float c = 0.0f;
              if (t < nrow) {
                const int j = ts + t;
                p = __ldg(penalty + s0 + j) +
                    ((j >= o0 && j < o1) ? 0.0f : big_penalty());
                if constexpr (I8) c = __ldg(scale + s0 + j);
              }
              pen_s[slot * BOX_ROWS + t] = p;
              if constexpr (I8) scl_s[slot * BOX_ROWS + t] = c;
            }
            if (!NARROW) mbar_arrive_cp_async(fb);
            mbar_arrive(fb);
          }
        }
        if constexpr (NARROW) {
          if (it == 0) {
            // the block's query rows, once its first tile is on its way,
            // into a buffer the consumers have released (the warp's 32
            // rows; lane l takes 16-byte piece l % 8 of row 32 warp + 4 i
            // + l / 8 in each k half, whole 128-byte lines; zeros for -1
            // rows and past d)
            const int qs = qi % NQ;
            mbar_wait(qempty + qs, ((qi / NQ) & 1) ^ 1);
            if (copy) {
              for (int kh = 0; kh < nst; ++kh) {
                // the prober and the thread index pass through an opaque
                // move, so the addresses are worked out anew each k half
                int pv, tv;
                asm volatile("mov.b32 %0, %1;" : "=r"(pv) : "r"(pr));
                asm volatile("mov.b32 %0, %1;" : "=r"(tv) : "r"(t));
                unsigned char* dst = aq + qs * QBUF_BYTES;
                const int kb = kh * SW_ROW + 16 * (tv % 8);
                // one copy at a time: the producer's registers hold no
                // batch of addresses
#pragma unroll 1
                for (int i = 0; i < 8; ++i) {
                  const int rr = 4 * i + (tv % 32) / 8;  // of the warp's 32
                  const int q = __shfl_sync(0xffffffffu, pv, rr);
                  tpq::cp_async16(
                      dst + qbuf_offset((tv / 32) * 32 + rr, kb),
                      reinterpret_cast<const unsigned char*>(qtable) +
                          (size_t)max(q, 0) * rb + kb,
                      q >= 0 && kb < rb ? 16 : 0);
                }
              }
            }
            mbar_arrive_cp_async(qfull + qs);
            mbar_arrive(qfull + qs);
            ++qi;
          }
        }
      }
    }
    cp_async_wait_all();
  } else if constexpr (TURNS) {
    // ---- consumers, pass-by-pass pack32: products, scores and selects,
    // the warpgroups in turns, no barrier of all consumers ----
    setmaxnreg_inc<(CODES    ? CODES_CONSUMER_REGS
                    : NARROW ? NARROW_CONSUMER_REGS
                             : CONSUMER_REGS)>();
    const int ct = t - 128;
    const int lane = ct % 32;
    const int cw = ct / 32;  // consumer warp
    const int h = wgi - 1;   // consumer warpgroup
    const int wq = cw % 4;   // warp of the warpgroup: rows 16 wq .. + 15
    int* prow_w = prow_s + 16 * cw;  // the probers of this warp's 16 rows
    const uint32_t win_u = smem_u32(win);
    const uint32_t aq_u = smem_u32(aq);
    using Acc = std::conditional_t<I8, int, float>;
    Acc sum[2][8][4];  // a tile's sums over its chunks, per column half
    // APART: the chunk's products from zero into accumulators of their
    // own, then added into sum (k-chunked bf16 rows); else one chain into
    // sum itself (narrow rows; k-chunked int8 rows, whose s32 sums are
    // exact in any order: one chain over the whole row)
    constexpr bool APART = !NARROW && !I8;
    Acc part[8][4];
    Acc part_hi[8][4];  // the second half's (two live 64-prober tiles)
    Acc(&acc)[8][4] = tc::pick<APART>(part, sum[0]);
    Acc(&acc_hi)[8][4] = tc::pick<APART>(part_hi, sum[1]);
    int g = 0;   // stages consumed
    int qi = 0;  // narrow: query buffers consumed
    // whether block b is the CTA's last with a live prober (the prologue's
    // b_last_s, read through prow_s: no pointer of its own across the loop)
    auto cta_last = [&](int b) {
      return b == ((volatile int*)prow_s)[MAX_PT];
    };
    if (turn_opens(h) && prow_s[MAX_PT] >= 0) turn_hand_on(h);
    // after a block of S = 2, the pair meets before either starts the next
    // live block, so that neither overwrites the lists or rows the other
    // still reads (at the next block's start rather than the last's end: no
    // value held across the tiles for it)
    bool pair_owed = false;
    // the block's tiles, from s_eff through an opaque move where used (a
    // value held across the block loop spills)
    auto tiles_n = [&]() {
      int se = s_eff;
      asm volatile("mov.b32 %0, %0;" : "+r"(se));
      return (se + BOX_ROWS - 1) / BOX_ROWS;
    };
    for (int b = blockIdx.x; b < n_blocks; b += gridDim.x) {
      // the block's probers, lane l holding rows l + 32 j (-1 past p_tile):
      // each warp reads them itself, so that no barrier of the consumers
      // publishes them
      int pv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = 32 * j + lane;
        pv[j] = p < p_tile ? probers[(size_t)b * p_tile + p] : -1;
      }
      if (h == 0) {  // pad rows (warp cw: rows 32 cw + lane): dead, never
                     // scored
        const int p = 32 * cw + lane;
        const int pr = cw == 0 ? pv[0] : cw == 1 ? pv[1] : cw == 2 ? pv[2]
                                                                  : pv[3];
        if (p < p_tile && pr < 0) {
          int* o = out + ((size_t)b * p_tile + p) * k_pair;
          for (int i = 0; i < k_pair; ++i) o[i] = INT_MIN;
        }
      }
      // the block's live 64-prober tiles (bit 0: rows 0-63, bit 1: 64-127):
      // what this warp takes of the block (warp_rows: S, the slices of a
      // 16-prober tile; m64, its warpgroup's tile; p0, the first of its 16
      // rows) is derived from them where used, through an opaque move
      // (rows()), not kept across the tiles in registers (the k-chunked
      // instances' registers are at the edge)
      const int tl = (int)__any_sync(0xffffffffu, pv[0] >= 0 || pv[1] >= 0) |
                     (int)__any_sync(0xffffffffu, pv[2] >= 0 || pv[3] >= 0)
                         << 1;
      if (tl == 0) continue;  // no live prober
      if (pair_owed) named_barrier(pair_bar(cw), PAIR_THREADS);
      auto rows = [&]() {
        int v = tl;
        asm volatile("mov.b32 %0, %0;" : "+r"(v));
        return warp_rows(v & 1, v >> 1, cw);
      };
      {
        // this warp's rows' probers into its own copy (its last block's
        // reads of it are done)
        const int p0 = rows().p0;
        const int p32 = p0 / 32;
        const int pw = p32 == 0 ? pv[0] : p32 == 1 ? pv[1] : p32 == 2 ? pv[2]
                                                                      : pv[3];
        const int mine = __shfl_sync(0xffffffffu, pw, p0 % 32 + lane % 16);
        __syncwarp();
        if (lane < 16) prow_w[lane] = mine;
        __syncwarp();
      }
      // this warp's 16 rows hold a live prober: else it scores and selects
      // nothing (its rows were written dead), but joins the products
      const bool wlive =
          !NARROW || __any_sync(0xffffffffu, prow_w[lane % 16] >= 0);
      // the window columns this warp scores of each tile (none where its
      // rows hold no live prober): a bound the scores' own conditions read,
      // so a dead slice adds no branch of its own (a branch spilled)
      const int ncol = wlive ? s_eff : 0;
      // the query rows' 64-prober tile: narrow, of the block's buffer
      const int qs = qi % NQ;
      if constexpr (NARROW) {
        mbar_wait(qfull + qs, (qi / NQ) & 1);
        fence_proxy_async();  // the query copies, for wgmma's reads
      }
      // the scale of the lane's two accumulator rows (acc_row: 16 wq + lane
      // / 4 and 8 more): factor, int8 times the prober's q_scale
      float rowm[2] = {factor, factor};
      if constexpr (I8) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int q = prow_w[lane / 4 + 8 * rr];
          rowm[rr] = __fmul_rn(factor, __ldg(q_scale + max(q, 0)));
        }
      }

      // select state: the group maxima of the lane's two rows
      int mx[2][tc::NGRP];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
        for (int j = 0; j < tc::NGRP; ++j) mx[rr][j] = INT_MIN;
      }
      int phase = 0;

      for (int it = 0; it < tiles_n(); ++it) {
        // the tile's window columns (warpgroup 1's half ends past them
        // where nrow <= 64)
        const int nrow = min(BOX_ROWS, s_eff - tile_start(it, tpp, stride));
        // the tile's sums start at -0, the identity of f32 addition (-0 +
        // x is x, -0 and +0 included; int8: 0): the first chunk's add is its
        // assignment, and no sum stays live from the last tile (a chain's
        // first wgmma overwrites them, and the reset keeps a path without
        // products from carrying the last tile's sums across the phase
        // end's select)
#pragma unroll
        for (int lh = 0; lh < 2; ++lh) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int i = 0; i < 4; ++i) sum[lh][j][i] = I8 ? 0 : -0.0f;
          }
        }
        for (int kc = 0; kc < nch; ++kc) {
          {  // the chunk's waits, turn and products
            const bool last_k = kc + 1 == nch;
            const int nsc = min(2, nst - 2 * kc);  // the chunk's stages
            const int sa = g % NST;
            const int sb = (g + 1) % NST;
            mbar_wait(full + sa, (g / NST) & 1);
            if (nsc > 1) mbar_wait(full + sb, ((g + 1) / NST) & 1);
            // the stage's query copies (codes: the decoded tile's stores)
            if (!NARROW || CODES) fence_proxy_async();
            const int ka = ksteps_of(d, 2 * kc, E);
            const int kb = nsc > 1 ? ksteps_of(d, 2 * kc + 1, E) : 0;
            // the chunk's first product continues the tile's chain (k-chunked
            // int8 rows past their first chunk) or starts from zero
            const bool cont = !APART && kc > 0;
            // A of the chunk's two stages: narrow, the k halves of the
            // block's buffer (its address through an opaque move, so that
            // the descriptors are worked out anew each tile rather than
            // kept across the selects); k-chunked, the stages' query tiles
            const uint32_t a_tile =
                aq_u + qs * QBUF_BYTES + rows().m64 * HALF;
            uint32_t qa = a_tile + (NARROW ? 0 : sa * STAGE_BYTES);
            if constexpr (NARROW) asm volatile("mov.b32 %0, %0;" : "+r"(qa));
            const uint32_t qb =
                NARROW ? qa + STAGE_BYTES : a_tile + sb * STAGE_BYTES;
            // this warpgroup's turn: the other has issued its last chain
            turn_take(h);
            if (rows().S == 1) {  // both halves in one chain
              wgmma_fence();
              if (cont) {
                wgmma_n128(acc, acc_hi, kmajor_desc(qa, 0),
                           kmajor_desc(win_u + sa * STAGE_BYTES, 0));
              } else {
                wgmma_n128_zero(acc, acc_hi, kmajor_desc(qa, 0),
                                kmajor_desc(win_u + sa * STAGE_BYTES, 0));
              }
#pragma unroll
              for (int ks = 1; ks < 4; ++ks) {
                if (ks < ka) {
                  wgmma_n128(acc, acc_hi, kmajor_desc(qa, ks),
                             kmajor_desc(win_u + sa * STAGE_BYTES, ks));
                }
              }
#pragma unroll
              for (int ks = 0; ks < 4; ++ks) {
                if (ks < kb) {
                  wgmma_n128(acc, acc_hi, kmajor_desc(qb, ks),
                             kmajor_desc(win_u + sb * STAGE_BYTES, ks));
                }
              }
              wgmma_commit();
              // the other warpgroup's turn, while this chain runs
              if (turn_hands_on(h, it + 1 == tiles_n() && last_k &&
                                cta_last(b))) {
                turn_hand_on(h);
              }
              wgmma_wait_all();
              fence_acc(acc);
              fence_acc(acc_hi);
              if constexpr (APART) {
#pragma unroll
                for (int j = 0; j < 8; ++j) {
#pragma unroll
                  for (int i = 0; i < 4; ++i) {
                    sum[0][j][i] += part[j][i];
                    sum[1][j][i] += part_hi[j][i];
                  }
                }
              }
            } else if (takes_chain(2, h, nrow)) {  // one: this warpgroup's half
              wgmma_fence();
              if (cont) {
                wgmma_n64(acc, kmajor_desc(qa, 0),
                          kmajor_desc(win_u + sa * STAGE_BYTES + h * HALF, 0));
              } else {
                wgmma_n64_zero(
                    acc, kmajor_desc(qa, 0),
                    kmajor_desc(win_u + sa * STAGE_BYTES + h * HALF, 0));
              }
#pragma unroll
              for (int ks = 1; ks < 4; ++ks) {
                if (ks < ka) {
                  wgmma_n64(acc, kmajor_desc(qa, ks),
                            kmajor_desc(win_u + sa * STAGE_BYTES + h * HALF,
                                        ks));
                }
              }
#pragma unroll
              for (int ks = 0; ks < 4; ++ks) {
                if (ks < kb) {
                  wgmma_n64(acc, kmajor_desc(qb, ks),
                            kmajor_desc(win_u + sb * STAGE_BYTES + h * HALF,
                                        ks));
                }
              }
              wgmma_commit();
              if (turn_hands_on(h, it + 1 == tiles_n() && last_k &&
                                cta_last(b))) {
                turn_hand_on(h);
              }
              wgmma_wait_all();
              fence_acc(acc);
              if constexpr (APART) {
#pragma unroll
                for (int j = 0; j < 8; ++j) {
#pragma unroll
                  for (int i = 0; i < 4; ++i) sum[0][j][i] += part[j][i];
                }
              }
            } else {  // no half: the turn passes on
              if (turn_hands_on(h, it + 1 == tiles_n() && last_k &&
                                cta_last(b))) {
                turn_hand_on(h);
              }
            }
          }
          // what the scores, selects and releases read, worked out anew
          // after the products from opaque copies of the counters rather
          // than held across them (held, a k-chunked instance spilled group
          // maxima there): the chunk's stages, the block's layout, the
          // tile's columns and its stages' penalties, scales and slots
          int gv = g, kv = kc, itv = it;
          asm volatile("mov.b32 %0, %0;" : "+r"(gv));
          asm volatile("mov.b32 %0, %0;" : "+r"(kv));
          asm volatile("mov.b32 %0, %0;" : "+r"(itv));
          const bool last_k = kv + 1 == nch;
          const int nsc = min(2, nst - 2 * kv);
          const int sa = gv % NST;
          const int sb = (gv + 1) % NST;
          const int S = rows().S;
          const int ts = tile_start(itv, tpp, stride);
          const int nscore = min(BOX_ROWS, ncol - ts);  // columns it scores
          const float* pen = pen_s + ((gv + nsc - 1) % NST) * BOX_ROWS;
          const float* scl = scl_s + ((gv + nsc - 1) % NST) * BOX_ROWS;
          const int* slt = slt_s + ((gv + nsc - 1) % NST) * BOX_ROWS;
          if constexpr (CODES) {
            // the products are done with the chunk's first stage: released
            // before the scores, so that the producer decodes the next tile
            // beside them (the last stage holds the penalties and slots)
            if (nsc > 1) {
              __syncwarp();
              if (lane == 0) mbar_arrive(empty + sa);
            }
          }
          // at a tile's last chunk, the scores (after the chunk's products:
          // no lane-dependent code between two of its wgmmas), over the
          // column halves it takes (S = 1: both; S = 2: its own)
#pragma unroll
          for (int lh = 0; lh < 2; ++lh) {
            const int hv = S == 1 ? lh : h;
            if (last_k && lh < 3 - S && 64 * hv < nscore) {
              // the scores of this lane's columns of the half, ascending
#pragma unroll
              for (int nt = 0; nt < 8; ++nt) {
                const int c8 = 64 * hv + 8 * nt;  // the n8 tile's
                const int cl = c8 + tpq::frag_c_col(lane, 0);
                if (c8 < nscore) {
                  const float2 p = *reinterpret_cast<const float2*>(pen + cl);
                  float2 cs = make_float2(0.0f, 0.0f);
                  if constexpr (I8) {
                    cs = *reinterpret_cast<const float2*>(scl + cl);
                  }
                  // codes: the columns' slots, the keys' low bits
                  int2 sl = make_int2(0, 0);
                  if constexpr (CODES) {
                    sl = *reinterpret_cast<const int2*>(slt + cl);
                  }
#pragma unroll
                  for (int i = 0; i < 2; ++i) {
                    if (cl + i < nscore) {
#pragma unroll
                      for (int rr = 0; rr < 2; ++rr) {
                        const float sc =
                            wg_score(sum[lh][nt][2 * rr + i], rowm[rr],
                                     i ? cs.y : cs.x, i ? p.y : p.x);
                        const int key =
                            (sortable(sc) & ~slot_mask) |
                            (CODES ? (i ? sl.y : sl.x) : ts + cl + i);
                        int& best = mx[rr][16 * lh + 2 * nt + i];
                        best = max(best, key);
                      }
                    }
                  }
                }
              }
            }
          }
          __syncwarp();
          if (lane == 0) {  // the chunk's stages are free again
            if (!CODES || nsc == 1) mbar_arrive(empty + sa);
            if (nsc > 1) mbar_arrive(empty + sb);
            // narrow: and the query buffer after the block's last products
            if (NARROW && it + 1 == tiles_n()) mbar_arrive(qempty + qs);
          }
          g += nsc;
        }
        // the phase end, after a tile's last chunk (outside the chunk loop:
        // none of its values is live there)
        if ((it + 1) % tpp == 0) {
          const int S = rows().S;
          // phase end: each slice's k_pair largest keys per row, by the
          // quad's shuffles, into its warp's list; then one lane per
          // live row (S = 1: the warp's 16; S = 2: 8 of the pair's)
          // merges its slices' lists and the running list, after a
          // barrier of the warp or of the pair
          int* ks_w = keys_s + slice_region(cw) * 16 * kls;
          // a slice of no live row extracts nothing (its lists are
          // never read): a count, not a branch of its own (a branch
          // spilled)
          const int kx = wlive ? k_pair : 0;
          if (S == 1) {
            tc::extract_slice<tc::NGRP>(mx, ks_w, lane, kx, kls);
            __syncwarp();
          } else {
            tc::extract_slice<tc::NGRP / 2>(mx, ks_w, lane, kx, kls);
            named_barrier(pair_bar(cw), PAIR_THREADS);
          }
          const int p0 = rows().p0;
          const int r = merge_first(S, h) + lane;  // of the warp's 16
          if (lane < merge_count(S) && prow_w[r] >= 0) {
            const int* cur = run_s + ((phase & 1) * MAX_PT + p0 + r) * kls;
            int* nxt = run_s + (((phase + 1) & 1) * MAX_PT + p0 + r) * kls;
            // slice 0 (S = 2: warpgroup 0's warp), slice 1 64 rows on
            const int* sl =
                keys_s + (slice_region(S == 2 ? wq : cw) * 16 + r) * kls;
            int h0 = 0, h1 = 0, hc = 0;
            for (int i = 0; i < k_pair; ++i) {
              int best = phase > 0 ? cur[hc] : INT_MIN;
              int bs = 2;
              const int v0 = h0 < k_pair ? sl[h0] : INT_MIN;
              if (v0 > best) {
                best = v0;
                bs = 0;
              }
              if (S == 2) {
                const int v1 = h1 < k_pair ? sl[64 * kls + h1] : INT_MIN;
                if (v1 > best) {
                  best = v1;
                  bs = 1;
                }
              }
              h0 += bs == 0;
              h1 += bs == 1;
              hc += bs == 2;
              nxt[i] = best;
            }
          }
          // the slice lists are read (the block's last phase: the
          // pair's barrier after the outputs)
          if (it + 1 < tiles_n()) {
            if (S == 1) {
              __syncwarp();
            } else {
              named_barrier(pair_bar(cw), PAIR_THREADS);
            }
          }
          ++phase;
        }
      }

      // the live rows' outputs
      const WarpRows wr = rows();
      const int S = wr.S;
      const int p0 = wr.p0;
      // the rows this warp merged, its lanes on consecutive keys
      __syncwarp();
      const int r0 = merge_first(S, h);
      for (int r = r0; r < r0 + merge_count(S); ++r) {
        if (prow_w[r] >= 0) {
          const int* fin = run_s + ((phase & 1) * MAX_PT + p0 + r) * kls;
          int* o = out + ((size_t)b * p_tile + p0 + r) * k_pair;
          for (int i = lane; i < k_pair; i += 32) o[i] = fin[i];
        }
      }
      pair_owed = S == 2;
      ++qi;
    }
  } else {
    // ---- consumers, exact and deep pack32: products, scores and selects,
    // the warpgroups in lockstep (the block's start and the exact outputs
    // on barriers of all consumers) ----
    setmaxnreg_inc<(CODES    ? CODES_CONSUMER_REGS
                    : NARROW ? NARROW_CONSUMER_REGS
                             : CONSUMER_REGS)>();
    const int ct = t - 128;
    const int lane = ct % 32;
    const int cw = ct / 32;  // consumer warp
    const int h = wgi - 1;   // consumer warpgroup
    const int wq = cw % 4;   // warp of the warpgroup: rows 16 wq .. + 15
    const int width = PACK ? k_pair : 2 * k_pair;  // output ints per row
    // pack32 phase ends: deep_select.cuh (KMAX > PASS_K) or pass by pass
    constexpr bool DEEP = PACK && KMAX > tc::PASS_K;
    static_assert(!PACK || DEEP, "the pass-by-pass instances take turns");
    const uint32_t win_u = smem_u32(win);
    const uint32_t aq_u = smem_u32(aq);
    using Acc = std::conditional_t<I8, int, float>;
    Acc sum[2][8][4];  // a tile's sums over its chunks, per column half
    // APART: the chunk's products from zero into accumulators of their
    // own, then added into sum (k-chunked bf16 rows); else one chain into
    // sum itself (narrow rows; k-chunked int8 rows, whose s32 sums are
    // exact in any order: one chain over the whole row)
    constexpr bool APART = !NARROW && !I8;
    Acc part[8][4];
    Acc part_hi[8][4];  // the second half's (two live 64-prober tiles)
    Acc(&acc)[8][4] = tc::pick<APART>(part, sum[0]);
    Acc(&acc_hi)[8][4] = tc::pick<APART>(part_hi, sum[1]);
    int g = 0;   // stages consumed
    int qi = 0;  // narrow: query buffers consumed
    for (int b = blockIdx.x; b < n_blocks; b += gridDim.x) {
      const int pr =
          ct < MAX_PT && ct < p_tile ? probers[(size_t)b * p_tile + ct] : -1;
      named_barrier(BAR_CONSUMERS, CONSUMERS);  // the last block is done
                                                // with the shared arrays
      if (ct < MAX_PT) {
        prow_s[ct] = pr;
        if (!PACK) rowb_s[ct] = neg_inf();
      }
      if (ct < p_tile && pr < 0) {  // pad rows: dead, never scored
        int* o = out + ((size_t)b * p_tile + ct) * width;
        for (int i = 0; i < k_pair; ++i) {
          if (PACK) {
            o[i] = INT_MIN;
          } else {
            o[i] = sortable(neg_inf());
            o[k_pair + i] = -1;
          }
        }
      }
      const unsigned live = __ballot_sync(0xffffffffu, pr >= 0);
      if (lane == 0 && cw < 4) live_s[cw] = live != 0u;
      named_barrier(BAR_CONSUMERS, CONSUMERS);
      const bool l0 = live_s[0] | live_s[1];
      const bool l1 = live_s[2] | live_s[3];
      const int nm64 = (int)l0 + (int)l1;  // live 64-prober tiles
      if (nm64 == 0) continue;
      const int S = nm64 == 2 ? 1 : 2;      // slices per 16-prober tile
      const int m64 = nm64 == 2 ? h : (l0 ? 0 : 1);  // this warpgroup's
      const int base64 = nm64 == 2 ? 0 : 64 * m64;   // the scored rows'
                                                     // first
      const int nm = 4 * nm64;               // scored 16-prober tiles
      const int lt = nm64 == 2 ? cw : wq;    // this warp's, among them
      const int nhalf = nm64 == 2 ? 2 : 1;   // column halves it takes
      const int s0 = start_c[b];
      // this warp's 16 rows hold a live prober: else it scores and selects
      // nothing (its rows were written dead), but joins the products
      const bool wlive =
          !NARROW ||
          __any_sync(0xffffffffu, prow_s[64 * m64 + 16 * wq + lane % 16] >= 0);
      // the window columns this warp scores of each tile (none where its
      // rows hold no live prober): a bound the scores' own conditions read,
      // so a dead slice adds no branch of its own (a branch spilled)
      const int ncol = wlive ? s_eff : 0;
      // the query rows' 64-prober tile: narrow, of the block's buffer
      const int qs = qi % NQ;
      const uint32_t a_tile = aq_u + qs * QBUF_BYTES + m64 * HALF;
      if constexpr (NARROW) {
        mbar_wait(qfull + qs, (qi / NQ) & 1);
        fence_proxy_async();  // the query copies, for wgmma's reads
      }
      // the scale of the lane's two accumulator rows (acc_row: 16 wq + lane
      // / 4 and 8 more): factor, int8 times the prober's q_scale
      float rowm[2] = {factor, factor};
      if constexpr (I8) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int q = prow_s[64 * m64 + 16 * wq + lane / 4 + 8 * rr];
          rowm[rr] = __fmul_rn(factor, __ldg(q_scale + max(q, 0)));
        }
      }

      // select state: exact lists (lane l keeps row l / 2 of the warp's 16
      // over its half of each 64 columns) and the bound, or pack32 maxima
      float vals[PACK ? 1 : KMAX];
      int cols[PACK ? 1 : KMAX];
      const bool dead_row = prow_s[64 * m64 + 16 * wq + lane / 2] < 0;
      float bound = dead_row ? -neg_inf() : neg_inf();
      int mx[2][tc::NGRP];
      tc::ExactQueue queue;
      queue.v = qv_s + ct;
      queue.c = qc_s + ct;
      queue.n = 0;
      if constexpr (PACK) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
          for (int j = 0; j < tc::NGRP; ++j) mx[rr][j] = INT_MIN;
        }
      } else {
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          vals[j] = neg_inf();
          cols[j] = INT_MAX;
        }
      }
      int phase = 0;

      for (int it = 0; it < n_tiles; ++it) {
        const int ts = tile_start(it, tpp, stride);
        const int nrow = min(BOX_ROWS, s_eff - ts);
        const int nscore = min(BOX_ROWS, ncol - ts);  // columns it scores
        // the tile's sums start at -0, the identity of f32 addition (-0 +
        // x is x, -0 and +0 included; int8: 0): the first chunk's add is its
        // assignment, and no sum stays live from the last tile (a chain's
        // first wgmma overwrites them, and the reset keeps a path without
        // products from carrying the last tile's sums across the phase
        // end's select)
#pragma unroll
        for (int lh = 0; lh < 2; ++lh) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int i = 0; i < 4; ++i) sum[lh][j][i] = I8 ? 0 : -0.0f;
          }
        }
        for (int kc = 0; kc < nch; ++kc) {
          const bool last_k = kc + 1 == nch;
          const int nsc = min(2, nst - 2 * kc);  // the chunk's stages
          const int sa = g % NST;
          const int sb = (g + 1) % NST;
          mbar_wait(full + sa, (g / NST) & 1);
          if (nsc > 1) mbar_wait(full + sb, ((g + 1) / NST) & 1);
          // the stage's query copies (codes: the decoded tile's stores)
          if (!NARROW || CODES) fence_proxy_async();
          const int ka = ksteps_of(d, 2 * kc, E);
          const int kb = nsc > 1 ? ksteps_of(d, 2 * kc + 1, E) : 0;
          const float* pen = pen_s + ((g + nsc - 1) % NST) * BOX_ROWS;
          const float* scl = scl_s + ((g + nsc - 1) % NST) * BOX_ROWS;
          const int* slt = slt_s + ((g + nsc - 1) % NST) * BOX_ROWS;
          // the chunk's first product continues the tile's chain (k-chunked
          // int8 rows past their first chunk) or starts from zero
          const bool cont = !APART && kc > 0;
          // A of the chunk's two stages: narrow, the k halves of the
          // block's buffer (its address through an opaque move, so that
          // the descriptors are worked out anew each tile rather than
          // kept across the selects); k-chunked, the stages' query tiles
          uint32_t qa = a_tile + (NARROW ? 0 : sa * STAGE_BYTES);
          if constexpr (NARROW) asm volatile("mov.b32 %0, %0;" : "+r"(qa));
          const uint32_t qb =
              NARROW ? qa + STAGE_BYTES : a_tile + sb * STAGE_BYTES;
          if (nm64 == 2) {  // both halves in one chain
            wgmma_fence();
            if (cont) {
              wgmma_n128(acc, acc_hi, kmajor_desc(qa, 0),
                         kmajor_desc(win_u + sa * STAGE_BYTES, 0));
            } else {
              wgmma_n128_zero(acc, acc_hi, kmajor_desc(qa, 0),
                              kmajor_desc(win_u + sa * STAGE_BYTES, 0));
            }
#pragma unroll
            for (int ks = 1; ks < 4; ++ks) {
              if (ks < ka) {
                wgmma_n128(acc, acc_hi, kmajor_desc(qa, ks),
                           kmajor_desc(win_u + sa * STAGE_BYTES, ks));
              }
            }
#pragma unroll
            for (int ks = 0; ks < 4; ++ks) {
              if (ks < kb) {
                wgmma_n128(acc, acc_hi, kmajor_desc(qb, ks),
                           kmajor_desc(win_u + sb * STAGE_BYTES, ks));
              }
            }
            wgmma_commit();
            wgmma_wait_all();
            fence_acc(acc);
            fence_acc(acc_hi);
            if constexpr (APART) {
#pragma unroll
              for (int j = 0; j < 8; ++j) {
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  sum[0][j][i] += part[j][i];
                  sum[1][j][i] += part_hi[j][i];
                }
              }
            }
          } else if (64 * h < nrow) {  // one: this warpgroup's half
            wgmma_fence();
            if (cont) {
              wgmma_n64(acc, kmajor_desc(qa, 0),
                        kmajor_desc(win_u + sa * STAGE_BYTES + h * HALF, 0));
            } else {
              wgmma_n64_zero(
                  acc, kmajor_desc(qa, 0),
                  kmajor_desc(win_u + sa * STAGE_BYTES + h * HALF, 0));
            }
#pragma unroll
            for (int ks = 1; ks < 4; ++ks) {
              if (ks < ka) {
                wgmma_n64(acc, kmajor_desc(qa, ks),
                          kmajor_desc(win_u + sa * STAGE_BYTES + h * HALF, ks));
              }
            }
#pragma unroll
            for (int ks = 0; ks < 4; ++ks) {
              if (ks < kb) {
                wgmma_n64(acc, kmajor_desc(qb, ks),
                          kmajor_desc(win_u + sb * STAGE_BYTES + h * HALF, ks));
              }
            }
            wgmma_commit();
            wgmma_wait_all();
            fence_acc(acc);
            if constexpr (APART) {
#pragma unroll
              for (int j = 0; j < 8; ++j) {
#pragma unroll
                for (int i = 0; i < 4; ++i) sum[0][j][i] += part[j][i];
              }
            }
          }
          if constexpr (CODES) {
            // the products are done with the chunk's first stage: released
            // before the scores, so that the producer decodes the next tile
            // beside them (the last stage holds the penalties and slots)
            if (nsc > 1) {
              __syncwarp();
              if (lane == 0) mbar_arrive(empty + sa);
            }
          }
          // at a tile's last chunk, the scores (after the chunk's products:
          // no lane-dependent code between two of its wgmmas)
#pragma unroll
          for (int lh = 0; lh < 2; ++lh) {
            const int hv = nm64 == 2 ? lh : h;
            if (last_k && lh < nhalf && 64 * hv < nscore) {
              {
                // the scores of this lane's columns of the half, ascending
                if constexpr (PACK) {
#pragma unroll
                  for (int nt = 0; nt < 8; ++nt) {
                    const int c8 = 64 * hv + 8 * nt;  // the n8 tile's
                    const int cl = c8 + tpq::frag_c_col(lane, 0);
                    if (c8 < nscore) {
                      const float2 p =
                          *reinterpret_cast<const float2*>(pen + cl);
                      float2 cs = make_float2(0.0f, 0.0f);
                      if constexpr (I8) {
                        cs = *reinterpret_cast<const float2*>(scl + cl);
                      }
                      // codes: the columns' slots, the keys' low bits
                      int2 sl = make_int2(0, 0);
                      if constexpr (CODES) {
                        sl = *reinterpret_cast<const int2*>(slt + cl);
                      }
#pragma unroll
                      for (int i = 0; i < 2; ++i) {
                        if (cl + i < nscore) {
#pragma unroll
                          for (int rr = 0; rr < 2; ++rr) {
                            const float sc =
                                wg_score(sum[lh][nt][2 * rr + i], rowm[rr],
                                         i ? cs.y : cs.x, i ? p.y : p.x);
                            const int key =
                                (sortable(sc) & ~slot_mask) |
                                (CODES ? (i ? sl.y : sl.x) : ts + cl + i);
                            int& best = mx[rr][16 * lh + 2 * nt + i];
                            best = max(best, key);
                          }
                        }
                      }
                    }
                  }
                } else {
                  // exact: the half's scores through the warp's staging
                  // rows [16][SLD]; lane l then takes row l / 2 over its
                  // 32 of the half's columns, in ascending order
                  float* st = stage_s + cw * 16 * SLD;
#pragma unroll
                  for (int nt = 0; nt < 8; ++nt) {
                    const int c8 = 64 * hv + 8 * nt;
                    const int cl = c8 + tpq::frag_c_col(lane, 0);
                    if (c8 < nscore) {
                      const float2 p =
                          *reinterpret_cast<const float2*>(pen + cl);
                      float2 cs = make_float2(0.0f, 0.0f);
                      if constexpr (I8) {
                        cs = *reinterpret_cast<const float2*>(scl + cl);
                      }
#pragma unroll
                      for (int rr = 0; rr < 2; ++rr) {
                        *reinterpret_cast<float2*>(
                            st + tpq::frag_c_row(lane, 2 * rr) * SLD +
                            8 * nt + tpq::frag_c_col(lane, 0)) =
                            make_float2(wg_score(sum[lh][nt][2 * rr],
                                                 rowm[rr], cs.x, p.x),
                                        wg_score(sum[lh][nt][2 * rr + 1],
                                                 rowm[rr], cs.y, p.y));
                      }
                    }
                  }
                  __syncwarp();
                  constexpr int hw = 32;  // a lane's columns of the half
                  const int c0 = 64 * hv + (lane % 2) * hw;
                  const float* sr = st + (lane / 2) * SLD + (lane % 2) * hw;
                  // the block's first half: the lists are empty, so its
                  // first 16 columns are sorted into them at once
                  int j0 = 0;
                  if (it == 0 && lh == 0) {
                    tc::first_fill<16, KMAX>(vals, cols, sr, c0, ts + c0,
                                             nscore);
                    j0 = 16;
                    const float kth = tc::kth_of(vals, k_pair);
                    bound = fmaxf(
                        bound,
                        fmaxf(kth, __shfl_xor_sync(0xffffffffu, kth, 1)));
                  }
#pragma unroll 1
                  for (int j = j0; j < hw; j += 4) {
                    if (__any_sync(0xffffffffu, queue.n > QUEUE - 4)) {
                      queue.flush(vals, cols);
                    }
                    const float4 s4 =
                        *reinterpret_cast<const float4*>(sr + j);
#pragma unroll
                    for (int u = 0; u < 4; ++u) {
                      const float sc = u == 0   ? s4.x
                                       : u == 1 ? s4.y
                                       : u == 2 ? s4.z
                                                : s4.w;
                      if (c0 + j + u < nscore && sc >= bound &&
                          sc > vals[KMAX - 1]) {
                        queue.push(sc, ts + c0 + j + u);
                      }
                    }
                  }
                  __syncwarp();  // the staging rows are free again
                  // a bound on the row's k_pair-th value, shared with the
                  // row's other slice (scan_tc.cuh)
                  float kth = tc::kth_of(vals, k_pair);
                  kth = fmaxf(kth, __shfl_xor_sync(0xffffffffu, kth, 1));
                  if (lane % 2 == 0) rowb_s[cw * 16 + lane / 2] = kth;
                  bound = kth;
#pragma unroll
                  for (int sl = 0; sl < 2; ++sl) {
                    if (sl < S) {
                      bound = fmaxf(bound,
                                    rowb_s[(sl * 4 + lt) * 16 + lane / 2]);
                    }
                  }
                  if (dead_row) bound = -neg_inf();
                }
              }
            }
          }
          __syncwarp();
          if (lane == 0) {  // the chunk's stages are free again
            if (!CODES || nsc == 1) mbar_arrive(empty + sa);
            if (nsc > 1) mbar_arrive(empty + sb);
            // narrow: and the query buffer after the block's last products
            if (NARROW && it + 1 == n_tiles) mbar_arrive(qempty + qs);
          }
          g += nsc;
          if constexpr (DEEP) {
            if (last_k && (it + 1) % tpp == 0) {
              // phase end (deep_select.cuh): the rows' survivors of the
              // running lists' bounds staged and merged into the lists; S =
              // 1, the warp's 16 rows alone; S = 2, with its partner (warp
              // cw ^ 4: the other column half of the same rows, the staging
              // rows of warp wq), 8 rows merged each
              // k_pair, the rows' base and the warp through opaque moves:
              // what the select derives from them (list strides, array
              // offsets, the staging region and the pair's barrier) is
              // worked out here, not kept across the tiles in registers
              // (kept, the k-chunked bf16 instance spilled 16-24 B beside
              // its chunk sums)
              int kp = k_pair;
              int p0 = base64 + 16 * lt;
              int wv = cw;  // the warp: its staging region and pair
              asm volatile("mov.b32 %0, %0;" : "+r"(kp));
              asm volatile("mov.b32 %0, %0;" : "+r"(p0));
              asm volatile("mov.b32 %0, %0;" : "+r"(wv));
              const DeepWarp w{lane, BAR_PAIR + wv % 4};
              if (S == 1) {
                ds::phase_end<tc::NGRP>(w, mx, prow_s, p0, false, 0, wv,
                                        keys_s, kp, phase == 0);
              } else {
                ds::phase_end<tc::NGRP / 2>(w, mx, prow_s, p0, true, wv / 4,
                                            wv % 4, keys_s, kp, phase == 0);
              }
              ++phase;
            }
          }
        }
      }

      // the live rows' outputs
      if constexpr (DEEP) {
        // the rows this warp merged (deep_select.cuh: phase_end), from
        // their lists (its own writes), its lanes on consecutive keys
        __syncwarp();
        const int* run = keys_s + ds::run_offset();
        const int lo = S == 2 ? ds::SLOTS / 2 * h : 0;
        const int hi = S == 2 ? lo + ds::SLOTS / 2 : ds::SLOTS;
        for (int rr = 0; rr < 2; ++rr) {
          for (int r = lo; r < hi; ++r) {
            const int p = base64 + 16 * lt + 8 * rr + r;
            if (prow_s[p] >= 0) {
              int* o = out + ((size_t)b * p_tile + p) * k_pair;
              for (int i = lane; i < k_pair; i += 32) {
                o[i] = run[p * kls + i];
              }
            }
          }
        }
      } else {
        // each slice's k_pair best per row: the better head of the row's
        // two lanes, then its owner pops it (a slice of no live row has
        // nothing to give)
        queue.flush(vals, cols);
        for (int i = 0; i < (wlive ? k_pair : 0); ++i) {
          float v = vals[0];
          int c = cols[0];
          const float ov = __shfl_xor_sync(0xffffffffu, v, 1);
          const int oc = __shfl_xor_sync(0xffffffffu, c, 1);
          const bool mine = !tc::before(ov, oc, v, c);
          if (mine) {
#pragma unroll
            for (int j = 0; j < KMAX - 1; ++j) {
              vals[j] = vals[j + 1];
              cols[j] = cols[j + 1];
            }
            vals[KMAX - 1] = neg_inf();
            cols[KMAX - 1] = INT_MAX;
          } else {
            v = ov;
            c = oc;
          }
          if (lane % 2 == 0) {
            const int e = (cw * 16 + lane / 2) * k_pair + i;
            vals_s[e] = v;
            keys_s[e] = c;
          }
        }
        named_barrier(BAR_CONSUMERS, CONSUMERS);
        // one thread per live row: merge its slices' lists
        if (ct < 16 * nm) {
          const int p = base64 + ct;
          if (prow_s[p] >= 0) {
            int* o = out + ((size_t)b * p_tile + p) * 2 * k_pair;
            const float dead = -big_penalty() / 2.0f;
            // codes: the lists hold window columns, the output their slots
            int h0 = 0, h1 = 0;
            for (int i = 0; i < k_pair; ++i) {
              float v = neg_inf();
              int c = INT_MAX;
              int bs = 0;
              if (h0 < k_pair) {
                const int e = ct * k_pair + h0;
                v = vals_s[e];
                c = keys_s[e];
              }
              if (S == 2 && h1 < k_pair) {
                const int e = (ct + 64) * k_pair + h1;
                if (tc::before(vals_s[e], keys_s[e], v, c)) {
                  v = vals_s[e];
                  c = keys_s[e];
                  bs = 1;
                }
              }
              h0 += bs == 0;
              h1 += bs == 1;
              const bool alive = v > dead;
              o[i] = sortable(alive ? v : neg_inf());
              o[k_pair + i] =
                  alive ? s0 + (CODES ? col_slot(c, ca.s_rows, ca.g, ca.inv)
                                      : c)
                        : -1;
            }
          }
        }
      }
      ++qi;
    }
  }
}

// Dynamic shared memory of the instance that serves inst_k (0: k_pair) at
// width d (int8 rows: i8), writing k_pair keys or entries a row: its ring
// (and narrow, its query buffers) and k_pair's lists.
size_t smem_of(int d, int pack32, int k_pair, int i8, int inst_k = 0) {
  const int ik = inst_k ? inst_k : k_pair;
  return d * (i8 ? 1 : 2) <= NARROW_ROW
             ? narrow_smem_bytes(pack32, k_pair, ik, i8)
             : smem_bytes(pack32, k_pair, ik, i8);
}

// CTAs one SM holds at once of `kern` with `smem` bytes of dynamic shared
// memory, or minus the CUDA error code.
template <typename Kernel>
int occupancy_at(Kernel kern, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  }
  int n = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, THREADS,
                                                        smem);
  }
  return err == cudaSuccess ? n : -(int)err;
}

template <bool PACK, int KMAX, int NST, int QB, bool I8>
int occupancy_of(int d, int pack32, int k_pair) {
  return occupancy_at(block_scan_wg_kernel<PACK, KMAX, NST, QB, I8, false>,
                      smem_of(d, pack32, k_pair, I8));
}

// CTAs one SM holds at once of the instance that serves this select.
template <bool I8>
int occupancy_wg(int d, int pack32, int k_pair) {
  if (d * (I8 ? 1 : 2) <= NARROW_ROW) {
    if (pack32 && k_pair > tc::PASS_K) {
      return occupancy_of<true, ds::MAX_K, NRING_DEEP, NQB_DEEP, I8>(
          d, pack32, k_pair);
    }
    if (pack32) {
      return occupancy_of<true, tc::PASS_K, narrow_ring_of(1, 16, I8), NQB,
                          I8>(d, pack32, k_pair);
    }
    return k_pair <= 10
               ? occupancy_of<false, 10, NRING_EXACT_10, NQB, I8>(d, pack32,
                                                                  k_pair)
               : occupancy_of<false, 16, NRING_EXACT, NQB, I8>(d, pack32,
                                                               k_pair);
  }
  if (pack32 && k_pair > 16) {
    return occupancy_of<true, ds::MAX_K, RING_DEEP, 0, I8>(d, pack32, k_pair);
  }
  if (pack32) {
    return occupancy_of<true, tc::PASS_K, RING_PACK_16, 0, I8>(d, pack32,
                                                               k_pair);
  }
  return k_pair <= 10
             ? occupancy_of<false, 10, RING_EXACT_10, 0, I8>(d, pack32, k_pair)
             : occupancy_of<false, 16, RING_EXACT, 0, I8>(d, pack32, k_pair);
}

// The 2-D tensor map of the cache [capacity][d] (bf16, or int8 copied as
// bytes: TMA has no signed 8-bit type and moves the bits alike) for boxes
// {128 bytes of k, 128 rows} in the 128-byte swizzle, elements past the
// tensor filled with zeros.
bool encode_map(CUtensorMap* map, const void* decoded, int d, int capacity,
                int i8) {
  const int e = i8 ? 1 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)capacity};
  const cuuint64_t strides[1] = {(cuuint64_t)d * e};
  const cuuint32_t box[2] = {(cuuint32_t)(SW_ROW / e), (cuuint32_t)BOX_ROWS};
  const cuuint32_t elem[2] = {1, 1};
  return cuTensorMapEncodeTiled(
             map,
             i8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             2, const_cast<void*>(decoded), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The launch of the instance that serves the select of depth inst_k >=
// k_pair (its kernel and ring stages), writing k_pair keys or entries a
// row; the shared memory of that ring and of k_pair's lists. I8: int8 rows
// (q_scale, scale read), else bf16.
template <bool I8>
int launch_wg(const void* qtable, const float* q_scale, const int* probers,
              const int* start_c, const int* off, const int* capb,
              const float* penalty, const float* scale, const void* decoded,
              int* out, int n_blocks, int p_tile, int d, int capacity,
              int s_eff, int k_pair, int euclidean, int pack32, int slot_mask,
              int n_groups, int n_ctas, void* stream, int inst_k) {
  const int rb = d * (I8 ? 1 : 2);
  const size_t smem = smem_of(d, pack32, k_pair, I8, inst_k);
  if (!tc::shape_ok(n_blocks, n_ctas, p_tile, rb,
                    I8 ? MAX_ROW_I8 : MAX_ROW_BF16,
                    s_eff, k_pair, pack32, n_groups) ||
      inst_k < k_pair ||
      inst_k > (pack32 ? tc::MAX_PACK_K : tc::MAX_EXACT_K) ||
      capacity < s_eff || smem > SMEM_LIMIT ||
      (I8 && (q_scale == nullptr || scale == nullptr)) ||
      reinterpret_cast<uintptr_t>(qtable) % 16 ||
      reinterpret_cast<uintptr_t>(decoded) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap map;
  if (!encode_map(&map, decoded, d, capacity, I8)) {
    return (int)cudaErrorInvalidValue;
  }
  const float factor = euclidean ? 2.0f : 1.0f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TPQ_LAUNCH(...)                                                     \
  return tpq::launch_kernel(                                                \
      block_scan_wg_kernel<__VA_ARGS__, I8, false>, dim3(n_ctas), THREADS, \
      smem, st, map, static_cast<const unsigned char*>(qtable), q_scale,    \
      probers, start_c, off, capb, penalty, scale, out, n_blocks, p_tile,   \
      d, s_eff, k_pair, factor, slot_mask, n_groups, CodesArgs{})
  if (rb <= NARROW_ROW) {  // narrow rows: resident query buffers
    if (pack32 && inst_k > tc::PASS_K) {  // the deep selects
      TPQ_LAUNCH(true, ds::MAX_K, NRING_DEEP, NQB_DEEP);
    }
    if (pack32) TPQ_LAUNCH(true, tc::PASS_K, narrow_ring_of(1, 16, I8), NQB);
    if (inst_k <= 10) TPQ_LAUNCH(false, 10, NRING_EXACT_10, NQB);
    TPQ_LAUNCH(false, 16, NRING_EXACT, NQB);
  }
  if (pack32 && inst_k > 16) TPQ_LAUNCH(true, ds::MAX_K, RING_DEEP, 0);
  if (pack32) TPQ_LAUNCH(true, tc::PASS_K, RING_PACK_16, 0);
  if (inst_k <= 10) TPQ_LAUNCH(false, 10, RING_EXACT_10, 0);
  TPQ_LAUNCH(false, 16, RING_EXACT, 0);
#undef TPQ_LAUNCH
}

// The codes instance of this select (exact k_pair <= 10 or 16, pack32
// k_pair <= 16 or up to CODES_PASS_K pass by pass, deeper by
// deep_select.cuh): its kernel, ring stages and query buffers.
#define TPQ_CODES_INSTANCE(pack32, k_pair, X)                          \
  ((pack32) ? ((k_pair) <= tc::PASS_K    ? X(true, tc::PASS_K, CRING_PACK_16) \
               : (k_pair) <= CODES_PASS_K ? X(true, tc::PASS_K, CRING_PACK) \
                                          : X(true, ds::MAX_K, CRING_DEEP)) \
            : ((k_pair) <= 10 ? X(false, 10, CRING_EXACT)                \
                              : X(false, 16, CRING_EXACT)))

int occupancy_codes(int m, int dsub, int pack32, int k_pair) {
  const size_t smem = codes_smem_bytes(m, dsub, pack32, k_pair);
#define TPQ_OCC(P, K, N) \
  occupancy_at(block_scan_wg_kernel<P, K, N, CQB, false, true>, smem)
  return TPQ_CODES_INSTANCE(pack32, k_pair, TPQ_OCC);
#undef TPQ_OCC
}

int launch_codes(const void* qtable, const int* probers, const int* start_c,
                 const int* off, const int* capb, const float* penalty,
                 const unsigned char* codes, const void* codebook, int* out,
                 int n_blocks, int p_tile, int m, int dsub, int g, int s_eff,
                 int k_pair, int euclidean, int pack32, int slot_mask,
                 int n_groups, int n_ctas, void* stream) {
  const int d = m * dsub;
  const size_t smem = codes_smem_bytes(m, dsub, pack32, k_pair);
  if (m < CODE_CHUNK || m > 128 || (m & (m - 1)) || dsub <= 0 ||
      !tc::shape_ok(n_blocks, n_ctas, p_tile, 2 * d, NARROW_ROW, s_eff,
                    k_pair, pack32, n_groups) ||
      g <= 0 || s_eff % g || smem > SMEM_LIMIT ||
      reinterpret_cast<uintptr_t>(qtable) % 16 ||
      reinterpret_cast<uintptr_t>(codebook) % 16 ||
      reinterpret_cast<uintptr_t>(codes) % CODE_CHUNK) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap map = {};  // unused: the producer decodes the window
  const CodesArgs ca = {codes,
                        static_cast<const uint16_t*>(codebook),
                        m,
                        dsub,
                        g,
                        s_eff / g,
                        1.0f / (float)(s_eff / g),
                        codes_passes(m),
                        __builtin_ctz(pass_chunks(m))};
  const float factor = euclidean ? 2.0f : 1.0f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TPQ_RUN(P, K, N)                                                     \
  tpq::launch_kernel(block_scan_wg_kernel<P, K, N, CQB, false, true>,        \
                     dim3(n_ctas), THREADS, smem, st, map,                   \
                     static_cast<const unsigned char*>(qtable),              \
                     (const float*)nullptr, probers, start_c, off, capb,     \
                     penalty, (const float*)nullptr, out, n_blocks, p_tile, \
                     d, s_eff, k_pair, factor, slot_mask, n_groups, ca)
  return TPQ_CODES_INSTANCE(pack32, k_pair, TPQ_RUN);
#undef TPQ_RUN
}
#undef TPQ_CODES_INSTANCE

}  // namespace

// Plain C entry points (bound with ctypes). bf16: qtable [nq, d] and
// decoded [capacity, d] bf16, d <= 1024, d % 8 == 0. int8 (the *_int8
// ones): qtable [nq, d] and decoded [capacity, d] int8, d <= 1024, d % 16
// == 0, q_scale [nq] and scale [capacity] f32. Both 16-byte aligned;
// probers [n_blocks, p_tile] int32 (p_tile % 16 == 0, p_tile <= 128),
// start_c / off / capb [n_blocks] int32 (start_c[b] + s_eff <= capacity),
// penalty [capacity] f32, out int32; exact: k_pair <= 16; pack32: k_pair
// <= 64 and n_groups % 8 == 0, either n_groups == s_eff <= 128, or n_groups
// a multiple of 128 that divides s_eff. n_ctas: the persistent grid (at
// most n_blocks). Return 0 or the CUDA error code of the tensor map, an
// attribute call or the launch (cudaErrorInvalidValue, without launching,
// for other shapes). Launch on `stream`, do not synchronize and allocate
// nothing.
extern "C" int torchpq_block_scan_wg(
    const void* qtable, const int* probers, const int* start_c,
    const int* off, const int* capb, const float* penalty,
    const void* decoded, int* out, int n_blocks, int p_tile, int d,
    int capacity, int s_eff, int k_pair, int euclidean, int pack32,
    int slot_mask, int n_groups, int n_ctas, void* stream) {
  return launch_wg<false>(qtable, nullptr, probers, start_c, off, capb,
                          penalty, nullptr, decoded, out, n_blocks, p_tile, d,
                          capacity, s_eff, k_pair, euclidean, pack32,
                          slot_mask, n_groups, n_ctas, stream, k_pair);
}

extern "C" int torchpq_block_scan_wg_int8(
    const void* qtable, const float* q_scale, const int* probers,
    const int* start_c, const int* off, const int* capb,
    const float* penalty, const float* scale, const void* decoded, int* out,
    int n_blocks, int p_tile, int d, int capacity, int s_eff, int k_pair,
    int euclidean, int pack32, int slot_mask, int n_groups, int n_ctas,
    void* stream) {
  return launch_wg<true>(qtable, q_scale, probers, start_c, off, capb,
                         penalty, scale, decoded, out, n_blocks, p_tile, d,
                         capacity, s_eff, k_pair, euclidean, pack32,
                         slot_mask, n_groups, n_ctas, stream, k_pair);
}

// The entry points above on the instance of a deeper select of the same
// kind, inst_k >= k_pair (its ring stages): a launch that writes fewer keys
// than the instance serves, which measures what the select's depth costs
// apart from the ring.
extern "C" int torchpq_block_scan_wg_instance(
    const void* qtable, const int* probers, const int* start_c,
    const int* off, const int* capb, const float* penalty,
    const void* decoded, int* out, int n_blocks, int p_tile, int d,
    int capacity, int s_eff, int k_pair, int euclidean, int pack32,
    int slot_mask, int n_groups, int n_ctas, void* stream, int inst_k) {
  return launch_wg<false>(qtable, nullptr, probers, start_c, off, capb,
                          penalty, nullptr, decoded, out, n_blocks, p_tile, d,
                          capacity, s_eff, k_pair, euclidean, pack32,
                          slot_mask, n_groups, n_ctas, stream, inst_k);
}

extern "C" int torchpq_block_scan_wg_int8_instance(
    const void* qtable, const float* q_scale, const int* probers,
    const int* start_c, const int* off, const int* capb,
    const float* penalty, const float* scale, const void* decoded, int* out,
    int n_blocks, int p_tile, int d, int capacity, int s_eff, int k_pair,
    int euclidean, int pack32, int slot_mask, int n_groups, int n_ctas,
    void* stream, int inst_k) {
  return launch_wg<true>(qtable, q_scale, probers, start_c, off, capb,
                         penalty, scale, decoded, out, n_blocks, p_tile, d,
                         capacity, s_eff, k_pair, euclidean, pack32,
                         slot_mask, n_groups, n_ctas, stream, inst_k);
}

// Dynamic shared memory of one CTA at width d (narrow rows of at most 256
// bytes, or k-chunked ones: d enters no further, the ring's stages being
// 128 bytes of any row).
extern "C" long long torchpq_block_scan_wg_smem(int d, int pack32,
                                               int k_pair) {
  return (long long)smem_of(d, pack32, k_pair, 0);
}
extern "C" long long torchpq_block_scan_wg_int8_smem(int d, int pack32,
                                                    int k_pair) {
  return (long long)smem_of(d, pack32, k_pair, 1);
}

// CTAs one SM holds at once (registers and shared memory permitting), or
// minus the CUDA error code.
extern "C" int torchpq_block_scan_wg_occupancy(int d, int pack32,
                                               int k_pair) {
  return occupancy_wg<false>(d, pack32, k_pair);
}
extern "C" int torchpq_block_scan_wg_int8_occupancy(int d, int pack32,
                                                    int k_pair) {
  return occupancy_wg<true>(d, pack32, k_pair);
}

// The codes scan on this kernel's narrow body (codes_scan_wg: the window
// decoded by the producer warpgroup). qtable [nq, d] bf16 (16-byte
// aligned), probers [n_blocks, p_tile] int32 (p_tile % 16 == 0, p_tile <=
// 128), start_c / off / capb [n_blocks] int32, penalty [capacity] f32,
// codes the packed uint8 storage (slot j's m bytes at j m; 8-byte
// aligned), m a power of two from 8 to 128, codebook [m, 256, dsub] bf16
// (16-byte aligned), d = m * dsub <= 128 and d % 8 == 0, g the pack group
// (s_eff % g == 0), out int32; exact: k_pair <= 16; pack32: k_pair <= 48
// and n_groups % 8 == 0, either n_groups == s_eff <= 128 or n_groups a
// multiple of 128 that divides s_eff. n_ctas: the persistent grid (at most
// n_blocks). Returns 0 or the CUDA error code of an attribute call or the
// launch (cudaErrorInvalidValue, without launching, for other shapes or a
// shared memory above the limit: codes_smem_bytes). Launches on `stream`,
// does not synchronize and allocates nothing.
extern "C" int torchpq_codes_scan_wg(
    const void* qtable, const int* probers, const int* start_c,
    const int* off, const int* capb, const float* penalty,
    const unsigned char* codes, const void* codebook, int* out, int n_blocks,
    int p_tile, int m, int dsub, int g, int s_eff, int k_pair, int euclidean,
    int pack32, int slot_mask, int n_groups, int n_ctas, void* stream) {
  return launch_codes(qtable, probers, start_c, off, capb, penalty, codes,
                      codebook, out, n_blocks, p_tile, m, dsub, g, s_eff,
                      k_pair, euclidean, pack32, slot_mask, n_groups, n_ctas,
                      stream);
}

extern "C" long long torchpq_codes_scan_wg_smem(int m, int dsub, int pack32,
                                               int k_pair) {
  return (long long)codes_smem_bytes(m, dsub, pack32, k_pair);
}

extern "C" int torchpq_codes_scan_wg_occupancy(int m, int dsub, int pack32,
                                               int k_pair) {
  return occupancy_codes(m, dsub, pack32, k_pair);
}
