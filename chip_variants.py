#!/usr/bin/env python3
"""Variant builds of the block scan and the fused flat scan, timed in turns
with the built library on the JAX package's GIST records' arguments
(k-chunked rows), on random inputs at the main path's narrow windows and
the GIST k = 10 shape (--narrow), on random
inputs at the deep pack32 rows' shapes (--deep, also against a parent
tree's build), for the codes instances on random codes at the code
domain's window (--codes), or for the flat scan on the flat plan's own
arguments (--flat), on one CUDA card:

    python3 chip_variants.py                       # every variant and tier
    python3 chip_variants.py --variants wg8_ring4 --tiers int8
    python3 chip_variants.py --variants wgn_noscore --narrow
    python3 chip_variants.py --variants wgp_clock,wgp_noturns --narrow
    python3 chip_variants.py --variants wgd_noprune --ptxas-only
    python3 chip_variants.py --variants wgc_noearly,wgc_pass4 --codes
    python3 chip_variants.py --codes --parent DIR --variants wgc_deep_all
    python3 chip_variants.py --deep --parent DIR --variants wgd_noprune
    python3 chip_variants.py --flat                # the fused flat scan

On each of the records' searches (1M x 960 manifold-12, seed 1, IVF4096 x
PQ64, spill 8 cells at 512, scan_group 4: bf16 pack32 k = 10 and k = 100
at n_probe 32, exact at n_probe 8; int8 the same three) it logs the
block's shapes (blocks, live probers, live 64-prober tiles and the share
of pad rows they carry) and the built route's agreement with an
f64-summed pack32 select (bf16; the int8 routes are exact, held by
chip_smoke and the card tests): the warp-specialised instances of
block_scan_wg.cu, wgmma + TMA, bf16 and s8.

Each variant is a copy of `torchpq_tpu_torch/csrc` with text edits, built
with the package's nvcc flags into its own library under
`build/variants/`, and timed in turns with the built one on its route
(built, variant, variant, built):
  - wg_regs224: (wgmma) the consumer warpgroups' register budget
            lowered from 232 to 224 (the producer's raised from 40 to 56);
  - wg_ring4: (wgmma) rings of four stages where the built instances
            take five (exact k_pair <= 10) or six (pack32 k_pair <= 16);
  - wg8_ring4: (wgmma; for the int8 rows, whose k-chunked tiles take half
            the stages of bf16 ones) rings of four stages where the built
            k-chunked instances take five (exact k_pair <= 10) or six
            (pack32 k_pair <= 16);
  - wgn_*: (wgmma, narrow rows d <= 128; ptxas only, these records being
            d 1024) wgn_regs224: the producer's and the consumers'
            registers at 56 / 224 instead of 40 / 232; and some that
            compute wrong keys, to
            time what a part costs (--narrow only): wgn_nopen, no penalty
            loads in the producer; wgn_noscore, no scores or maxima;
            wgn_noprod, no products; wgn_noselect, no phase-end extraction
            (pack32 up to k_pair 16) or list pops (exact);
  - wgp_*: (the consumers' schedule of the pass-by-pass pack32
            instances, --narrow) wgp_clock: a consumer warp's cycles by
            part (a Clock and its marks added by WGP_CLOCK's text edits,
            logged per warp and tile: waiting for stages, for the turn,
            products, scores, phase ends, outputs, block starts; not
            timed); wgp_noturns: decoupled
            without the turns (turn_take and turn_hand_on empty: each
            warpgroup issues its chain as its stages land);
  - wgd_*, wgn_deep_q1: (the deep pack32 instances, k_pair 17-64,
            csrc/deep_select.cuh; --deep) wgd_noprune: every group maximum
            of a phase staged and merged, the running lists' bounds
            unread; wgd_ring_less: one ring stage fewer on each deep
            instance (k-chunked 3, narrow 4; one more fits at neither but
            the narrow one on one buffer); wgd_rows1: the
            merge one row at a time, not two; wgn_deep_q1: the narrow deep
            instance on one query buffer and seven stages instead of two
            and five;
  - wgc_*: (the codes instances, --codes only) wgc_noearly: a tile's first
            k half released with its last after the scores, not after the
            products; wgc_pass4: the raw slot half as large (4 chunks of a
            column a pass, two passes at m = 64) and the exact k_pair <= 10
            instance on four ring stages in place of three; wgc_regs40:
            the producer and the consumers at 40 / 232 registers (ptxas
            spills 16-20 B) instead of 56 / 224; wgc_nodecode: the producer
            copies the codes and writes the penalties but decodes nothing
            (wrong keys, what the decode costs); wgc_restrict2: the decode's
            codebook and stage pointers __restrict__ and its loop unrolled
            by two; wgc_deep_all: pack32 above k_pair 16 all by the deep
            select (the passes instance of 17-32 unused); wgc_passes35: the
            passes up to k_pair 35; wgc_deep_ring4: the deep instance on
            four stages (where they fit: a row they do not is skipped);
  - fwg_*: (the fused flat scan's warp-specialised kernel,
            csrc/flat_scan_wg.cu; --flat, on the flat plan's own arguments
            at chip_smoke's main shape) fwg_noprune: every bucket's top 2
            offered to the lists (the bucket maxima's test against the rows'
            bounds off); fwg_novote: the votes never pass (the thinned path
            alone, wrong lists); fwg_noshare: no run publishes its bound
            (each run's lists fill from nothing); fwg_noepi: the epilogue
            elided (products only, wrong lists); fwg_rotate: the consumer
            warpgroups' products in turns (a ping-pong of three); fwg_count,
            fwg_clock: counts of the votes, passes and insert rounds, and a
            consumer warp's cycles by part (their times not timed);
            fwg_wg4, fwg_wg4_noepi: four consumer warpgroups (256 queries
            a CTA, 640 threads, registers 24 / 112), with the epilogue and
            without; fwg_ring_less: one ring stage fewer; and the built
            kernel at other run counts.
It prints each variant's ptxas report for the k-chunked and
warp-specialised instances; --ptxas-only stops there.
Imports nothing of JAX."""

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke as cs

FWG_WG4 = [("flat_scan_wg.cu", "constexpr int THREADS = 512;",
            "constexpr int THREADS = 640;"),
           ("flat_scan_wg.cu", "constexpr int PRODUCER_REGS = 32;",
            "constexpr int PRODUCER_REGS = 24;"),
           ("flat_scan_wg.cu", "constexpr int CONSUMER_REGS = 160;",
            "constexpr int CONSUMER_REGS = 112;"),
           ("flat_scan_wg.cu", "constexpr int CONSUMERS = 3;",
            "constexpr int CONSUMERS = 4;"),
           ("flat_select.cuh", "constexpr int QROWS = 192;",
            "constexpr int QROWS = 256;")]
FWG_NOEPI = [("flat_scan_wg.cu",
              "fsel::tile_votes(w, sc, bound, floors, pass, vote);",
              "(void)sc;"),
             ("flat_scan_wg.cu",
              "          fsel::tile_offers(w, sc, pass, vote, bound, floors, "
              "own, lst_v,\n                            lst_a, off, r_keep, "
              "ts);", "")]
# the wgp_clock variant: a Clock (WGP_CLOCK_DEFS) in block_scan_wg.cu, its
# marks in the turns body at WGP_CLOCK_MARKS' anchors (each found once,
# applied in order) and the sums' reader (WGP_CLOCK_READER)
WGP_CLOCK_DEFS = (
    "// A consumer warp's cycles by part: each mark adds the cycles since the\n"
    "// last one to its part, count() adds one, lane 0 into the CTA's and warp's\n"
    "// sums in wg_clock (read and cleared by torchpq_block_scan_wg_clock), so\n"
    "// that the clock holds one register. Parts: waiting for a chunk's stages\n"
    "// or the block's query rows, for the turn; the products (issue to the\n"
    "// wait's return, the chunk adds included); the scores and group maxima;\n"
    "// the phase ends; the outputs; the block's start; tiles; blocks.\n"
    "enum ClockPart {\n"
    "  CK_WAIT, CK_TURN, CK_PROD, CK_SCORE, CK_PHASE, CK_OUT, CK_START,\n"
    "  CK_TILES, CK_BLOCKS, CK_PARTS\n"
    "};\n"
    "constexpr int CK_CTAS = 256;  // CTAs with sums of their own (the rest wrap)\n"
    "__device__ unsigned long long wg_clock[CK_CTAS * 12 * CK_PARTS];\n"
    "struct Clock {\n"
    "  unsigned t;\n"
    "  __device__ __forceinline__ Clock() : t((unsigned)clock()) {}\n"
    "  __device__ __forceinline__ static void add(int part, unsigned v) {\n"
    "    if (threadIdx.x % 32 == 0) {\n"
    "      atomicAdd(wg_clock + ((blockIdx.x % CK_CTAS) * 12 + threadIdx.x / 32) *\n"
    "                               CK_PARTS + part,\n"
    "                (unsigned long long)v);\n"
    "    }\n"
    "  }\n"
    "  __device__ __forceinline__ void mark(int part) {\n"
    "    const unsigned now = (unsigned)clock();\n"
    "    add(part, now - t);\n"
    "    t = now;\n"
    "  }\n"
    "  __device__ __forceinline__ void count(int part) { add(part, 1); }\n"
    "};\n"
    "\n")
WGP_CLOCK_READER = (
    "// The consumer warps' cycle sums by part since the last call, over all\n"
    "// CTAs and warps (out: CK_PARTS counts), then cleared; 0 or the CUDA error\n"
    "// code.\n"
    "extern \"C\" int torchpq_block_scan_wg_clock(unsigned long long* out) {\n"
    "  static unsigned long long sums[CK_CTAS * 12 * CK_PARTS];\n"
    "  int rc = (int)cudaMemcpyFromSymbol(sums, wg_clock, sizeof(sums));\n"
    "  for (int i = 0; i < CK_PARTS; ++i) out[i] = 0;\n"
    "  for (int i = 0; i < CK_CTAS * 12 * CK_PARTS; ++i) {\n"
    "    out[i % CK_PARTS] += sums[i];\n"
    "    sums[i] = 0;\n"
    "  }\n"
    "  return rc ? rc : (int)cudaMemcpyToSymbol(wg_clock, sums, sizeof(sums));\n"
    "}\n"
    "\n")
WGP_CLOCK_MARKS = [
    ("    // whether block b is the CTA's last with a live prober (the prologue's\n",
     "    Clock clk;\n"
     "    // whether block b is the CTA's last with a live prober (the prologue's\n"),
    ("        __syncwarp();\n"
     "      }\n",
     "        __syncwarp();\n"
     "      }\n"
     "      clk.mark(CK_START);\n"),
    ("      const int qs = qi % NQ;\n"
     "      if constexpr (NARROW) {\n"
     "        mbar_wait(qfull + qs, (qi / NQ) & 1);\n"
     "        fence_proxy_async();  // the query copies, for wgmma's reads\n"
     "      }\n",
     "      const int qs = qi % NQ;\n"
     "      if constexpr (NARROW) {\n"
     "        mbar_wait(qfull + qs, (qi / NQ) & 1);\n"
     "        fence_proxy_async();  // the query copies, for wgmma's reads\n"
     "      }\n"
     "      clk.mark(CK_WAIT);\n"),
    ("            if (!NARROW || CODES) fence_proxy_async();\n",
     "            if (!NARROW || CODES) fence_proxy_async();\n"
     "            clk.mark(CK_WAIT);\n"),
    ("            turn_take(h);\n",
     "            turn_take(h);\n"
     "            clk.mark(CK_TURN);\n"),
    ("          // what the scores, selects and releases read, worked out anew\n",
     "          clk.mark(CK_PROD);\n"
     "          // what the scores, selects and releases read, worked out anew\n"),
    ("                    }\n"
     "                  }\n"
     "                }\n"
     "              }\n",
     "                    }\n"
     "                  }\n"
     "                }\n"
     "              }\n"
     "              clk.mark(CK_SCORE);\n"),
    ("        }\n"
     "        // the phase end, after a tile's last chunk (outside the chunk loop:\n",
     "          clk.mark(CK_SCORE);\n"
     "        }\n"
     "        // the phase end, after a tile's last chunk (outside the chunk loop:\n"),
    ("          }\n"
     "          ++phase;\n",
     "          }\n"
     "          ++phase;\n"
     "          clk.mark(CK_PHASE);\n"),
    ("          clk.mark(CK_PHASE);\n"
     "        }\n",
     "          clk.mark(CK_PHASE);\n"
     "        }\n"
     "        clk.count(CK_TILES);\n"),
    ("      pair_owed = S == 2;\n"
     "      ++qi;\n",
     "      pair_owed = S == 2;\n"
     "      ++qi;\n"
     "      clk.mark(CK_OUT);\n"
     "      clk.count(CK_BLOCKS);\n"),
]
WGP_CLOCK = (
    [("block_scan_wg.cu", "// The score of a product sum x",
      WGP_CLOCK_DEFS + "// The score of a product sum x"),
     ("block_scan_wg.cu", "// Dynamic shared memory of one CTA at width d",
      WGP_CLOCK_READER + "// Dynamic shared memory of one CTA at width d")]
    + [("block_scan_wg.cu", old, new) for old, new in WGP_CLOCK_MARKS])

VARIANTS = {
    "wg8_ring4": [("wg_layout.cuh", "constexpr int RING_EXACT_10 = 5;",
                   "constexpr int RING_EXACT_10 = 4;"),
                  ("wg_layout.cuh", "constexpr int RING_PACK_16 = 6;",
                   "constexpr int RING_PACK_16 = 4;")],
    "wg_regs224": [("block_scan_wg.cu", "constexpr int PRODUCER_REGS = 40;",
                    "constexpr int PRODUCER_REGS = 56;"),
                   ("block_scan_wg.cu", "constexpr int CONSUMER_REGS = 232;",
                    "constexpr int CONSUMER_REGS = 224;")],
    "wgn_regs224": [("block_scan_wg.cu",
                     "constexpr int NARROW_PRODUCER_REGS = 40;",
                     "constexpr int NARROW_PRODUCER_REGS = 56;"),
                    ("block_scan_wg.cu",
                     "constexpr int NARROW_CONSUMER_REGS = 232;",
                     "constexpr int NARROW_CONSUMER_REGS = 224;")],
    "wgn_nopen": [("block_scan_wg.cu", "p = __ldg(penalty + s0 + j) +",
                   "p = 0.0f +")],
    "wgn_noscore": [("block_scan_wg.cu",
                     "const int ncol = wlive ? s_eff : 0;",
                     "const int ncol = 0;")],
    "wgn_noprod": [("block_scan_wg.cu",
                    "if (rows().S == 1) {  // both halves in one chain",
                    "if (false) {"),
                   ("block_scan_wg.cu",
                    "} else if (takes_chain(2, h, nrow)) {  // one: this",
                    "} else if (false) {  //"),
                   ("block_scan_wg.cu",
                    "if (nm64 == 2) {  // both halves in one chain",
                    "if (false) {"),
                   ("block_scan_wg.cu",
                    "} else if (64 * h < nrow) {  // one: this warpgroup's",
                    "} else if (false) {  //")],
    "wgn_noselect": [("block_scan_wg.cu",
                      "const int kx = wlive ? k_pair : 0;",
                      "const int kx = 0;"),
                     ("block_scan_wg.cu",
                      "for (int i = 0; i < (wlive ? k_pair : 0); ++i) {",
                      "for (int i = 0; i < 0; ++i) {")],
    # the deep select (csrc/deep_select.cuh): no pruning (every maximum of a
    # phase staged and merged, whatever the running list's bound); one ring
    # stage fewer on each deep instance (one more fits at no deep instance
    # but the narrow one on one query buffer, wgn_deep_q1); the merge one
    # row at a time (one shuffle chain) instead of two; the narrow
    # instance on one query buffer and seven stages instead of two and five
    "wgd_noprune": [("deep_select.cuh",
                     "                                  : run[p * kls + "
                     "k_pair - 1];",
                     "                                  : INT_MIN + 0 * kls;")],
    "wgd_ring_less": [("wg_layout.cuh", "constexpr int RING_DEEP = 4;",
                       "constexpr int RING_DEEP = 3;"),
                      ("wg_layout.cuh", "constexpr int NRING_DEEP = 5;",
                       "constexpr int NRING_DEEP = 4;")],
    "wgd_rows1": [("deep_select.cuh", "constexpr int MERGE_ROWS = 2;",
                   "constexpr int MERGE_ROWS = 1;")],
    "wgn_deep_q1": [("wg_layout.cuh", "constexpr int NRING_DEEP = 5;",
                     "constexpr int NRING_DEEP = 7;"),
                    ("wg_layout.cuh", "constexpr int NQB_DEEP = 2;",
                     "constexpr int NQB_DEEP = 1;")],
    "wgc_noearly": [("block_scan_wg.cu", """            if (nsc > 1) {
              __syncwarp();
              if (lane == 0) mbar_arrive(empty + sa);
            }""", """            if (false) {
              __syncwarp();
              if (lane == 0) mbar_arrive(empty + sa);
            }"""),
                    ("block_scan_wg.cu",
                     "if (!CODES || nsc == 1) mbar_arrive(empty + sa);",
                     "mbar_arrive(empty + sa);")],
    "wgc_pass4": [("wg_layout.cuh", "constexpr int PASS_CHUNKS = 8;",
                   "constexpr int PASS_CHUNKS = 4;"),
                  ("wg_layout.cuh", "return !pack32                   ? CRING_EXACT",
                   "return !pack32 ? (k_pair <= 10 ? 4 : CRING_EXACT)"),
                  ("block_scan_wg.cu", "? X(false, 10, CRING_EXACT)",
                   "? X(false, 10, 4)")],
    "wgc_nodecode": [("block_scan_wg.cu", """      decode_chunk(rc.x, rc.y, cb_s, ca.dsub, (ps << ca.lc) + ch, cl,
                   stage0, stage1);""", """      if (rc.x == 0xFFFFFFFFu && rc.y == 0x12345678u) stage0[cl] = 0;""")],
    "wgc_restrict2": [("wg_layout.cuh", """TPQ_HD inline void decode_chunk(uint32_t lo, uint32_t hi, const uint16_t* cb,
                                int dsub, int chunk, int cl,
                                unsigned char* stage0,
                                unsigned char* stage1) {""", """TPQ_HD inline void decode_chunk(uint32_t lo, uint32_t hi,
                                const uint16_t* __restrict__ cb,
                                int dsub, int chunk, int cl,
                                unsigned char* __restrict__ stage0,
                                unsigned char* __restrict__ stage1) {"""),
                      ("block_scan_wg.cu", """  tpq::cp_async_wait<0>();
#pragma unroll 1
  for (int e = t; e < (BOX_ROWS << ca.lc); e += 128) {""", """  tpq::cp_async_wait<0>();
#pragma unroll 2
  for (int e = t; e < (BOX_ROWS << ca.lc); e += 128) {""")],
    # the codes instances' boundary between the passes (four stages) and
    # the deep select (three): the deep select from k_pair 17; the passes
    # up to 35 (the deepest whose lists fit four stages at d = 128); the
    # deep instance on four stages where they fit (k_pair <= 39 at PQ64)
    "wgc_deep_all": [("wg_layout.cuh", "constexpr int CODES_PASS_K = 32;",
                      "constexpr int CODES_PASS_K = 16;")],
    "wgc_passes35": [("wg_layout.cuh", "constexpr int CODES_PASS_K = 32;",
                      "constexpr int CODES_PASS_K = 35;")],
    "wgc_deep_ring4": [("wg_layout.cuh", "constexpr int CRING_DEEP = 3;",
                        "constexpr int CRING_DEEP = 4;")],
    "wgc_regs40": [("block_scan_wg.cu",
                    "constexpr int CODES_PRODUCER_REGS = 56;",
                    "constexpr int CODES_PRODUCER_REGS = 40;"),
                   ("block_scan_wg.cu",
                    "constexpr int CODES_CONSUMER_REGS = 224;",
                    "constexpr int CODES_CONSUMER_REGS = 232;")],
    # the fused flat scan's warp-specialised kernel (--flat): the pruning
    # off (every bucket's top 2 offered to the lists, which test it against
    # their last entry); the votes never passing (bucket maxima, tests and
    # votes, but no top 2 or insert: wrong lists, what the thinned path
    # costs); the runs' shared bound off (nothing published); the epilogue
    # elided (products only: wrong lists, what the products cost); one ring
    # stage fewer
    "fwg_noprune": [("flat_select.cuh",
                     "      p[rr] = m[b][rr] > fmaxf(bound[rr], floors[rr]);",
                     "      p[rr] = true;")],
    "fwg_novote": [("flat_select.cuh",
                    "    vote |= (unsigned)w.any(p[0] || p[1]) << b;",
                    "    vote |= (unsigned)(w.any(p[0] || p[1]) && "
                    "bound[0] > 3e38f) << b;")],
    # counts (wrong times, the same lists): the votes, those that pass, the
    # row halves among them holding a passing row, and the insert rounds
    # (passing rows whose pair goes in), read back by fwg_counts
    "fwg_count": [("flat_select.cuh", "namespace fsel {\n",
                   "namespace fsel {\n"
                   "__device__ unsigned long long counts[4];\n"),
                  ("flat_select.cuh",
                   "    vote |= (unsigned)w.any(p[0] || p[1]) << b;\n",
                   "    vote |= (unsigned)w.any(p[0] || p[1]) << b;\n"
                   "#ifdef __CUDA_ARCH__\n"
                   "    {\n"
                   "      const bool h0 = w.any(p[0]), h1 = w.any(p[1]);\n"
                   "      if (w.lane() == 0) {\n"
                   "        atomicAdd(&counts[0], 1ull);\n"
                   "        if (h0 || h1) atomicAdd(&counts[1], 1ull);\n"
                   "        atomicAdd(&counts[2], (unsigned long long)(h0 + h1));"
                   "\n"
                   "      }\n"
                   "    }\n#endif\n"),
                  ("flat_select.cuh", "    todo &= todo - 1;\n",
                   "    todo &= todo - 1;\n#ifdef __CUDA_ARCH__\n"
                   "    if (i == 0) atomicAdd(&counts[3], 1ull);\n#endif\n"),
                  ("flat_scan_wg.cu", "// Dynamic shared memory of one CTA",
                   "extern \"C\" int fwg_counts(unsigned long long* out) {\n"
                   "  const unsigned long long zero[4] = {0, 0, 0, 0};\n"
                   "  int rc = (int)cudaMemcpyFromSymbol(out, tpq::fsel::counts,"
                   " 32);\n"
                   "  return rc ? rc : (int)cudaMemcpyToSymbol("
                   "tpq::fsel::counts, zero, 32);\n}\n\n"
                   "// Dynamic shared memory of one CTA")],
    # a consumer warp's clock (wrong times, the same lists): cycles waiting
    # for a tile's stages, from then to the products' end, in the votes, in
    # the offers; votes passed; tiles; read back by fwg_clocks
    "fwg_clock": [("flat_scan_wg.cu", "    float acc[2][8][4];  // [bucket]",
                   "    float acc[2][8][4];  // [bucket]\n"
                   "    long long ck[6] = {0, 0, 0, 0, 0, 0};\n"
                   "    long long tq = 0;"),
                  ("flat_scan_wg.cu",
                   "        mbar_wait(full + sa, (g / nring) & 1);",
                   "        tq = clock64();\n"
                   "        mbar_wait(full + sa, (g / nring) & 1);"),
                  ("flat_scan_wg.cu",
                   "        const float* pen = pen_s + (nst > 1 ? sb : sa) * "
                   "BOX_ROWS;",
                   "        ck[0] += clock64() - tq;\n        tq = clock64();\n"
                   "        const float* pen = pen_s + (nst > 1 ? sb : sa) * "
                   "BOX_ROWS;"),
                  ("flat_scan_wg.cu", "          wgmma_wait_all();\n",
                   "          wgmma_wait_all();\n"
                   "          ck[1] += clock64() - tq;\n          tq = clock64();"
                   "\n"),
                  ("flat_scan_wg.cu",
                   "          fsel::tile_votes(w, sc, bound, floors, pass, vote);",
                   "          fsel::tile_votes(w, sc, bound, floors, pass, vote);"
                   "\n          ck[2] += clock64() - tq;\n          tq = clock64();"
                   "\n          ck[4] += __popc(vote);"),
                  ("flat_scan_wg.cu",
                   "                            lst_a, off, r_keep, ts);\n",
                   "                            lst_a, off, r_keep, ts);\n"
                   "          ck[3] += clock64() - tq;\n"),
                  ("flat_scan_wg.cu", "        g += nst;\n",
                   "        ck[5] += 1;\n        g += nst;\n"),
                  ("flat_scan_wg.cu", "      // the owned row's sorted top R of the run",
                   "      if (lane == 0) {\n"
                   "        for (int i = 0; i < 6; ++i) {\n"
                   "          atomicAdd(&fwg_clock[i], (unsigned long long)ck[i]);"
                   "\n          ck[i] = 0;\n"
                   "        }\n"
                   "      }\n"
                   "      // the owned row's sorted top R of the run"),
                  ("flat_scan_wg.cu",
                   "// nring: ring stages (fsel::ring_of); split:",
                   "__device__ unsigned long long fwg_clock[6];\n\n"
                   "// nring: ring stages (fsel::ring_of); split:"),
                  ("flat_scan_wg.cu", "// Dynamic shared memory of one CTA",
                   "extern \"C\" int fwg_clocks(unsigned long long* out) {\n"
                   "  const unsigned long long zero[6] = {0, 0, 0, 0, 0, 0};\n"
                   "  int rc = (int)cudaMemcpyFromSymbol(out, fwg_clock, 48);\n"
                   "  return rc ? rc : (int)cudaMemcpyToSymbol(fwg_clock, zero, "
                   "48);\n}\n\n"
                   "// Dynamic shared memory of one CTA")],
    # the consumer warpgroups' products in turns (a ping-pong of three: each
    # issues after the previous one's products end, so that its scores run
    # beside the others' products)
    "fwg_rotate": [("flat_scan_wg.cu",
                    "constexpr int CONSUMER_WARPS = 4 * CONSUMERS;",
                    "constexpr int CONSUMER_WARPS = 4 * CONSUMERS;\n"
                    "constexpr int BAR_TURN = 1;"),
                   ("flat_scan_wg.cu",
                    "        if (live) {\n          wgmma_fence();",
                    "        if (g > 0 || h > 0) named_barrier(BAR_TURN + h, 256);"
                    "\n        if (live) {\n          wgmma_fence();"),
                   ("flat_scan_wg.cu",
                    "          wgmma_wait_all();\n          fence_acc(acc[0]);",
                    "          wgmma_wait_all();\n        }\n"
                    "        asm volatile(\"bar.arrive %0, %1;\" :: \"r\"("
                    "BAR_TURN + (h + 1) % CONSUMERS), \"r\"(256) : "
                    "\"memory\");"
                    "\n        if (live) {\n          fence_acc(acc[0]);"),
                   ("flat_scan_wg.cu",
                    "    }\n  }\n}\n\n// The 2-D tensor map of a bf16 matrix",
                    "    }\n    if (h == 0 && g > 0) named_barrier(BAR_TURN, 256);"
                    "\n  }\n}\n\n// The 2-D tensor map of a bf16 matrix")],
    # the turns body's consumer warps' cycles by part (WGP_CLOCK: waiting
    # for stages, for the turn, products, scores, phase ends, outputs, block
    # starts; tiles, blocks), read back by torchpq_block_scan_wg_clock (not
    # timed)
    "wgp_clock": WGP_CLOCK,
    # the pass-by-pass instances decoupled without their turns (each
    # warpgroup issues its chain as its stages land; no barrier of all
    # consumers either way): what the turns add beside the barriers' removal
    "wgp_noturns": [("block_scan_wg.cu",
                     "void turn_take(int h) {\n",
                     "void turn_take(int h) {\n  return;\n"),
                    ("block_scan_wg.cu",
                     "void turn_hand_on(int h) {\n",
                     "void turn_hand_on(int h) {\n  return;\n")],
    "fwg_noshare": [("flat_scan_wg.cu", "atomicMax(gkey + q, key);",
                     "(void)key;")],
    "fwg_noepi": FWG_NOEPI,
    # four consumer warpgroups of one m64 tile (256 queries a CTA, the cache
    # read from L2 a quarter fewer times), registers 24 / 112; and so with
    # the epilogue elided
    "fwg_wg4": FWG_WG4,
    "fwg_wg4_noepi": FWG_WG4 + FWG_NOEPI,
    "fwg_ring_less": [("flat_select.cuh",
                       "? MAX_RING : ring_fit(d, r_keep);",
                       "? MAX_RING - 1 : ring_fit(d, r_keep) - 1;")],
}
SOURCES = ("block_scan.cu", "block_scan_wg.cu")
FLAT_SOURCES = ("flat_scan_wg.cu",)


def ptxas(log, tag):
    """Registers and spills of the warp-specialised instances (bf16, int8
    and codes) in a build log, and the warpgroup syncs ptxas injected into
    each (around a wgmma whose registers other code touches: they
    serialise the warpgroup's products)."""
    injected = {}
    for m in re.finditer(r"warpgroup\.(?:arrive|wait) is injected.*?"
                         r"function '(\S+)'", log):
        name = cs.kernel_name(m.group(1))
        injected[name] = injected.get(name, 0) + 1
    for name, n in sorted(injected.items()):
        print(f"ptxas {tag} {name}: {n} warpgroup syncs injected",
              flush=True)
    kernel = "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = cs.kernel_name(m.group(1))
        elif ("registers" in line or "spill" in line) and \
                ("block_scan_wg_kernel" in kernel or
                 "flat_scan_wg_kernel" in kernel):
            print(f"ptxas {tag} {kernel}: {line.strip()}", flush=True)


def build_variant(_build, name, edits):
    """The variant's library: csrc copied, edited, built, bound."""
    src = Path("build/variants") / name
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build._PKG / "csrc", src)
    for fname, old, new in edits:
        text = (src / fname).read_text()
        if old not in text:
            cs.fail(f"variant {name}: {old!r} not in {fname}")
        (src / fname).write_text(text.replace(old, new))
    nvcc = _build._nvcc()
    sources = FLAT_SOURCES if name.startswith("fwg") else SOURCES
    objs = [src / (f + ".o") for f in sources]
    procs = [subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-c", str(src / f), "-o", str(o)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for f, o in zip(sources, objs)]
    log = "".join(p.communicate()[0] for p in procs)
    if any(p.returncode for p in procs):
        cs.fail(f"variant {name}: nvcc failed:\n{log}")
    so = src / "libvariant.so"
    subprocess.run([nvcc, "-shared", "-o", str(so), *map(str, objs),
                    *_build.LINK_FLAGS], check=True)
    ptxas(log, name)
    lib = ctypes.CDLL(str(so))
    for fn_name, (argtypes, restype) in _build._SIGNATURES.items():
        fn = getattr(lib, fn_name, None)
        if fn is not None:
            fn.argtypes, fn.restype = argtypes, restype
    return lib


def shapes(torch, args):
    """Blocks, live probers, live 64-prober tiles and the share of pad rows
    those tiles carry (the warp-specialised route's products)."""
    probers = args[1]
    blocks = probers.shape[0]
    live = int((probers >= 0).sum())
    tiles = probers.view(blocks, -1, 64) >= 0
    live64 = int(tiles.any(-1).sum())
    return (f"{blocks} blocks, {live} live probers "
            f"({live / probers.numel():.3f}), {live64} live 64-prober tiles "
            f"({1 - live / max(64 * live64, 1):.3f} of their rows pads)")


# the codes rows of --codes, on `random_codes_inputs` at the code domain's
# window (s_eff 1024): (m, dsub, k_pair, pack32, live probers a block (0:
# drawn from 1-128), blocks); pack32 above k_pair 16: the pqr3_codes base
# scans at k = 10, n_probe 8 (k_pair 20, G = 128) and k = 100, n_probe 32 /
# 8 (k_pair 52 / 64, G = 512), k_pair 40 (G = 512), the 4-bit byte pairs
# at 47, PQ128 at 64; then the passes' reach against the deep select's
# (k_pair 17-39 at the pqr3_codes blocks' liveness, 20 and 71 live probers
# a block, and drawn: G = 128, one phase, up to k_pair 32; 512 above)
CODES_ROWS = (
    (64, 2, 10, False, 0, 4507), (64, 2, 10, True, 0, 4507),
    (32, 4, 10, False, 0, 4507), (32, 4, 10, True, 0, 4507),
    (64, 2, 10, False, 19, 4507), (64, 2, 10, True, 71, 4507),
    (64, 2, 20, True, 20, 4075), (64, 2, 52, True, 71, 4509),
    (64, 2, 64, True, 20, 4075), (64, 2, 40, True, 0, 4507),
    (32, 4, 47, True, 0, 4507), (128, 1, 64, True, 0, 4507),
    (64, 2, 17, True, 20, 4075), (64, 2, 17, True, 71, 4509),
    (64, 2, 17, True, 0, 4507), (64, 2, 20, True, 71, 4509),
    (64, 2, 20, True, 0, 4507), (64, 2, 24, True, 20, 4075),
    (64, 2, 24, True, 71, 4509), (64, 2, 24, True, 0, 4507),
    (64, 2, 28, True, 20, 4075), (64, 2, 28, True, 71, 4509),
    (64, 2, 28, True, 0, 4507), (64, 2, 32, True, 20, 4075),
    (64, 2, 32, True, 71, 4509), (64, 2, 32, True, 0, 4507),
    (64, 2, 33, True, 71, 4509), (64, 2, 35, True, 20, 4075),
    (64, 2, 35, True, 71, 4509), (64, 2, 35, True, 0, 4507),
    (64, 2, 39, True, 0, 4507), (32, 4, 20, True, 71, 4509),
    (32, 4, 28, True, 71, 4509))


def codes_turns(torch, lib, libs):
    """The codes instances (block_scan_wg.cu, CODES) of the built library
    on CODES_ROWS: each deep row first bit for bit against codes_scan_ref
    on integer inputs (`integer_codes_inputs`, 256 blocks; live rows, pad
    rows dead); then on random codes in turns (built, the others, ...,
    built; 10 launches a turn) with each wgc_* variant and, with --parent,
    the parent tree's codes instance of the same select (block_scan_wg.cu)
    and its mma.sync sorted codes_scan_tc.cu, where they take the row,
    each with its share of live keys equal to the built instance's."""
    from torchpq_tpu_torch.ops import block_scan as bs
    from torchpq_tpu_torch.ops import codes_scan as cods
    stream = torch.cuda.current_stream().cuda_stream
    for m, dsub, k_pair, pack32, n_live, blocks in CODES_ROWS:
        kw = dict(s_eff=1024, k_pair=k_pair, euclidean=True, pack32=pack32,
                  slot_mask=1023)
        route = cods.pick_route(m=m, dsub=dsub, p_tile=128, s_eff=1024,
                                k_pair=k_pair, pack32=pack32)
        what = (f"codes m={m} dsub={dsub} {route} k_pair={k_pair} "
                f"(ring {cods.wg_ring(pack32, k_pair)})"
                f"{f' ({n_live} live)' if n_live else ''}")
        if pack32 and k_pair > 16:
            args = cods.integer_codes_inputs(
                "cuda", s_eff=1024, n_blocks=256, nq=10000, m=m, dsub=dsub,
                cap_total=1 << 18, seed=m + k_pair)
            got = cods.launch(lib, stream, *args, route=route, **kw)
            torch.cuda.synchronize()
            ref = cods.codes_scan_ref(*args, **kw)
            live = args[1] >= 0
            if not torch.equal(got[live], ref[live]) or not cs.dead_rows(
                    torch, bs, got, args[1], k_pair, pack32):
                cs.fail(f"{what}: the built instance differs from "
                        f"codes_scan_ref on integer inputs "
                        f"({cs.share_equal(got[live], ref[live]):.6f} of live "
                        "entries equal) or writes pad rows alive")
            print(f"{what}: integer inputs bit for bit against "
                  "codes_scan_ref (live rows; pad rows dead)", flush=True)
            del args, got, ref
        args = cods.random_codes_inputs("cuda", s_eff=1024, n_blocks=blocks,
                                        nq=10000, m=m, dsub=dsub,
                                        cap_total=1 << 21, seed=5)
        if n_live:
            args[1][:, n_live:] = -1
        live = args[1] >= 0
        outs = {"built": cods.launch(lib, stream, *args, route=route, **kw)}
        fns = {"built": lambda: cods.launch(lib, stream, *args, route=route,
                                            **kw)}
        for kind, entry in (("wg", "torchpq_codes_scan_wg"),
                            ("codes", "torchpq_codes_scan_tc")):
            plib = cs.PARENT.get(kind)
            if plib is None or not hasattr(plib, entry):
                continue
            launch, out = cs.codes_launch_fn(torch, bs, plib, entry, args, kw)
            if launch is None or launch() != 0:
                print(f"{what}: the parent's {entry} does not take the row",
                      flush=True)
                continue
            fns["parent_" + kind], outs["parent_" + kind] = launch, out
        for name, vlib in libs.items():
            if not name.startswith("wgc_"):
                continue
            try:
                outs[name] = cods.launch(vlib, stream, *args, route=route,
                                         **kw)
            except ValueError as e:  # its shared memory exceeds the limit
                print(f"{what}: {name} refuses the row: {e}", flush=True)
                continue
            fns[name] = (lambda v: lambda: cods.launch(
                v, stream, *args, route=route, **kw))(vlib)
        torch.cuda.synchronize()
        for name, out in outs.items():
            if name != "built":
                print(f"{what}: {name} live keys equal to the built "
                      f"instance's {cs.share_equal(out[live], outs['built'][live]):.6f}",
                      flush=True)
        t, turns = cs.in_turns(torch, fns, 10)
        print(f"{what}: " + ", ".join(
            f"{n} {t[n]:.3f} ms {[round(x, 3) for x in turns[n]]}"
            for n in fns), flush=True)
        del args, outs, fns


# the deep pack32 rows (k_pair 17-64) of PERF.md, and the main path's
# k_pair 10 selects, on `random_inputs` / `random_int8_inputs` at each row's
# shape: (name, int8, d, s_eff, k_pair, pack32, blocks)
DEEP_ROWS = (
    ("deep-k head", False, 128, 4096, 64, True, 2048),   # G 512, 8 tiles
    ("deep-k untapered", False, 128, 512, 64, True, 4096),  # G 256, 2
    ("pqr3 k = 100", False, 128, 2048, 64, True, 2048),  # G 512, 4 tiles
    ("pq4 k = 100", False, 128, 2560, 64, True, 2048),   # G 512, 5 tiles
    ("residual k = 100", False, 128, 640, 64, True, 4096),  # G 128, 5
    ("k_pair 40, G 512", False, 128, 2048, 40, True, 2048),
    ("int8 k_pair 64, G 512", True, 128, 2048, 64, True, 2048),
    ("GIST bf16 k = 100", False, 1024, 2048, 64, True, 1024),
    ("GIST bf16 k_pair 48", False, 1024, 2048, 48, True, 1024),
    ("GIST int8 k = 100", True, 1024, 2048, 64, True, 1024),
    ("main exact k_pair 10", False, 128, 640, 10, False, 4096),
    ("main pack32 k_pair 10", False, 128, 640, 10, True, 4096))


def deep_turns(torch, bs, lib, libs, parent):
    """The deep pack32 instances of the built library (csrc/deep_select.cuh)
    on DEEP_ROWS: first bit for bit against block_scan_ref on integer
    inputs (`integer_block_inputs`, int8 `int8_tie_inputs`; 256 blocks; live
    rows, pad rows dead), then on random inputs (each block's live probers
    drawn from 1-128) their live keys against the parent tree's
    block_scan_wg.cu instance of the same select (--parent; equal, the
    products and the selects' results being the same) and in turns
    (built, parent, variants..., ..., built; 5 launches a turn) with it,
    with the parent's mma.sync block_scan_tc.cu where it takes the row, and
    with each variant."""
    for name, int8, d, s_eff, k_pair, pack32, blocks in DEEP_ROWS:
        slot_mask = bs.util.next_pow2(s_eff) - 1
        base = dict(s_eff=s_eff, k_pair=k_pair, euclidean=True,
                    pack32=pack32, slot_mask=slot_mask)
        cap = 1 << (19 if d > 128 else 21)
        if int8:
            args, scale, q_scale = bs.int8_tie_inputs(
                "cuda", s_eff=s_eff, n_blocks=256, nq=10000, d=d,
                cap_total=1 << 18, seed=k_pair)
            kkw = dict(base, scale=scale, q_scale=q_scale)
        else:
            args = bs.integer_block_inputs("cuda", s_eff=s_eff, n_blocks=256,
                                           nq=10000, d=d, cap_total=1 << 18,
                                           seed=k_pair)
            kkw = dict(base)
        launch, out = cs.wg_launch_fn(torch, bs, lib, args, kkw)
        if launch is None or launch() != 0:
            cs.fail(f"{name}: the built block_scan_wg.cu refuses the shapes")
        torch.cuda.synchronize()
        ref = bs.block_scan_ref(*args, **kkw)
        live = args[1] >= 0
        if not torch.equal(out[live], ref[live]) or not cs.dead_rows(
                torch, bs, out, args[1], k_pair, pack32):
            cs.fail(f"{name}: the built instance differs from block_scan_ref "
                    f"on integer inputs ({cs.share_equal(out[live], ref[live]):.6f}"
                    " of live entries equal) or writes pad rows alive")
        print(f"{name}: integer inputs bit for bit against block_scan_ref "
              f"(live rows; pad rows dead)", flush=True)
        del args, ref
        if int8:
            args, scale, q_scale = bs.random_int8_inputs(
                "cuda", s_eff=s_eff, n_blocks=blocks, nq=10000, d=d,
                cap_total=cap, seed=s_eff)
            kkw = dict(base, scale=scale, q_scale=q_scale)
        else:
            args = bs.random_inputs("cuda", s_eff=s_eff, n_blocks=blocks,
                                    nq=10000, d=d, cap_total=cap, seed=s_eff)
            kkw = dict(base)
        live = args[1] >= 0
        fns = {}
        for tag, lb in [("built", lib)] + ([("parent", parent["wg"])]
                                           if "wg" in parent else []) \
                + list(libs.items()):
            launch, out = cs.wg_launch_fn(torch, bs, lb, args, kkw)
            if launch is None or launch() != 0:
                print(f"{name}: {tag} refuses the shapes", flush=True)
                continue
            fns[tag] = (launch, out)
        if "bf16" in parent and not int8 and d <= 128:
            launch, out = cs.tc_launch_fn(torch, bs, parent["bf16"], args,
                                          kkw)
            if launch is not None and launch() == 0:
                fns["parent_mma_sync"] = (launch, out)
        torch.cuda.synchronize()
        for tag, (_, out) in fns.items():
            if tag != "built":
                print(f"{name}: {tag} live keys equal to the built "
                      f"instance's {cs.share_equal(out[live], fns['built'][1][live]):.6f}",
                      flush=True)
        t, turns = cs.in_turns(torch, {k: v[0] for k, v in fns.items()}, 5)
        print(f"{name} ({shapes(torch, args)}): " + ", ".join(
            f"{k} {t[k]:.3f} ms {[round(x, 3) for x in turns[k]]}"
            for k in fns), flush=True)
        del args, fns
        torch.cuda.empty_cache()


# the Clock's parts (WGP_CLOCK_DEFS: CK_*), in order
CLOCK_PARTS = ("waiting", "turn", "products", "scores", "phase ends",
               "outputs", "block starts", "tiles", "blocks")
# the rows of --narrow, on `random_inputs`: (s_eff, blocks, k_pair, pack32,
# d); the main path's window (s_eff 640: exact and pack32 k_pair 10), the
# deep-k tail's (s_eff 4096, pack32 k_pair 16) and the GIST k = 10 shape
# (d 1024, s_eff 2048, pack32 k_pair 10, the k-chunked instance, the
# record's 2,677 blocks at n_probe 32)
NARROW_ROWS = ((640, 4096, 10, False, 128), (640, 4096, 10, True, 128),
               (4096, 2048, 16, True, 128), (2048, 2677, 10, True, 1024))


def clock_split(torch, vlib, launch, what):
    """A launch of the wgp_clock variant: its consumer warps' cycles by part,
    per warp and tile."""
    import ctypes
    clocks = (ctypes.c_ulonglong * len(CLOCK_PARTS))()
    fn = vlib.torchpq_block_scan_wg_clock
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    fn(clocks)
    launch()
    torch.cuda.synchronize()
    if fn(clocks) != 0:
        cs.fail(f"{what}: torchpq_block_scan_wg_clock failed")
    got = dict(zip(CLOCK_PARTS, clocks))
    tiles = max(got["tiles"], 1)
    parts = [n for n in CLOCK_PARTS if n not in ("tiles", "blocks")]
    total = sum(got[n] for n in parts)
    print(f"{what} (wgp_clock): a consumer warp's cycles a tile, "
          f"{got['tiles']} warp-tiles of {got['blocks']} warp-blocks: "
          + ", ".join(f"{n} {got[n] / tiles:.0f}" for n in parts)
          + f"; all {total / tiles:.0f}", flush=True)


def narrow_turns(torch, bs, lib, libs):
    """The bf16 routes of the built library and of each variant in turns
    (built, variant, variant, built; 5 launches a turn) on NARROW_ROWS, each
    block's live probers drawn uniformly from 1-128; the wgp_clock variant
    logs its cycle split (clock_split) in place of a time."""
    stream = torch.cuda.current_stream().cuda_stream
    for s_eff, blocks, k_pair, pack32, d in NARROW_ROWS:
        args = bs.random_inputs("cuda", s_eff=s_eff, n_blocks=blocks,
                                nq=10000, d=d,
                                cap_total=1 << (21 if d <= 128 else 19),
                                seed=s_eff)
        kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=True, pack32=pack32,
                  slot_mask=bs.util.next_pow2(s_eff) - 1)
        route = bs.pick_route(dtype=torch.bfloat16, d=d, p_tile=128,
                              s_eff=s_eff, k_pair=k_pair, pack32=pack32)
        what = (f"{route} d={d} s_eff={s_eff} k_pair={k_pair} "
                f"({shapes(torch, args)})")
        for name, vlib in libs.items():
            if name.startswith("wgp") and not (pack32 and k_pair <= 16):
                continue  # the turns body's variants; this row is lockstep
            if name == "wgp_clock":
                clock_split(torch, vlib, lambda: bs.launch(
                    vlib, stream, *args, route=route, **kw), what)
                continue
            t, turns = cs.in_turns(torch, {
                "built": lambda: bs.launch(lib, stream, *args, route=route,
                                           **kw),
                name: lambda: bs.launch(vlib, stream, *args, route=route,
                                        **kw)}, 5)
            print(f"{what}: built {t['built']:.3f} ms "
                  f"{[round(x, 3) for x in turns['built']]}, {name} "
                  f"{t[name]:.3f} ms {[round(x, 3) for x in turns[name]]}",
                  flush=True)
        del args


# the runs of the flat plan's cache timed with the built library beside
# wg_splits' choice (13 at the plan's 1M slots and 10k queries)
FLAT_SPLITS = (3, 6, 12, 24)


def flat_turns(torch, tp, lib, libs):
    """The fused flat scan's warp-specialised kernel (csrc/flat_scan_wg.cu)
    of the built library and of each fwg_* variant in turns (built,
    variant, variant, built; 5 launches a turn) on the flat plan's own
    arguments: chip_smoke's main shape (1M x 128 manifold-12, seed 0,
    IVF4096 x PQ64 trained on 100k, four adds), scan_impl="pallas_flat",
    k = 10 (r_keep 16); each variant's lists held to the built one's
    (equal but for fwg_noepi); then the built kernel at other run counts
    (n_splits) beside wg_splits' choice, in turns."""
    from torchpq_tpu_torch.ops import flat_scan as fs
    base, query = cs.make_data(1_000_000, 10_000, 128)
    index = tp.IVFPQIndex(d_vector=128, n_subvectors=64, n_cells=4096,
                          initial_size=732, distance="euclidean",
                          device="cuda")
    index.train(torch.from_numpy(base[:100_000]).cuda().T)
    trained = {**index.vq_codec.state_dict("vq_codec."),
               **index.pq_codec.state_dict("pq_codec.")}
    del index
    index, _ = cs.build_index(torch, tp, trained, base, d=128, m=64,
                              n_cells=4096, per_cell=732, cache=None)
    xq = torch.from_numpy(query).cuda()
    index.scan_mode, index.use_approx_topk = "flat", True
    index.scan_impl = "pallas_flat"
    args, kw = cs.capture_call(tp, index, xq, 10, module=tp.ops.flat_adc,
                               name="flat_scan")
    del index
    torch.cuda.empty_cache()
    stream = torch.cuda.current_stream().cuda_stream
    nq, d = args[0].shape
    cap = args[1].shape[0]
    flop = 2.0 * nq * cap * d
    what = f"flat_wg nq={nq} cap={cap} d={d} r_keep={kw['r_keep']}"

    def run(which, **extra):
        return fs._launch_wg(which, stream, *args, **kw, **extra)

    ref = run(lib)
    torch.cuda.synchronize()
    for name, vlib in libs.items():
        if name == "fwg_clock":
            clocks = (ctypes.c_ulonglong * 6)()
            vlib.fwg_clocks(clocks)
            run(vlib)
            torch.cuda.synchronize()
            vlib.fwg_clocks(clocks)
            full, prod, votes, offers, passed, tiles = list(clocks)
            print(f"{what} (fwg_clock): a consumer warp's cycles a tile, "
                  f"{tiles} warp-tiles: waiting for the stages "
                  f"{full / tiles:.0f}, products (issue to end) "
                  f"{prod / tiles:.0f}, votes {votes / tiles:.0f}, offers "
                  f"{offers / tiles:.0f} ({passed / tiles:.4f} votes passed "
                  f"a tile, {offers / max(passed, 1):.0f} cycles each)",
                  flush=True)
            continue
        if name == "fwg_count":
            counts = (ctypes.c_ulonglong * 4)()
            vlib.fwg_counts(counts)
            got = run(vlib)
            torch.cuda.synchronize()
            vlib.fwg_counts(counts)
            votes, passed, halves, rounds = list(counts)
            print(f"{what} (fwg_count): {votes} votes of 16 rows, "
                  f"{passed} ({passed / votes:.4f}) passing, {halves} "
                  f"passing row halves of 8 ({halves / (2 * votes):.4f} of "
                  f"them); {rounds} insert rounds "
                  f"({rounds / max(passed, 1):.2f} a passing vote, "
                  f"{rounds / nq:.1f} a query); lists equal: "
                  f"{torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])}",
                  flush=True)
            continue
        if not name.startswith("fwg"):
            continue
        got = run(vlib)
        torch.cuda.synchronize()
        equal = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        t, turns = cs.in_turns(torch, {"built": lambda: run(lib),
                                       name: lambda: run(vlib)}, 5)
        print(f"{what}: built {t['built']:.3f} ms "
              f"{[round(x, 3) for x in turns['built']]}, {name} "
              f"{t[name]:.3f} ms {[round(x, 3) for x in turns[name]]} "
              f"({flop / t[name] / 1e9:.1f} TFLOP/s), lists equal to the "
              f"built kernel's: {equal}", flush=True)
    chosen = fs.wg_splits(nq, cap, torch.cuda.get_device_properties(0)
                          .multi_processor_count)[1]
    fns = {f"n_splits {n}": (lambda n=n: run(lib, n_splits=n))
           for n in FLAT_SPLITS}
    t, turns = cs.in_turns(torch, fns, 5)
    print(f"{what}, wg_splits' choice {chosen}: " + ", ".join(
        f"{k} {t[k]:.3f} ms {[round(x, 3) for x in turns[k]]}"
        for k in fns), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=None,
                    help="comma-separated names of VARIANTS ('' for none; "
                    "default: the fwg_* ones with --flat, the others "
                    "without)")
    ap.add_argument("--tiers", default="bf16,int8",
                    help="the records' caches to time: bf16, int8")
    ap.add_argument("--ptxas-only", action="store_true",
                    help="build the variants, print their ptxas reports "
                    "and stop")
    ap.add_argument("--narrow", action="store_true",
                    help="time the variants on narrow random inputs "
                    "(narrow_turns) and stop")
    ap.add_argument("--codes", action="store_true",
                    help="time the wgc_* variants of the codes instances on "
                    "random codes (codes_turns) and stop")
    ap.add_argument("--deep", action="store_true",
                    help="check the deep pack32 instances and time them in "
                    "turns with --parent's and the variants (deep_turns) "
                    "and stop")
    ap.add_argument("--flat", action="store_true",
                    help="time the fwg_* variants of the fused flat scan on "
                    "the flat plan's arguments (flat_turns) and stop")
    ap.add_argument("--parent", default=None,
                    help="with --deep or --codes: a checkout of the parent "
                    "tree, whose block_scan_wg.cu, block_scan_tc.cu and "
                    "codes_scan_tc.cu (those it holds) are built and timed "
                    "in turns")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this run needs a card")
    print(cs.card_line(), flush=True)
    import torchpq_tpu_torch as tp
    from torchpq_tpu_torch import _build
    from torchpq_tpu_torch.ops import block_scan as bs
    lib = _build.library()
    ptxas(lib.build_log, "built")
    names = (list(filter(None, opts.variants.split(",")))
             if opts.variants is not None else
             [n for n in VARIANTS if n.startswith("fwg") == opts.flat])
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        built = pool.map(lambda n: build_variant(_build, n, VARIANTS[n]),
                         names)
        libs = dict(zip(names, built))
    if opts.ptxas_only:
        return
    if opts.deep:
        if opts.parent:
            cs.build_parent(_build, opts.parent)
        deep_turns(torch, bs, lib, libs, cs.PARENT)
        return
    if opts.narrow:
        narrow_turns(torch, bs, lib, libs)
        return
    if opts.flat:
        flat_turns(torch, tp, lib, libs)
        return
    if opts.codes:
        if opts.parent:
            cs.build_parent(_build, opts.parent)
        codes_turns(torch, lib, libs)
        return
    base, query = cs.make_data(1_000_000, 10_000, 960, seed=1)
    proto = tp.IVFPQIndex(d_vector=960, n_subvectors=64, n_cells=4096,
                          initial_size=16, device="cuda")
    proto.train(torch.from_numpy(base[:100_000]).cuda().T)
    trained = {**proto.vq_codec.state_dict("vq_codec."),
               **proto.pq_codec.state_dict("pq_codec.")}
    del proto
    xq = torch.from_numpy(query).cuda()
    stream = torch.cuda.current_stream().cuda_stream
    tiers = opts.tiers.split(",")
    for cache, plans in ((None, ((10, 32, True), (100, 32, True),
                                 (10, 8, False))),
                         ("int8", ((10, 32, True), (100, 32, True),
                                   (10, 8, False)))):
        if (cache or "bf16") not in tiers:
            continue
        index, _ = cs.build_index(torch, tp, trained, base, d=960, m=64,
                                  n_cells=4096, per_cell=488, cache=cache,
                                  spill=True)
        index.scan_group = cs.GIST_GROUP
        for k, n_probe, approx in plans:
            index.scan_mode, index.n_probe = "cell_major", n_probe
            index.use_approx_topk = approx
            args, kw = cs.capture_call(tp, index, xq, k)
            kkw = dict(s_eff=kw["s_eff"], k_pair=kw["k_pair"],
                       euclidean=kw["euclidean"], pack32=approx,
                       slot_mask=kw["slot_mask"])
            if cache:
                kkw.update(scale=kw["scale"], q_scale=kw["q_scale"])
            route = bs.pick_route(dtype=args[6].dtype, d=1024, p_tile=128,
                                  s_eff=kw["s_eff"], k_pair=kw["k_pair"],
                                  pack32=approx)
            what = (f"{cache or 'bf16'} {route} k={k} n_probe={n_probe} "
                    f"k_pair={kw['k_pair']}")
            print(f"{what}: {shapes(torch, args)}", flush=True)
            live = args[1] >= 0
            f64 = cs.pack32_f64(torch, bs, args, kkw)[live] \
                if approx and not cache else None
            if f64 is not None:
                out = bs.launch(lib, stream, *args, **kkw)
                print(f"{what} built: keys equal to the f64-summed select "
                      f"{cs.share_equal(out[live], f64):.6f}", flush=True)
            for name, vlib in libs.items():
                if name.startswith(("wgn", "wgp", "fwg")) or \
                        name.startswith("wg") != route.startswith("tc_wg_"):
                    continue  # a variant of another route's instances
                out = bs.launch(vlib, stream, *args, route=route, **kkw)
                if f64 is not None:
                    print(f"{what} {name} ({route}): keys equal to the "
                          f"f64-summed select "
                          f"{cs.share_equal(out[live], f64):.6f}",
                          flush=True)
                t, turns = cs.in_turns(torch, {
                    "built": lambda: bs.launch(lib, stream, *args,
                                               route=route, **kkw),
                    name: lambda: bs.launch(vlib, stream, *args,
                                            route=route, **kkw)}, 5)
                print(f"{what}: built {t['built']:.3f} ms "
                      f"{[round(x, 3) for x in turns['built']]}, {name} "
                      f"{t[name]:.3f} ms {[round(x, 3) for x in turns[name]]}",
                      flush=True)
            if f64 is not None:
                ref = bs.block_scan_ref(*args, **kkw)[live]
                print(f"{what} plain version: keys equal to the f64-summed "
                      f"select {cs.share_equal(ref, f64):.6f}", flush=True)
            del args, f64
        del index
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
