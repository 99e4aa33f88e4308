"""The consumers' schedule of the warp-specialised block scan's
pass-by-pass pack32 instances (csrc/block_scan_wg.cu: the warpgroups in
turns, no barrier of all consumers in the block loop), compiled with the
host's g++ and run without a card.

csrc/wg_layout.cuh holds the schedule's parts as plain functions: the
named barriers' ids and thread counts, the two consumer warpgroups' turns
(warpgroup h waits on turn_wait(h) before a chunk's chain and arrives on
turn_pass(h) after it; turn_opens / turn_hands_on), which warpgroup issues a
chain (takes_chain), a warp's rows in a block (warp_rows) and the rows and
regions it merges and writes (merge_first / merge_count, slice_region).
Here a harness runs a CTA's eight consumer warps and its producer as
coroutines on one host thread, switched in a random order at every wait and
at every use of a shared array, through the kernel's block loop step for
step: the ring's full and empty mbarriers, the narrow instances' query
buffers, the turns, the pair barriers of the phase ends and of a pair's
next live block, the codes instances' early release of a tile's first
stage. (The exact and deep pack32 instances run in lockstep on barriers of
all consumers, as before the turns, and are not modelled here.)

Each case is a sequence of blocks (one or two live 64-prober tiles,
alternating; dead 16-row slices; skipped blocks; a ragged last tile of 64
or fewer columns; one live block; none) on one instance family (narrow
bf16 and int8, k-chunked, phased, codes), with the turns and without (the
wgp_noturns variant of chip_variants.py), each run under many random
schedules. It asserts:

- every named barrier completes on its thread count, no warp arriving
  twice in one phase, and none is left part-arrived at the end; every
  mbarrier phase on its arrivals;
- no warp waits on an arrival that never comes (the coroutines never all
  wait);
- with the turns, each warpgroup's chains alternate with the other's (all
  of warpgroup 0's issues of turn t before any of warpgroup 1's, all of
  those before warpgroup 0's of turn t + 1), warpgroup 0 first;
- the ring: a warp reads a stage (and a query buffer) only after the
  producer filled it for that use, and the producer refills it only after
  all eight warps released it;
- no two blocks use one unit of the shared arrays while both are live: the
  slice lists' regions and the running lists' rows, each held from its
  first write in a block (or phase end) to its last read; a warp of
  another block (or phase end) taking it meanwhile is a fault.

Mutations of the schedule (the pair's barrier between an S = 2 block and
its next left out, warpgroup 1 handing the turn on after the CTA's last
chunk too, warpgroup 1 taking no turn where it issues no chain, warpgroup 1
opening the turns in a CTA with no live block) must fail, so that the
checks can see a fault.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from torchpq_tpu_torch.ops import block_scan as bs

_CSRC = Path(bs.__file__).resolve().parents[1] / "csrc"

_HARNESS = r"""
#include <ucontext.h>

#include <cstdio>
#include <cstdlib>
#include <map>
#include <random>
#include <vector>

#include "wg_layout.cuh"

using namespace tpq::wg;

// ---- the CTA's 8 consumer warps and its producer as coroutines ----------
constexpr int CO = 9;  // 0-7 consumer warps, 8 the producer
constexpr int STACK = 1 << 17;
static ucontext_t sched_uc, co_uc[CO];
static std::vector<char> stacks((size_t)CO * STACK);
static bool finished[CO];
static int cur;
static long progress;
static std::mt19937 rng;
static int errors;
static char first_error[256];

static void fault(const char* what) {
  if (!errors++) std::snprintf(first_error, sizeof first_error, "%s", what);
}
static void yield_co() { swapcontext(&co_uc[cur], &sched_uc); }
// a switch at a use of shared state (progress: the coroutine moved on)
static void step() {
  ++progress;
  yield_co();
}

// ---- named barriers: warps arrive (32 threads each) or wait ----------------
struct NamedBar {
  int expected = 0;
  int count = 0;
  unsigned mask = 0;  // the warps arrived in this phase
  long gen = 0;
};
static NamedBar nb[16];
static void nb_arrive(int id, int threads, int warp) {
  NamedBar& b = nb[id];
  if (id <= 0 || id >= 16) fault("barrier id out of range");
  if (b.expected == 0) b.expected = threads;
  if (b.expected != threads) fault("barrier used with two thread counts");
  if (b.mask >> warp & 1u) fault("a warp arrived twice in one phase");
  b.mask |= 1u << warp;
  b.count += 32;
  ++progress;
  if (b.count == b.expected) {
    b.count = 0;
    b.mask = 0;
    ++b.gen;
  }
}
static void nb_sync(int id, int threads, int warp) {
  const long g = nb[id].gen;
  nb_arrive(id, threads, warp);
  while (nb[id].gen == g) yield_co();
}

// ---- mbarriers: phases of `expected` arrivals, waits by parity ------------
struct MBar {
  int expected = 1;
  int pending = 1;
  long done = 0;
};
static void mb_arrive(MBar& m) {
  if (--m.pending == 0) {
    ++m.done;
    m.pending = m.expected;
  }
  ++progress;
}
// the kernel's mbar_wait: passes once the phase of parity `parity` completed
static void mb_wait(MBar& m, int parity) {
  while ((int)(m.done & 1) == parity) yield_co();
}

// ---- a case -------------------------------------------------------------
enum Family { PACK = 0, CODES_PACK = 1 };
struct Case {
  int family, narrow, nst_ring, qbufs, stages, n_tiles, last_nrow, tpp;
  int turns, mutation;
  std::vector<int> l0, l1, dead;  // per block: live tiles, dead 16-row slices
};
static Case cs;
// mutations: 1 no pair barrier between an S = 2 block and the next; 2
// warpgroup 1 hands the turn on after the CTA's last chunk too; 3
// warpgroup 1 takes no turn where it issues no chain; 4 warpgroup 1 opens
// the turns in a CTA with no live block
static bool codes() { return cs.family == CODES_PACK; }

static MBar full[8], empty_[8], qfull[2], qempty[2];
static long stage_tag[8], qbuf_tag[2];  // which fill a slot holds
static int released[8];                 // warps released since the fill

// shared units held: unit -> {warp -> tag}
static std::map<long, std::map<int, long>> held;
enum Unit { SLICE = 0, RUN = 1 };
static long unit(int kind, int i) { return (long)kind * 1000 + i; }
static void take(int warp, long u, long tag) {
  for (auto& kv : held[u]) {
    if (kv.first != warp && kv.second != tag) fault("a shared unit in use by two blocks");
  }
  held[u][warp] = tag;
  step();
}
static void drop(int warp, long u) {
  held[u].erase(warp);
  step();
}

// turn log: (warpgroup, turn) of every issue, in order
static std::vector<std::pair<int, int>> issues;

static int nrow_of(int it) {
  return it + 1 == cs.n_tiles ? cs.last_nrow : 128;
}

static void producer() {
  long g = 0, qi = 0;
  for (size_t b = 0; b < cs.l0.size(); ++b) {
    if (!cs.l0[b] && !cs.l1[b]) continue;
    for (int it = 0; it < cs.n_tiles; ++it) {
      for (int st = 0; st < cs.stages; ++st, ++g) {
        const int s = (int)(g % cs.nst_ring);
        mb_wait(empty_[s], (int)((g / cs.nst_ring) & 1) ^ 1);
        if (g >= cs.nst_ring && released[s] != WARPS) fault("a stage refilled before its release");
        released[s] = 0;
        stage_tag[s] = g;
        step();
        mb_arrive(full[s]);
      }
      if (cs.qbufs && it == 0) {
        const int q = (int)(qi % cs.qbufs);
        mb_wait(qempty[q], (int)((qi / cs.qbufs) & 1) ^ 1);
        qbuf_tag[q] = qi;
        step();
        mb_arrive(qfull[q]);
        ++qi;
      }
    }
  }
}

static void consumer(int cw) {
  const int h = cw / 4;
  long g = 0, qi = 0;
  int turn = 0;
  // the CTA's last block with a live prober: its last chunk the last turn
  int b_last = -1;
  for (size_t b = 0; b < cs.l0.size(); ++b) {
    if (cs.l0[b] || cs.l1[b]) b_last = (int)b;
  }
  if (cs.turns && turn_opens(h) && (b_last >= 0 || cs.mutation == 4)) {
    nb_arrive(turn_wait(0), TURN_THREADS, cw);
  }
  // after a block of S = 2 the pair meets before its next live block
  bool pair_owed = false;
  for (size_t b = 0; b < cs.l0.size(); ++b) {
    const WarpRows wr = warp_rows(cs.l0[b], cs.l1[b], cw);
    if (wr.S == 0) continue;
    if (pair_owed && cs.mutation != 1) {
      nb_sync(pair_bar(cw), PAIR_THREADS, cw);
    }
    const int S = wr.S;
    const int p0 = wr.p0;
    // a dead slice (its 16 rows hold no live prober; narrow instances)
    // writes no list and merges no row, but takes every barrier; at S = 2
    // its pair holds the same rows
    const bool wlive = !((cs.dead[b] >> (p0 / 16)) & 1) || !cs.narrow;
    const int q = cs.qbufs ? (int)(qi % cs.qbufs) : 0;
    if (cs.qbufs) {
      mb_wait(qfull[q], (int)((qi / cs.qbufs) & 1));
      if (qbuf_tag[q] != qi) fault("a query buffer read before its fill");
    }
    int phase = 0;
    const int nch = (cs.stages + 1) / 2;
    for (int it = 0; it < cs.n_tiles; ++it) {
      const int nrow = nrow_of(it);
      const bool chain = takes_chain(S, h, nrow);
      for (int kc = 0; kc < nch; ++kc) {
        const bool last_k = kc + 1 == nch;
        const int nsc = cs.stages - 2 * kc < 2 ? 1 : 2;
        const int sa = (int)(g % cs.nst_ring);
        const int sb = (int)((g + 1) % cs.nst_ring);
        mb_wait(full[sa], (int)((g / cs.nst_ring) & 1));
        if (nsc > 1) mb_wait(full[sb], (int)(((g + 1) / cs.nst_ring) & 1));
        if (stage_tag[sa] != g || (nsc > 1 && stage_tag[sb] != g + 1)) {
          fault("a stage read before its fill");
        }
        const bool take_turn = cs.turns && !(cs.mutation == 3 && h == 1 && !chain);
        if (take_turn) nb_sync(turn_wait(h), TURN_THREADS, cw);
        if (cs.turns) issues.push_back({h, turn});
        step();  // the chain in flight
        const bool last = (int)b == b_last && it + 1 == cs.n_tiles && last_k;
        if (take_turn && (turn_hands_on(h, last) || cs.mutation == 2)) {
          nb_arrive(turn_pass(h), TURN_THREADS, cw);
        }
        ++turn;
        if (codes() && nsc > 1) {  // the first stage, after the products
          ++released[sa];
          mb_arrive(empty_[sa]);
        }
        if (!codes() || nsc == 1) {
          ++released[sa];
          mb_arrive(empty_[sa]);
        }
        if (nsc > 1) {
          ++released[sb];
          mb_arrive(empty_[sb]);
        }
        if (cs.qbufs && it + 1 == cs.n_tiles && last_k) mb_arrive(qempty[q]);
        g += nsc;
      }
      if ((it + 1) % cs.tpp) continue;
      // the phase end: the warp's slice lists, then (S = 2: after the
      // pair's barrier) the merge of its rows' lists into the running ones
      const long tag = (long)b * 64 + phase;
      if (wlive) take(cw, unit(SLICE, slice_region(cw)), tag);
      if (S == 2) {
        nb_sync(pair_bar(cw), PAIR_THREADS, cw);
        if (wlive) take(cw, unit(SLICE, slice_region(cw ^ 4)), tag);
      } else {
        step();
      }
      if (wlive) {
        for (int r = merge_first(S, h); r < merge_first(S, h) + merge_count(S); ++r) {
          take(cw, unit(RUN, p0 + r), (long)b);
        }
      }
      if (it + 1 < cs.n_tiles) {
        if (wlive) {
          drop(cw, unit(SLICE, slice_region(cw)));
          if (S == 2) drop(cw, unit(SLICE, slice_region(cw ^ 4)));
        }
        if (S == 2) {
          nb_sync(pair_bar(cw), PAIR_THREADS, cw);
        } else {
          step();
        }
      }
      ++phase;
    }
    // the outputs: the merged rows written, the lists free again (the
    // pair's barrier at its next live block)
    if (wlive) {
      drop(cw, unit(SLICE, slice_region(cw)));
      if (S == 2) drop(cw, unit(SLICE, slice_region(cw ^ 4)));
      for (int r = 0; r < 16; ++r) {
        if (held[unit(RUN, p0 + r)].count(cw)) drop(cw, unit(RUN, p0 + r));
      }
    }
    pair_owed = S == 2;
    ++qi;
  }
}

static void entry() {
  if (cur == CO - 1) {
    producer();
  } else {
    consumer(cur);
  }
  finished[cur] = true;
  ++progress;
  swapcontext(&co_uc[cur], &sched_uc);
}

// one schedule: 0 clean, 1 deadlock, 2 a fault
static int run(unsigned seed) {
  rng.seed(seed);
  errors = 0;
  progress = 0;
  held.clear();
  issues.clear();
  for (auto& b : nb) b = NamedBar{};
  for (int i = 0; i < 8; ++i) {
    full[i] = MBar{1, 1, 0};
    empty_[i] = MBar{WARPS, WARPS, 0};
    stage_tag[i] = -1;
    released[i] = WARPS;
  }
  for (int i = 0; i < 2; ++i) {
    qfull[i] = MBar{1, 1, 0};
    qempty[i] = MBar{WARPS, WARPS, 0};
    qbuf_tag[i] = -1;
  }
  for (int i = 0; i < CO; ++i) {
    finished[i] = false;
    getcontext(&co_uc[i]);
    co_uc[i].uc_stack.ss_sp = stacks.data() + (size_t)i * STACK;
    co_uc[i].uc_stack.ss_size = STACK;
    co_uc[i].uc_link = nullptr;
    makecontext(&co_uc[i], entry, 0);
  }
  long idle = 0, last = 0;
  for (;;) {
    int alive = 0;
    for (int i = 0; i < CO; ++i) alive += !finished[i];
    if (!alive) break;
    int pick = (int)(rng() % CO);
    while (finished[pick]) pick = (pick + 1) % CO;
    cur = pick;
    swapcontext(&sched_uc, &co_uc[pick]);
    if (progress == last) {
      if (++idle > 400 * CO) return 1;
    } else {
      idle = 0;
      last = progress;
    }
  }
  for (int id = 1; id < 16; ++id) {
    if (nb[id].count) fault("a named barrier left part-arrived");
  }
  if (cs.turns) {
    // each turn: warpgroup 0's four issues, then warpgroup 1's four
    std::map<int, std::vector<int>> order;
    for (size_t i = 0; i < issues.size(); ++i) order[issues[i].second].push_back((int)i);
    int prev_end = -1;
    for (auto& kv : order) {
      int last0 = -1, first1 = 1 << 30, last1 = -1, first0 = 1 << 30;
      for (int i : kv.second) {
        if (issues[i].first == 0) {
          last0 = last0 > i ? last0 : i;
          first0 = first0 < i ? first0 : i;
        } else {
          first1 = first1 < i ? first1 : i;
          last1 = last1 > i ? last1 : i;
        }
      }
      if (last0 > first1 || first0 < prev_end) fault("the warpgroups' chains did not alternate");
      prev_end = last1;
    }
  }
  return errors ? 2 : 0;
}

static bool read_ints(int* p, size_t n) {
  return std::fread(p, 4, n, stdin) == n;
}

int main() {
  // the barrier ids: distinct, within the 16 a CTA has, none __syncthreads'
  int ids[] = {BAR_CONSUMERS, BAR_PRODUCER, pair_bar(0), pair_bar(1),
               pair_bar(2), pair_bar(3), turn_wait(0), turn_wait(1)};
  for (int i = 0; i < 8; ++i) {
    for (int j = 0; j < i; ++j) {
      if (ids[i] == ids[j] || ids[i] <= 0 || ids[i] >= 16) return 3;
    }
  }
  if (turn_pass(0) != turn_wait(1) || turn_pass(1) != turn_wait(0)) return 3;
  int n_cases;
  if (!read_ints(&n_cases, 1)) return 1;
  for (int c = 0; c < n_cases; ++c) {
    int head[12];
    if (!read_ints(head, 12)) return 1;
    cs = Case{};
    cs.family = head[0];
    cs.narrow = head[1];
    cs.nst_ring = head[2];
    cs.qbufs = head[3];
    cs.stages = head[4];
    cs.n_tiles = head[5];
    cs.last_nrow = head[6];
    cs.tpp = head[7];
    cs.turns = head[8];
    cs.mutation = head[9];
    const int n_blocks = head[10], schedules = head[11];
    cs.l0.resize(n_blocks);
    cs.l1.resize(n_blocks);
    cs.dead.resize(n_blocks);
    if (!read_ints(cs.l0.data(), n_blocks) || !read_ints(cs.l1.data(), n_blocks) ||
        !read_ints(cs.dead.data(), n_blocks)) {
      return 1;
    }
    int res[3] = {0, 0, 0};
    for (int s = 0; s < schedules; ++s) {
      const int r = run(1000u * (unsigned)c + (unsigned)s);
      ++res[r];
    }
    std::printf("%d %d %d %s\n", res[0], res[1], res[2],
                res[2] ? first_error : "-");
  }
  return 0;
}
"""

# the instance families that take turns, the pass-by-pass pack32 ones
# (wg_layout.cuh: takes_turns): (family, narrow, ring stages, query
# buffers, stages a tile, phased: phase ends every PATTERNS' tiles a phase,
# else at the block's last tile): bf16 narrow d = 128 (two stages a tile,
# eight in the ring), int8 narrow d = 128 (one, seven), k-chunked d = 1024
# (sixteen: eight chunks), the codes instances (one query buffer; d = 128,
# two stages a tile, the first released early, five in the ring; d = 64
# at k_pair 17-32, one, four)
FAMILIES = {
    "pack32_narrow": (0, 1, 8, 2, 2, 0),
    "pack32_narrow_int8": (0, 1, 7, 2, 1, 0),
    "pack32_chunked": (0, 0, 6, 0, 16, 0),
    "pack32_phased": (0, 1, 8, 2, 2, 1),
    "codes_pack32": (1, 1, 5, 1, 2, 0),
    "codes_pack32_d64": (1, 1, 4, 1, 1, 0),
}
# block sequences (live tiles l0, l1 a block; dead 16-row slices a block)
# and their tiles a block and, on the phased families, tiles a phase:
# alternating blocks of one tile (one turn a block: the pairs' barriers
# alone keep one block from another), ragged ones of three (the last of 40
# columns: warpgroup 1 has no half at S = 2), skipped ones of four, a CTA
# whose one live block is both its first and its last, and one with no
# live block
PATTERNS = {"alternating": (1, 1), "ragged": (3, 1), "skipped": (4, 2),
            "one_block": (2, 1), "empty": (2, 1)}
SCHEDULES = 60


def _blocks(pattern, seed):
    """A CTA's blocks: `alternating` two live tiles, then two blocks of one
    (the first or the second, drawn), ...; `ragged` the same with a last
    tile of 64 or fewer columns; `skipped` blocks of no live prober between
    live ones and dead 16-row slices in live tiles; `one_block` one live
    block (one or two tiles, drawn) among skipped ones; `empty` none."""
    rng = np.random.default_rng(seed)
    n = 12
    l0 = np.ones(n, np.int32)
    l1 = np.ones(n, np.int32)
    one = np.arange(n) % 3 != 0
    l0[one] = rng.integers(0, 2, int(one.sum()))
    l1[one] = 1 - l0[one]
    dead = np.zeros(n, np.int32)
    if pattern == "skipped":
        l0[2::3] = 0
        l1[2::3] = 0
        dead = rng.integers(0, 256, n).astype(np.int32)
    elif pattern in ("one_block", "empty"):
        keep = np.arange(n) == 5 if pattern == "one_block" else np.zeros(n, bool)
        l0[~keep] = 0
        l1[~keep] = 0
    return l0, l1, dead


def _cases():
    out = []
    for fam in FAMILIES:
        for pattern in PATTERNS:
            for turns in (1, 0):
                out.append((fam, pattern, turns, 0))
    # mutations of the schedule, which the checks must see
    out += [("pack32_narrow", "alternating", 1, 1),
            ("codes_pack32", "alternating", 1, 1),
            ("pack32_narrow", "alternating", 1, 2),
            ("pack32_narrow", "ragged", 1, 3),
            ("pack32_narrow", "empty", 1, 4)]
    return out


def _compile(tmp_path_factory):
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to compile csrc/wg_layout.cuh"
    work = tmp_path_factory.mktemp("wg_schedule")
    (work / "h.cpp").write_text(_HARNESS)
    exe = work / "h"
    subprocess.run([gxx, "-std=c++17", "-O1", "-Wall", "-Werror",
                    "-U_FORTIFY_SOURCE", f"-I{_CSRC}", str(work / "h.cpp"),
                    "-o", str(exe)], check=True, capture_output=True,
                   text=True)
    return exe


@pytest.fixture(scope="module")
def scheduled(tmp_path_factory):
    """Every case through the harness in one run: {case: (clean, deadlocked,
    faulted schedules, the first fault)}."""
    exe = _compile(tmp_path_factory)
    cases = _cases()
    blobs = [np.int32(len(cases)).tobytes()]
    for i, (fam, pattern, turns, mutation) in enumerate(cases):
        family, narrow, ring, qbufs, stages, phased = FAMILIES[fam]
        n_tiles, tpp = PATTERNS[pattern]
        tpp = tpp if phased else n_tiles
        last = 40 if pattern == "ragged" else 128
        l0, l1, dead = _blocks(pattern, i)
        blobs += [np.array([family, narrow, ring, qbufs, stages, n_tiles,
                            last, tpp, turns, mutation, l0.size,
                            SCHEDULES * (5 if mutation else 1)],
                           np.int32).tobytes(),
                  l0.tobytes(), l1.tobytes(), dead.tobytes()]
    res = subprocess.run([str(exe)], input=b"".join(blobs),
                         capture_output=True, timeout=600)
    assert res.returncode == 0, (res.returncode, res.stderr[-2000:])
    lines = res.stdout.decode().splitlines()
    assert len(lines) == len(cases)
    out = {}
    for case, line in zip(cases, lines):
        clean, dead_, faulted, first = line.split(" ", 3)
        out[case] = (int(clean), int(dead_), int(faulted), first)
    return out


@pytest.mark.parametrize("turns", [1, 0])
@pytest.mark.parametrize("pattern", list(PATTERNS))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_schedule_completes_without_fault(scheduled, family, pattern, turns):
    """Under every random schedule the CTA's warps run through the blocks
    without deadlock, every barrier completes on its count and none is left
    part-arrived, the chains alternate (with the turns), the ring's stages
    and query buffers are read after their fill and refilled after their
    release, and no unit of the shared arrays is used by two blocks at
    once."""
    clean, deadlocked, faulted, first = scheduled[(family, pattern, turns, 0)]
    assert (deadlocked, faulted) == (0, 0), first
    assert clean == SCHEDULES


@pytest.mark.parametrize("family,pattern,turns,mutation", [
    c for c in _cases() if c[3]])
def test_schedule_mutations_are_seen(scheduled, family, pattern, turns,
                                     mutation):
    """A schedule without the pair's barrier between an S = 2 block and the
    next lets one warp's next block take the lists the other still reads
    (1); warpgroup 1 handing the turn on after the CTA's last chunk leaves
    its arrival on the barrier (2); a warpgroup that skips its turn where it
    issues no chain breaks the alternation or deadlocks (3); warpgroup 1
    opening the turns in a CTA with no live block leaves its arrival (4):
    the checks see each."""
    clean, deadlocked, faulted, first = scheduled[(family, pattern, turns,
                                                   mutation)]
    assert deadlocked + faulted > 0, "the model did not see the mutation"
