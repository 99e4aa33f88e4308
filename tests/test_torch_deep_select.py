"""The deep pack32 select of the warp-specialised block scan
(csrc/deep_select.cuh), compiled with the host's g++ and run without a
card.

The header's phase end is plain C++ over a warp's lanes, its exchanges
(shuffles, votes, the warp's and a warp pair's barriers) through a policy
object. Here a small harness runs the very code the kernel compiles: the
256 consumer lanes of a CTA as coroutines on one host thread, switched at
each exchange, so that a lane reads what the others wrote as it would on
the card. Each case feeds the consumers' group maxima phase by phase, laid
out as block_scan_wg.cu's scores leave them (S = 1: a warp holds a row's
128 groups of a phase; S = 2: two warps, one per consumer warpgroup, 64
each), calls the phase end after each phase, and holds every live row's
running list to numpy's k_pair largest of the row's maxima over all
phases, INT_MIN where a row has fewer keys; every maximum must be cleared
from the registers on return. Cases: G = 128, 256 and 512 groups (one, two
and four phases), k_pair 17, 33, 48, 49, 57 and 64, random keys,
adversarial keys whose every phase's maxima all survive (an ascending
window), rows with fewer live groups than k_pair, phases whose maxima all
fall below the bound (a descending window), dead rows in every case. Then
the shared-memory formulas of the deep instances (csrc/wg_layout.cuh)
against ops/block_scan.py's mirror at every deep k_pair and both dtypes,
and those of the deep codes instances against ops/codes_scan.py's."""

import shutil
import subprocess

import numpy as np
import pytest

from torchpq_tpu_torch.ops import block_scan as bs
from torchpq_tpu_torch.ops import codes_scan as cs

from pathlib import Path

_CSRC = Path(bs.__file__).resolve().parents[1] / "csrc"
INT_MIN = np.iinfo(np.int32).min

_HARNESS = r"""
#include <setjmp.h>
#include <ucontext.h>

#include <climits>
#include <cstdio>
#include <cstdlib>
#include <vector>

#include "deep_select.cuh"

using namespace tpq;

// ---- the CTA's 256 consumer lanes as coroutines on this thread ----------
constexpr int LANES = 256;
constexpr int STACK = 1 << 16;
static jmp_buf sched_jb, lane_jb[LANES];
static ucontext_t lane_uc[LANES];
static std::vector<char> stacks((size_t)LANES * STACK);
static bool started[LANES], finished[LANES];
static int cur;
static long progress;
static void (*body)(int);

static void yield_lane() {
  if (!_setjmp(lane_jb[cur])) _longjmp(sched_jb, 1);
}
static void lane_entry() {
  body(cur);
  finished[cur] = true;
  ++progress;
  _longjmp(sched_jb, 1);
}

struct Barrier {
  int expected;
  int count;
  long gen;
};
static void arrive(Barrier& b) {
  const long g = b.gen;
  if (++b.count == b.expected) {
    b.count = 0;
    ++b.gen;
    ++progress;
    return;
  }
  while (b.gen == g) yield_lane();
}

// Runs fn on every lane; false where the lanes deadlock.
static bool run_lanes(void (*fn)(int)) {
  body = fn;
  for (int i = 0; i < LANES; ++i) {
    started[i] = finished[i] = false;
    getcontext(&lane_uc[i]);
    lane_uc[i].uc_stack.ss_sp = stacks.data() + (size_t)i * STACK;
    lane_uc[i].uc_stack.ss_size = STACK;
    lane_uc[i].uc_link = nullptr;
    makecontext(&lane_uc[i], lane_entry, 0);
  }
  for (;;) {
    bool all = true;
    const long before = progress;
    for (int i = 0; i < LANES; ++i) {
      if (finished[i]) continue;
      all = false;
      cur = i;
      if (!_setjmp(sched_jb)) {
        if (!started[i]) {
          started[i] = true;
          setcontext(&lane_uc[i]);
        } else {
          _longjmp(lane_jb[i], 1);
        }
      }
    }
    if (all) return true;
    if (progress == before) return false;
  }
}

// ---- the warps' exchanges (the kernel's: shuffles, votes, barriers) -------
struct WarpState {
  Barrier bar;
  int slot[2][32];
};
static WarpState warps[8];
static Barrier pairs[4];
static long xcount[LANES];

struct HostWarp {
  int l, w;
  int lane() const { return l; }
  // every lane posts v, then reads lane src's (slots by parity: a slot is
  // written again only after all lanes passed the next exchange)
  int ex(int v, int src) const {
    WarpState& ws = warps[w];
    const int par = (int)(xcount[32 * w + l]++ & 1);
    ws.slot[par][l] = v;
    arrive(ws.bar);
    return ws.slot[par][src];
  }
  int xor_(int v, int m) const { return ex(v, l ^ m); }
  int up4(int v, int d) const { return ex(v, l % 4 >= d ? l - d : l); }
  int idx4(int v, int s) const { return ex(v, (l & ~3) + s); }
  bool any(bool p) const {
    WarpState& ws = warps[w];
    const int par = (int)(xcount[32 * w + l]++ & 1);
    ws.slot[par][l] = p;
    arrive(ws.bar);
    int o = 0;
    for (int i = 0; i < 32; ++i) o |= ws.slot[par][i];
    return o != 0;
  }
  void sync() const { arrive(warps[w].bar); }
  void pair_sync() const { arrive(pairs[w % 4]); }
};

// ---- a case -------------------------------------------------------------
static int P, K, S, M64;
static int prow[128];
static std::vector<int> keys;  // [P][128 rows][128 groups of the phase]
static std::vector<int> arrays;
static int errors;

static int key(int f, int p, int c) { return keys[((size_t)f * 128 + p) * 128 + c]; }

static void consumer(int t) {
  const int cw = t / 32, l = t % 32, wq = cw % 4, h = cw / 4;
  const HostWarp w{l, cw};
  const bool split = S == 2;
  const int p0 = split ? 64 * M64 + 16 * wq : 16 * cw;
  int mx[2][32];
  for (int f = 0; f < P; ++f) {
    // the maxima as the kernel's scores leave them: lane l holds rows
    // l / 4 and l / 4 + 8 of the warp's 16, columns 8 nt + 2 (l % 4) + i
    // of each 64-column half it scores
    for (int rr = 0; rr < 2; ++rr) {
      const int p = p0 + l / 4 + 8 * rr;
      for (int j = 0; j < 32; ++j) mx[rr][j] = INT_MIN;
      for (int lh = 0; lh < (split ? 1 : 2); ++lh) {
        for (int nt = 0; nt < 8; ++nt) {
          for (int i = 0; i < 2; ++i) {
            const int c = 64 * (split ? h : lh) + 8 * nt + 2 * (l % 4) + i;
            mx[rr][16 * lh + 2 * nt + i] = key(f, p, c);
          }
        }
      }
    }
    if (split) {
      ds::phase_end<16>(w, mx, prow, p0, true, h, wq, arrays.data(), K,
                        f == 0);
    } else {
      ds::phase_end<32>(w, mx, prow, p0, false, 0, cw, arrays.data(), K,
                        f == 0);
    }
    for (int rr = 0; rr < 2; ++rr) {
      for (int j = 0; j < 32; ++j) errors += mx[rr][j] != INT_MIN;
    }
  }
}

static bool read_ints(int* p, size_t n) {
  return std::fread(p, 4, n, stdin) == n;
}

int main() {
  int n_cases;
  if (!read_ints(&n_cases, 1)) return 1;
  for (int cs = 0; cs < n_cases; ++cs) {
    int head[4];
    if (!read_ints(head, 4)) return 1;
    P = head[0], K = head[1], S = head[2], M64 = head[3];
    keys.assign((size_t)P * 128 * 128, 0);
    if (!read_ints(prow, 128) || !read_ints(keys.data(), keys.size())) {
      return 1;
    }
    // the shared arrays as a previous block left them: anything
    arrays.assign(ds::select_bytes(K) / 4, 0x5A5A5A5A);
    for (int i = 0; i < 8; ++i) warps[i] = WarpState{{32, 0, 0}, {}};
    for (int i = 0; i < 4; ++i) pairs[i] = Barrier{64, 0, 0};
    for (int i = 0; i < LANES; ++i) xcount[i] = 0;
    errors = 0;
    const int ok = run_lanes(consumer) ? errors : -1;
    std::fwrite(&ok, 4, 1, stdout);
    const int* run = arrays.data() + ds::run_offset();
    for (int p = 0; p < 128; ++p) {
      std::fwrite(run + p * ds::list_ld(K), 4, K, stdout);
    }
  }
  return 0;
}
"""

GROUPS = (128, 256, 512)
K_PAIRS = (17, 33, 48, 49, 57, 64)
KINDS = ("random", "ascending", "sparse", "descending")
SPLITS = (1, 2)


def _case(g, k_pair, kind, split, seed):
    """A block's group maxima [phases][128 rows][128 groups] and prober
    rows: distinct keys a row (the slot bits), ~20% of rows dead; S = 2
    keeps one 64-prober tile live (rows 64 m64 .. + 63), the other dead.
    ascending: every phase's maxima above the last's (all survive);
    descending: below them (the later phases prune to nothing); sparse:
    fewer keys than k_pair a row, the other groups INT_MIN."""
    rng = np.random.default_rng(seed)
    phases = max(g // 128, 1)
    n = phases * 128
    keys = np.empty((128, n), np.int64)
    for p in range(128):
        keys[p] = rng.choice(1 << 32, n, replace=False) - (1 << 31) + 1
    if kind in ("ascending", "descending"):
        keys.sort(axis=1)
        if kind == "descending":
            keys = keys[:, ::-1]
        keys = keys.reshape(128, phases, 128)
        keys = rng.permuted(keys, axis=2).reshape(128, n)
    elif kind == "sparse":
        live = rng.permuted(np.arange(n)[None].repeat(128, 0), axis=1) \
            < k_pair // 2
        keys = np.where(live, keys, INT_MIN)
    keys = keys.astype(np.int32).reshape(128, phases, 128).transpose(1, 0, 2)
    prow = np.where(rng.random(128) < 0.2, -1, rng.integers(0, 1000, 128))
    m64 = seed % 2
    if split == 2:
        prow[np.arange(128) // 64 != m64] = -1
    return phases, m64, prow.astype(np.int32), np.ascontiguousarray(keys)


def _cases():
    return [(g, k, kind, s) for g in GROUPS for k in K_PAIRS for kind in KINDS
            for s in SPLITS]


def _compile(tmp_path_factory, name, source):
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to compile csrc/deep_select.cuh"
    work = tmp_path_factory.mktemp(name)
    (work / "h.cpp").write_text(source)
    exe = work / "h"
    subprocess.run([gxx, "-std=c++17", "-O1", "-Wall", "-Werror",
                    "-U_FORTIFY_SOURCE", f"-I{_CSRC}", str(work / "h.cpp"),
                    "-o", str(exe)], check=True, capture_output=True,
                   text=True)
    return exe


@pytest.fixture(scope="module")
def selected(tmp_path_factory):
    """Every case through the harness in one run: {case: (status, the
    rows' lists [128][k_pair], the case's inputs)}."""
    exe = _compile(tmp_path_factory, "deep_select", _HARNESS)
    cases = _cases()
    blobs, inputs = [np.int32(len(cases)).tobytes()], {}
    for i, (g, k, kind, s) in enumerate(cases):
        phases, m64, prow, keys = _case(g, k, kind, s, seed=i)
        inputs[(g, k, kind, s)] = (prow, keys)
        blobs += [np.array([phases, k, s, m64], np.int32).tobytes(),
                  prow.tobytes(), keys.tobytes()]
    res = subprocess.run([str(exe)], input=b"".join(blobs), check=True,
                         capture_output=True, timeout=600)
    out = np.frombuffer(res.stdout, np.int32)
    got, at = {}, 0
    for g, k, kind, s in cases:
        status = int(out[at])
        lists = out[at + 1:at + 1 + 128 * k].reshape(128, k)
        got[(g, k, kind, s)] = (status, lists, inputs[(g, k, kind, s)])
        at += 1 + 128 * k
    assert at == out.size
    return got


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k_pair", K_PAIRS)
@pytest.mark.parametrize("groups", GROUPS)
def test_phase_end_selects_the_k_largest(selected, groups, k_pair, kind,
                                         split):
    """Every live row's running list equals numpy's k_pair largest of the
    row's maxima over all phases (descending, INT_MIN past the row's keys),
    the lanes ran without deadlock and left no maximum in their registers;
    dead rows are never merged."""
    status, lists, (prow, keys) = selected[(groups, k_pair, kind, split)]
    assert status == 0, ("deadlock" if status < 0 else
                         f"{status} maxima left in the registers")
    live = prow >= 0
    assert live.any()
    rows = keys.transpose(1, 0, 2).reshape(128, -1)
    want = -np.sort(-rows.astype(np.int64), axis=1)[:, :k_pair]
    np.testing.assert_array_equal(lists[live], want[live].astype(np.int32))
    if kind == "sparse":
        assert (want[live][:, -1] == INT_MIN).all()


_SMEM = r"""
#include <cstdio>

#include "wg_layout.cuh"

using namespace tpq::wg;

int main() {
  for (int k_pair = 17; k_pair <= 64; ++k_pair) {
    for (int i8 = 0; i8 < 2; ++i8) {
      std::printf("%d %d %zu %zu %d %d %d %zu\n", k_pair, i8,
                  smem_bytes(1, k_pair, 0, i8),
                  narrow_smem_bytes(1, k_pair, 0, i8), ring_of(1, k_pair),
                  narrow_ring_of(1, k_pair, i8), narrow_qbufs_of(1, k_pair),
                  select_bytes(1, k_pair));
    }
  }
  // the one-key launch: k_pair 1 on the deep instances' layout
  std::printf("%zu %zu %zu\n", select_bytes(1, 1, 64), smem_bytes(1, 1, 64),
              narrow_smem_bytes(1, 1, 64));
  return 0;
}
"""


def test_deep_smem_mirror_equals_header(tmp_path_factory):
    """csrc/wg_layout.cuh's shared memory of the deep pack32 instances
    (k_pair 17-64: one running list per row beside the staging rows,
    deep_select.cuh:select_bytes) equals ops/block_scan.py:wg_smem_bytes at
    every deep k_pair, bf16 and int8, k-chunked (d 1024 and 272) and narrow
    (d 128); the k-chunked instance runs four ring stages, the narrow one
    five with two query buffers; every shape
    fits the limit; the deep select's arrays are the warps' staging rows
    (8 a warp, a phase's 128 groups each), one list a row and the counts;
    and the one-key launch (k_pair 1 on the deep instance) takes the deep
    layout."""
    exe = _compile(tmp_path_factory, "deep_smem", _SMEM)
    lines = subprocess.run([str(exe)], check=True, capture_output=True,
                           text=True).stdout.splitlines()
    assert len(lines) == 2 * 48 + 1
    for line in lines[:-1]:
        k, i8, chunked, narrow, ring, nring, nqb, sel = map(int, line.split())
        dtype = bs.torch.int8 if i8 else bs.torch.bfloat16
        for d in (1024, 272 if i8 else 136):
            assert bs.wg_smem_bytes(True, k, d, dtype) == chunked, (k, i8, d)
        assert bs.wg_smem_bytes(True, k, 128, dtype) == narrow, (k, i8)
        assert ring == bs.wg_ring(True, k) == 4
        assert bs.wg_narrow_instance(True, k, dtype) == (64, nring, nqb)
        assert (nring, nqb) == (5, 2)
        assert max(chunked, narrow) <= bs._SMEM_LIMIT
        kls = k | 1
        assert sel == 4 * (8 * 8 * 129 + 128 * kls + 2 * 128)
    one, chunked1, narrow1 = map(int, lines[-1].split())
    assert one == 4 * (8 * 8 * 129 + 128 + 2 * 128)
    assert chunked1 == bs.wg_smem_bytes(True, 64) - 4 * 128 * (65 - 1)
    assert narrow1 == bs.wg_smem_bytes(True, 64, 128) - 4 * 128 * (65 - 1)


_CODES_SMEM = r"""
#include <cstdio>
#include <cstdlib>

#include "wg_layout.cuh"

using namespace tpq::wg;

int main(int argc, char** argv) {
  const int m = std::atoi(argv[1]), dsub = std::atoi(argv[2]);
  for (int k_pair = 17; k_pair <= 64; ++k_pair) {
    std::printf("%d %zu %d %d %zu\n", k_pair,
                codes_smem_bytes(m, dsub, 1, k_pair),
                codes_ring_of(1, k_pair), CODES_PASS_K,
                k_pair > CODES_PASS_K ? select_bytes(1, k_pair)
                                      : list_bytes(1, k_pair));
  }
  return 0;
}
"""


@pytest.mark.parametrize("m,dsub", [(64, 2), (128, 1), (32, 4)])
def test_deep_codes_smem_mirror_equals_header(tmp_path_factory, m, dsub):
    """csrc/wg_layout.cuh's shared memory of the codes instances above
    pack32 k_pair 16 (block_scan_wg.cu's codes instances: pass by pass on
    four ring stages up to CODES_PASS_K = 32, where a phase holds every
    group (G = 128); above it the deep select on three, its arrays
    deep_select.cuh:select_bytes beside the codebook and the raw slot) and
    their ring stages equal ops/codes_scan.py's mirror (wg_smem_bytes,
    wg_ring) at every such k_pair, at d = 128 (PQ64, PQ128 and the 4-bit
    byte pairs), every shape within the limit; the deep select's arrays
    are the warps' staging rows, one list a row and the counts."""
    exe = _compile(tmp_path_factory, f"codes_smem_{m}", _CODES_SMEM)
    lines = subprocess.run([str(exe), str(m), str(dsub)], check=True,
                           capture_output=True, text=True).stdout.splitlines()
    assert len(lines) == 48
    for line in lines:
        k, nbytes, ring, pass_k, sel = map(int, line.split())
        assert pass_k == cs._WG_CODES_PASS_K == 32
        assert cs.wg_smem_bytes(m=m, dsub=dsub, pack32=True,
                                k_pair=k) == nbytes, k
        assert cs.wg_ring(True, k) == ring == (4 if k <= 32 else 3), k
        assert nbytes <= cs._SMEM_LIMIT
        if k > 32:
            assert sel == 4 * (8 * 8 * 129 + 128 * (k | 1) + 2 * 128)
        else:
            assert sel == bs._wg_list_bytes(True, k)
