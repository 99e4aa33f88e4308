"""The fused flat scan's thinned epilogue (csrc/flat_select.cuh), compiled
with the host's g++ and run without a card.

The header's select is plain C++ over a quad's lanes, its exchanges
(shuffles, ballots and the warp's vote) through a policy object. Here a
small harness runs the very code csrc/flat_scan_wg.cu compiles: a warp's
32 lanes as coroutines on one host thread, switched at each exchange, so
that a lane reads what the others wrote as it would on the card. Each lane
holds, as the kernel's accumulators leave them, 16 columns of each of its
quad's two rows (rows g and g + 8 of the warp's 16 of an m64 tile), and
scores tile after tile of two buckets as the kernel does (tile_votes: the
bucket maxima, the bound tests and the votes; tile_offers: where a vote
passed, the top 2, the quad merge and the warp's inserts into the lists
quad lanes 0 and 1 own), run by run, with the bound the runs share; the
runs' lists are then merged in address order as flat_common.cuh's merge
kernel merges them. Every row's result is held to numpy's bucket top 2
(the first maximal slot, then the first maximum of the rest) -> stable
top r_keep, bit for bit, addresses included. Cases: random scores;
integer scores with ties, bucket maxima equal to the bound among them;
dead slots (about -BIG) in and across buckets; rows whose list never
fills; r_keep 8, 16 and 32; runs merged, and runs scanned last first
beside ties. On random scores of many buckets the warp's vote must skip
most buckets, and the shared bound must skip more. Then the kernel's
shared-memory formula (csrc/flat_select.cuh: smem_bytes, ring_of) against
ops/flat_scan.py's mirror at every width and r_keep the route takes."""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from torchpq_tpu_torch.ops import flat_scan as fs

_CSRC = Path(fs.__file__).resolve().parents[1] / "csrc"
BIG = np.float32(fs.BIG)

_HARNESS = r"""
#include <setjmp.h>
#include <ucontext.h>

#include <cstdio>
#include <cstring>
#include <vector>

#include "flat_select.cuh"

using namespace tpq;

// ---- a warp's 32 lanes as coroutines on this thread ----------------------
constexpr int LANES = 32;
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

// ---- the warp's exchanges (the kernel's: shuffles and a vote) -------------
static Barrier bar;
static unsigned slot[2][LANES];
static long xcount[LANES];
static long votes, passed;  // the warp's votes, and those that passed

struct HostWarp {
  int l;
  int lane() const { return l; }
  // every lane posts v, then reads lane src's (slots by parity: a slot is
  // written again only after all lanes passed the next exchange)
  template <class T>
  T ex(T v, int src) const {
    const int par = (int)(xcount[l]++ & 1);
    std::memcpy(&slot[par][l], &v, 4);
    arrive(bar);
    T o;
    std::memcpy(&o, &slot[par][src], 4);
    return o;
  }
  float xor_(float v, int m) const { return ex(v, l ^ m); }
  int xor_(int v, int m) const { return ex(v, l ^ m); }
  float idx(float v, int src) const { return ex(v, src); }
  int idx(int v, int src) const { return ex(v, src); }
  float up(float v, int d) const { return ex(v, l >= d ? l - d : l); }
  int up(int v, int d) const { return ex(v, l >= d ? l - d : l); }
  unsigned ballot(bool p) const {
    const int par = (int)(xcount[l]++ & 1);
    slot[par][l] = p;
    arrive(bar);
    unsigned o = 0;
    for (int i = 0; i < LANES; ++i) o |= (slot[par][i] != 0u) << i;
    return o;
  }
  void sync() const { arrive(bar); }
  bool any(bool p) const {
    const int par = (int)(xcount[l]++ & 1);
    slot[par][l] = p;
    arrive(bar);
    unsigned o = 0;
    for (int i = 0; i < LANES; ++i) o |= slot[par][i];
    return o != 0;
  }
};

// ---- a case -------------------------------------------------------------
// the warp's 16 rows of an m64 tile (row g + 8 rr), buckets of 64 columns,
// tiles of two buckets; scores [16][tiles * 128]; runs: the first tile of
// each run
constexpr int ROWS = 16;
static int R, NT, NRUNS, BASE, REVERSE, SHARE;
static int run0[8];
static int gkey[ROWS];  // the rows' shared bound keys (the kernel's gkey)
static std::vector<float> scores;
static std::vector<float> lst_v, part_v;
static std::vector<int> lst_a, part_a;

// the quad's two rows' floors (the kernel's read_floors)
static void read_floors(float (&floors)[2], int g) {
  for (int rr = 0; rr < 2; ++rr) floors[rr] = fsel::floor_of(gkey[g + 8 * rr]);
}

// a tile's scores as the kernel's TileScores gives them
struct HostScores {
  int g, t4, tile;
  float operator()(int b, int rr, int u) const {
    const float* row = scores.data() + (size_t)(g + 8 * rr) * NT * 128;
    return row[128 * tile + 64 * b + fsel::lane_col(u, t4)];
  }
  void operator()(int b, float (&s)[2][fsel::LANE_COLS]) const {
    for (int rr = 0; rr < 2; ++rr) {
      for (int u = 0; u < fsel::LANE_COLS; ++u) s[rr][u] = (*this)(b, rr, u);
    }
  }
};

static void consumer(int l) {
  const HostWarp w{l};
  const int g = l / 4, t4 = l % 4;
  const int ld = fsel::list_ld(R);
  const int own = t4 < 2 ? t4 : -1;  // quad lanes 0 and 1 own rows g, g + 8
  const int prow = g + 8 * (t4 & 1);
  const int off = prow * ld;
  float* lv = lst_v.data() + off;
  int* la = lst_a.data() + off;
  for (int k = 0; k < NRUNS; ++k) {
    const int rn = REVERSE ? NRUNS - 1 - k : k;
    const int t1 = rn + 1 < NRUNS ? run0[rn + 1] : NT;
    if (own >= 0) {
      for (int i = 0; i < R; ++i) {
        lv[i] = fsel::NEG_INF;
        la[i] = -1;
      }
    }
    float bound[2] = {fsel::NEG_INF, fsel::NEG_INF};
    float floors[2];
    read_floors(floors, g);
    int pub = fsel::NO_KEY;
    for (int it = run0[rn]; it < t1; ++it) {
      const HostScores sc{g, t4, it};
      unsigned pass = 0, vote = 0;
      fsel::tile_votes(w, sc, bound, floors, pass, vote);
      if (l == 0) {
        votes += 2;
        passed += __builtin_popcount(vote);
      }
      fsel::tile_offers(w, sc, pass, vote, bound, floors, own, lst_v.data(),
                        lst_a.data(), off, R, BASE + 128 * it);
      if (SHARE && ((it - run0[rn] + 1) % SHARE == 0 || it + 1 == t1)) {
        // the kernel's exchange with the shared bound
        const int key = fsel::key_of(lv[R - 1]);
        if (own >= 0 && lv[R - 1] > fsel::NEG_INF && key > pub) {
          if (key > gkey[prow]) gkey[prow] = key;
          pub = key;
        }
        w.sync();
        read_floors(floors, g);
      }
    }
    if (own >= 0) {
      for (int i = 0; i < R; ++i) {
        part_v[((size_t)rn * ROWS + prow) * R + i] = lv[i];
        part_a[((size_t)rn * ROWS + prow) * R + i] = la[i];
      }
    }
  }
}

// the runs' lists merged as flat_common.cuh's flat_merge_kernel merges
// them: run by run in address order, each entry going after every entry at
// or above its value
static void merge_row(int p, float* ov, int* oa) {
  std::vector<float> v(R, fsel::NEG_INF);
  std::vector<int> a(R, -1);
  for (int rn = 0; rn < NRUNS; ++rn) {
    const size_t o = ((size_t)rn * ROWS + p) * R;
    for (int i = 0; i < R; ++i) {
      const float x = part_v[o + i];
      if (!(x > v[R - 1])) continue;
      int k = R - 1;
      for (; k > 0 && v[k - 1] < x; --k) {
        v[k] = v[k - 1];
        a[k] = a[k - 1];
      }
      v[k] = x;
      a[k] = part_a[o + i];
    }
  }
  for (int i = 0; i < R; ++i) {
    ov[i] = v[i];
    oa[i] = a[i];
  }
}

static bool read_ints(void* p, size_t n) {
  return std::fread(p, 4, n, stdin) == n;
}

int main() {
  int n_cases;
  if (!read_ints(&n_cases, 1)) return 1;
  for (int cs = 0; cs < n_cases; ++cs) {
    int head[6];
    if (!read_ints(head, 6)) return 1;
    R = head[0], NT = head[1], NRUNS = head[2], BASE = head[3];
    REVERSE = head[4], SHARE = head[5];
    for (int i = 0; i < ROWS; ++i) gkey[i] = fsel::NO_KEY;
    if (!read_ints(run0, NRUNS)) return 1;
    scores.assign((size_t)ROWS * NT * 128, 0.0f);
    if (!read_ints(scores.data(), scores.size())) return 1;
    const int ld = fsel::list_ld(R);
    // the lists as a previous unit left them: anything
    lst_v.assign((size_t)ROWS * ld, 12345.0f);
    lst_a.assign((size_t)ROWS * ld, 777);
    part_v.assign((size_t)NRUNS * ROWS * R, 0.0f);
    part_a.assign((size_t)NRUNS * ROWS * R, 0);
    bar = Barrier{LANES, 0, 0};
    for (int i = 0; i < LANES; ++i) xcount[i] = 0;
    votes = passed = 0;
    const int ok = run_lanes(consumer) ? 0 : -1;
    const int stats[3] = {ok, (int)votes, (int)passed};
    std::fwrite(stats, 4, 3, stdout);
    std::vector<float> ov(R);
    std::vector<int> oa(R);
    for (int p = 0; p < ROWS; ++p) {
      merge_row(p, ov.data(), oa.data());
      std::fwrite(ov.data(), 4, R, stdout);
      std::fwrite(oa.data(), 4, R, stdout);
    }
  }
  return 0;
}
"""

R_KEEPS = (8, 16, 32)
KINDS = ("random", "ties", "dead", "unfilled", "two_runs", "ties_reversed")
# and, at r_keep 8 only, "long", "long_runs" and "long_runs_alone": 1,200
# random buckets in one run and in four, with and without the shared bound.
# Of a kind: the first tiles (two buckets) of its runs, the runs scanned
# last first, tiles between the exchanges with the shared bound (0: none;
# the kernel's: a window's 16)
RUNS = {"two_runs": ([0, 15], False, 4),
        "ties_reversed": ([0, 8, 15], True, 2),
        "long_runs": ([0, 150, 300, 450], False, 16),
        "long_runs_alone": ([0, 150, 300, 450], False, 0)}


def _case(kind, r_keep, seed):
    """A warp's scores [16 rows][buckets * 64] (f32) and how its runs go
    (RUNS). ties: integers in -3..3, so that a row's list fills with 3s
    and later buckets' maxima equal its bound; dead: of rows 0-7 95% of
    the buckets dead whole, of the others a quarter, and a tenth of the
    other slots dead (about -BIG, as penalty BIG makes them), so that dead
    candidates enter lists; unfilled: fewer buckets than r_keep / 2 (rows'
    lists keep -inf / -1 past the candidates); two_runs: the buckets in two
    runs of unequal length; ties_reversed: ties in three runs scanned last
    run first, so that a run's candidates equal to the bound a later run
    published must stay; long, long_runs: 1,200
    random buckets in one run and in four (the vote's pruning, the shared
    bound's)."""
    rng = np.random.default_rng(seed)
    n_buckets = {"random": 96, "long": 1200, "long_runs": 1200,
                 "long_runs_alone": 1200, "ties": 48,
                 "ties_reversed": 48, "dead": 40,
                 "unfilled": max(2, r_keep // 2 - 2), "two_runs": 72}[kind]
    if kind.startswith("ties"):
        s = rng.integers(-3, 4, (16, n_buckets * 64)).astype(np.float32)
    else:
        s = rng.normal(size=(16, n_buckets * 64)).astype(np.float32)
    if kind == "dead":
        dead = rng.random((16, n_buckets * 64)) < 0.1
        # rows 0-7: nearly every bucket dead, so that dead candidates fill
        # their lists; rows 8-15: a quarter
        share = np.where(np.arange(16) < 8, 0.95, 0.25)[:, None]
        dead |= np.repeat(rng.random((16, n_buckets)) < share, 64, axis=1)
        s = np.where(dead, -BIG - s * np.float32(1e30), s)
        s = s.astype(np.float32)
    return (s,) + RUNS.get(kind, ([0], False, 16))


def _reference(s, runs, r_keep, base):
    """numpy's bucket top 2 -> stable top r_keep per row (values desc, the
    visit order on ties); the runs change nothing (the merge is exact)."""
    rows, cols = s.shape
    b = s.reshape(rows, -1, 64)
    a1 = b.argmax(-1)
    m1 = np.take_along_axis(b, a1[..., None], -1)[..., 0]
    rest = b.copy()
    np.put_along_axis(rest, a1[..., None], -np.inf, -1)
    a2 = rest.argmax(-1)
    m2 = np.take_along_axis(rest, a2[..., None], -1)[..., 0]
    start = base + 64 * np.arange(b.shape[1])
    cand_v = np.stack([m1, m2], -1).reshape(rows, -1)
    cand_a = np.stack([a1 + start, a2 + start], -1).reshape(rows, -1)
    order = np.argsort(-cand_v, axis=1, kind="stable")[:, :r_keep]
    v = np.take_along_axis(cand_v, order, 1)
    a = np.take_along_axis(cand_a, order, 1)
    pad = r_keep - v.shape[1]
    if pad > 0:
        v = np.pad(v, ((0, 0), (0, pad)), constant_values=-np.inf)
        a = np.pad(a, ((0, 0), (0, pad)), constant_values=-1)
    return v.astype(np.float32), a.astype(np.int32)


def _compile(tmp_path_factory, name, source):
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to compile csrc/flat_select.cuh"
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
    warp's votes, those that ran on, values [16][r_keep], addresses, the
    reference's); head of a case: r_keep, tiles, runs, the first address,
    reversed run order, tiles between the shared bound's exchanges."""
    exe = _compile(tmp_path_factory, "flat_select", _HARNESS)
    cases = [(k, r) for k in KINDS for r in R_KEEPS] + [
        (k, 8) for k in ("long", "long_runs", "long_runs_alone")]
    blobs, refs = [np.int32(len(cases)).tobytes()], {}
    for i, (kind, r_keep) in enumerate(cases):
        s, runs, reverse, share = _case(kind, r_keep, seed=i)
        base = 64 * (1000 + i)
        refs[(kind, r_keep)] = _reference(s, runs, r_keep, base)
        blobs += [np.array([r_keep, s.shape[1] // 128, len(runs), base,
                            reverse, share], np.int32).tobytes(),
                  np.array(runs, np.int32).tobytes(), s.tobytes()]
    res = subprocess.run([str(exe)], input=b"".join(blobs), check=True,
                         capture_output=True, timeout=600)
    out = np.frombuffer(res.stdout, np.int32)
    got, at = {}, 0
    for kind, r_keep in cases:
        status, votes, passed = (int(x) for x in out[at:at + 3])
        at += 3
        rows = out[at:at + 16 * 2 * r_keep].reshape(16, 2, r_keep)
        at += 16 * 2 * r_keep
        got[(kind, r_keep)] = (status, votes, passed,
                               rows[:, 0].view(np.float32), rows[:, 1],
                               refs[(kind, r_keep)])
    assert at == out.size
    return got


@pytest.mark.parametrize("r_keep", R_KEEPS)
@pytest.mark.parametrize("kind", KINDS)
def test_tile_epilogue_selects_the_bucket_top2(selected, kind, r_keep):
    """Every scored row's merged list equals numpy's bucket top 2 -> stable
    top r_keep, values and addresses bit for bit (-inf / -1 past the
    candidates of a row whose list never fills), the lanes ran without
    deadlock; ties: the list holds the earliest of equal values, so
    buckets whose maximum equals the bound offered nothing that survives;
    """
    status, votes, passed, v, a, (v_ref, a_ref) = selected[(kind, r_keep)]
    assert status == 0, "deadlock"
    np.testing.assert_array_equal(v, v_ref)
    np.testing.assert_array_equal(a, a_ref)
    assert 0 < passed <= votes  # a vote a bucket
    if kind.startswith("ties"):
        assert (v_ref == v_ref[:, :1]).all(), "the lists must hold ties"
    if kind == "dead":
        assert (v_ref < -BIG / 2).any(), "dead candidates must enter"
    if kind == "unfilled":
        assert (a_ref[:, -1] == -1).all() and np.isinf(v_ref[:, -1]).all()


def test_the_vote_skips_most_buckets(selected):
    """On random scores of a run of 1,200 buckets at r_keep 8 (one vote a
    bucket, 16 rows each), once the lists fill most buckets' maxima stay
    at or below their rows' bounds in all 16 rows: the warp runs the top 2
    for fewer than 40% of its votes (all of them in the first r_keep / 2
    buckets), and the lists are still numpy's."""
    status, votes, passed, v, a, (v_ref, a_ref) = selected[("long", 8)]
    assert status == 0
    np.testing.assert_array_equal(v, v_ref)
    np.testing.assert_array_equal(a, a_ref)
    assert votes == 1200
    assert passed < 0.4 * votes, (passed, votes)


def test_the_shared_bound_prunes_later_runs(selected):
    """1,200 random buckets in four runs of 300: each run's list starts
    empty, but from the second run on its rows start from the bound the
    earlier runs published, so the warp runs the top 2 on at most 80% of
    the votes it needs without the shared bound (each run refilling its
    lists from nothing), and both merge to numpy's lists."""
    got = {k: selected[(k, 8)] for k in ("long_runs", "long_runs_alone")}
    for status, votes, passed, v, a, (v_ref, a_ref) in got.values():
        assert status == 0
        np.testing.assert_array_equal(v, v_ref)
        np.testing.assert_array_equal(a, a_ref)
        assert votes == 1200
    shared, alone = got["long_runs"][2], got["long_runs_alone"][2]
    assert shared < 0.8 * alone, (shared, alone)


_SMEM = r"""
#include <cstdio>

#include "flat_select.cuh"

using namespace tpq;

int main() {
  for (int d = 8; d <= fsel::MAX_D; d += 8) {
    for (int r = 1; r <= 32; ++r) {
      std::printf("%d %d %zu %d %d %d\n", d, r, fsel::smem_bytes(d, r),
                  fsel::ring_of(d, r), fsel::halves(d), fsel::list_ld(r));
    }
  }
  return 0;
}
"""


def test_wg_smem_mirror_equals_header(tmp_path_factory):
    """csrc/flat_select.cuh's shared memory and ring depth of the
    warp-specialised flat scan equal ops/flat_scan.py's mirror
    (wg_smem_bytes, wg_ring) at every width it takes (d % 8 == 0, d <=
    128) and every r_keep (1-32); every shape fits the limit and its ring
    holds at least one whole tile's k halves (so a consumer's wait for a
    tile's stages never needs a stage the ring lacks); at d = 128, r_keep
    16 the ring has 8 stages, at r_keep 32 7."""
    exe = _compile(tmp_path_factory, "flat_smem", _SMEM)
    lines = subprocess.run([str(exe)], check=True, capture_output=True,
                           text=True).stdout.splitlines()
    assert len(lines) == 16 * 32
    for line in lines:
        d, r, nbytes, ring, halves, ld = map(int, line.split())
        assert fs.wg_smem_bytes(d, r) == nbytes, (d, r)
        assert fs.wg_ring(d, r) == ring, (d, r)
        assert fs.wg_halves(d) == halves == (1 if d <= 64 else 2)
        assert ld == (r | 1)
        assert nbytes <= fs._SMEM_LIMIT
        assert halves <= ring <= 8
    assert fs.wg_ring(128, 16) == 8 and fs.wg_ring(128, 32) == 7
