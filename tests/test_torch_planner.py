"""The port's query planner (IVFPQIndex.plan_scan_mode, index/ivfpq.py:
plan_for) against the JAX package's (tests/test_planner.py).

On a CPU index the port keeps the JAX package's rule and TPU v5e
crossovers, so every case of tests/test_planner.py is mirrored here: the
same host shadows (faked as there: the planner reads only n_items and the
cell capacities) give the same plan in both packages. On a CUDA index the
port decides by the card's measured costs (CARD_PLAN_COSTS); plan_for is a
pure function of the shadows, so its cases need no card: the searches the
JAX package's rule sent to the flat sweep at 1M (17-47x slower on the card)
take the probed plan, and a small index the sweep."""

import numpy as np
import pytest
import torch

from torchpq_tpu.index import IVFPQIndex as JaxIndex
import torchpq_tpu_torch as tp
from torchpq_tpu_torch.fn.ivfpq_topk import (BATCH_THRESHOLD,
                                             batch_threshold_for)
from torchpq_tpu_torch.index.ivfpq import (CARD_PLAN_COSTS, card_plan_ms,
                                           plan_for)

from _torch_helpers import CPU

BIG_NQ = 10_000


def _fake_scale(index, *, n_items, s_max, n_cells=None):
    """A large index's host shadows (tests/test_planner.py:20-25)."""
    index._n_items = n_items
    n = n_cells if n_cells is not None else index.n_cells
    index._cell_capacity_np = np.full(n, s_max, np.int64)
    return index


def _pair(d=32, **kw):
    """A JAX and a port index of the same tiny untrained layout."""
    kw.setdefault("n_subvectors", 8)
    kw.setdefault("n_cells", 64)
    kw.setdefault("initial_size", 16)
    return JaxIndex(d_vector=d, **kw), tp.IVFPQIndex(d_vector=d, device=CPU,
                                                     **kw)


def _plans(pair, nq, k, *, n_items, s_max, n_probe, approx=True,
           scan_mode="auto"):
    out = []
    for index in pair:
        _fake_scale(index, n_items=n_items, s_max=s_max)
        index.scan_mode = scan_mode
        index.n_probe = n_probe
        index.use_approx_topk = approx
        out.append(index.plan_scan_mode(nq, k))
    return out


# (case of tests/test_planner.py, index kwargs, shadows, query, its plan)
MIRRORED = [
    ("pinned_flat", {}, dict(n_items=10**6, s_max=1024, n_probe=1),
     (BIG_NQ, 10), dict(scan_mode="flat"), "flat"),
    ("pinned_cell_major", {}, dict(n_items=10**6, s_max=1024, n_probe=32),
     (BIG_NQ, 10), dict(scan_mode="cell_major"), "cell_major"),
    ("pinned_query_major", {}, dict(n_items=10**6, s_max=1024, n_probe=1),
     (BIG_NQ, 10), dict(scan_mode="query_major"), "query_major"),
    ("small_batch_below", {}, dict(n_items=500_000_000, s_max=1024,
                                   n_probe=8), (255, 10), {}, "query_major"),
    ("small_batch_at", {}, dict(n_items=500_000_000, s_max=1024, n_probe=8),
     (256, 10), {}, "cell_major"),
    ("k_le_32_np32", {}, dict(n_items=10**6, s_max=1024, n_probe=32),
     (BIG_NQ, 10), {}, "flat"),
    ("k_le_32_np1", {}, dict(n_items=10**6, s_max=1024, n_probe=1),
     (BIG_NQ, 10), {}, "cell_major"),
    ("k_le_32_boundary", {}, dict(n_items=1024 * 128, s_max=1024,
                                  n_probe=1), (BIG_NQ, 10), {}, "flat"),
    ("k_le_32_past_boundary", {}, dict(n_items=1024 * 128 + 1, s_max=1024,
                                       n_probe=1), (BIG_NQ, 10), {},
     "cell_major"),
    ("k_le_32_needs_approx", {}, dict(n_items=10**6, s_max=1024,
                                      n_probe=32), (BIG_NQ, 10),
     dict(approx=False), "cell_major"),
    ("k_gt_32_np2", {}, dict(n_items=10**6, s_max=1024, n_probe=2),
     (BIG_NQ, 100), {}, "flat"),
    ("k_gt_32_np1", {}, dict(n_items=10**6, s_max=1024, n_probe=1),
     (BIG_NQ, 100), {}, "cell_major"),
    ("high_d_deep_k", dict(d=512), dict(n_items=10**6, s_max=1024,
                                        n_probe=32), (BIG_NQ, 100), {},
     "flat"),
    ("code_domain_kernel_probes", dict(d=128, n_subvectors=16,
                                       scan_cache_dtype="none"),
     dict(n_items=10**6, s_max=1024, n_probe=64), (BIG_NQ, 10), {},
     "cell_major"),
    ("code_domain_kernel_flat", dict(d=128, n_subvectors=16,
                                     scan_cache_dtype="none"),
     dict(n_items=10**6, s_max=2048, n_probe=64), (BIG_NQ, 10), {}, "flat"),
    ("code_domain_fallback_np2", dict(scan_cache_dtype="none",
                                      distance="manhattan"),
     dict(n_items=10**6, s_max=1024, n_probe=2), (BIG_NQ, 10), {}, "flat"),
    ("code_domain_fallback_np1", dict(scan_cache_dtype="none",
                                      distance="manhattan"),
     dict(n_items=10**6, s_max=1024, n_probe=1), (BIG_NQ, 10), {},
     "cell_major"),
    ("code_domain_huge_index", dict(d=128, n_subvectors=16,
                                    scan_cache_dtype="none"),
     dict(n_items=100_000_000, s_max=2048, n_probe=32), (BIG_NQ, 10), {},
     "cell_major"),
] + [
    (f"bench_shape_np{n_probe}", {}, dict(n_items=10**6, s_max=1024,
                                          n_probe=n_probe), (BIG_NQ, 10),
     {}, "flat") for n_probe in (8, 32, 64)]


@pytest.mark.parametrize("case,kw,shadows,query,knobs,want", MIRRORED,
                         ids=[m[0] for m in MIRRORED])
def test_cpu_plan_matches_jax(case, kw, shadows, query, knobs, want):
    """A case of tests/test_planner.py: on a CPU index the port's planner
    returns the JAX planner's plan on the same shadows, and that plan is
    the one tests/test_planner.py pins."""
    del case
    kw = dict(kw)
    d = kw.pop("d", 32)
    pair = _pair(d, **kw)
    got = _plans(pair, *query, **shadows, **knobs)
    assert got == [want, want]


def test_cpu_batch_threshold_is_jax():
    """The CPU keeps the JAX package's batch threshold of 256, in the
    index and in the IVFPQTopk facade."""
    jidx, port = _pair()
    assert port._ivfpq_topk.batch_threshold is None
    assert batch_threshold_for(port.device) \
        == jidx._ivfpq_topk.batch_threshold == 256
    assert batch_threshold_for(torch.device("cuda")) \
        == BATCH_THRESHOLD["cuda"]
    assert batch_threshold_for("cuda", 7) == 7


def test_codes_gate_mirror_matches_dispatch():
    """tests/test_planner.py's codes-gate case: the planner's
    _codes_kernel_eligible equals the port's dispatch gate for every
    packed shape, and the JAX package's wherever d_pad % 128 (the JAX
    gate's Mosaic term, which the port drops: ROADMAP's deliberate
    divergences) does not decide it."""
    from torchpq_tpu.ops.pallas_codes_scan import \
        codes_kernel_static_gate as jax_gate
    from torchpq_tpu_torch.ops.codes_scan import codes_kernel_static_gate
    for d, m in ((32, 8), (64, 16), (96, 16), (128, 64), (128, 16)):
        kw = dict(n_subvectors=m, n_cells=8, scan_cache_dtype="none",
                  initial_size=64)
        jidx, port = JaxIndex(d_vector=d, **kw), tp.IVFPQIndex(
            d_vector=d, device=CPU, **kw)
        if port.pack_group <= 1:
            continue
        assert port._codes_kernel_eligible() == codes_kernel_static_gate(
            port.code_size, port.pack_group, d, "euclidean"), (d, m)
        if d % 128 == 0:
            assert port._codes_kernel_eligible() \
                == jidx._codes_kernel_eligible() \
                == jax_gate(m, jidx.pack_group, d, "euclidean"), (d, m)


def test_scan_gate_stable_across_n_probe_axis(rng):
    """tests/test_planner.py's gate case: the scan's k_pair along the
    n_probe axis at k = 100 equals the JAX package's (the completeness
    floor's 100 at n_probe 1, at most 64 from 2 on), and the port's
    resolved select does not flip from n_probe 2 on."""
    import jax.numpy as jnp
    from torchpq_tpu.index.ivfpq import _coarse_probe as jax_probe
    from torchpq_tpu.ops import adc as jadc
    from torchpq_tpu_torch.index.ivfpq import _coarse_probe
    from torchpq_tpu_torch.ops import adc
    d = 32
    x = rng.normal(size=(3000, d)).astype(np.float32)
    kw = dict(n_subvectors=8, n_cells=8, scan_cache_dtype="float32",
              initial_size=64)
    jidx = JaxIndex(d_vector=d, **kw)
    jidx.vq_max_iter = jidx.pq_max_iter = 4
    jidx.train(jnp.asarray(x.T))
    port = tp.IVFPQIndex(d_vector=d, device=CPU, **kw)
    port.load_state_dict(jidx.state_dict())
    jidx.add(jnp.asarray(x.T))
    port.add(x.T)
    q = rng.normal(size=(8, d)).astype(np.float32)
    gates = {}
    for n_probe in (1, 2, 4, 8):
        _, cells, mask = jax_probe(
            jnp.asarray(q), jidx.vq_codec.kmeans._centroids[0],
            jnp.float32(30.0), n_probe=n_probe, use_smart=False,
            precision=None)
        jadc.scan_cell_major(
            jnp.asarray(q), cells, mask, jidx.aux("decoded"),
            jidx.aux("norm")[:, 0], jidx._is_empty, jidx._cell_start,
            jidx._cell_capacity, k=100, distance="euclidean",
            s_max=jidx.max_cell_capacity, n_cells=8, approx=True,
            impl="auto", interpret=True)
        _, cells_t, mask_t = _coarse_probe(
            torch.from_numpy(q), port._coarse_cb(), 30.0, n_probe=n_probe,
            use_smart=False)
        adc.scan_cell_major(
            torch.from_numpy(q), cells_t, mask_t, port.aux("decoded"),
            port._aux_col0("norm"), port._is_empty, port._cell_start,
            port._cell_capacity, k=100, distance="euclidean",
            s_max=port.max_cell_capacity, n_cells=8, approx=True,
            impl="auto")
        gates[n_probe] = (jadc.LAST_GATE["k_pair"], adc.LAST_GATE["k_pair"],
                          adc.LAST_GATE["impl"])
    assert all(j == t for j, t, _ in gates.values()), gates
    assert gates[1][1] == 100, gates
    assert all(gates[n][1] <= 64 for n in (2, 4, 8)), gates
    assert len({gates[n][2] for n in (2, 4, 8)}) == 1, gates


# the card's table: plan_for on a CUDA device, a pure function of the
# shadows. The cases the JAX package's rule sent to the flat sweep, where
# the card's sweep measured the probed plan fastest (PERF.md, PR 16):
# (case, shadows, nq, k)
MAIN = dict(n_items=10**6, s_pow2=1024, d_vector=128, tier="bf16",
            approx=True)
PQR3 = dict(MAIN, s_pow2=512)
GIST = dict(MAIN, s_pow2=512, d_vector=960)
CARD_PROBED = [
    ("1M bf16 approx k10 np8", dict(MAIN, n_probe=8), BIG_NQ, 10),
    ("1M bf16 approx k10 np32", dict(MAIN, n_probe=32), BIG_NQ, 10),
    ("pqr3 approx k100 np8", dict(PQR3, n_probe=8), BIG_NQ, 100),
    ("pqr3 approx k100 np32", dict(PQR3, n_probe=32), BIG_NQ, 100),
    ("deep-k r6 k100 np128", dict(PQR3, n_probe=128), BIG_NQ, 100),
    ("GIST bf16 approx k10 np32", dict(GIST, n_probe=32), BIG_NQ, 10),
    ("GIST bf16 approx k100 np32", dict(GIST, n_probe=32), BIG_NQ, 100),
]


@pytest.mark.parametrize("case,shadows,nq,k", CARD_PROBED,
                         ids=[c[0] for c in CARD_PROBED])
def test_card_table_probes_at_1m(case, shadows, nq, k):
    """The JAX package's rule sends these searches to the flat sweep; the
    card's table sends them to the probed plan its sweep measured fastest,
    and the CPU keeps the JAX rule's flat."""
    del case
    assert plan_for(nq, k, device="cuda", **shadows) == "cell_major"
    assert plan_for(nq, k, device="cpu", **shadows) == "flat"


# a small index (the main layout's codecs, the base's first 20k rows: cell
# capacity 32), where the card's sweep measured the flat sweep fastest by
# more than 1.25x: (case, shadows, nq, k)
SMALL = dict(MAIN, n_items=20_000, s_pow2=32)
CARD_FLAT = [
    ("20k nq1024 approx k10 np8", dict(SMALL, n_probe=8), 1024, 10),
    ("20k nq10k exact k100 np128", dict(SMALL, n_probe=128, approx=False),
     BIG_NQ, 100),
]


@pytest.mark.parametrize("case,shadows,nq,k", CARD_FLAT,
                         ids=[c[0] for c in CARD_FLAT])
def test_card_table_sweeps_small_index(case, shadows, nq, k):
    """Where the card's sweep measured the flat sweep fastest on a small
    index, the card's table takes it."""
    del case
    assert plan_for(nq, k, device="cuda", **shadows) == "flat"


@pytest.mark.parametrize("tier", ["bf16", "float32", "int8", "codes"])
def test_card_table_names_what_runs(tier):
    """At 64 queries, n_probe 8 on the 1M index, the card's sweep measured
    query_major fastest (1.40 ms against cell_major's 2.55 and flat's
    2.20, every GEMM in IEEE f32: the flat terms of "highest"):
    the bf16 and f32 caches take it. The int8 and code tiers run every
    probed plan cell-major, so the card's rule names no query_major there
    but the faster of the two plans that run, as the sweep measured them
    at this point (int8: cell_major 2.302 ms against flat 2.714; codes:
    cell_major 2.197 against flat 2.821). From the batch threshold on,
    query_major is never a candidate."""
    shadows = dict(MAIN, tier=tier, n_probe=8, precision="highest")
    want = {"bf16": "query_major", "float32": "query_major",
            "int8": "cell_major", "codes": "cell_major"}[tier]
    assert plan_for(64, 10, device="cuda", **shadows) == want
    assert plan_for(BATCH_THRESHOLD["cuda"], 10, device="cuda",
                    **dict(shadows, n_probe=1, s_pow2=16)) != "query_major"


def test_card_estimates_are_monotone():
    """Each plan's estimate grows with the batch, the items swept and the
    slots probed; the table has an entry for every tier and select, and
    flat terms for each precision class."""
    assert set(CARD_PLAN_COSTS["flat"]) == {"f32", "bf16"}
    for precision in ("default", "high", "highest"):
        for tier in CARD_PLAN_COSTS["flat"]["f32"]["slot_ps"]:
            sh = dict(MAIN, tier=tier, precision=precision)
            for approx, k in ((True, 10), (False, 10), (False, 100),
                              (True, 100)):
                sh["approx"] = approx
                a = card_plan_ms(1000, k, n_probe=8, **sh)
                b = card_plan_ms(2000, k, n_probe=16,
                                 **dict(sh, n_items=2e6))
                assert all(b[p] > a[p] > 0 for p in a), (tier, approx, k)


def test_card_index_keys_the_table_and_passes_pins():
    """An index whose device is CUDA reads the card's table from its own
    shadows (faked on a CPU index: the planner reads no tensor); a pinned
    scan_mode passes through unchanged on either device."""
    _, port = _pair(128, n_subvectors=16)
    _fake_scale(port, n_items=10**6, s_max=1024)
    port.use_approx_topk = True
    port.n_probe = 32
    assert port.plan_scan_mode(BIG_NQ, 10) == "flat"
    port.device = torch.device("cuda")
    assert port.plan_scan_mode(BIG_NQ, 10) == plan_for(
        BIG_NQ, 10, **port._plan_shadows()) == "cell_major"
    for mode in ("flat", "cell_major", "query_major"):
        port.scan_mode = mode
        assert port.plan_scan_mode(BIG_NQ, 10) == mode
        port.scan_mode = "auto"
