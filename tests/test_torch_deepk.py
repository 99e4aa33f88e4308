"""Port parity of the deep-k surface and the device spill: the same numpy
inputs (seeded draws) through the JAX package's functions (Pallas in
interpret mode, tests/conftest.py) and the port's.

Tolerances: spill ranks and assignments, supercell probes and the indexes'
stored layouts are integers and must be equal. Exact selects: values
within 1e-4 absolute + 1e-5 relative, ids equal outside ties
(assert_topk_match). pack32 selects keep a score only above its slot
bits, so f32 summation order can move a score across one truncation step:
ids overlap >= 0.99 and values agree within 5e-3 absolute (a truncation
step of the scores here)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torchpq_tpu.index import IVFPQIndex as JaxIndex
from torchpq_tpu.index import ivfpq as jivfpq
from torchpq_tpu.ops import adc as jadc
from torchpq_tpu.ops import spill as jspill
import torchpq_tpu_torch as tp
from torchpq_tpu_torch.index import ivfpq as tivfpq
from torchpq_tpu_torch.ops import adc as tadc
from torchpq_tpu_torch.ops import spill as tspill

from _torch_helpers import CPU, assert_topk_match, overlap, to_np

D, M, N_CELLS, N = 64, 8, 32, 2600
PACK_ATOL = 5e-3


# ---- spill ----

def _spill_cases():
    rng = np.random.default_rng(3)
    yield "capacity", np.stack([np.zeros(60, np.int32), rng.integers(
        1, 8, 60).astype(np.int32)], 1), np.zeros(8, np.int32), 10
    yield "occupancy", np.stack([np.full(6, 2, np.int32),
                                 np.full(6, 3, np.int32)], 1), \
        np.array([0, 0, 3, 0], np.int32), 5
    yield "all_full", np.stack([np.zeros(5, np.int32),
                                np.ones(5, np.int32)], 1), \
        np.zeros(2, np.int32), 1
    top = np.stack([rng.permutation(32)[:4] for _ in range(500)]) \
        .astype(np.int32)
    top[:200, 0] = 5   # a hot cell: its items spill to their next choices
    top[:40, :] = [5, 6, 7, 8]  # and some find all their choices full
    occ = rng.integers(0, 12, 32).astype(np.int32)
    occ[[6, 7, 8]] = 12
    yield "random", top, occ, 12


@pytest.mark.parametrize("case", list(_spill_cases()),
                         ids=lambda c: c[0])
def test_spill_assign_device_matches(case):
    """Bit-equal chosen cells and counts, the all-full fallback included."""
    _, top, occ, cap = case
    n_cells = occ.shape[0]
    c_ref, n_ref = jspill.spill_assign_device(
        jnp.asarray(top), jnp.asarray(occ), cap=cap, n_cells=n_cells)
    c, n = tspill.spill_assign_device(torch.from_numpy(top),
                                      torch.from_numpy(occ), cap=cap,
                                      n_cells=n_cells)
    assert c.dtype == torch.int32 and n.dtype == torch.int32
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))
    np.testing.assert_array_equal(n.numpy(), np.asarray(n_ref))
    assert int(n.sum()) == top.shape[0]


def test_rank_in_group_matches():
    rng = np.random.default_rng(4)
    cells = rng.integers(0, 16, 700).astype(np.int32)
    active = rng.random(700) < 0.7
    ref = np.asarray(jspill.rank_in_group(jnp.asarray(cells),
                                          jnp.asarray(active), 16))
    got = tspill.rank_in_group(torch.from_numpy(cells),
                               torch.from_numpy(active), 16).numpy()
    np.testing.assert_array_equal(got[active], ref[active])


# ---- supercell-native probing ----

@pytest.mark.parametrize("use_smart", [False, True])
@pytest.mark.parametrize("n_cells,group,cap", [(30, 4, 5), (32, 8, 8),
                                               (30, 4, 2)])
def test_coarse_probe_super_matches(n_cells, group, cap, use_smart):
    """Equal supercells and mask; 30 cells in groups of 4 leave a ragged
    last supercell of 2; cap 8 over 4 supercells takes all of them."""
    rng = np.random.default_rng(n_cells + cap)
    q = rng.normal(size=(40, 16)).astype(np.float32)
    cb = rng.normal(size=(n_cells, 16)).astype(np.float32)
    s_ref, c_ref, m_ref = jivfpq._coarse_probe_super(
        jnp.asarray(q), jnp.asarray(cb), jnp.float32(30.0), cap=cap,
        group=group, n_cells=n_cells, use_smart=use_smart, precision=None)
    s, c, m = tivfpq._coarse_probe_super(
        torch.from_numpy(q), torch.from_numpy(cb), 30.0, cap=cap,
        group=group, n_cells=n_cells, use_smart=use_smart)
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-5,
                               atol=1e-4)


# ---- the grouped cell-major scan ----

_SCAN = {}


def _scan_inputs(n_cells):
    """A bf16 cache of n_cells cells of 16-aligned capacities 16-64 (~30%
    of slots empty), 12 queries, their top-160 cells and the supercells of
    group 4 (jivfpq._coarse_probe_super at cap 20)."""
    if n_cells in _SCAN:
        return _SCAN[n_cells]
    rng = np.random.default_rng(n_cells)
    caps = rng.integers(1, 5, n_cells).astype(np.int32) * 16
    start = np.concatenate([[0], np.cumsum(caps)[:-1]]).astype(np.int32)
    total = int(caps.sum())
    dec = rng.normal(size=(total, D)).astype(np.float32)
    dec = np.array(jnp.asarray(dec, jnp.bfloat16).astype(jnp.float32))
    norms = (dec ** 2).sum(1).astype(np.float32)
    empty = rng.random(total) < 0.3
    cb = rng.normal(size=(n_cells, D)).astype(np.float32)
    q = (cb[rng.integers(0, n_cells, 12)]
         + 0.3 * rng.normal(size=(12, D))).astype(np.float32)
    sims = 2 * q @ cb.T - (cb ** 2).sum(1)[None]
    cells = np.argsort(-sims, axis=1, kind="stable")[:, :160] \
        .astype(np.int32)
    _, sup, sup_mask = jivfpq._coarse_probe_super(
        jnp.asarray(q), jnp.asarray(cb), jnp.float32(30.0), cap=20, group=4,
        n_cells=n_cells, use_smart=False, precision=None)
    _SCAN[n_cells] = dict(q=q, dec=dec, norms=norms, empty=empty,
                          start=start, caps=caps, cells=cells,
                          sup=np.array(sup), sup_mask=np.array(sup_mask),
                          s_max=int(caps.max()))
    return _SCAN[n_cells]


def _run_scan(inp, cells, mask, *, k, approx, impl="auto", **kw):
    """(values, addresses) of the JAX and the port scan on the same
    inputs. impl "auto": the block scan (Pallas in interpret mode, the
    port's plain version); "xla": both packages' XLA select, which holds
    the glue at less cost."""
    common = dict(k=k, distance="euclidean", s_max=inp["s_max"],
                  n_cells=len(inp["caps"]), approx=approx, impl=impl,
                  group=4, **kw)
    j = jadc.scan_cell_major(
        jnp.asarray(inp["q"]), jnp.asarray(cells), jnp.asarray(mask),
        jnp.asarray(inp["dec"], jnp.bfloat16), jnp.asarray(inp["norms"]),
        jnp.asarray(inp["empty"]), jnp.asarray(inp["start"]),
        jnp.asarray(inp["caps"]), **common)
    t = tadc.scan_cell_major(
        torch.from_numpy(inp["q"]), torch.from_numpy(cells),
        torch.from_numpy(mask), torch.from_numpy(inp["dec"]).bfloat16(),
        torch.from_numpy(inp["norms"]), torch.from_numpy(inp["empty"]),
        torch.from_numpy(inp["start"]), torch.from_numpy(inp["caps"]),
        **common)
    return j, t


@pytest.mark.parametrize("n_probe,probe_cap,pre_grouped,approx,k_pair,impl", [
    (24, None, False, False, None, "auto"),
    (24, None, False, True, None, "xla"),
    (24, 5, False, True, 40, "xla"),
    (24, 5, False, False, 12, "xla"),
    (160, None, False, False, 12, "xla"),
    (160, None, False, True, None, "xla"),
    (160, 20, False, True, 40, "auto"),
    (160, 20, False, False, None, "xla"),
    (20, None, True, True, 40, "xla"),
    (20, None, True, False, None, "xla")])
def test_scan_cell_major_grouped_matches(n_probe, probe_cap, pre_grouped,
                                         approx, k_pair, impl):
    """group 4 over 256 cells: the [np, np] dedup (n_probe 24) and the
    stable-sort one (n_probe 160), with and without the probe cap; the
    supercells of _coarse_probe_super (pre_grouped); exact and pack32,
    with the scan's k_pair and an explicit one; through the block scan
    (the Pallas kernel in interpret mode) and through the XLA select."""
    inp = _scan_inputs(256)
    if pre_grouped:
        cells, mask = inp["sup"], inp["sup_mask"]
    else:
        cells = np.ascontiguousarray(inp["cells"][:, :n_probe])
        mask = np.ones(cells.shape, bool)
        mask[::3, n_probe // 2:] = False   # smart probing's short rows
    (v_ref, a_ref), (v, a) = _run_scan(
        inp, cells, mask, k=48, approx=approx, k_pair=k_pair,
        probe_cap=probe_cap, pre_grouped=pre_grouped, impl=impl)
    gate = tadc.LAST_GATE
    assert gate["impl"] == ("block_scan" if impl == "auto"
                            else "block_select")
    assert gate["group"] == 4 and gate["pack32"] == approx
    assert gate["s_eff"] == 4 * inp["s_max"]
    assert gate["n_probe"] == (probe_cap or cells.shape[1])
    if k_pair is not None:
        assert gate["k_pair"] == k_pair
    if approx:
        assert overlap(a, a_ref) >= 0.99
        np.testing.assert_allclose(v.numpy(), np.asarray(v_ref),
                                   atol=PACK_ATOL, rtol=1e-4)
    else:
        assert_topk_match(v_ref, a_ref, v, a)


@pytest.mark.parametrize("taper", [(32, 8), (2, 8), (3, 16)])
def test_merge_taper_matches(taper):
    """The rank-tapered merge (pack32, k 64 > 32, k_pair 32): (32, 8) over
    32 probes does not engage and equals the untapered merge; (2, 8) and
    (3, 16) engage, with tail widths raised so the columns reach k. Port
    and JAX agree on each (mirrors tests/test_advice_r4.py:131)."""
    inp = _scan_inputs(64)
    cells = np.ascontiguousarray(inp["cells"][:, :32])
    mask = np.ones(cells.shape, bool)
    (v_ref, a_ref), (v, a) = _run_scan(inp, cells, mask, k=64, approx=True,
                                       k_pair=32, merge_taper=taper,
                                       impl="xla")
    assert overlap(a, a_ref) >= 0.99
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), atol=PACK_ATOL,
                               rtol=1e-4)
    _, (v0, a0) = _run_scan(inp, cells, mask, k=64, approx=True, k_pair=32,
                            impl="xla")
    if taper[0] >= 32:
        assert torch.equal(a, a0) and torch.equal(v, v0)
    else:
        assert (a.numpy() >= 0).all()
        assert overlap(a, a0) >= 0.7


# ---- the index with the r6 knobs ----

def _data(seed, n, d=D):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype(np.float32)


_INDEX = {}


def _index_pair(cache=None):
    """A JAX-trained index and the port's copy of its codecs (state
    carried), each filled by the same two adds with spill on (8 choices,
    capacity the initial per-cell 64, device route): equal layouts."""
    if cache in _INDEX:
        return _INDEX[cache]
    x = _data(11, N)
    kw = dict(d_vector=D, n_subvectors=M, n_cells=N_CELLS, initial_size=64,
              scan_cache_dtype=cache)
    jidx = JaxIndex(**kw)
    jidx.vq_codec.kmeans.max_iter = 8
    jidx.pq_codec.kmeans.max_iter = 8
    jidx.train(jnp.asarray(x[:1500].T))
    port = tp.IVFPQIndex(**kw, device=CPU)
    port.load_state_dict(jidx.state_dict())
    for idx in (jidx, port):
        idx.spill_cells = 8
        idx.spill_capacity = idx.max_cell_capacity
    for chunk in (x[:1300], x[1300:]):
        _, a_ref = jidx.add(jnp.asarray(chunk.T), return_address=True)
        _, a = port.add(chunk.T, return_address=True)
        np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    _INDEX[cache] = (jidx, port, _data(12, 13))
    return _INDEX[cache]


def _r6(idx, **over):
    """The deep-k record's knobs, scaled: n_probe 24 cells in supercells of
    4, capped at 8, k_pair 48, taper (2, 8)."""
    settings = dict(scan_mode="cell_major", use_approx_topk=True,
                    use_smart_probing=False, n_probe=24, scan_group=4,
                    scan_probe_cap=8, scan_k_pair=48,
                    scan_merge_taper=(2, 8), scan_super_probe=True,
                    scan_split_taper=True)
    settings.update(over)
    for name, value in settings.items():
        setattr(idx, name, value)


def test_spill_adds_match():
    """Spill routes the overflow of full cells: the same layout in both
    packages, every cell at most its capacity unless all of an item's
    choices were full (then the container grew it)."""
    jidx, port, _ = _index_pair()
    for name in ("_storage", "_is_empty", "_cell_start", "_cell_capacity",
                 "_cell_size", "_address2id"):
        np.testing.assert_array_equal(to_np(getattr(port, name)),
                                      to_np(getattr(jidx, name)),
                                      err_msg=name)
    assert port.spill_impl == "device" and port.n_items == N


def test_r6_search_matches_and_gates():
    """Every knob on, approx: super-probe and split engage in both
    packages, with the same split; ids overlap >= 0.99. LAST_GATE holds
    both scans' records."""
    jidx, port, q = _index_pair()
    for idx in (jidx, port):
        _r6(idx)
    v_ref, i_ref = jidx.search(jnp.asarray(q.T), k=48)
    v, i = port.search(q.T, k=48)
    gate = tadc.LAST_GATE
    assert gate["super_probe"] is True
    assert gate["split"] == jadc.LAST_GATE["split"] == (2, 8)
    head, tail = gate["head"], gate["tail"]
    assert (head["k_pair"], tail["k_pair"]) == (48, 8)
    assert (head["n_probe"], tail["n_probe"]) == (2, 6)
    assert head["impl"] == tail["impl"] == "block_scan"
    assert head["s_eff"] == tail["s_eff"] == 4 * port.max_cell_capacity
    assert head["pack32"] and tail["pack32"]
    assert overlap(i, i_ref) >= 0.99
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), atol=PACK_ATOL,
                               rtol=1e-4)


def test_r6_exact_setting_matches():
    """The same knobs with the exact select: the probe cap, super-probe
    and taper need approx, so grouping and k_pair alone act; equal ids."""
    jidx, port, q = _index_pair()
    for idx in (jidx, port):
        _r6(idx, use_approx_topk=False, scan_k_pair=20)
    v_ref, i_ref = jidx.search(jnp.asarray(q.T), k=20)
    v, i = port.search(q.T, k=20)
    g = tadc.LAST_GATE
    assert g["split"] is None and g["super_probe"] is False
    assert (g["group"], g["k_pair"], g["pack32"]) == (4, 20, False)
    assert_topk_match(v_ref, i_ref, v, i)


def test_r6_npz_carried_searches_alike(tmp_path):
    """A JAX index saved as .npz and loaded into the port searches as the
    JAX index does, every knob on: ids overlap >= 0.99 with the approx
    select, equal ids with the exact one."""
    jidx, _, q = _index_pair()
    jidx.save(tmp_path / "jax_deepk.npz")
    port = tp.IVFPQIndex(D, M, N_CELLS, initial_size=64, device=CPU)
    port.load(tmp_path / "jax_deepk.npz")
    for idx in (jidx, port):
        _r6(idx)
    v_ref, i_ref = jidx.search(jnp.asarray(q.T), k=48)
    v, i = port.search(q.T, k=48)
    assert tadc.LAST_GATE["split"] == (2, 8)
    assert overlap(i, i_ref) >= 0.99
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), atol=PACK_ATOL,
                               rtol=1e-4)
    for idx in (jidx, port):
        idx.use_approx_topk = False
    assert_topk_match(*jidx.search(jnp.asarray(q.T), k=20),
                      *port.search(q.T, k=20))


@pytest.mark.parametrize("super_probe", [True, False])
def test_split_matches_single_launch(super_probe):
    """The split taper against the single tapered launch in the port (as
    tests/test_ivfpq.py:477 holds the JAX package): pools agree almost
    everywhere and at the top; without super-probe grouping leaves probes
    that may share a supercell, so nothing splits and the two equal."""
    _, port, q = _index_pair()
    _r6(port, scan_super_probe=super_probe)
    v_s, i_s = port.search(q.T, k=48)
    assert tadc.LAST_GATE["split"] == ((2, 8) if super_probe else None)
    port.scan_split_taper = False
    v_o, i_o = port.search(q.T, k=48)
    assert tadc.LAST_GATE["split"] is None
    if super_probe:
        assert overlap(i_s, i_o) > 0.9
        np.testing.assert_array_equal(i_s[:, 0].numpy(), i_o[:, 0].numpy())
    else:
        assert torch.equal(i_s, i_o) and torch.equal(v_s, v_o)


def test_super_probe_matches_dedup_path():
    """cap = n_super: supercell-native probing and the dedup + cap path
    scan the same windows (tests/test_ivfpq.py:440), in the port as in
    the JAX package."""
    jidx, port, q = _index_pair()
    for idx in (jidx, port):
        _r6(idx, n_probe=32, scan_probe_cap=N_CELLS // 4 - 1,
            scan_merge_taper=None, scan_k_pair=None)
    out = {}
    for sp in (True, False):
        for idx in (jidx, port):
            idx.scan_super_probe = sp
        v_ref, i_ref = jidx.search(jnp.asarray(q.T), k=10)
        out[sp] = port.search(q.T, k=10)
        assert tadc.LAST_GATE["super_probe"] is sp
        assert overlap(out[sp][1], i_ref) >= 0.99
    assert overlap(out[True][1], out[False][1]) > 0.8


def test_search_cells_keeps_jax_behaviour():
    """search_cells takes the index's group and probe cap but no taper,
    split or super-probe (ROADMAP C2), as the JAX package's does."""
    jidx, port, q = _index_pair()
    rng = np.random.default_rng(13)
    cells = np.stack([rng.permutation(N_CELLS)[:12]
                      for _ in range(len(q))]).astype(np.int32)
    for idx in (jidx, port):
        _r6(idx, scan_probe_cap=2)
    v_ref, i_ref = jidx.search_cells(jnp.asarray(q.T), jnp.asarray(cells),
                                     k=48)
    v, i = port.search_cells(q.T, cells, k=48)
    g = tadc.LAST_GATE
    assert "split" not in g and g["n_probe"] == 2 and g["k_pair"] == 48
    assert overlap(i, i_ref) >= 0.99
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), atol=PACK_ATOL,
                               rtol=1e-4)


def test_code_domain_scan_k_pair_matches():
    """The code domain takes scan_k_pair in place of its own rule."""
    jidx, port, q = _index_pair("none")
    for idx in (jidx, port):
        idx.scan_mode, idx.n_probe = "cell_major", 6
        idx.use_approx_topk = True
        idx.scan_k_pair = 24
    v_ref, i_ref = jidx.search(jnp.asarray(q.T), k=48)
    v, i = port.search(q.T, k=48)
    assert tadc.LAST_GATE["k_pair"] == jadc.LAST_GATE["k_pair"] == 24
    assert overlap(i, i_ref) >= 0.99
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), atol=PACK_ATOL,
                               rtol=1e-4)


def test_split_keeps_completeness_floor():
    """ROADMAP C1: scan_k_pair None, an engaged taper and k > 64 * np_eff
    (k 200 over 3 supercells): the JAX package's split pads 8 -inf / -1
    entries per row, the port keeps the scan's completeness floor (k_pair
    67) and returns 200 live rows that hold the JAX rows' live ids."""
    jidx, port, q = _index_pair()
    for idx in (jidx, port):
        _r6(idx, n_probe=16, scan_probe_cap=3, scan_k_pair=None,
            scan_merge_taper=(1, 8))
    v_ref, i_ref = jidx.search(jnp.asarray(q.T), k=200)
    v, i = port.search(q.T, k=200)
    i_ref = np.asarray(i_ref)
    assert ((i_ref < 0).sum(1) == 8).all()
    assert (i.numpy() >= 0).all() and torch.isfinite(v).all()
    g = tadc.LAST_GATE
    assert g["split"] == (1, 67) and g["head"]["k_pair"] == 67
    assert jadc.LAST_GATE["split"] == (1, 64)
    assert overlap(i, i_ref) >= 0.95


def test_host_spill_raises():
    """The native host route is not ported: spill with spill_impl="host"
    raises naming A15 and adds nothing."""
    _, port, _ = _index_pair()
    idx = tp.IVFPQIndex(D, M, N_CELLS, initial_size=64, device=CPU)
    idx.load_state_dict({**port.vq_codec.state_dict("vq_codec."),
                         **port.pq_codec.state_dict("pq_codec.")})
    idx.spill_cells, idx.spill_capacity = 8, 64
    idx.spill_impl = "host"
    with pytest.raises(NotImplementedError, match="A15"):
        idx.add(_data(14, 50).T)
    assert idx.n_items == 0
