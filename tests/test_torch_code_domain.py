"""Port parity of the code-domain tier (scan_cache_dtype="none"): the codes
scan against the JAX package's Pallas codes kernel (interpret mode, through
tests/conftest.py) on the same staged inputs, the code-domain cell-major
scan on its gated and one-hot paths, the decode-on-the-fly flat sweep, and
the whole index with JAX-trained state carried across. Mirrors
tests/test_pallas_codes_scan.py and tests/test_code_domain.py case by case.

Tolerances: the kernel's candidates are bf16(codebook) rows and its
products are exact in f32 in both packages, so scores differ only by f32
summation order (rtol 1e-5, atol 1e-5 on scores of size ~10-100). The
one-hot path sums bf16 LUT entries in f32, in another order than XLA's dot
(atol 1e-4). Index-level searches are held to assert_topk_match at atol
1e-4 / rtol 1e-5 (the query and the coarse probe add f32 rounding)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torchpq_tpu.index import IVFPQIndex as JaxIndex
from torchpq_tpu.index.ivfpq import _coarse_probe
from torchpq_tpu.ops import onehot_adc as jonehot
import torchpq_tpu_torch as tp
from torchpq_tpu_torch.ops import codes_scan as cs
from torchpq_tpu_torch.ops import onehot_adc as tonehot
from torchpq_tpu_torch.ops.block_scan import (BIG, sortable_i32_to_f32,
                                              block_scan)

from _torch_helpers import CPU, assert_topk_match, overlap, pallas_codes, \
    to_np, to_t

N_CELLS = 8


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16))


def _data(seed, n, d):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(40, d)).astype(np.float32) * 3
    x = centers[rng.integers(0, 40, n)] \
        + rng.normal(size=(n, d)).astype(np.float32)
    return x.astype(np.float32)


# ---- the kernel's plain version against the Pallas codes kernel ----

def _staged(rng, *, d, m, s_eff, b=4, cap_total=2048, tie=False):
    """Random staged codes-scan inputs (dead slots, windows that hold slots
    of neighbouring cells). With `tie`, every slot of block 0's window
    holds the same codes, so each prober's scores there are all equal."""
    dsub = d // m
    qtable = _bf16(rng.normal(size=(300, d)))
    codes = rng.integers(0, 256, size=(cap_total, m)).astype(np.uint8)
    codebook = _bf16(rng.normal(size=(m, 256, dsub)))
    probers = rng.integers(-1, 300, size=(b, 128)).astype(np.int32)
    start_c = (rng.integers(0, (cap_total - s_eff) // 16, size=b) * 16) \
        .astype(np.int32)
    off = (rng.integers(0, 4, size=b) * 16).astype(np.int32)
    cap = np.minimum(rng.integers(s_eff // 2, s_eff, size=b),
                     s_eff - off).astype(np.int32)
    empty = rng.random(cap_total) < 0.1
    norms = rng.uniform(0, 40, size=cap_total).astype(np.float32)
    if tie:
        w = slice(start_c[0], start_c[0] + s_eff)
        codes[w] = codes[start_c[0]]
        norms[w] = norms[start_c[0]]
        empty[w] = False
    return qtable, probers, start_c, off, cap, norms, empty, codes, codebook


@pytest.mark.parametrize("d,m", [(32, 8), (128, 64)])
@pytest.mark.parametrize("distance", ["euclidean", "inner"])
@pytest.mark.parametrize("pack32", [False, True])
def test_codes_scan_ref_matches_pallas(rng, d, m, distance, pack32):
    """Block 0's window holds identical codes: its exact winners are the
    first live columns in the kernel's column order (slot r*g + q at
    column q*s_rows + r), which both packages must reproduce."""
    s_eff, k_pair = 256, 10
    qt, pr, sc, off, cap, norms, empty, codes, cb = _staged(
        rng, d=d, m=m, s_eff=s_eff, tie=True)
    euclid = distance == "euclidean"
    penalty = np.where(empty, BIG, norms if euclid else 0.0) \
        .astype(np.float32)
    slot_mask = s_eff - 1
    kw = dict(s_eff=s_eff, k_pair=k_pair, pack32=pack32,
              slot_mask=slot_mask)
    ref = pallas_codes(qt, pr, sc, off, cap, penalty, codes, cb, m=m,
                        distance=distance, **kw)
    got = cs.codes_scan(
        to_t(qt), to_t(pr), to_t(sc), to_t(off), to_t(cap), to_t(penalty),
        to_t(codes.reshape(-1, 128)), to_t(cb), euclidean=euclid,
        **kw).numpy()
    assert got.shape == ref.shape
    if pack32:
        assert np.mean((got & slot_mask) == (ref & slot_mask)) >= 0.99
        v = sortable_i32_to_f32(to_t(got & ~slot_mask)).numpy()
        v_ref = sortable_i32_to_f32(to_t(ref & ~slot_mask)).numpy()
        np.testing.assert_allclose(v, v_ref, rtol=1e-3, atol=1e-3)
        return
    v = sortable_i32_to_f32(to_t(got[..., :k_pair])).numpy()
    v_ref = sortable_i32_to_f32(to_t(ref[..., :k_pair])).numpy()
    np.testing.assert_allclose(v, v_ref, rtol=1e-5, atol=1e-5)
    assert np.mean(got[..., k_pair:] == ref[..., k_pair:]) >= 0.999
    # the tie window: every live prober row equals the first k_pair
    # in-cell columns, in column order
    np.testing.assert_array_equal(got[0, :, k_pair:], ref[0, :, k_pair:])
    g = 128 // m
    col_slot = cs.column_slots(s_eff, g, "cpu").numpy()
    live = col_slot[(col_slot >= off[0]) & (col_slot < off[0] + cap[0])]
    expect = sc[0] + live[:k_pair]
    rows = pr[0] >= 0
    assert (got[0, rows, k_pair:] == expect).all()
    if g > 1:
        assert not (expect == sc[0] + np.sort(live)[:k_pair]).all()


def test_codes_scan_checks_inputs(rng):
    qt, pr, sc, off, cap, norms, empty, codes, cb = _staged(
        rng, d=32, m=8, s_eff=256)
    args = [to_t(qt), to_t(pr), to_t(sc), to_t(off), to_t(cap), to_t(norms),
            to_t(codes.reshape(-1, 128)), to_t(cb)]
    kw = dict(s_eff=256, k_pair=10, euclidean=True, pack32=False,
              slot_mask=255)
    before = dict(cs.launches)
    cs.codes_scan(*args, **kw)
    assert cs.launches == before, "the plain version is not a launch"
    for i, bad in ((0, args[0].float()), (1, args[1].long()),
                   (6, args[6].int()), (7, args[7].float())):
        with pytest.raises(TypeError):
            cs.codes_scan(*args[:i], bad, *args[i + 1:], **kw)
    with pytest.raises(ValueError):
        cs.codes_scan(*args[:6], args[6].t(), args[7], **kw)
    with pytest.raises(ValueError):
        cs.codes_scan(*args, **dict(kw, k_pair=65))


def test_codes_scan_ref_equals_block_scan_over_decoded_rows(rng):
    """Exact select: the codes scan's scores are the block scan's over the
    bf16 decoded rows, so values agree and addresses agree outside ties."""
    qt, pr, sc, off, cap, norms, empty, codes, cb = _staged(
        rng, d=128, m=64, s_eff=256)
    penalty = to_t(np.where(empty, BIG, norms).astype(np.float32))
    kw = dict(s_eff=256, k_pair=10, euclidean=True, pack32=False,
              slot_mask=255)
    blocks = [to_t(qt), to_t(pr), to_t(sc), to_t(off), to_t(cap), penalty]
    got = cs.codes_scan(*blocks, to_t(codes.reshape(-1, 128)), to_t(cb),
                        **kw)
    dec = cs.decode_codes(to_t(codes), to_t(cb))
    ref = block_scan(*blocks, dec, **kw)
    torch.testing.assert_close(got[..., :10], ref[..., :10], rtol=0, atol=0)
    assert (got[..., 10:] == ref[..., 10:]).float().mean() >= 0.999


def test_decode_matches_blockdiag_product(rng):
    """The gather decode equals the JAX package's one-hot @ block-diagonal
    product over the bf16 codebook, bit for bit."""
    m, dsub = 8, 4
    cb = _bf16(rng.normal(size=(m, 256, dsub)))
    codes = rng.integers(0, 256, size=(100, m)).astype(np.uint8)
    bd = torch.from_numpy(np.array(jonehot.blockdiag_codebook(
        jnp.asarray(cb, jnp.float32))))
    onehot = torch.nn.functional.one_hot(
        to_t(codes).long() + torch.arange(m) * 256, m * 256).sum(1).float()
    np.testing.assert_array_equal(
        cs.decode_codes(to_t(codes), to_t(cb)).float().numpy(),
        (onehot @ bd).numpy())


# ---- the index, with JAX-trained state carried across ----

_CASES = {}


def _case(distance="euclidean", d=32, m=8, pack_ingest=None,
          initial_size=64):
    """JAX-trained code-domain index, its state carried into the port, then
    the same two adds in both (built once per setting)."""
    key = (distance, d, m, pack_ingest, initial_size)
    if key in _CASES:
        return _CASES[key]
    x = _data(5, 3000, d)
    kw = dict(d_vector=d, n_subvectors=m, n_cells=N_CELLS,
              initial_size=initial_size, distance=distance,
              scan_cache_dtype="none", pack_ingest=pack_ingest)
    jidx = JaxIndex(**kw)
    jidx.vq_codec.kmeans.max_iter = 6
    jidx.pq_codec.kmeans.max_iter = 6
    jidx.train(jnp.asarray(x[:1500].T))
    port = tp.IVFPQIndex(**kw, device=CPU)
    port.load_state_dict(jidx.state_dict())
    assert port.is_trained and port.n_items == 0
    for chunk in (x[:1200], x[1200:]):
        _, a_ref = jidx.add(jnp.asarray(chunk.T), return_address=True)
        _, a = port.add(chunk.T, return_address=True)
        np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    q = _data(6, 48, d)
    for idx in (jidx, port):
        idx.n_probe = 4
    _CASES[key] = (jidx, port, q)
    return _CASES[key]


def _probe(jidx, q, n_probe=4):
    _, cells, mask = _coarse_probe(
        jnp.asarray(q), jidx.vq_codec.kmeans._centroids[0],
        jnp.float32(30.0), n_probe=n_probe, use_smart=True, precision=None)
    return np.asarray(cells), np.asarray(mask)


@pytest.mark.parametrize("d,m,pack", [(32, 8, None), (32, 8, False),
                                      (128, 64, None)])
def test_adds_match(d, m, pack):
    jidx, port, _ = _case(d=d, m=m, pack_ingest=pack)
    assert "decoded" not in port._aux and "_aux_decoded" not in \
        port.state_dict()
    assert port.pack_group == jidx.pack_group == (1 if pack is False
                                                  else 128 // m)
    for k in ("_storage", "_is_empty", "_cell_start", "_cell_capacity",
              "_address2id", "_id2address"):
        np.testing.assert_array_equal(to_np(getattr(port, k)),
                                      to_np(getattr(jidx, k)), err_msg=k)
    np.testing.assert_allclose(port.aux("norm").numpy(),
                               np.asarray(jidx.aux("norm")), rtol=1e-6)


@pytest.mark.parametrize("d,m,pack,impl", [
    (32, 8, None, "codes_scan"), (128, 64, None, "codes_scan"),
    (32, 8, False, "onehot")])
@pytest.mark.parametrize("approx", [False, True])
def test_scan_cell_major_codes_matches(d, m, pack, impl, approx):
    """The gated path (packed storage, the codes scan) against the JAX
    package's Pallas codes kernel, and the outside-gate path (unpacked
    storage: the bf16 LUT) against its one-hot XLA path."""
    jidx, port, q = _case(d=d, m=m, pack_ingest=pack)
    cells, mask = _probe(jidx, q)
    mj = jidx.code_size if jidx.pack_group > 1 else None
    kw = dict(k=10, distance="euclidean", s_max=jidx.max_cell_capacity,
              n_cells=N_CELLS, approx=approx)
    v_ref, a_ref = jonehot.scan_cell_major_codes(
        jnp.asarray(q), jnp.asarray(cells), jnp.asarray(mask),
        jidx._storage, jidx.aux("norm")[:, 0], jidx._is_empty,
        jidx._cell_start, jidx._cell_capacity, jidx._scan_codebook, m=mj,
        **kw)
    v, a = tonehot.scan_cell_major_codes(
        to_t(q), to_t(cells), to_t(mask), port._storage,
        port.aux("norm")[:, 0], port._is_empty, port._cell_start,
        port._cell_capacity, port._scan_codebook, m=mj, **kw)
    gate = tp.ops.adc.LAST_GATE
    assert gate["impl"] == impl and gate["pack32"] == approx, gate
    if approx:
        assert overlap(a, a_ref) >= 0.99
        np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=2e-3,
                                   atol=1e-2)
    else:
        assert_topk_match(v_ref, a_ref, v, a, atol=1e-4, rtol=1e-5)


def test_build_scan_lut_matches():
    jidx, port, q = _case()
    lut_ref = jonehot.build_scan_lut(jnp.asarray(q), jidx._scan_codebook,
                                     "euclidean")
    lut = tonehot.build_scan_lut(to_t(q), port._scan_codebook, "euclidean")
    np.testing.assert_allclose(lut.numpy(), np.asarray(lut_ref), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("pack", [None, False])
@pytest.mark.parametrize("distance", ["euclidean", "inner"])
def test_flat_decode_scan_matches(pack, distance):
    jidx, port, q = _case(pack_ingest=pack)
    mj = jidx.code_size if jidx.pack_group > 1 else None
    pen = np.where(to_np(jidx._is_empty), BIG,
                   to_np(jidx.aux("norm")[:, 0]) if distance == "euclidean"
                   else 0.0).astype(np.float32)
    v_ref, a_ref = jonehot.flat_decode_scan(
        jnp.asarray(q), jidx._storage, jnp.asarray(pen), jidx._scan_codebook,
        k=10, distance=distance, approx=False, sub=512, m=mj)
    v, a = tonehot.flat_decode_scan(
        to_t(q), port._storage, to_t(pen), port._scan_codebook, k=10,
        distance=distance, m=mj)
    assert_topk_match(v_ref, a_ref, v, a, atol=1e-4, rtol=1e-5)


def _search_both(jidx, port, q, mode, approx):
    for idx in (jidx, port):
        idx.scan_mode = mode
        idx.use_approx_topk = approx
    v_ref, i_ref = jidx.search(jnp.asarray(q.T), k=10)
    v, i = port.search(q.T, k=10)
    assert v.dtype == torch.float32 and tuple(i.shape) == (len(q), 10)
    return v_ref, i_ref, v, i


@pytest.mark.parametrize("mode", ["cell_major", "query_major", "flat"])
@pytest.mark.parametrize("approx", [False, True])
def test_search_matches(mode, approx):
    jidx, port, q = _case()
    v_ref, i_ref, v, i = _search_both(jidx, port, q, mode, approx)
    if mode != "flat":
        assert tp.ops.adc.LAST_GATE["impl"] == "codes_scan"
    if approx and mode != "flat":
        # pack32 keys keep the value bits above the slot bits: both
        # packages truncate alike, up to f32 summation order
        assert tp.ops.adc.LAST_GATE["pack32"]
        assert overlap(i, i_ref) >= 0.99
        np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), atol=5e-3,
                                   rtol=1e-4)
    else:
        assert_topk_match(v_ref, i_ref, v, i, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("distance", ["inner", "cosine"])
@pytest.mark.parametrize("mode", ["cell_major", "flat"])
def test_search_other_distances_match(distance, mode):
    jidx, port, q = _case(distance=distance)
    assert_topk_match(*_search_both(jidx, port, q, mode, False),
                      atol=1e-4, rtol=1e-5)


def test_search_wide_rows_match():
    """d=128, m=64: g=2 packed rows, the slice's own code width."""
    jidx, port, q = _case(d=128, m=64)
    for mode in ("cell_major", "flat"):
        assert_topk_match(*_search_both(jidx, port, q, mode, False),
                          atol=1e-4, rtol=1e-5)


def test_search_cells_matches():
    jidx, port, q = _case()
    rng = np.random.default_rng(10)
    cells = np.stack([rng.permutation(N_CELLS)[:3] for _ in range(len(q))]) \
        .astype(np.int32)
    for idx in (jidx, port):
        idx.scan_mode = "cell_major"
        idx.use_approx_topk = False
    v_ref, i_ref = jidx.search_cells(jnp.asarray(q.T), jnp.asarray(cells),
                                     k=10)
    v, i = port.search_cells(q.T, cells, k=10)
    assert tp.ops.adc.LAST_GATE["impl"] == "codes_scan"
    assert_topk_match(v_ref, i_ref, v, i, atol=1e-4, rtol=1e-5)


def test_similarity_at_address_matches():
    """Rows decoded from their codes in f32 (rtol 1e-5 on the product)."""
    jidx, port, q = _case()
    addr = np.array([-1, 0, 5, 17, 64, 200, 5000])
    ref = np.asarray(jidx.similarity_at_address(jnp.asarray(q.T),
                                                jnp.asarray(addr)))
    got = port.similarity_at_address(q.T, addr).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


def test_remove_then_search_matches():
    jidx, port, q = _case(initial_size=32)
    ids = np.arange(0, 3000, 7)
    assert port.remove(ids=ids) == jidx.remove(ids=jnp.asarray(ids))
    for mode in ("cell_major", "flat"):
        v_ref, i_ref, v, i = _search_both(jidx, port, q, mode, False)
        assert_topk_match(v_ref, i_ref, v, i, atol=1e-4, rtol=1e-5)
        assert not np.isin(i.numpy(), ids).any()


def test_relayout_matches():
    """16-slot cells: the adds relayout through the norm-only rebuilder."""
    jidx, port, q = _case(initial_size=16)
    assert port.max_cell_capacity > 16, "the adds must relayout"
    np.testing.assert_array_equal(port._storage.numpy(),
                                  np.asarray(jidx._storage))
    np.testing.assert_allclose(port.aux("norm").numpy(),
                               np.asarray(jidx.aux("norm")), rtol=1e-6)
    assert_topk_match(*_search_both(jidx, port, q, "cell_major", False),
                      atol=1e-4, rtol=1e-5)


def test_freeze_unfreeze():
    """An unpacked index packs its rows on freeze (the same bytes), finds
    the same neighbours, and refuses add / remove until unfrozen."""
    jidx, port, q = _case(pack_ingest=False, initial_size=32)
    port.scan_mode, port.use_approx_topk = "cell_major", False
    v0, i0 = port.search(q.T, k=10)
    assert tp.ops.adc.LAST_GATE["impl"] == "onehot"
    jidx.freeze_codes()
    port.freeze_codes()
    assert port._frozen_codes and port.pack_group == 16
    np.testing.assert_array_equal(port._storage.numpy(),
                                  np.asarray(jidx._storage))
    v_ref, i_ref, v, i = _search_both(jidx, port, q, "cell_major", False)
    assert tp.ops.adc.LAST_GATE["impl"] == "codes_scan"
    assert_topk_match(v_ref, i_ref, v, i, atol=1e-4, rtol=1e-5)
    assert overlap(i, i0) >= 0.95  # bf16 LUT vs decode-then-score
    with pytest.raises(RuntimeError):
        port.add(q.T)
    with pytest.raises(RuntimeError):
        port.remove(ids=np.arange(4))
    port.unfreeze_codes()
    jidx.unfreeze_codes()
    assert not port._frozen_codes and port.pack_group == 16
    _, i2 = port.search(q.T, k=10)
    np.testing.assert_array_equal(i2.numpy(), i.numpy())


def test_freeze_needs_code_domain():
    with pytest.raises(ValueError):
        tp.IVFPQIndex(32, 8, N_CELLS, device=CPU).freeze_codes()


def test_jax_saved_npz_searches_alike(tmp_path):
    jidx, _, q = _case()
    jidx.save(tmp_path / "jax_codes.npz")
    port = tp.IVFPQIndex(32, 8, N_CELLS, initial_size=64,
                         scan_cache_dtype="none", device=CPU)
    port.load(tmp_path / "jax_codes.npz")
    assert port.pack_group == 16 and "decoded" not in port._aux
    for idx in (jidx, port):
        idx.n_probe = 4
    assert_topk_match(*_search_both(jidx, port, q, "cell_major", False),
                      atol=1e-4, rtol=1e-5)


def test_port_saved_npz_loads_in_jax(tmp_path):
    jidx, port, q = _case()
    port.save(tmp_path / "port_codes.npz")
    back = JaxIndex(d_vector=32, n_subvectors=8, n_cells=N_CELLS,
                    initial_size=64, scan_cache_dtype="none")
    back.load(str(tmp_path / "port_codes.npz"))
    back.n_probe = 4
    back.scan_mode, back.use_approx_topk = "cell_major", False
    port.scan_mode, port.use_approx_topk = "cell_major", False
    v_ref, i_ref = back.search(jnp.asarray(q.T), k=10)
    v, i = port.search(q.T, k=10)
    assert_topk_match(v_ref, i_ref, v, i, atol=1e-4, rtol=1e-5)


def test_port_trains_on_its_own():
    """train -> add -> search through the port alone: self-recall on the
    probed codes scan and on the flat sweep (test_code_domain.py's
    end-to-end case)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1500, 32)).astype(np.float32)
    idx = tp.IVFPQIndex(32, 8, N_CELLS, initial_size=64,
                        scan_cache_dtype="none", device=CPU)
    idx.train(x.T)
    ids = idx.add(x.T).numpy()
    idx.n_probe = 8
    for mode in ("cell_major", "flat"):
        idx.scan_mode = mode
        _, got = idx.search(x[:64].T, k=1)
        assert (got[:, 0].numpy() == ids[:64]).mean() >= 0.95, mode
    sims = idx.similarity_at_address(x[:4].T,
                                     idx.get_address_by_id(ids[:4]))
    assert torch.isfinite(sims).all()
