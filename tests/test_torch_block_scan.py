"""Port parity of the block scan and the cell-major scan built on it.

The oracle is the JAX package's Pallas kernel run in interpret mode
(tests/conftest.py), on the same inputs. The CUDA kernel itself runs only on
a card: tests/test_torch_gpu.py holds it to its plain version there."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torchpq_tpu.index import IVFPQIndex as JaxIndex
from torchpq_tpu.index.ivfpq import _coarse_probe
from torchpq_tpu.ops import adc as jadc
from torchpq_tpu.ops import pallas_scan
from torchpq_tpu_torch.ops import adc as tadc
from torchpq_tpu_torch.ops import block_scan as bs

from _torch_helpers import assert_topk_match, overlap, to_t

BIG = bs.BIG


def _blocks(rng, *, b=5, p_tile=128, d=32, s_eff=256, cap_total=2048,
            dtype=np.float32):
    """Random staged block-scan inputs (some dead slots, some windows that
    hold slots of neighbouring cells)."""
    qtable = rng.normal(size=(300, d)).astype(np.float32)
    decoded = rng.normal(size=(cap_total, d)).astype(np.float32)
    if dtype != np.float32:
        qtable = np.asarray(jnp.asarray(qtable).astype(jnp.bfloat16))
        decoded = np.asarray(jnp.asarray(decoded).astype(jnp.bfloat16))
    probers = rng.integers(-1, 300, size=(b, p_tile)).astype(np.int32)
    start_c = (rng.integers(0, (cap_total - s_eff) // 16, size=b) * 16) \
        .astype(np.int32)
    off = (rng.integers(0, 4, size=b) * 16).astype(np.int32)
    cap = rng.integers(s_eff // 2, s_eff, size=b).astype(np.int32)
    cap = np.minimum(cap, s_eff - off).astype(np.int32)
    norms = rng.uniform(0, 40, size=cap_total).astype(np.float32)
    empty = rng.random(cap_total) < 0.1
    return qtable, probers, start_c, off, cap, norms, empty, decoded


@pytest.mark.parametrize("pack32", [False, True])
@pytest.mark.parametrize("distance", ["euclidean", "inner"])
@pytest.mark.parametrize("s_eff", [64, 256])
def test_block_scan_ref_matches_pallas(rng, pack32, distance, s_eff):
    qt, pr, sc, off, cap, norms, empty, dec = _blocks(
        rng, s_eff=s_eff, dtype=jnp.bfloat16)
    k_pair = 10
    euclid = distance == "euclidean"
    penalty = np.where(empty, BIG, norms if euclid else 0.0) \
        .astype(np.float32)
    slot_mask = int(2 ** np.ceil(np.log2(s_eff))) - 1
    # the JAX kernel's staged inputs: query tiles and per-block penalty rows
    j = np.arange(s_eff)
    in_cell = (j[None] >= off[:, None]) & (j[None] < (off + cap)[:, None])
    pen_all = penalty[sc[:, None] + j[None]] + np.where(in_cell, 0.0, BIG) \
        .astype(np.float32)
    ref = np.asarray(pallas_scan.scan_blocks_pallas(
        jnp.asarray(qt)[jnp.asarray(np.maximum(pr, 0))], jnp.asarray(sc),
        jnp.asarray(pen_all.astype(np.float32)), jnp.asarray(dec),
        s_eff=s_eff, k_pair=k_pair, p_tile=128, distance=distance,
        approx=pack32, slot_mask=slot_mask, bps=1, interpret=True))
    got = bs.block_scan(
        to_t(qt), to_t(pr), to_t(sc), to_t(off), to_t(cap), to_t(penalty),
        to_t(dec), s_eff=s_eff, k_pair=k_pair, euclidean=euclid,
        pack32=pack32, slot_mask=slot_mask).numpy()
    assert got.shape == ref.shape
    if pack32:
        # same keys up to f32 summation order: equal slots, close values
        assert np.mean((got & slot_mask) == (ref & slot_mask)) >= 0.99
        v = bs.sortable_i32_to_f32(to_t(got & ~slot_mask))
        v_ref = bs.sortable_i32_to_f32(to_t(ref & ~slot_mask))
        np.testing.assert_allclose(v.numpy(), v_ref.numpy(), rtol=1e-3,
                                   atol=1e-3)
    else:
        v = bs.sortable_i32_to_f32(to_t(got[..., :k_pair]))
        v_ref = bs.sortable_i32_to_f32(to_t(ref[..., :k_pair]))
        np.testing.assert_allclose(v.numpy(), v_ref.numpy(), rtol=1e-5,
                                   atol=1e-5)
        assert np.mean(got[..., k_pair:] == ref[..., k_pair:]) >= 0.999


def test_block_scan_checks_inputs(rng):
    qt, pr, sc, off, cap, norms, empty, dec = _blocks(rng)
    kw = dict(s_eff=256, k_pair=10, euclidean=True, pack32=False,
              slot_mask=255)
    args = [to_t(qt), to_t(pr), to_t(sc), to_t(off), to_t(cap),
            to_t(norms), to_t(dec)]
    before = dict(bs.launches)
    bs.block_scan(*args, **kw)
    assert bs.launches == before, "the plain version is not a launch"
    bad = list(args)
    bad[0] = bad[0].to(torch.bfloat16)
    with pytest.raises(TypeError):
        bs.block_scan(*bad, **kw)
    bad = list(args)
    bad[1] = bad[1].long()
    with pytest.raises(TypeError):
        bs.block_scan(*bad, **kw)
    bad = list(args)
    bad[6] = bad[6].t()
    with pytest.raises(ValueError):
        bs.block_scan(*bad, **kw)
    with pytest.raises(ValueError):
        bs.block_scan(*args, **dict(kw, k_pair=65))


@pytest.fixture(scope="module")
def scan_case():
    rng = np.random.default_rng(3)
    d, n = 32, 3000
    x = rng.normal(size=(n, d)).astype(np.float32)
    index = JaxIndex(d_vector=d, n_subvectors=8, n_cells=8, initial_size=64)
    index.train(jnp.asarray(x.T))
    index.add(jnp.asarray(x.T))
    q = rng.normal(size=(40, d)).astype(np.float32)
    _, cells, mask = _coarse_probe(
        jnp.asarray(q), index.vq_codec.kmeans._centroids[0],
        jnp.float32(30.0), n_probe=4, use_smart=True, precision=None)
    return index, q, np.asarray(cells), np.asarray(mask)


def _layout(index, compact):
    if compact:
        dec, nrm, emp, _, _, cs, sz, s_live = index._cell_compacted()
        return (dec, nrm, emp, cs, sz), s_live
    return ((index.aux("decoded"), index.aux("norm")[:, 0], index._is_empty,
             index._cell_start, index._cell_capacity),
            index.max_cell_capacity)


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("approx,k", [(False, 10), (True, 10), (False, 80),
                                      (True, 300)])
def test_scan_cell_major_matches(scan_case, compact, approx, k):
    """k=80 (exact) and k=300 (approx) give k_pair > 64: outside the
    kernel's gate, where both packages take their plain per-block select."""
    index, q, cells, mask = scan_case
    arrs, s_max = _layout(index, compact)
    assert s_max >= 256, "the pack32 group reduce must engage"
    kw = dict(k=k, distance="euclidean", s_max=s_max, n_cells=8,
              approx=approx)
    v_ref, a_ref = jadc.scan_cell_major(
        jnp.asarray(q), jnp.asarray(cells), jnp.asarray(mask), *arrs,
        impl="pallas" if k <= 64 else "xla", interpret=True, **kw)
    v, a = tadc.scan_cell_major(
        to_t(q), to_t(cells), to_t(mask),
        *[to_t(t) for t in arrs], impl="auto", **kw)
    assert tadc.LAST_GATE["impl"] == ("block_scan" if k <= 64
                                      else "block_select")
    if approx:
        assert tadc.LAST_GATE["pack32"]
        assert overlap(a, a_ref) >= 0.99
        np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=2e-3,
                                   atol=1e-2)
    else:
        assert_topk_match(v_ref, a_ref, v, a, atol=1e-5, rtol=1e-5)


def test_scan_query_major_matches(scan_case):
    index, q, cells, mask = scan_case
    arrs, s_max = _layout(index, False)
    v_ref, a_ref = jadc.scan_query_major(
        jnp.asarray(q), jnp.asarray(cells), jnp.asarray(mask), *arrs,
        k=10, distance="euclidean", s_max=s_max)
    v, a = tadc.scan_query_major(
        to_t(q), to_t(cells), to_t(mask),
        *[to_t(t) for t in arrs], k=10, distance="euclidean", s_max=s_max)
    assert_topk_match(v_ref, a_ref, v, a, atol=1e-5, rtol=1e-5)


def test_adc_table_oracle(scan_case):
    """LUT-gather ADC equals the decoded-cache score the scans use."""
    index, q, _, _ = scan_case
    cb = to_t(index.pq_codec.codebook_internal)
    codes = to_t(index.storage_rows(jnp.arange(64)))
    lut = tadc.build_adc_table(torch.from_numpy(q), cb, "euclidean")
    lut_ref = jadc.build_adc_table(jnp.asarray(q),
                                   index.pq_codec.codebook_internal,
                                   "euclidean")
    np.testing.assert_allclose(lut.numpy(), np.asarray(lut_ref), rtol=1e-5,
                               atol=1e-4)
    s = tadc.adc_lookup_scores(lut, codes)
    dec = to_t(index._decode_stored(codes.numpy()))
    qt = torch.from_numpy(q)
    direct = 2 * qt @ dec.T - (qt * qt).sum(-1)[:, None] \
        - (dec * dec).sum(-1)[None]
    np.testing.assert_allclose(s.numpy(), direct.numpy(), rtol=1e-4,
                               atol=1e-3)
