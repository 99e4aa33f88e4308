"""Port parity of the int8 scan-cache tier (scan_cache_dtype="int8"): the
row quantization, the block scan's int8 mode (its plain version against the
JAX Pallas kernel in interpret mode), the int8 flat sweep, and the whole
int8 index built from the same trained state in both packages; plus the
device default of the port's objects."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torchpq_tpu import util as jutil
from torchpq_tpu.index import IVFPQIndex as JaxIndex
from torchpq_tpu.index.ivfpq import _coarse_probe
from torchpq_tpu.ops import adc as jadc
from torchpq_tpu.ops import flat_adc as jflat
from torchpq_tpu.ops import pallas_scan
import torchpq_tpu_torch as tp
from torchpq_tpu_torch.ops import adc as tadc
from torchpq_tpu_torch.ops import block_scan as bs
from torchpq_tpu_torch.ops import flat_adc as tflat

from _torch_helpers import CPU, assert_topk_match, overlap, to_np, to_t

BIG = bs.BIG
N_CELLS = 16


@pytest.mark.parametrize("d", [32, 160])
def test_int8_quantize_rows_matches(rng, d):
    """Bytes and scales equal bit for bit (torch.round and jnp.round both
    round half to even), a zero row included (the 1e-12 floor)."""
    rows = rng.normal(size=(257, d)).astype(np.float32) * 3
    rows[7] = 0.0
    q_ref, s_ref = jutil.int8_quantize_rows(jnp.asarray(rows))
    q, s = tp.util.int8_quantize_rows(torch.from_numpy(rows))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))


def _int8_blocks(rng, *, d, s_eff, b=5, nq=300, cap_total=2048):
    """Random int8 block-scan inputs: f32 rows quantized by the JAX
    package's int8_quantize_rows, some dead slots, windows that hold slots
    of neighbouring cells."""
    q8, q_sc = jutil.int8_quantize_rows(
        jnp.asarray(rng.normal(size=(nq, d)).astype(np.float32)))
    y8, y_sc = jutil.int8_quantize_rows(
        jnp.asarray(rng.normal(size=(cap_total, d)).astype(np.float32)))
    probers = rng.integers(-1, nq, size=(b, 128)).astype(np.int32)
    start_c = (rng.integers(0, (cap_total - s_eff) // 16, size=b) * 16) \
        .astype(np.int32)
    off = (rng.integers(0, 4, size=b) * 16).astype(np.int32)
    cap = np.minimum(rng.integers(s_eff // 2, s_eff, size=b),
                     s_eff - off).astype(np.int32)
    norms = rng.uniform(0, 40, size=cap_total).astype(np.float32)
    empty = rng.random(cap_total) < 0.1
    return (np.asarray(q8), np.asarray(q_sc), probers, start_c, off, cap,
            norms, empty, np.asarray(y8), np.asarray(y_sc))


def _pallas_int8(q8, q_sc, probers, start_c, off, cap, penalty, y8, y_sc,
                 *, s_eff, k_pair, distance, pack32):
    """The JAX kernel on its staged inputs: query tiles, penalty rows and
    per-slot / per-prober scale rows."""
    j = np.arange(s_eff)
    in_cell = (j[None] >= off[:, None]) & (j[None] < (off + cap)[:, None])
    rows = start_c[:, None] + j[None]
    pen_all = (penalty[rows] + np.where(in_cell, 0.0, BIG)) \
        .astype(np.float32)
    pidx = np.maximum(probers, 0)
    return np.asarray(pallas_scan.scan_blocks_pallas(
        jnp.asarray(q8[pidx]), jnp.asarray(start_c), jnp.asarray(pen_all),
        jnp.asarray(y8), s_eff=s_eff, k_pair=k_pair, p_tile=128,
        distance=distance, approx=pack32,
        slot_mask=int(2 ** np.ceil(np.log2(s_eff))) - 1, bps=1,
        interpret=True, scales_all=jnp.asarray(y_sc[rows]),
        q_scales=jnp.asarray(q_sc[pidx])))


@pytest.mark.parametrize("pack32", [False, True])
@pytest.mark.parametrize("distance", ["euclidean", "inner"])
@pytest.mark.parametrize("d", [32, 160])
def test_int8_block_scan_ref_matches_pallas(rng, pack32, distance, d):
    """The dequant is one fused multiply-add in both (the JAX kernel's CPU
    run contracts ab * m - pen; the plain version rounds it once in f64),
    and the int8 products are exact integers: exact keys bit-equal and
    addresses equal, pack32 keys equal. No tolerance."""
    s_eff, k_pair = 256, 10
    q8, q_sc, pr, sc, off, cap, norms, empty, y8, y_sc = _int8_blocks(
        rng, d=d, s_eff=s_eff)
    euclid = distance == "euclidean"
    penalty = np.where(empty, BIG, norms if euclid else 0.0) \
        .astype(np.float32)
    ref = _pallas_int8(q8, q_sc, pr, sc, off, cap, penalty, y8, y_sc,
                       s_eff=s_eff, k_pair=k_pair, distance=distance,
                       pack32=pack32)
    before = dict(bs.launches)
    got = bs.block_scan(
        to_t(q8), to_t(pr), to_t(sc), to_t(off), to_t(cap), to_t(penalty),
        to_t(y8), s_eff=s_eff, k_pair=k_pair, euclidean=euclid,
        pack32=pack32, slot_mask=s_eff - 1, scale=to_t(y_sc),
        q_scale=to_t(q_sc)).numpy()
    assert bs.launches == before, "the plain version is not a launch"
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("pack32", [False, True])
@pytest.mark.parametrize("distance", ["euclidean", "inner"])
@pytest.mark.parametrize("d", [32, 288])
def test_int8_tie_inputs_plain_matches_pallas(pack32, distance, d):
    """bs.int8_tie_inputs, what the card holds both int8 kernels to (equal
    rows all over each window, so exact ties): the plain version equals the
    JAX kernel bit for bit, keys, addresses and the column order of ties,
    pad rows included. d = 288 crosses the tensor-core kernel's 256-byte k
    chunk."""
    s_eff, k_pair = 256, 10
    args, scale, q_scale = bs.int8_tie_inputs(
        "cpu", s_eff=s_eff, n_blocks=3, nq=60, d=d, cap_total=2048, seed=d)
    got = bs.block_scan_ref(*args, s_eff=s_eff, k_pair=k_pair,
                            euclidean=distance == "euclidean", pack32=pack32,
                            slot_mask=s_eff - 1, scale=scale,
                            q_scale=q_scale).numpy()
    q8, pr, sc, off, cap, penalty, y8 = (x.numpy() for x in args)
    ref = _pallas_int8(q8, q_scale.numpy(), pr, sc, off, cap, penalty, y8,
                       scale.numpy(), s_eff=s_eff, k_pair=k_pair,
                       distance=distance, pack32=pack32)
    np.testing.assert_array_equal(got, ref)
    if not pack32:
        keys = got[..., :k_pair][pr >= 0]
        assert (keys[:, 1:] == keys[:, :-1]).sum() > 0, "no ties"


def test_int8_plain_version_does_not_wrap():
    """A row of +-127s at d = 160 sums to 160 * 127^2 = 2,580,640, far past
    int8 (and int16) arithmetic; the plain version scores it exactly, as
    the JAX kernel does."""
    d, s_eff = 160, 64
    q8 = np.full((4, d), 127, np.int8)
    q8[1] = -127
    y8 = np.zeros((256, d), np.int8)
    y8[16:80] = 127
    y8[16:80:3] = -127
    q_sc = np.full(4, 0.5, np.float32)
    y_sc = np.full(256, 0.25, np.float32)
    pr = np.full((1, 128), -1, np.int32)
    pr[0, :4] = np.arange(4)
    args = [np.array([16], np.int32), np.array([0], np.int32),
            np.array([s_eff], np.int32), np.zeros(256, np.float32)]
    kw = dict(s_eff=s_eff, k_pair=4, distance="inner", pack32=False)
    ref = _pallas_int8(q8, q_sc, pr, *args, y8, y_sc, **kw)
    got = bs.block_scan(
        to_t(q8), to_t(pr), *map(to_t, args), to_t(y8), s_eff=s_eff,
        k_pair=4, euclidean=False, pack32=False, slot_mask=s_eff - 1,
        scale=to_t(y_sc), q_scale=to_t(q_sc)).numpy()
    np.testing.assert_array_equal(got, ref)
    best = bs.sortable_i32_to_f32(torch.from_numpy(got[0, 0, :1]))
    assert float(best) == d * 127 * 127 * 0.5 * 0.25


def test_int8_block_scan_checks_inputs(rng):
    q8, q_sc, pr, sc, off, cap, norms, _, y8, y_sc = _int8_blocks(
        rng, d=32, s_eff=256)
    args = [to_t(q8), to_t(pr), to_t(sc), to_t(off), to_t(cap), to_t(norms),
            to_t(y8)]
    kw = dict(s_eff=256, k_pair=10, euclidean=True, pack32=False,
              slot_mask=255)
    with pytest.raises(ValueError):  # int8 needs both scales
        bs.block_scan(*args, **kw, scale=to_t(y_sc))
    with pytest.raises(TypeError):  # per-slot scales, not per query
        bs.block_scan(*args, **kw, scale=to_t(q_sc), q_scale=to_t(q_sc))
    bf16 = [a.to(torch.bfloat16) if a.dtype == torch.int8 else a
            for a in args]
    with pytest.raises(ValueError):  # no scales for a bf16 cache
        bs.block_scan(*bf16, **kw, scale=to_t(y_sc), q_scale=to_t(q_sc))


def _data(seed, n, d):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(40, d)).astype(np.float32) * 3
    x = centers[rng.integers(0, 40, n)] \
        + rng.normal(size=(n, d)).astype(np.float32)
    return x.astype(np.float32)


_CASES = {}


def _case(d, distance="euclidean"):
    """JAX-trained int8 index, its state carried into the port, then the
    same two adds in both (they force a relayout)."""
    key = (d, distance)
    if key in _CASES:
        return _CASES[key]
    x = _data(5, 3000, d)
    kw = dict(d_vector=d, n_subvectors=8, n_cells=N_CELLS, initial_size=64,
              distance=distance, scan_cache_dtype="int8")
    jidx = JaxIndex(**kw)
    jidx.vq_codec.kmeans.max_iter = 6
    jidx.pq_codec.kmeans.max_iter = 6
    jidx.train(jnp.asarray(x[:1500].T))
    port = tp.IVFPQIndex(**kw, device=CPU)
    port.load_state_dict(jidx.state_dict())
    for chunk in (x[:1200], x[1200:]):
        _, a_ref = jidx.add(jnp.asarray(chunk.T), return_address=True)
        _, a = port.add(chunk.T, return_address=True)
        np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    q = _data(6, 48, d)
    for idx in (jidx, port):
        idx.n_probe = 4
    _CASES[key] = (jidx, port, q)
    return _CASES[key]


@pytest.mark.parametrize("d", [32, 160])
def test_int8_adds_match(d):
    """Equal stores after the relayout: int8 rows lane-padded to d_cache,
    scales and norms (the rebuilt ones included)."""
    jidx, port, _ = _case(d)
    assert jidx.max_cell_capacity > 64, "the adds must force a relayout"
    assert port.aux("decoded").dtype == torch.int8
    assert port.aux("decoded").shape[1] == (256 if d == 160 else d)
    for k in ("_storage", "_is_empty", "_cell_start", "_address2id",
              "_aux_decoded"):
        np.testing.assert_array_equal(to_np(getattr(port, k)),
                                      to_np(getattr(jidx, k)), err_msg=k)
    # one f32 ulp: the JAX relayout rebuilds the cache under jit
    # (_cache_chunk), where XLA turns absmax / 127 into a multiply by the
    # reciprocal; its add path and int8_quantize_rows itself divide, as the
    # port does (test_int8_quantize_rows_matches: bit-equal)
    np.testing.assert_allclose(port.aux("scale").numpy(),
                               np.asarray(jidx.aux("scale")), rtol=2 ** -23,
                               atol=0)
    np.testing.assert_allclose(port.aux("norm").numpy(),
                               np.asarray(jidx.aux("norm")), rtol=1e-6)


def _search_both(jidx, port, q, mode, approx, k=10):
    for idx in (jidx, port):
        idx.scan_mode = mode
        idx.use_approx_topk = approx
    v_ref, i_ref = jidx.search(jnp.asarray(q.T), k=k)
    v, i = port.search(q.T, k=k)
    assert v.dtype == torch.float32 and tuple(i.shape) == (len(q), k)
    return v_ref, i_ref, v, i


@pytest.mark.parametrize("d", [32, 160])
@pytest.mark.parametrize("mode,approx,k", [
    ("cell_major", False, 10), ("query_major", False, 10),
    ("cell_major", False, 80), ("flat", False, 10), ("flat", True, 10)])
def test_int8_search_matches(d, mode, approx, k):
    """Every non-flat plan runs the int8 cell-major scan (query_major
    included); k = 80 takes the plain select outside the kernel's gate.
    Scores agree up to the f32 sum order of the flat sweep's dequant
    (1e-4 absolute on values of ~10^2); ids equal outside ties."""
    jidx, port, q = _case(d)
    out = _search_both(jidx, port, q, mode, approx, k=k)
    if mode != "flat":
        assert tadc.LAST_GATE["cache"] == "int8"
        assert tadc.LAST_GATE["impl"] == ("block_scan" if k <= 64
                                          else "block_select")
    else:
        assert tflat.LAST_FLAT["impl"] == "sweep"
    assert_topk_match(*out, atol=1e-4, rtol=1e-5)


def test_int8_search_pack32_matches():
    """pack32 keys keep the value bits above the slot bits. The plain
    version equals the JAX kernel bit for bit on equal inputs (test above),
    but a rebuilt row's scale may sit one ulp apart (test_int8_adds_match),
    which can move its key across one truncation step: 2^log2(s_pow2) ulps,
    under 1e-4 relative at these windows."""
    jidx, port, q = _case(32)
    v_ref, i_ref, v, i = _search_both(jidx, port, q, "cell_major", True)
    assert tadc.LAST_GATE["pack32"] and tadc.LAST_GATE["cache"] == "int8"
    assert overlap(i, i_ref) >= 0.99
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("distance", ["inner", "cosine"])
def test_int8_other_distances_match(distance):
    jidx, port, q = _case(32, distance)
    assert_topk_match(*_search_both(jidx, port, q, "cell_major", False),
                      atol=1e-4, rtol=1e-5)


def test_int8_search_cells_and_similarity_match():
    jidx, port, q = _case(32)
    rng = np.random.default_rng(10)
    cells = np.stack([rng.permutation(N_CELLS)[:3] for _ in range(len(q))]) \
        .astype(np.int32)
    for idx in (jidx, port):
        idx.scan_mode, idx.use_approx_topk = "query_major", False
    v_ref, i_ref = jidx.search_cells(jnp.asarray(q.T), jnp.asarray(cells),
                                     k=10)
    v, i = port.search_cells(q.T, cells, k=10)
    assert tadc.LAST_GATE["cache"] == "int8"
    assert_topk_match(v_ref, i_ref, v, i)
    addr = np.array([-1, 0, 5, 17, 64, 200, 5000])
    ref = np.asarray(jidx.similarity_at_address(jnp.asarray(q.T),
                                                jnp.asarray(addr)))
    got = port.similarity_at_address(q.T, addr).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


def test_int8_npz_both_ways(tmp_path):
    """A JAX-saved int8 index (int8 decoded [cap, d_cache], f32 scale)
    searches alike in the port, and the port's save loads into the JAX
    package with equal arrays."""
    jidx, _, q = _case(32)
    jidx.save(tmp_path / "jax_int8.npz")
    port = tp.IVFPQIndex(32, 8, N_CELLS, initial_size=64,
                         scan_cache_dtype="int8", device=CPU)
    port.load(tmp_path / "jax_int8.npz")
    assert port.aux("decoded").dtype == torch.int8
    assert port.aux("scale").dtype == torch.float32
    port.n_probe = 4
    assert_topk_match(*_search_both(jidx, port, q, "cell_major", False))
    port.save(tmp_path / "port_int8.npz")
    back = JaxIndex(d_vector=32, n_subvectors=8, n_cells=N_CELLS,
                    initial_size=64, scan_cache_dtype="int8")
    back.load(str(tmp_path / "port_int8.npz"))
    with np.load(tmp_path / "jax_int8.npz") as fa, \
            np.load(tmp_path / "port_int8.npz") as fb:
        assert set(fa.files) == set(fb.files)
        for k in fa.files:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    back.n_probe = 4
    v_ref, i_ref = back.search(jnp.asarray(q.T), k=10)
    v, i = port.search(q.T, k=10)
    assert_topk_match(v_ref, i_ref, v, i)


@pytest.mark.parametrize("distance", ["euclidean", "inner"])
def test_int8_flat_sweep_matches(rng, distance):
    """The int8 flat sweep against flat_adc_scan(scales=...): integer
    products exact in both, the dequant rounded alike up to contraction
    (values within 1e-5 relative); ids equal outside ties."""
    rows = rng.normal(size=(3000, 48)).astype(np.float32)
    y8, y_sc = jutil.int8_quantize_rows(jnp.asarray(rows))
    q = rng.normal(size=(40, 48)).astype(np.float32)
    norms = (rows ** 2).sum(1)
    empty = rng.random(3000) < 0.1
    pen = np.where(empty, BIG, norms if distance == "euclidean" else 0.0) \
        .astype(np.float32)
    v_ref, a_ref = jflat.flat_adc_scan(
        jnp.asarray(q), y8, jnp.asarray(pen), k=10, distance=distance,
        approx=False, scales=y_sc)
    v, a = tflat.flat_adc_scan(torch.from_numpy(q), to_t(y8),
                               torch.from_numpy(pen), k=10,
                               distance=distance, max_elems=40 * 1024,
                               scales=to_t(y_sc))
    assert_topk_match(v_ref, a_ref, v, a, atol=1e-4, rtol=1e-5)


def test_int8_scan_cell_major_matches():
    """adc.scan_cell_major on the int8 index's own arrays against the JAX
    one (Pallas in interpret mode), both selects."""
    jidx, _, q = _case(32)
    _, cells, mask = _coarse_probe(
        jnp.asarray(q), jidx.vq_codec.kmeans._centroids[0],
        jnp.float32(30.0), n_probe=4, use_smart=True, precision=None)
    arrs = (jidx.aux("decoded"), jidx.aux("norm")[:, 0], jidx._is_empty,
            jidx._cell_start, jidx._cell_capacity)
    for approx in (False, True):
        kw = dict(k=10, distance="euclidean", s_max=jidx.max_cell_capacity,
                  n_cells=N_CELLS, approx=approx)
        v_ref, a_ref = jadc.scan_cell_major(
            jnp.asarray(q), cells, mask, *arrs, impl="pallas",
            interpret=True, scales=jidx.aux("scale")[:, 0], **kw)
        v, a = tadc.scan_cell_major(
            torch.from_numpy(q), to_t(cells), to_t(mask),
            *[to_t(t) for t in arrs], scales=to_t(jidx.aux("scale")[:, 0]),
            impl="auto", **kw)
        assert tadc.LAST_GATE["impl"] == "block_scan"
        assert overlap(a, a_ref) >= (0.99 if approx else 1.0)
        np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), atol=1e-4,
                                   rtol=1e-5)


def test_objects_default_to_the_card():
    """Built without a device, the port's objects live on the card; with
    no card the first allocation raises (nothing falls back)."""
    assert tp.StateModule().device.type == "cuda"
    if torch.cuda.is_available():
        assert tp.IVFPQIndex(32, 8, N_CELLS).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            tp.IVFPQIndex(32, 8, N_CELLS)
