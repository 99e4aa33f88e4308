"""Port parity of the fused flat scan (the flat plan under
scan_impl="pallas_flat") and of the scan_impl routing.

The oracle is the JAX package's Pallas kernel (flat_scan_pallas) and its
glue (_flat_pallas_glue) in interpret mode, on the same inputs. The CUDA
kernel runs only on a card: tests/test_torch_gpu.py holds it to its plain
version there."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torchpq_tpu.index import IVFPQIndex as JaxIndex
from torchpq_tpu.ops import flat_adc as jflat
from torchpq_tpu.ops import pallas_flat
import torchpq_tpu_torch as tp
from torchpq_tpu_torch.ops import adc as tadc
from torchpq_tpu_torch.ops import flat_adc as tflat
from torchpq_tpu_torch.ops import flat_scan as fs

from _torch_helpers import CPU, assert_topk_match, to_t

BIG = fs.BIG


def _inputs(rng, *, nq, cap, d=32, live=0.9, dtype=np.float32, ties=False):
    """Queries, a cache (bf16-representable values when dtype is bf16),
    its squared norms as penalty with BIG at the dead slots."""
    q = rng.normal(size=(nq, d)).astype(np.float32)
    y = rng.normal(size=(cap, d)).astype(np.float32)
    if ties:  # equal rows inside and across buckets
        y[100:300] = y[100]
    if dtype != np.float32:
        y = np.asarray(jnp.asarray(y).astype(jnp.bfloat16))
    empty = rng.random(cap) >= live
    pen = np.where(empty, BIG, (to_t(y).float() ** 2).sum(1).numpy()) \
        .astype(np.float32)
    return q, y, pen


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("distance", ["euclidean", "inner"])
def test_flat_scan_ref_matches_pallas(rng, dtype, distance):
    """The raw top R (values and addresses, dead entries included): bf16
    products are exact in f32, and f32 caches meet bf16(q) in both; only
    the summation order of the dot products may differ (1e-5)."""
    q, y, pen = _inputs(rng, nq=16, cap=4096, dtype=dtype, ties=True)
    v_ref, a_ref = pallas_flat.flat_scan_pallas(
        jnp.asarray(q), jnp.asarray(y), jnp.asarray(pen), r_keep=16,
        w=2048, q_tile=8, distance=distance, interpret=True)
    before = dict(fs.launches)
    v, a = fs.flat_scan(torch.from_numpy(q), to_t(y), torch.from_numpy(pen),
                        r_keep=16, euclidean=distance == "euclidean")
    assert fs.launches == before, "the plain version is not a launch"
    assert_topk_match(v_ref, a_ref, v, a, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("cap,n_live,k", [(4096, None, 10), (5120, None, 10),
                                          (4096, 5, 10), (5120, None, 32)])
def test_flat_glue_matches_pallas(rng, cap, n_live, k):
    """The port's glue against _flat_pallas_glue: cap 5120 pads to the
    2048-slot window with dead slots; 5 live slots are fewer than k (the
    dead entries come back -inf / -1); k = 32 is the widest r_keep."""
    q, y, pen = _inputs(rng, nq=24, cap=cap, dtype=jnp.bfloat16)
    if n_live is not None:
        keep = rng.choice(cap, n_live, replace=False)
        pen = np.where(np.isin(np.arange(cap), keep), pen, BIG) \
            .astype(np.float32)
    v_ref, a_ref = jflat._flat_pallas_glue(
        jnp.asarray(q), jnp.asarray(y), jnp.asarray(pen), k=k,
        distance="euclidean", interpret=True)
    v, a = tflat.flat_scan_glue(torch.from_numpy(q), to_t(y),
                                torch.from_numpy(pen), k=k,
                                distance="euclidean")
    assert_topk_match(v_ref, a_ref, v, a, atol=1e-4, rtol=1e-5)
    if n_live is not None:
        assert bool((a[:, n_live:] == -1).all())
        assert bool(torch.isinf(v[:, n_live:]).all())


def test_flat_scan_checks_inputs(rng):
    q, y, pen = _inputs(rng, nq=4, cap=2048)
    args = [torch.from_numpy(q), to_t(y), torch.from_numpy(pen)]
    with pytest.raises(ValueError):
        fs.flat_scan(*args, r_keep=33, euclidean=True)
    with pytest.raises(TypeError):
        fs.flat_scan(args[0], args[1].to(torch.int8), args[2], r_keep=8,
                     euclidean=True)
    with pytest.raises(TypeError):
        fs.flat_scan(args[0].double(), *args[1:], r_keep=8, euclidean=True)


@pytest.mark.parametrize("distance", ["euclidean", "inner"])
def test_flat_scan_ref_integer_ties_match_pallas(distance):
    """Integer-valued inputs with equal rows inside and across buckets
    (the card tests' tie case): every sum is exact in any order, so the
    plain version equals the JAX kernel bit for bit, addresses included."""
    q, y, pen = fs.integer_flat_inputs("cpu", nq=16, cap=4096, d=32, seed=3)
    v_ref, a_ref = pallas_flat.flat_scan_pallas(
        jnp.asarray(q.numpy()), jnp.asarray(y.float().numpy(), jnp.bfloat16),
        jnp.asarray(pen.numpy()), r_keep=16, w=2048, q_tile=8,
        distance=distance, interpret=True)
    v, a = fs.flat_scan(q, y, pen, r_keep=16,
                        euclidean=distance == "euclidean")
    assert bool((v[:, 1:] == v[:, :-1]).any()), "the case must hold ties"
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 128, "flat_wg"), (torch.bfloat16, 1024, "flat_tc"),
    (torch.bfloat16, 8, "flat_wg"), (torch.bfloat16, 40, "flat_wg"),
    (torch.bfloat16, 100, "flat"), (torch.bfloat16, 1032, "flat"),
    (torch.float32, 128, "flat"), (torch.float32, 1024, "flat"),
    (torch.bfloat16, 136, "flat_tc"), (torch.bfloat16, 72, "flat_wg"),
    (torch.bfloat16, 16, "flat_wg"), (torch.bfloat16, 132, "flat")])
def test_pick_route(dtype, d, route):
    """The wrapper's choice of kernel, made from the cache's dtype and
    width before launch: for bf16 with d % 8 == 0 the warp-specialised
    kernel up to d = 128 and the mma.sync one up to 1024, the CUDA cores
    the rest."""
    assert fs.pick_route(dtype, d) == route


def test_launch_refuses_a_route_that_does_not_take_the_cache(rng):
    """Forcing a tensor-core route onto a cache it does not take (an f32
    cache; flat_tc at d <= 128, flat_wg above) or naming no known route
    raises before any kernel is touched."""
    q, y, pen = _inputs(rng, nq=4, cap=2048)
    args = [torch.from_numpy(q), to_t(y), torch.from_numpy(pen)]
    with pytest.raises(ValueError, match="tensor-core"):
        fs.launch(None, 0, *args, r_keep=8, euclidean=True, route="flat_tc")
    with pytest.raises(ValueError, match="route"):
        fs.launch(None, 0, *args, r_keep=8, euclidean=True, route="wgmma")
    with pytest.raises(ValueError, match="warp-specialised"):
        fs.launch(None, 0, *args, r_keep=8, euclidean=True, route="flat_wg")
    bf16 = [args[0], args[1].to(torch.bfloat16), args[2]]
    with pytest.raises(ValueError, match="tensor-core"):
        fs.launch(None, 0, *bf16, r_keep=8, euclidean=True, route="flat_tc")
    q, y, pen = _inputs(rng, nq=4, cap=2048, d=136, dtype=jnp.bfloat16)
    wide = [torch.from_numpy(q), to_t(y), torch.from_numpy(pen)]
    with pytest.raises(ValueError, match="warp-specialised"):
        fs.launch(None, 0, *wide, r_keep=8, euclidean=True, route="flat_wg")


@pytest.mark.parametrize("nq,cap,rows,resident", [
    (10000, 1 << 20, 128, 2), (10000, 1 << 20, 256, 1),
    (300, 20000, 128, 2), (40, 4100, 64, 1), (1, 2048, 128, 2)])
def test_tc_splits(nq, cap, rows, resident):
    """The tensor-core kernel's split: whole windows, the runs cover the
    padded cache with no empty run, and at least two CTAs per SM of 132
    wherever the cache has windows enough (the flat plan: 10k queries x
    1M slots), within four waves of resident CTAs."""
    split, n_splits = fs.tc_splits(nq, cap, rows, resident, 132)
    assert split % fs.W == 0
    assert split * n_splits >= cap > split * (n_splits - 1)
    ctas = -(-nq // rows) * n_splits
    n_windows = -(-cap // fs.W)
    if -(-nq // rows) * n_windows >= 2 * 132:
        assert 2 * 132 <= ctas <= 4 * 132 * resident
    else:
        assert n_splits == n_windows


@pytest.mark.parametrize("nq,cap,ctas", [
    (10000, 1 << 20, 132), (1, 2048, 132), (63, 20000, 132),
    (10000, 4100, 132), (300, 1 << 20, 132), (10000, 1 << 20, 114),
    (100000, 1 << 20, 132)])
def test_wg_splits(nq, cap, ctas):
    """The warp-specialised kernel's split: whole windows, the runs cover
    the padded cache with no empty run, and no other split count of whole
    windows gives its busiest CTA fewer windows to scan (units a CTA times
    the run plus a unit's fixed window) or as few with fewer splits; at the
    flat plan (10k queries = 53 tiles of 192, 512 windows, 132 SMs) 12 runs
    of 43 windows, five waves."""
    split, n_splits = fs.wg_splits(nq, cap, ctas)
    assert split % fs.W == 0
    assert split * n_splits >= cap > split * (n_splits - 1)
    n_windows = -(-cap // fs.W)
    q_tiles = -(-nq // 192)

    def cost(r):
        per = -(-n_windows // r)
        return -(-q_tiles * r // ctas) * (per + 1)

    whole = [r for r in range(1, n_windows + 1)
             if -(-n_windows // -(-n_windows // r)) == r]
    assert n_splits in whole
    assert all(cost(r) > cost(n_splits) or
               (cost(r) == cost(n_splits) and r >= n_splits)
               for r in whole if -(-q_tiles * r // ctas) <= 64)
    if (nq, cap, ctas) == (10000, 1 << 20, 132):
        assert (split, n_splits) == (43 * fs.W, 12)


def test_flat_wg_launch_sizes_the_grid(rng):
    """launch(route="flat_wg") with a stand-in library: the wrapper folds c
    into the bf16 query (x 2, exact, euclidean only), asks the occupancy
    entry, sizes the persistent grid to the units (at most SMs x resident),
    takes wg_splits' runs (or, through _launch_wg, n_splits'), and hands
    the kernel the scratch of those runs and the rows' shared bound keys,
    none published (INT_MIN); a refused occupancy raises before any
    launch."""
    q, y, pen = _inputs(rng, nq=300, cap=5000, d=64, dtype=jnp.bfloat16)
    args = [torch.from_numpy(q), to_t(y), torch.from_numpy(pen)]
    seen, tensors = {}, {}

    class Lib:
        occ = 1

        def torchpq_flat_scan_wg_occupancy(self, d, r_keep):
            seen["occupancy"] = (d, r_keep)
            return self.occ

        def torchpq_flat_scan_wg(self, qt, pen, dec, pv, pa, gk, ov, oa,
                                 *rest):
            seen["ints"] = rest[:7]
            seen["q"], seen["part"] = tensors[qt], tensors[pv]
            seen["gkey"] = tensors[gk].clone()
            return 0

    real_ptr = torch.Tensor.data_ptr

    def data_ptr(t):
        tensors[real_ptr(t)] = t
        return real_ptr(t)

    torch.Tensor.data_ptr = data_ptr
    try:
        for euclidean, n_splits in ((True, None), (False, 2)):
            if n_splits is None:
                fs.launch(Lib(), 0, *args, r_keep=16, euclidean=euclidean,
                          route="flat_wg")
            else:
                fs._launch_wg(Lib(), 0, *args, r_keep=16,
                              euclidean=euclidean, n_splits=n_splits)
            nq, cap, d, r_keep, split, runs, n_ctas = seen["ints"]
            assert (nq, cap, d, r_keep) == (300, 5000, 64, 16)
            assert seen["occupancy"] == (64, 16)
            want = torch.from_numpy(q).to(torch.bfloat16) * (
                2 if euclidean else 1)
            assert seen["q"].dtype == torch.bfloat16
            assert torch.equal(seen["q"], want)
            if n_splits is None:
                assert (split, runs) == fs.wg_splits(300, 5000, 132)
            else:
                assert (split, runs) == (2 * fs.W, 2)
            assert tuple(seen["part"].shape) == (runs, 300, 16)
            assert torch.equal(seen["gkey"], torch.full(
                (300,), torch.iinfo(torch.int32).min, dtype=torch.int32))
            assert n_ctas == min(132, 2 * runs)  # two tiles of 192 queries
        Lib.occ = -1
        with pytest.raises(RuntimeError, match="no CTA"):
            fs.launch(Lib(), 0, *args, r_keep=16, euclidean=True,
                      route="flat_wg")
    finally:
        torch.Tensor.data_ptr = real_ptr


def _data(seed, n, d=32):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(40, d)).astype(np.float32) * 3
    x = centers[rng.integers(0, 40, n)] \
        + rng.normal(size=(n, d)).astype(np.float32)
    return x.astype(np.float32)


_CASES = {}


def _case(cache="bfloat16"):
    """A JAX-trained index carried into the port, the same adds in both;
    scan_impl="pallas_flat" and approx top-k on both."""
    if cache in _CASES:
        return _CASES[cache]
    x = _data(5, 4000)
    kw = dict(d_vector=32, n_subvectors=8, n_cells=16, initial_size=64,
              scan_cache_dtype=cache)
    jidx = JaxIndex(**kw)
    jidx.vq_codec.kmeans.max_iter = 6
    jidx.pq_codec.kmeans.max_iter = 6
    jidx.train(jnp.asarray(x[:2000].T))
    port = tp.IVFPQIndex(**kw, device=CPU)
    port.load_state_dict(jidx.state_dict())
    jidx.add(jnp.asarray(x.T))
    port.add(x.T)
    for idx in (jidx, port):
        idx.scan_impl, idx.use_approx_topk, idx.n_probe = \
            "pallas_flat", True, 4
    _CASES[cache] = (jidx, port, _data(6, 40))
    return _CASES[cache]


def _search_both(jidx, port, q, k=10):
    v_ref, i_ref = jidx.search(jnp.asarray(q.T), k=k)
    v, i = port.search(q.T, k=k)
    return v_ref, i_ref, v, i


def test_pallas_flat_index_matches():
    """The flat plan of an index set to scan_impl="pallas_flat" runs the
    fused flat scan. The JAX index's flat path does not read the interpret
    switch, so its side is _search_flat's work done by hand on the JAX
    index's own flat layout: the glue in interpret mode, then the address
    and id translation."""
    jidx, port, q = _case()
    port.scan_mode = "flat"
    v, i = port.search(q.T, k=10)
    assert tflat.LAST_FLAT["impl"] == "flat_scan"
    dec, nrm, emp, amap, _ = jidx._flat_compacted()
    pen = jnp.where(emp, jnp.float32(BIG), nrm)
    v_ref, a_ref = jflat._flat_pallas_glue(
        jnp.asarray(q), dec, pen, k=10, distance="euclidean",
        interpret=True)
    if amap is not None:
        a_ref = jnp.where(a_ref >= 0, amap[jnp.maximum(a_ref, 0)], -1)
    i_ref = jnp.where(a_ref >= 0, jidx._address2id[jnp.maximum(a_ref, 0)],
                      -1)
    assert_topk_match(v_ref, i_ref, v, i, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("what", ["k>32", "approx off", "int8"])
def test_pallas_flat_gate_routes(what):
    """Outside the flat kernel's gate both packages run the sweep: k > 32,
    exact top-k, or an int8 cache."""
    jidx, port, q = _case("int8" if what == "int8" else "bfloat16")
    k = 40 if what == "k>32" else 10
    for idx in (jidx, port):
        idx.scan_mode = "flat"
        idx.use_approx_topk = what != "approx off"
    out = _search_both(jidx, port, q, k=k)
    assert tflat.LAST_FLAT["impl"] == "sweep"
    assert_topk_match(*out, atol=1e-4, rtol=1e-5)
    for idx in (jidx, port):
        idx.use_approx_topk = True


@pytest.mark.parametrize("impl", ["xla", "pallas_flat"])
def test_scan_impl_sends_probed_plans_to_the_select(impl):
    """scan_impl "xla" and "pallas_flat" run the probed plans through the
    XLA select, in both packages alike."""
    jidx, port, q = _case()
    for idx in (jidx, port):
        idx.scan_mode, idx.scan_impl = "cell_major", impl
    v_ref, i_ref, v, i = _search_both(jidx, port, q)
    assert tadc.LAST_GATE["impl"] == "block_select"
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), atol=5e-3,
                               rtol=1e-4)
    for idx in (jidx, port):
        idx.scan_impl = "pallas_flat"


def test_scan_impl_pallas_raises_outside_the_gate():
    """scan_impl="pallas" demands the kernel: where the JAX package warns
    and falls back (k_pair > 64 here), the port raises; inside the gate it
    runs the kernel's path."""
    _, port, q = _case()
    port.scan_mode, port.scan_impl = "cell_major", "pallas"
    port.search(q.T, k=10)
    assert tadc.LAST_GATE["impl"] == "block_scan"
    port.use_approx_topk = False
    with pytest.raises(ValueError, match="pallas"):
        port.search(q.T, k=80)
    port.scan_impl = "triton"
    with pytest.raises(ValueError, match="scan_impl"):
        port.search(q.T, k=10)
    port.scan_impl, port.use_approx_topk = "pallas_flat", True
