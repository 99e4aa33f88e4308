"""The JAX package's matmul precision contract in the port (config.py,
util.matmul): the setters and their defaults, the names a precision may
take, the plain version of each mode against numpy products of
ml_dtypes-rounded operands, the card's branch of util.matmul (emulated on
the CPU), and searches and k-means at each precision against the JAX
package's on the CPU, where every precision computes float32 in both."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import torchpq_tpu.config as jconfig
from torchpq_tpu.clustering import KMeans as JaxKMeans
from torchpq_tpu.index import FlatIndex as JaxFlatIndex
from torchpq_tpu.index import IVFPQIndex as JaxIndex
import torchpq_tpu_torch as tp
from torchpq_tpu_torch import config, util
from torchpq_tpu_torch.index import ivfpq as tivfpq
from torchpq_tpu_torch.ops import adc, flat_adc

from _torch_helpers import CPU, assert_topk_match

P = jax.lax.Precision
PRECISIONS = ["default", "high", "highest"]
# one f32 unit for accumulators that truncate (the card's tensor cores)
F32_UNIT = 2.0 ** -23


@pytest.fixture
def keep_precisions():
    """Both packages' global precisions, restored after the test."""
    saved = (jconfig.SEARCH_PRECISION, jconfig.TRAIN_PRECISION,
             config.SEARCH_PRECISION, config.TRAIN_PRECISION)
    yield
    (jconfig.SEARCH_PRECISION, jconfig.TRAIN_PRECISION,
     config.SEARCH_PRECISION, config.TRAIN_PRECISION) = saved


def _set_both(search=None, train=None):
    """The same precision in both packages, by name."""
    if search is not None:
        jconfig.set_search_precision(P(search))
        config.set_search_precision(search)
    if train is not None:
        jconfig.set_train_precision(P(train))
        config.set_train_precision(train)


def test_defaults_are_the_jax_packages():
    """The port's defaults are the ones torchpq_tpu/config.py declares,
    read from its source: a JAX test module (tests/test_metric.py) sets
    the JAX package's global when it is imported."""
    import ast
    import inspect
    declared = {
        t.id: node.value.attr.lower()
        for node in ast.parse(inspect.getsource(jconfig)).body
        if isinstance(node, ast.Assign)
        for t in node.targets
        if isinstance(t, ast.Name) and t.id.endswith("_PRECISION")}
    assert declared == {"TRAIN_PRECISION": "highest",
                        "SEARCH_PRECISION": "default"}
    assert config.resolve_precision(None) == declared["SEARCH_PRECISION"]
    assert config.resolve_precision(None, train=True) \
        == declared["TRAIN_PRECISION"]


@pytest.mark.parametrize("name", ["default", "bfloat16", "fastest", "high",
                                  "bfloat16_3x", "tensorfloat32", "highest",
                                  "float32"])
def test_names_resolve_as_jax(name):
    """Each name jax.lax.Precision accepts, and each of its members, names
    the same precision in the port."""
    want = P(name).name.lower()
    assert config.resolve_precision(name) == want
    assert config.resolve_precision(P(name)) == want


@pytest.mark.parametrize("bad", ["DEFAULT", "Highest", "tf32", "", 3, 1.0,
                                 object()])
def test_bad_precision_raises(bad):
    """A name jax.lax.Precision refuses raises, in the setters' first use
    too."""
    with pytest.raises(ValueError):
        config.resolve_precision(bad)
    with pytest.raises(ValueError):
        util.matmul(torch.ones(2, 3), torch.ones(4, 3), bad)


def test_setters_drive_the_default(keep_precisions):
    """set_search_precision / set_train_precision take a name or a
    jax.lax.Precision member; None resolves to them, and a global None is
    XLA's default."""
    config.set_search_precision(P.HIGH)
    config.set_train_precision("bfloat16")
    assert config.resolve_precision(None) == "high"
    assert config.resolve_precision(None, train=True) == "default"
    assert config.resolve_precision("highest") == "highest"
    config.set_search_precision(None)
    assert config.resolve_precision(None) == "default"


def _bf16(x):
    return x.astype(ml_dtypes.bfloat16).astype(np.float64)


def _split(x):
    """numpy's bf16 high and low parts of f32 x (ml_dtypes rounding)."""
    hi = x.astype(ml_dtypes.bfloat16)
    lo = (x - hi.astype(np.float32)).astype(ml_dtypes.bfloat16)
    return hi.astype(np.float64), lo.astype(np.float64)


@pytest.mark.parametrize("d", [16, 128, 300])
def test_plain_modes_against_numpy(rng, d):
    """matmul_plain "default": the f64 product of the bf16-rounded
    operands within the f32 summation bound (d + 2) * 2^-23 sum |a_i b_i|;
    "high": the f64 sum of bf16_3x's three products (numpy's split) within
    that bound, and the f64 product of the f32 operands within 2^-14 sum
    |a_i b_i| more; "highest": the f32 product."""
    a = (rng.normal(size=(33, d)) * 10 ** rng.uniform(-3, 3, (33, 1))
         ).astype(np.float32)
    b = rng.normal(size=(47, d)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)

    got = util.matmul_plain(ta, tb, "default").double().numpy()
    a16, b16 = _bf16(a), _bf16(b)
    bound = (d + 2) * F32_UNIT * (np.abs(a16) @ np.abs(b16).T)
    assert np.all(np.abs(got - a16 @ b16.T) <= bound)

    got = util.matmul_plain(ta, tb, "high").double().numpy()
    (ah, al), (bh, bl) = _split(a), _split(b)
    three = ah @ bl.T + al @ bh.T + ah @ bh.T
    mag = np.abs(a.astype(np.float64)) @ np.abs(b.astype(np.float64)).T
    assert np.all(np.abs(got - three) <= 3 * (d + 2) * F32_UNIT * mag)
    exact = a.astype(np.float64) @ b.astype(np.float64).T
    assert np.all(np.abs(got - exact)
                  <= (2.0 ** -14 + 3 * (d + 2) * F32_UNIT) * mag)
    # bf16_3x is far closer than one bf16 pass
    assert np.abs(got - exact).max() < 0.05 * np.abs(a16 @ b16.T
                                                     - exact).max()

    assert torch.equal(util.matmul_plain(ta, tb, "highest"), ta @ tb.T)


def test_plain_bf16_operands_have_no_low_part(rng):
    """On bf16 operands "default" and "high" are the same one product."""
    a = torch.from_numpy(rng.normal(size=(9, 64)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(11, 64)).astype(np.float32))
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    assert torch.equal(util.matmul_plain(a, b, "default"),
                       util.matmul_plain(a, b, "high"))


def test_cpu_computes_f32_at_every_precision(rng):
    """On CPU tensors util.matmul is the f32 product at every precision
    (as XLA:CPU computes), its bias and alpha the f32 addmm's."""
    a = torch.from_numpy(rng.normal(size=(20, 24)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(30, 24)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(1, 30)).astype(np.float32))
    for p in PRECISIONS + [None, P.HIGH]:
        assert torch.equal(util.matmul(a, b, p), a @ b.T)
        assert torch.equal(util.matmul(a, b, p, alpha=2.0, bias=bias),
                           torch.addmm(bias, a, b.T, alpha=2.0))
        assert torch.equal(util.matmul_operand(b, p), b)


@pytest.fixture
def card_branch(monkeypatch):
    """util.matmul's card branch on CPU tensors: every tensor counts as on
    the card, and the bf16 GEMM is emulated by an f32 product of the bf16
    operands (exact products, f32 sums, as on the tensor cores)."""
    calls = []

    def mm_bf16(a, b):
        assert a.dtype == b.dtype == torch.bfloat16
        calls.append(tuple(a.shape))
        return a.float() @ b.float().mT
    monkeypatch.setattr(util, "_on_card", lambda x: True)
    monkeypatch.setattr(util, "_mm_bf16", mm_bf16)
    return calls


@pytest.mark.parametrize("precision", ["default", "high"])
def test_card_branch_matches_plain(rng, card_branch, precision):
    """The card branch's GEMMs (one at "default", three at "high", one on
    bf16 operands), alpha (a power of two folded into a's bf16 parts,
    exactly; another one after), bias, prepared operands and batched
    operands, against the plain version."""
    a = torch.from_numpy(rng.normal(size=(16, 40)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(24, 40)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(1, 24)).astype(np.float32))
    plain = util.matmul_plain(a, b, precision)
    n_gemms = 1 if precision == "default" else 3
    del card_branch[:]
    assert torch.allclose(util.matmul(a, b, precision), plain, rtol=1e-6,
                          atol=1e-5)
    assert len(card_branch) == n_gemms
    for alpha in (2.0, 0.5, 3.0):
        got = util.matmul(a, b, precision, alpha=alpha, bias=bias)
        assert torch.allclose(got, alpha * plain + bias, rtol=1e-6,
                              atol=1e-5), alpha
    prepared = util.matmul_operand(b, precision)
    assert isinstance(prepared, tuple)
    assert (prepared[1] is None) == (precision == "default")
    assert torch.equal(util.matmul(a, prepared, precision),
                       util.matmul(a, b, precision))
    del card_branch[:]
    a16 = a.to(torch.bfloat16)
    util.matmul(a16, b.to(torch.bfloat16), precision)
    assert len(card_branch) == 1
    a3, b3 = a.reshape(4, 4, 40), b.reshape(4, 6, 40)
    assert torch.allclose(util.matmul(a3, b3, precision),
                          util.matmul_plain(a3, b3, precision), rtol=1e-6,
                          atol=1e-5)
    # "highest" on the card stays the f32 product
    assert torch.equal(util.matmul(a, b, "highest"), a @ b.T)


def _data(seed, n, d=32):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(40, d)).astype(np.float32) * 3
    return (centers[rng.integers(0, 40, n)]
            + rng.normal(size=(n, d)).astype(np.float32)).astype(np.float32)


_PAIR = {}


def _ivfpq_pair():
    """A JAX-trained IVFPQ index, its state carried into the port, the
    same adds in both (built once)."""
    if not _PAIR:
        x = _data(5, 3000)
        kw = dict(d_vector=32, n_subvectors=8, n_cells=16, initial_size=64)
        jidx = JaxIndex(**kw)
        jidx.vq_codec.kmeans.max_iter = jidx.pq_codec.kmeans.max_iter = 6
        jidx.train(jnp.asarray(x[:1500].T))
        port = tp.IVFPQIndex(**kw, device=CPU)
        port.load_state_dict(jidx.state_dict())
        jidx.add(jnp.asarray(x.T))
        port.add(x.T)
        for idx in (jidx, port):
            idx.n_probe = 4
        _PAIR["pair"] = (jidx, port, _data(6, 48))
    return _PAIR["pair"]


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("mode", ["flat", "cell_major"])
def test_ivfpq_search_at_each_precision(keep_precisions, precision, mode):
    """The flat and cell_major plans at each search precision: the port's
    results are the JAX package's, and the records name the precision."""
    jidx, port, q = _ivfpq_pair()
    _set_both(search=precision)
    for idx in (jidx, port):
        idx.scan_mode = mode
        idx.use_approx_topk = False
    v_ref, i_ref = jidx.search(jnp.asarray(q.T), k=10)
    v, i = port.search(q.T, k=10)
    assert_topk_match(v_ref, i_ref, v, i)
    record = flat_adc.LAST_FLAT if mode == "flat" else adc.LAST_GATE
    assert record["precision"] == precision


def test_use_tensor_core_off_searches_at_highest(keep_precisions):
    """use_tensor_core = False resolves the search precision to "highest"
    (ivfpq.py:945-946), and LAST_GATE records it; True follows
    SEARCH_PRECISION."""
    _, port, q = _ivfpq_pair()
    port.scan_mode = "cell_major"
    config.set_search_precision("high")
    port.search(q.T, k=5)
    assert adc.LAST_GATE["precision"] == "high"
    port.use_tensor_core = False
    try:
        port.search(q.T, k=5)
        assert adc.LAST_GATE["precision"] == "highest"
        assert port._plan_shadows()["precision"] == "highest"
    finally:
        port.use_tensor_core = True


@pytest.mark.parametrize("precision", PRECISIONS)
def test_flat_index_at_each_precision(rng, keep_precisions, precision):
    """FlatIndex at each search precision against the JAX package's."""
    x = rng.normal(size=(16, 700)).astype(np.float32)
    q = rng.normal(size=(16, 40)).astype(np.float32)
    _set_both(search=precision)
    ref = JaxFlatIndex(d_vector=16)
    ref.add(jnp.asarray(x))
    port = tp.FlatIndex(d_vector=16, device=CPU)
    port.add(x)
    v_ref, i_ref = ref.search(jnp.asarray(q), k=10)
    v, i = port.search(q, k=10)
    assert_topk_match(v_ref, i_ref, v, i)
    assert tp.index.flat.LAST_SEARCH["precision"] == precision


@pytest.mark.parametrize("precision", PRECISIONS)
def test_kmeans_at_each_train_precision(rng, keep_precisions, precision):
    """One KMeans fit from the same initial centroids at each train
    precision: the JAX package's centroids and labels."""
    x = rng.normal(size=(12, 900)).astype(np.float32)
    init = x[:, :12].copy()
    _set_both(train=precision)
    kw = dict(n_clusters=12, max_iter=10, tol=1e-4)
    ref = JaxKMeans(**kw)
    l_ref = ref.fit(jnp.asarray(x), centroids=jnp.asarray(init))
    port = tp.clustering.KMeans(**kw, device=CPU)
    lab = port.fit(x, centroids=init)
    np.testing.assert_allclose(port._centroids.numpy(),
                               np.asarray(ref._centroids), atol=1e-5)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(l_ref))


def test_card_plan_ms_keys_flat_terms_by_precision(monkeypatch):
    """card_plan_ms reads the flat terms of the search precision's class:
    "bf16" at "default", "f32" at "high" and "highest"; None follows
    SEARCH_PRECISION. The probed plans' estimates do not move."""
    f32 = tivfpq.CARD_PLAN_COSTS["flat"]["f32"]
    costs = dict(f32=f32, bf16=dict(f32, call_ms=f32["call_ms"] + 100.0))
    monkeypatch.setitem(tivfpq.CARD_PLAN_COSTS, "flat", costs)
    monkeypatch.setattr(config, "SEARCH_PRECISION", "default")
    sh = dict(n_probe=8, s_pow2=1024, n_items=10**6, d_vector=128,
              tier="bf16", approx=True)
    est = {p: tivfpq.card_plan_ms(1000, 10, precision=p, **sh)
           for p in PRECISIONS + [None]}
    assert est["default"]["flat"] == pytest.approx(
        est["highest"]["flat"] + 100.0)
    assert est["high"] == est["highest"]
    assert est[None] == est["default"]
    assert all(e["cell_major"] == est["default"]["cell_major"]
               for e in est.values())
    assert tivfpq.flat_class("default") == "bf16"
    assert tivfpq.flat_class("high") == tivfpq.flat_class(P.HIGHEST) == "f32"
