"""Port parity of the whole IVFPQ slice: JAX-trained state carried into the
port, the same adds in both packages, then every search plan at k=10; a
JAX-saved .npz searched by the port; and the settings outside the slice."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torchpq_tpu.index import IVFPQIndex as JaxIndex
import torchpq_tpu_torch as tp

from _torch_helpers import CPU, assert_topk_match, overlap, to_np

D, M, N_CELLS = 32, 8, 16


def _data(seed, n):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(40, D)).astype(np.float32) * 3
    x = centers[rng.integers(0, 40, n)] \
        + rng.normal(size=(n, D)).astype(np.float32)
    return x.astype(np.float32)


_CASES = {}


def _case(distance):
    """JAX-trained index, its state carried into the port, then the same
    two adds in both (built once per distance)."""
    if distance in _CASES:
        return _CASES[distance]
    x = _data(5, 4000)
    kw = dict(d_vector=D, n_subvectors=M, n_cells=N_CELLS, initial_size=64,
              distance=distance)
    jidx = JaxIndex(**kw)
    jidx.vq_codec.kmeans.max_iter = 8
    jidx.pq_codec.kmeans.max_iter = 8
    jidx.train(jnp.asarray(x[:2000].T))
    port = tp.IVFPQIndex(**kw, device=CPU)
    port.load_state_dict(jidx.state_dict())
    assert port.is_trained and port.n_items == 0
    for chunk in (x[:1500], x[1500:]):
        _, a_ref = jidx.add(jnp.asarray(chunk.T), return_address=True)
        _, a = port.add(chunk.T, return_address=True)
        np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    q = _data(6, 64)
    for idx in (jidx, port):
        idx.n_probe = 4
    _CASES[distance] = (distance, jidx, port, q)
    return _CASES[distance]


@pytest.fixture(params=["euclidean", "inner", "cosine"])
def any_case(request):
    return _case(request.param)


@pytest.fixture
def slice_case():
    return _case("euclidean")


def test_adds_match(any_case):
    _, jidx, port, _ = any_case
    assert jidx.max_cell_capacity > 64, "the adds must force a relayout"
    for k in ("_storage", "_is_empty", "_cell_start", "_cell_capacity",
              "_address2id", "_id2address", "_aux_decoded"):
        np.testing.assert_array_equal(to_np(getattr(port, k)),
                                      to_np(getattr(jidx, k)), err_msg=k)
    np.testing.assert_allclose(port.aux("norm").numpy(),
                               np.asarray(jidx.aux("norm")), rtol=1e-6)


def _search_both(jidx, port, q, mode, approx):
    for idx in (jidx, port):
        idx.scan_mode = mode
        idx.use_approx_topk = approx
    v_ref, i_ref = jidx.search(jnp.asarray(q.T), k=10)
    v, i = port.search(q.T, k=10)
    assert v.dtype == torch.float32 and tuple(i.shape) == (len(q), 10)
    return v_ref, i_ref, v, i


@pytest.mark.parametrize("mode,approx", [
    ("cell_major", False), ("query_major", False), ("flat", False),
    ("flat", True)])
def test_search_matches(slice_case, mode, approx):
    _, jidx, port, q = slice_case
    assert_topk_match(*_search_both(jidx, port, q, mode, approx),
                      atol=1e-4, rtol=1e-5)


def test_search_pack32_matches(slice_case):
    """pack32 keys keep the value bits above the slot bits: both packages
    truncate alike, so results agree except where f32 summation order moves
    a score across one truncation step (2^-14 relative at 512-slot
    windows)."""
    _, jidx, port, q = slice_case
    v_ref, i_ref, v, i = _search_both(jidx, port, q, "cell_major", True)
    assert tp.ops.adc.LAST_GATE["pack32"]
    assert overlap(i, i_ref) >= 0.99
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), atol=5e-3,
                               rtol=1e-4)


@pytest.mark.parametrize("distance", ["inner", "cosine"])
@pytest.mark.parametrize("mode", ["cell_major", "flat"])
def test_search_other_distances_match(distance, mode):
    _, jidx, port, q = _case(distance)
    assert_topk_match(*_search_both(jidx, port, q, mode, False),
                      atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("mode", ["cell_major", "query_major"])
def test_search_cells_matches(slice_case, mode):
    _, jidx, port, q = slice_case
    rng = np.random.default_rng(10)
    cells = np.stack([rng.permutation(N_CELLS)[:3] for _ in range(len(q))]) \
        .astype(np.int32)
    for idx in (jidx, port):
        idx.scan_mode = mode
        idx.use_approx_topk = False
    v_ref, i_ref = jidx.search_cells(jnp.asarray(q.T), jnp.asarray(cells),
                                     k=10)
    v, i = port.search_cells(q.T, cells, k=10)
    assert_topk_match(v_ref, i_ref, v, i)


def test_similarity_at_address_matches(slice_case):
    _, jidx, port, q = slice_case
    addr = np.array([-1, 0, 5, 17, 64, 200, 5000])
    ref = np.asarray(jidx.similarity_at_address(jnp.asarray(q.T),
                                                jnp.asarray(addr)))
    got = port.similarity_at_address(q.T, addr).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


def test_remove_then_search_matches(slice_case):
    _, jidx, port, q = slice_case
    ids = np.arange(0, 4000, 7)
    assert port.remove(ids=ids) == jidx.remove(ids=jnp.asarray(ids))
    for idx in (jidx, port):
        idx.scan_mode = "cell_major"
        idx.use_approx_topk = False
    v_ref, i_ref = jidx.search(jnp.asarray(q.T), k=10)
    v, i = port.search(q.T, k=10)
    assert_topk_match(v_ref, i_ref, v, i)
    assert not np.isin(i.numpy(), ids).any()


def test_jax_saved_npz_searches_alike(slice_case, tmp_path):
    _, jidx, _, q = slice_case
    jidx.save(tmp_path / "jax_index.npz")
    port = tp.IVFPQIndex(D, M, N_CELLS, initial_size=64, device=CPU)
    port.load(tmp_path / "jax_index.npz")
    for idx in (jidx, port):
        idx.n_probe = 4
        idx.scan_mode = "cell_major"
        idx.use_approx_topk = False
    v_ref, i_ref = jidx.search(jnp.asarray(q.T), k=10)
    v, i = port.search(q.T, k=10)
    assert_topk_match(v_ref, i_ref, v, i)


def test_port_trains_on_its_own():
    """train -> add -> search through the port alone reaches the recall of
    its own flat ADC ceiling as n_probe grows."""
    x = _data(7, 3000)
    q = _data(8, 50)
    idx = tp.IVFPQIndex(D, M, N_CELLS, initial_size=64, seed=1, device=CPU)
    idx.train(x.T)
    idx.add(x.T)
    d2 = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    gt = np.argsort(d2, axis=1)[:, :10]
    recalls = {}
    for mode, n_probe in (("cell_major", 1), ("cell_major", 16),
                          ("flat", 1)):
        idx.scan_mode, idx.n_probe = mode, n_probe
        _, ids = idx.search(q.T, k=10)
        recalls[(mode, n_probe)] = np.mean(
            [len(set(ids[r].tolist()) & set(gt[r])) / 10 for r in range(50)])
    assert recalls[("cell_major", 16)] >= recalls[("cell_major", 1)]
    assert abs(recalls[("cell_major", 16)] - recalls[("flat", 1)]) < 0.02
    assert recalls[("flat", 1)] >= 0.5, recalls


@pytest.mark.parametrize("kwargs", [
    dict(scan_cache_dtype="int8", distance="manhattan"),
    dict(scan_cache_dtype="none", pq_use_residual=True),
])
def test_refused_settings_match_jax(kwargs):
    """The settings the JAX package refuses (an int8 cache with manhattan,
    residual PQ in the code domain), the port refuses alike: the same
    exception type and words."""
    with pytest.raises(AssertionError) as ref:
        JaxIndex(D, M, N_CELLS, initial_size=64, **kwargs)
    with pytest.raises(AssertionError) as got:
        tp.IVFPQIndex(D, M, N_CELLS, initial_size=64, device=CPU, **kwargs)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("kwargs,attr", [
    # the case keeps the id it had among the settings ported since
    pytest.param({}, dict(spill_cells=2, spill_capacity=64,
                          spill_impl="host"), id="kwargs6-attr6"),
])
def test_unported_settings_raise(kwargs, attr):
    idx = tp.IVFPQIndex(D, M, N_CELLS, initial_size=64, device=CPU,
                        **kwargs)
    x = _data(9, 300)
    idx.train(x.T)
    for name, value in attr.items():
        setattr(idx, name, value)
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        idx.add(x.T)
        idx.search(x[:4].T)
