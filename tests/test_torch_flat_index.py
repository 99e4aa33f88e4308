"""Port parity of the exact index and its parts: FlatIndex, the flat
containers (FlatContainer, FlatContainerGroup), the top-k facade and
metric.preprocess_query. The same seeded numpy inputs go through the JAX
package and the port at toy sizes; each test states its tolerance.
Mirrors tests/test_flat_index.py, the flat cases of tests/test_containers.py
and tests/test_topk.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torchpq_tpu as jtp
from torchpq_tpu import metric as jmetric
from torchpq_tpu.container import FlatContainer as JaxFlat
from torchpq_tpu.container import FlatContainerGroup as JaxGroup
from torchpq_tpu.fn import topk as jtopk
from torchpq_tpu.index import FlatIndex as JaxFlatIndex
import torchpq_tpu_torch as tp
from torchpq_tpu_torch import metric as tmetric

from _torch_helpers import CPU, assert_topk_match, to_np

DISTANCES = ["euclidean", "inner", "cosine", "manhattan"]


def _np_search(x, q, distance, k):
    if distance == "euclidean":
        s = -((q[:, None] - x[None]) ** 2).sum(-1)
    elif distance == "inner":
        s = q @ x.T
    elif distance == "cosine":
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        xn = x / np.linalg.norm(x, axis=1, keepdims=True)
        s = qn @ xn.T
    else:
        s = -np.abs(q[:, None] - x[None]).sum(-1)
    idx = np.argsort(-s, axis=1)[:, :k]
    return np.take_along_axis(s, idx, axis=1), idx


def _state_equal(port, ref, keys):
    for key in keys:
        np.testing.assert_array_equal(to_np(getattr(port, key)),
                                      np.asarray(getattr(ref, key)),
                                      err_msg=key)


# -- top-k facade ------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 7, 32, 300])
def test_topk_matches(rng, k):
    """Values equal, indices equal (no ties in normal draws), int32, through
    the function and the package-level facade."""
    x = rng.normal(size=(17, 300)).astype(np.float32)
    v_ref, i_ref = jtopk(jnp.asarray(x), k)
    for fn in (tp.fn.topk, tp.topk):
        v, i = fn(torch.from_numpy(x), k)
        assert i.dtype == torch.int32
        np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))


@pytest.mark.parametrize("dim", [0, 1, -1])
def test_topk_dim_matches(rng, dim):
    x = rng.normal(size=(50, 9, 6)).astype(np.float32)
    v_ref, i_ref = jtopk(jnp.asarray(x), 5, dim=dim)
    v, i = tp.topk(torch.from_numpy(x), 5, dim=dim)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))


@pytest.mark.parametrize("approx", [False, True])
def test_topk_pads_beyond_n(rng, approx):
    """k above the row length pads -inf values and index 0, as the JAX
    package does; approx takes the exact top-k (approx_max_k is exact off
    the TPU), recall_target accepted."""
    x = rng.normal(size=(4, 6)).astype(np.float32)
    v_ref, i_ref = jtp.topk(jnp.asarray(x), 10, approx=approx,
                            recall_target=0.9)
    v, i = tp.Topk()(torch.from_numpy(x), 10, approx=approx,
                     recall_target=0.9)
    assert tuple(v.shape) == (4, 10)
    assert np.all(np.isneginf(v.numpy()[:, 6:]))
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    assert (i.numpy()[:, 6:] == 0).all()


@pytest.mark.parametrize("distance", DISTANCES)
def test_preprocess_query_matches(rng, distance):
    q = rng.normal(size=(7, 12)).astype(np.float32)
    np.testing.assert_allclose(
        tmetric.preprocess_query(torch.from_numpy(q), distance).numpy(),
        np.asarray(jmetric.preprocess_query(jnp.asarray(q), distance)),
        rtol=1e-6, atol=1e-7)


# -- flat containers ----------------------------------------------------------

CONTAINER_KEYS = ("_storage", "_address2id", "_id2address")


def _both(**kw):
    return JaxFlat(**kw), tp.container.FlatContainer(**kw, device=CPU)


def test_flat_container_add_roundtrip(rng):
    """Addresses, ids, rows and the id maps equal the JAX container's after
    an add with default ids and one with custom ids."""
    jc, tc = _both(code_size=8, initial_size=16)
    d = rng.normal(size=(8, 10)).astype(np.float32)
    ids_r, addr_r = jc.add(jnp.asarray(d), return_address=True)
    ids, addr = tc.add(d, return_address=True)
    assert ids.dtype == torch.int32 and addr.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_r))
    np.testing.assert_array_equal(addr.numpy(), np.asarray(addr_r))
    custom = np.array([40, 20, 30, 10, 50], np.int64)
    d2 = rng.normal(size=(8, 5)).astype(np.float32)
    jc.add(jnp.asarray(d2), ids=custom)
    tc.add(d2, ids=custom)
    assert (tc.n_items, tc.max_id) == (jc.n_items, jc.max_id) == (15, 51)
    _state_equal(tc, jc, CONTAINER_KEYS)
    np.testing.assert_array_equal(tc.get_data_by_id(custom).numpy(), d2)
    addr_q = np.array([0, 3, 14, 15, -1, 99])
    np.testing.assert_array_equal(
        tc.get_data_by_address(addr_q).numpy(),
        np.asarray(jc.get_data_by_address(jnp.asarray(addr_q))))


@pytest.mark.parametrize("mode", ["double", "step"])
def test_flat_container_expand(rng, mode):
    """The growth policy: the same capacities after each add and after an
    explicit expand()."""
    jc, tc = _both(code_size=4, initial_size=8, expand_step_size=8,
                   expand_mode=mode)
    for n in (5, 30, 100):
        d = rng.normal(size=(4, n)).astype(np.float32)
        jc.add(jnp.asarray(d))
        tc.add(d)
        assert tc.capacity == jc.capacity
    jc.expand()
    tc.expand()
    assert tc.capacity == jc.capacity
    _state_equal(tc, jc, CONTAINER_KEYS)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flat_container_remove_compacts(seed):
    """Swap-from-tail compaction: the same storage, id maps and addresses
    as the JAX container after interleaved adds and removes (by id and by
    address, with duplicates and absent entries); survivors keep their
    rows."""
    rng = np.random.default_rng(seed)
    jc, tc = _both(code_size=4, initial_size=32)
    rows = {}
    for step in range(4):
        d = rng.normal(size=(4, 20)).astype(np.float32)
        ids = np.asarray(jc.add(jnp.asarray(d)))
        np.testing.assert_array_equal(tc.add(d).numpy(), ids)
        rows.update({int(i): d[:, j] for j, i in enumerate(ids)})
        live = np.array(sorted(rows))
        gone = rng.choice(live, size=7, replace=False)
        if step % 2:
            addr = np.asarray(jc.get_address_by_id(jnp.asarray(gone)))
            addr = np.concatenate([addr, addr[:2], [-1, 10 ** 6]])
            assert tc.remove(address=addr) == jc.remove(address=addr) == 7
        else:
            ids_rm = np.concatenate([gone, [10 ** 6]])
            assert tc.remove(ids=ids_rm) == jc.remove(ids=ids_rm) == 7
        for i in gone:
            del rows[int(i)]
        assert tc.n_items == jc.n_items == len(rows)
        _state_equal(tc, jc, CONTAINER_KEYS)
    live = np.array(sorted(rows))
    assert (tc.get_address_by_id(live).numpy() < tc.n_items).all()
    np.testing.assert_array_equal(tc.get_data_by_id(live).numpy(),
                                  np.stack([rows[i] for i in live], 1))


def test_flat_container_set_data_and_empty(rng):
    jc, tc = _both(code_size=3, initial_size=16)
    d = rng.normal(size=(3, 9)).astype(np.float32)
    jc.add(jnp.asarray(d))
    tc.add(d)
    addr = np.array([0, 4, 15, -1, 16])
    new = rng.normal(size=(3, 5)).astype(np.float32)
    jc.set_data_by_address(jnp.asarray(new), jnp.asarray(addr))
    tc.set_data_by_address(new, addr)
    _state_equal(tc, jc, CONTAINER_KEYS)
    jc.empty()
    tc.empty()
    assert tc.n_items == 0 and tc.max_id == 0
    _state_equal(tc, jc, CONTAINER_KEYS)
    assert tc.add(d[:, :2]).tolist() == [0, 1]


def test_flat_container_group_lockstep(rng):
    """Parallel storages: adds, views and a remove keep every member in
    lockstep, as in the JAX group."""
    kw = dict(code_sizes=[4, 8], dtypes=["float32", "uint8"],
              initial_size=16)
    jg, tg = JaxGroup(**kw), tp.container.FlatContainerGroup(**kw,
                                                              device=CPU)
    d0 = rng.normal(size=(4, 10)).astype(np.float32)
    d1 = rng.integers(0, 255, size=(8, 10)).astype(np.uint8)
    ids_r, addr_r = jg.add([jnp.asarray(d0), jnp.asarray(d1)],
                           return_address=True)
    ids, addr = tg.add([d0, d1], return_address=True)
    np.testing.assert_array_equal(addr.numpy(), np.asarray(addr_r))
    assert (tg[1].code_size, tg[1].dtype, tg[1].n_items) == (8, "uint8", 10)
    np.testing.assert_array_equal(tg[0].get_data_by_address(addr).numpy(),
                                  d0)
    np.testing.assert_array_equal(tg[1].get_data_by_address(addr).numpy(),
                                  d1)
    jg.remove(ids=np.asarray(ids_r)[:3])
    tg.remove(ids=ids.numpy()[:3])
    assert tg.n_items == jg.n_items == 7
    _state_equal(tg, jg, CONTAINER_KEYS + ("_aux_storage1",))
    keep = ids.numpy()[3:]
    np.testing.assert_array_equal(tg[1].get_data_by_id(keep).numpy(),
                                  d1[:, 3:])
    new = rng.integers(0, 255, size=(8, 2)).astype(np.uint8)
    jg.set_data_by_address(jnp.asarray(new), jnp.asarray([0, 6]),
                           storage_index=1)
    tg.set_data_by_address(new, [0, 6], storage_index=1)
    _state_equal(tg, jg, ("_aux_storage1",))


# -- FlatIndex ---------------------------------------------------------------

@pytest.mark.parametrize("distance", DISTANCES)
def test_flat_index_matches(rng, distance):
    """Values within 1e-4 (rel 1e-5) of the JAX index's, ids equal outside
    ties; ids also against the numpy sweep (values within 1e-3)."""
    d, n, nq, k = 24, 300, 17, 5
    x = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    kw = dict(d_vector=d, distance=distance, initial_size=512)
    jidx, port = JaxFlatIndex(**kw), tp.FlatIndex(**kw, device=CPU)
    ids_r = np.asarray(jidx.add(jnp.asarray(x.T)))
    ids = port.add(x.T).numpy()
    np.testing.assert_array_equal(ids, ids_r)
    np.testing.assert_allclose(port._storage.numpy(),
                               np.asarray(jidx._storage), rtol=1e-6,
                               atol=1e-7)
    v_ref, i_ref, a_ref = jidx.search(jnp.asarray(q.T), k=k,
                                      return_address=True)
    v, i, a = port.search(q.T, k=k, return_address=True)
    assert i.dtype == torch.int32 and a.dtype == torch.int32
    assert_topk_match(v_ref, i_ref, v, i)
    assert_topk_match(v_ref, a_ref, v, a)
    want_v, want_idx = _np_search(x, q, distance, k)
    np.testing.assert_allclose(v.numpy(), want_v, rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(i.numpy(), ids[want_idx])


def test_flat_index_remove_then_search(rng):
    d, n = 8, 50
    x = rng.normal(size=(n, d)).astype(np.float32)
    jidx = JaxFlatIndex(d_vector=d, initial_size=64)
    port = tp.FlatIndex(d_vector=d, initial_size=64, device=CPU)
    ids = np.asarray(jidx.add(jnp.asarray(x.T)))
    port.add(x.T)
    for idx in (jidx, port):
        idx.remove(ids=ids[7:8])
    v_ref, i_ref = jidx.search(jnp.asarray(x[:12].T), k=4)
    v, i = port.search(x[:12].T, k=4)
    assert int(i[7, 0]) != ids[7]
    assert_topk_match(v_ref, i_ref, v, i)


@pytest.mark.parametrize("k", [3, 10])
def test_flat_index_k_larger_than_n(rng, k):
    """k above the live rows pads -inf / -1 (ids and addresses)."""
    x = rng.normal(size=(3, 8)).astype(np.float32)
    jidx = JaxFlatIndex(d_vector=8, initial_size=8)
    port = tp.FlatIndex(d_vector=8, initial_size=8, device=CPU)
    jidx.add(jnp.asarray(x.T))
    port.add(x.T)
    v_ref, i_ref, a_ref = jidx.search(jnp.asarray(x.T), k=k,
                                      return_address=True)
    v, i, a = port.search(x.T, k=k, return_address=True)
    assert tuple(v.shape) == (3, k)
    assert (i.numpy()[:, 3:] == -1).all() and (a.numpy()[:, 3:] == -1).all()
    assert_topk_match(v_ref, i_ref, v, i)
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))


def test_flat_index_query_chunks(rng):
    """A search cut into many query chunks equals the search in one."""
    from torchpq_tpu_torch.index import flat as tflat
    x = rng.normal(size=(200, 16)).astype(np.float32)
    q = torch.from_numpy(rng.normal(size=(37, 16)).astype(np.float32))
    port = tp.FlatIndex(d_vector=16, device=CPU)
    port.add(x.T)
    whole = tflat._flat_search(q, port._storage, port._address2id,
                               port.n_items, k=6, distance="euclidean")
    cut = tflat._flat_search(q, port._storage, port._address2id,
                             port.n_items, k=6, distance="euclidean",
                             q_chunk=5)
    assert all(torch.equal(a, b) for a, b in zip(whole, cut))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_flat_index_npz_carries_across(rng, tmp_path, direction):
    """An index saved by one package (after adds and a remove) loads into
    the other: the same state and the same search."""
    d = 16
    x = rng.normal(size=(120, d)).astype(np.float32)
    q = rng.normal(size=(9, d)).astype(np.float32)
    kw = dict(d_vector=d, distance="cosine", initial_size=64)
    src = JaxFlatIndex(**kw) if direction == "jax_to_port" \
        else tp.FlatIndex(**kw, device=CPU)
    ids = np.asarray(src.add(jnp.asarray(x.T) if direction == "jax_to_port"
                             else x.T))
    src.remove(ids=ids[::5])
    path = str(tmp_path / "flat.npz")
    src.save(path)
    dst = tp.FlatIndex(**kw, device=CPU) if direction == "jax_to_port" \
        else JaxFlatIndex(**kw)
    dst.load(path)
    assert (dst.n_items, dst.capacity, dst.max_id) == \
        (src.n_items, src.capacity, src.max_id)
    for key in CONTAINER_KEYS:
        np.testing.assert_array_equal(to_np(getattr(dst, key)),
                                      to_np(getattr(src, key)), err_msg=key)
    qa = jnp.asarray(q.T)
    v_s, i_s = src.search(qa if direction == "jax_to_port" else q.T, k=5)
    v_d, i_d = dst.search(q.T if direction == "jax_to_port" else qa, k=5)
    assert_topk_match(v_s, i_s, v_d, i_d)
