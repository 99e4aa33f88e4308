"""Parity of the port's host data plane with the JAX package's: the native
readers and spill greedy (torchpq_tpu_torch.native against
torchpq_tpu.native), the host spill route of IVFPQIndex.add, and the exact
presize (CellContainer.expand(exact=True)). Everything here is integer or
copied bytes: results must be equal, bit for bit."""

import os
import pathlib
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torchpq_tpu import native as jnative
from torchpq_tpu.container import CellContainer as JaxCells
from torchpq_tpu.index import IVFPQIndex as JaxIndex
import torchpq_tpu_torch as tp
from torchpq_tpu_torch import native

from _torch_helpers import CPU, to_np


def _write_vecs(path, rows):
    """texmex layout: each row [int32 d][d values]."""
    n, d = rows.shape
    body = np.empty((n, 4 + d * rows.dtype.itemsize), np.uint8)
    body[:, :4] = np.frombuffer(np.int32(d).tobytes(), np.uint8)
    body[:, 4:] = rows.view(np.uint8).reshape(n, -1)
    body.tofile(path)


@pytest.fixture
def vecs(tmp_path):
    rng = np.random.default_rng(3)
    files = {
        "fvecs": rng.normal(size=(203, 12)).astype(np.float32),
        "bvecs": rng.integers(0, 256, size=(150, 20)).astype(np.uint8),
        "ivecs": rng.integers(-5, 1 << 20, size=(97, 7)).astype(np.int32),
    }
    out = {}
    for kind, rows in files.items():
        path = tmp_path / f"data.{kind}"
        _write_vecs(path, rows)
        out[kind] = (str(path), rows)
    return out


@pytest.fixture
def no_library(monkeypatch):
    """The state of a process with no C++ compiler: the build fails."""
    def fail():
        raise RuntimeError("g++ not found")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    monkeypatch.setattr(native, "BUILD_ERROR", None)
    monkeypatch.setattr(native, "_build", fail)


READ = [(None, 0), (5, 0), (10, 90), (None, 95), (50, 1000), (0, 3)]


@pytest.mark.parametrize("kind", ["fvecs", "bvecs", "ivecs"])
def test_readers_match_reference(vecs, kind):
    """Whole, bounded, offset and past-the-end reads through the C++ route
    equal the JAX package's readers and the source rows; streaming in
    chunks rebuilds the file."""
    path, rows = vecs[kind]
    read, jread = getattr(native, f"read_{kind}"), getattr(jnative,
                                                           f"read_{kind}")
    for n_max, offset in READ:
        got = read(path, n_max=n_max, offset=offset)
        assert native.LAST_ROUTE[f"read_{kind}"] == "cpp"
        want = jread(path, n_max=n_max, offset=offset)
        assert got.dtype == want.dtype == rows.dtype
        np.testing.assert_array_equal(got, want)
        end = None if n_max is None else offset + n_max
        np.testing.assert_array_equal(got, rows[offset:end])
    for chunk, n_max in ((25, None), (40, 70), (1000, None)):
        got = list(native.stream_vecs(path, chunk_rows=chunk, n_max=n_max,
                                      kind=kind))
        want = list(jnative.stream_vecs(path, chunk_rows=chunk, n_max=n_max,
                                        kind=kind))
        assert [len(b) for b in got] == [len(b) for b in want]
        np.testing.assert_array_equal(np.concatenate(got), rows[:n_max])


@pytest.mark.parametrize("kind", ["fvecs", "bvecs", "ivecs"])
def test_readers_numpy_fallback(vecs, no_library, kind):
    """Without a compiler the numpy route serves, warns once, records
    itself, and reads what the C++ route reads."""
    path, rows = vecs[kind]
    read = getattr(native, f"read_{kind}")
    with pytest.warns(RuntimeWarning, match="numpy serves instead"):
        got = read(path, n_max=10, offset=90)
    assert native.LAST_ROUTE[f"read_{kind}"] == "numpy"
    assert "g++ not found" in native.BUILD_ERROR
    np.testing.assert_array_equal(got, rows[90:100])
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no second warning
        np.testing.assert_array_equal(read(path), rows)


def _spill_cases():
    rng = np.random.default_rng(9)
    for n, l, n_cells, cap in ((3000, 4, 64, 40), (500, 8, 16, 20),
                               (2000, 1, 128, 10), (0, 3, 8, 4)):
        top = rng.integers(0, n_cells, size=(n, l)).astype(np.int32)
        top[: n // 3, 0] = 5  # a hot cell: its items spill
        counts = rng.integers(0, cap + 3, size=n_cells).astype(np.int64)
        yield top, counts, cap


@pytest.mark.parametrize("case", list(_spill_cases()),
                         ids=["hot", "full", "l1", "empty"])
@pytest.mark.parametrize("route", ["cpp", "numpy"])
def test_spill_assign_matches_reference(case, route, request):
    """Both routes equal the JAX package's greedy (cells and the updated
    counts), whose own route is its C++ library."""
    top, counts, cap = case
    if route == "numpy":
        request.getfixturevalue("no_library")
    want, want_counts = jnative.spill_assign(top, counts.copy(), cap)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got, got_counts = native.spill_assign(top, counts.copy(), cap)
    assert native.LAST_ROUTE["spill_assign"] == route
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_counts, want_counts)
    np.testing.assert_array_equal(native._spill_assign_numpy(
        top, counts.copy(), cap), want)


def test_spill_assign_rejects_out_of_range():
    top = np.array([[0, 9]], np.int32)
    with pytest.raises(ValueError, match="out of range"):
        native.spill_assign(top, np.zeros(4, np.int64), 1)


def test_library_builds_outside_the_reference():
    """The port builds its own copy of the source into build/, named by a
    hash of the source and flags, never inside the JAX package."""
    native.spill_assign(np.zeros((1, 1), np.int32), np.zeros(1, np.int64), 1)
    path = native.library_path()
    assert path.exists() and path.parent == tp._build.BUILD_DIR
    ref_pkg = pathlib.Path(jnative.__file__).resolve().parents[1]
    assert ref_pkg not in path.resolve().parents
    src = pathlib.Path(native.__file__).parent / "src" / "native.cpp"
    ref_src = pathlib.Path(jnative.__file__).parent / "src" / "native.cpp"
    body = src.read_text()
    ref_body = ref_src.read_text()
    # the same code below the header comment
    assert body[body.index("#include"):] == \
        ref_body[ref_body.index("#include"):]


D, M, N_CELLS = 32, 8, 16


def _host_spill_pair(settings):
    """A JAX index trained and filled once, its whole state carried into
    the port; both then add with spill on through the host route."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1800, D)).astype(np.float32)
    kw = dict(d_vector=D, n_subvectors=M, n_cells=N_CELLS, initial_size=32)
    jidx = JaxIndex(**kw)
    jidx.vq_codec.kmeans.max_iter = jidx.pq_codec.kmeans.max_iter = 5
    jidx.train(jnp.asarray(x[:800].T))
    jidx.add(jnp.asarray(x[:300].T))
    port = tp.IVFPQIndex(**kw, device=CPU)
    port.load_state_dict(jidx.state_dict())
    for idx in (jidx, port):
        for name, value in settings.items():
            setattr(idx, name, value)
    return jidx, port, x


@pytest.mark.parametrize("cap", [32, 48])
def test_host_spill_add_matches_reference(cap):
    """Adds through spill_impl="host" from carried state: the same
    addresses and layout as the JAX package's host route, before and after
    a remove (the host cell sizes the greedy reads stay in step)."""
    jidx, port, x = _host_spill_pair(dict(
        spill_cells=6, spill_capacity=cap, spill_impl="host"))

    def check():
        for name in ("_cell_size", "_cell_capacity", "_address2id",
                     "_is_empty", "_storage"):
            np.testing.assert_array_equal(to_np(getattr(port, name)),
                                          to_np(getattr(jidx, name)),
                                          err_msg=name)
        np.testing.assert_array_equal(port._cell_size_np,
                                      jidx._cell_size_np)

    for lo, hi in ((300, 900), (900, 1300)):
        _, a_ref = jidx.add(jnp.asarray(x[lo:hi].T), return_address=True)
        _, a = port.add(x[lo:hi].T, return_address=True)
        assert native.LAST_ROUTE["spill_assign"] == "cpp"
        np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
        check()
    rm = np.arange(100, 700, 3)
    assert port.remove(ids=rm) == jidx.remove(ids=jnp.asarray(rm))
    _, a_ref = jidx.add(jnp.asarray(x[1300:].T), return_address=True)
    _, a = port.add(x[1300:].T, return_address=True)
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    check()


def test_host_and_device_routes_agree_on_open_cells():
    """Where no candidate list ever runs out of room the greedy and the
    device route both give each item its best cell below the capacity."""
    jidx, port, x = _host_spill_pair(dict(
        spill_cells=4, spill_capacity=10_000, spill_impl="host"))
    _, a = port.add(x[300:900].T, return_address=True)
    dev = tp.IVFPQIndex(d_vector=D, n_subvectors=M, n_cells=N_CELLS,
                        initial_size=32, device=CPU)
    dev.load_state_dict(jidx.state_dict())
    dev.spill_cells, dev.spill_capacity = 4, 10_000
    _, a_dev = dev.add(x[300:900].T, return_address=True)
    np.testing.assert_array_equal(a.numpy(), a_dev.numpy())


REQUIRED = {0: 150, 1: 20, 2: 700, 5: 3, 7: 128, 9: 129}


@pytest.mark.parametrize("filled", [False, True])
def test_expand_exact_matches_reference(filled):
    """expand(required, exact=True) gives the JAX container's capacities
    (multiples of 16, of 128 from 128 up) and cell starts, on an empty
    store (fresh stores, no relayout of zeros) and on a filled one (rows
    moved with their ids); a later add that fits changes no capacity."""
    rng = np.random.default_rng(6)
    kw = dict(code_size=8, n_cells=10, initial_size=32, dtype="uint8")
    jc, tc = JaxCells(**kw), tp.container.CellContainer(**kw, device=CPU)
    tc.add_aux_store("norm", 1, "float32")
    data = rng.integers(0, 256, size=(8, 200)).astype(np.uint8)
    cells = rng.integers(0, 10, size=200)
    if filled:
        jc.add(jnp.asarray(data), jnp.asarray(cells))
        tc.add(data, cells, aux_rows={"norm": np.arange(200.0)[:, None]})
    jc.expand(required=REQUIRED, exact=True)
    tc.expand(required=REQUIRED, exact=True)
    caps = tc._cell_capacity.numpy()
    np.testing.assert_array_equal(caps, np.asarray(jc._cell_capacity))
    np.testing.assert_array_equal(tc._cell_capacity_np, caps)
    np.testing.assert_array_equal(tc._cell_start.numpy(),
                                  np.asarray(jc._cell_start))
    assert caps[2] == 768 and caps[0] == 256 and caps[9] == 256
    assert (tc._cell_start.numpy() % 16 == 0).all()
    for name in ("_storage", "_address2id", "_is_empty"):
        np.testing.assert_array_equal(to_np(getattr(tc, name)),
                                      to_np(getattr(jc, name)),
                                      err_msg=name)
    if filled:
        addr = tc.get_address_by_id(np.arange(200))
        np.testing.assert_array_equal(tc.aux("norm")[addr.long(), 0].numpy(),
                                      np.arange(200.0))
    more = rng.integers(0, 256, size=(8, 40)).astype(np.uint8)
    more_cells = np.repeat([0, 2], 20)
    jc.add(jnp.asarray(more), jnp.asarray(more_cells))
    tc.add(more, more_cells)
    np.testing.assert_array_equal(tc._cell_capacity.numpy(), caps)
    np.testing.assert_array_equal(tc._storage.numpy(),
                                  np.asarray(jc._storage))


def test_index_presize_then_ingest():
    """The presize-before-ingest path on an index: count the cells of the
    data on an empty index, expand(required, exact=True), then add it all
    with no relayout (the capacities stay as presized); the same layout as
    the JAX package's."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(1500, D)).astype(np.float32)
    kw = dict(d_vector=D, n_subvectors=M, n_cells=N_CELLS, initial_size=16)
    jidx = JaxIndex(**kw)
    jidx.vq_codec.kmeans.max_iter = jidx.pq_codec.kmeans.max_iter = 5
    jidx.train(jnp.asarray(x[:600].T))
    port = tp.IVFPQIndex(**kw, device=CPU)
    port.load_state_dict(jidx.state_dict())
    cells = port.vq_codec.encode(torch.from_numpy(x.T)).numpy()
    counts = np.bincount(cells, minlength=N_CELLS)
    required = {int(c): int(n) for c, n in enumerate(counts) if n}
    for idx in (jidx, port):
        idx.expand(required=required, exact=True)
    caps = port._cell_capacity.numpy().copy()
    assert ((caps % 16 == 0) & ((caps < 128) | (caps % 128 == 0))).all()
    assert port.n_items == 0 and (caps >= counts).all()
    jidx.add(jnp.asarray(x.T))
    port.add(x.T)
    np.testing.assert_array_equal(port._cell_capacity.numpy(), caps)
    for name in ("_cell_capacity", "_cell_size", "_address2id", "_storage"):
        np.testing.assert_array_equal(to_np(getattr(port, name)),
                                      to_np(getattr(jidx, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(to_np(port.aux("decoded")),
                                  to_np(jidx.aux("decoded")))
