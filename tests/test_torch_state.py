"""Port parity: the order-preserving int32 keys and the npz state format
carry across between torchpq_tpu and torchpq_tpu_torch."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torchpq_tpu.index import IVFPQIndex as JaxIndex
from torchpq_tpu.ops import adc as jadc
import torchpq_tpu_torch as tp
from torchpq_tpu_torch.ops.block_scan import sortable_i32, sortable_i32_to_f32

from _torch_helpers import CPU, to_np


def _floats(rng):
    special = np.array([0.0, -0.0, np.inf, -np.inf, 1.0, -1.0,
                        np.finfo(np.float32).max, -np.finfo(np.float32).max,
                        np.finfo(np.float32).tiny, -np.finfo(np.float32).tiny,
                        np.finfo(np.float32).max / 4,
                        -np.finfo(np.float32).max / 4], np.float32)
    return np.concatenate([special,
                           rng.normal(size=1000).astype(np.float32) * 1e3])


def test_sortable_keys_bit_exact(rng):
    x = _floats(rng)
    ref = np.asarray(jadc._f32_sortable_i32(jnp.asarray(x)))
    got = sortable_i32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ref)
    back = sortable_i32_to_f32(torch.from_numpy(ref.copy())).numpy()
    np.testing.assert_array_equal(back.view(np.int32), x.view(np.int32))
    # order: keys sort exactly like the floats (-0 just below +0)
    order = np.lexsort((-np.signbit(x).astype(np.int64), x))
    assert np.all(np.diff(got[order].astype(np.int64)) > 0)


def test_sortable_inverse_matches_jax(rng):
    keys = rng.integers(-2**31, 2**31 - 1, size=2000, dtype=np.int64) \
        .astype(np.int32)
    ref = np.asarray(jadc._sortable_i32_f32(jnp.asarray(keys)))
    got = sortable_i32_to_f32(torch.from_numpy(keys)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


@pytest.fixture(scope="module")
def jax_index():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(600, 32)).astype(np.float32)
    idx = JaxIndex(d_vector=32, n_subvectors=8, n_cells=8, initial_size=32)
    idx.train(jnp.asarray(x.T))
    idx.add(jnp.asarray(x.T))
    return idx


def _assert_states_equal(a, b):
    assert set(a) == set(b), set(a) ^ set(b)
    for k in a:
        va, vb = a[k], b[k]
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            va, vb = np.asarray(va), np.asarray(vb)
            assert va.dtype.itemsize == vb.dtype.itemsize, k
            np.testing.assert_array_equal(
                va.view(f"u{va.dtype.itemsize}") if va.dtype.kind == "V"
                or va.dtype.name == "bfloat16" else va,
                vb.view(f"u{vb.dtype.itemsize}") if vb.dtype.kind == "V"
                or vb.dtype.name == "bfloat16" else vb, err_msg=k)
        else:
            assert va == vb, k


def test_npz_round_trip_jax_port_jax(jax_index, tmp_path):
    jax_index.save(tmp_path / "a.npz")
    port = tp.IVFPQIndex(32, 8, 8, initial_size=32, device=CPU)
    port.load(tmp_path / "a.npz")
    assert port.aux("decoded").dtype == torch.bfloat16
    assert port.n_items == jax_index.n_items
    port.save(tmp_path / "b.npz")
    back = JaxIndex(d_vector=32, n_subvectors=8, n_cells=8, initial_size=32)
    back.load(tmp_path / "b.npz")
    _assert_states_equal(jax_index.state_dict(), back.state_dict())
    with np.load(tmp_path / "a.npz") as fa, np.load(tmp_path / "b.npz") as fb:
        assert set(fa.files) == set(fb.files)
        for k in fa.files:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("as_uint16", [False, True])
def test_load_state_dict_in_process(jax_index, as_uint16):
    """The JAX package's state_dict() output loads directly, with bf16 as
    ml_dtypes arrays or viewed as uint16."""
    state = jax_index.state_dict()
    if as_uint16:
        state = {k: (v.view(np.uint16) if isinstance(v, np.ndarray)
                     and v.dtype.name == "bfloat16" else v)
                 for k, v in state.items()}
    port = tp.IVFPQIndex(32, 8, 8, initial_size=32, device=CPU)
    port.load_state_dict(state)
    dec = port.aux("decoded")
    assert dec.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        to_np(dec), np.asarray(jax_index.aux("decoded")).astype(np.float32))
    np.testing.assert_array_equal(port._storage.numpy(),
                                  np.asarray(jax_index._storage))
    assert port.pack_group == jax_index.pack_group
    assert port.max_cell_capacity == jax_index.max_cell_capacity
    assert port.is_trained and port._frozen_codes is False
