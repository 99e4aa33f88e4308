"""Port parity of the cell container: adds that force a relayout, hole
reuse after removes, and the packed code layout."""

import numpy as np
import jax.numpy as jnp
import pytest

from torchpq_tpu.container import CellContainer as JaxCells
import torchpq_tpu_torch as tp

from _torch_helpers import to_np


def _state_equal(jc, tc):
    for k in ("_storage", "_is_empty", "_cell_start", "_cell_capacity",
              "_cell_size", "_address2id", "_id2address", "_aux_v"):
        np.testing.assert_array_equal(to_np(getattr(tc, k)),
                                      np.asarray(getattr(jc, k)), err_msg=k)
    assert tc.capacity == jc.capacity and tc.n_items == jc.n_items
    assert tc.max_cell_capacity == jc.max_cell_capacity


@pytest.mark.parametrize("pack_group", [1, 16])
def test_cell_add_relayout_remove_matches(rng, pack_group):
    kw = dict(code_size=8, n_cells=4, dtype="uint8", initial_size=16,
              pack_group=pack_group)
    jc, tc = JaxCells(**kw), tp.container.CellContainer(**kw)
    for c in (jc, tc):
        c.add_aux_store("v", 2, "float32")
    for step, (n, p) in enumerate([(30, [0.7, 0.1, 0.1, 0.1]),
                                   (50, [0.1, 0.1, 0.2, 0.6]),
                                   (20, None)]):
        data = rng.integers(0, 256, size=(8, n)).astype(np.uint8)
        cells = rng.choice(4, size=n, p=p).astype(np.int32)
        aux = rng.normal(size=(n, 2)).astype(np.float32)
        _, a_ref = jc.add(jnp.asarray(data), cells, return_address=True,
                          aux_rows={"v": jnp.asarray(aux)})
        _, a = tc.add(data, cells, return_address=True, aux_rows={"v": aux})
        np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
        _state_equal(jc, tc)
        if step == 0:
            assert jc.max_cell_capacity > 16, "batch must force a relayout"
            rm = np.array([1, 3, 5, 7, 11, 29])
            assert tc.remove(ids=rm) == jc.remove(ids=jnp.asarray(rm))
            _state_equal(jc, tc)
    addr = rng.integers(-2, tc.capacity + 2, size=40)
    np.testing.assert_array_equal(
        tc.get_data_by_address(addr).numpy(),
        np.asarray(jc.get_data_by_address(jnp.asarray(addr))))
    np.testing.assert_array_equal(
        tc.get_cell_by_address(addr).numpy(),
        np.asarray(jc.get_cell_by_address(jnp.asarray(addr))))
    ids = np.arange(-1, 105)
    np.testing.assert_array_equal(
        tc.get_address_by_id(ids).numpy(),
        np.asarray(jc.get_address_by_id(jnp.asarray(ids))))


def test_cell_add_user_ids_and_bad_cells(rng):
    tc = tp.container.CellContainer(code_size=4, n_cells=3, initial_size=16)
    data = rng.integers(0, 256, size=(4, 5)).astype(np.uint8)
    ids = tc.add(data, np.array([0, 1, 2, 0, 1]), ids=[10, 20, 30, 40, 50])
    assert ids.tolist() == [10, 20, 30, 40, 50]
    assert tc.get_address_by_id([30]).tolist() == [32]
    with pytest.raises(ValueError):
        tc.add(data, np.array([0, 1, 5, 0, 1]))
    with pytest.raises(ValueError):
        tc.remove()
