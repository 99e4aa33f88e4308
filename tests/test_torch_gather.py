"""Port parity of the row gather (ops/gather.py) against the JAX package's
Pallas kernel (pallas_gather.gather_rows) in interpret mode. The CUDA
kernel runs only on a card: tests/test_torch_gpu.py holds it to its plain
version there."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torchpq_tpu.ops import pallas_gather
import torchpq_tpu_torch as tp
from torchpq_tpu_torch.ops import gather as gr

from _torch_helpers import to_np, to_t


def _table(rng, dtype, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32) * 40
    if dtype == "int8":
        return np.clip(np.round(x), -127, 127).astype(np.int8)
    if dtype == "bfloat16":
        return np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
def test_gather_rows_matches_pallas(rng, dtype, idx_dtype):
    """Bit for bit, out-of-range indices clipped into [0, n - 1]."""
    table = _table(rng, dtype, 50, 24)
    idx = np.concatenate([rng.integers(0, 50, 37), [-5, -1, 50, 51, 10 ** 6]])
    ref = pallas_gather.gather_rows(jnp.asarray(table),
                                    jnp.asarray(idx.astype(np.int32)),
                                    tile=8, interpret=True)
    before = dict(gr.launches)
    got = tp.ops.gather_rows(to_t(table), torch.from_numpy(
        idx.astype(idx_dtype)))
    assert gr.launches == before, "the plain version is not a launch"
    assert got.dtype == to_t(table).dtype
    np.testing.assert_array_equal(to_np(got), to_np(ref))


def test_gather_rows_shapes_and_checks(rng):
    table = to_t(_table(rng, "float32", 8, 3))  # 12-byte rows
    idx = torch.tensor([7, 0, 9, -3], dtype=torch.int32)
    assert torch.equal(tp.ops.gather_rows(table, idx),
                       table[torch.tensor([7, 0, 7, 0])])
    assert tuple(tp.ops.gather_rows(table, idx[:0]).shape) == (0, 3)
    with pytest.raises(TypeError):
        tp.ops.gather_rows(table, idx.float())
    with pytest.raises(ValueError):
        tp.ops.gather_rows(table.t(), idx)
    with pytest.raises(ValueError):
        tp.ops.gather_rows(table[:0], idx)
