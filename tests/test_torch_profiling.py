"""The port's profiling helpers and the util helpers they sit on, against
the JAX package's (torchpq_tpu.profiling, torchpq_tpu.util): a named scope
appears in the Chrome trace that `trace` writes, the phase timer and tick
sum and report as the JAX package's do, and the layout helpers give the
JAX package's arrays (equal, on the same numpy inputs)."""

import json
import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torchpq_tpu import profiling as jprof
from torchpq_tpu import util as jutil
import torchpq_tpu_torch as tp
from torchpq_tpu_torch import profiling
from torchpq_tpu_torch import util


def test_named_scope_in_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.named_scope("torchpq_probe_scope"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof.trace_path.startswith(str(tmp_path))
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "torchpq_probe_scope" in names


def test_phase_timer_matches_reference():
    """Phases sum over repeats and report longest first, as the JAX
    package's; `sync` receives the phase's outputs."""
    timers = (profiling.PhaseTimer(), jprof.PhaseTimer())
    for t, mk in zip(timers, (torch.ones, jnp.ones)):
        for name, s in (("a", 0.02), ("b", 0.005), ("a", 0.02)):
            with t.phase(name, sync=lambda: mk(3)):
                time.sleep(s)
    got, want = (t.report() for t in timers)
    assert list(got) == list(want) == ["a", "b"]
    assert got["a"] >= 0.04 and 0.005 <= got["b"] < got["a"]


def test_timer_tick(capsys):
    t = util.Timer()
    time.sleep(0.01)
    dt = t.tick("step", sync=[torch.zeros(2), {"x": torch.ones(1)}])
    assert dt >= 0.01 and "[tick] step:" in capsys.readouterr().out
    assert t.tick() < dt + 1.0


def test_layout_helpers_match_reference(rng):
    x = rng.normal(size=(6, 11)).astype(np.float32)
    np.testing.assert_array_equal(util.as_n_d(x, 6).numpy(),
                                  np.asarray(jutil.as_n_d(jnp.asarray(x), 6)))
    np.testing.assert_array_equal(util.as_d_n(torch.from_numpy(x)).numpy(),
                                  np.asarray(jutil.as_d_n(jnp.asarray(x))))
    with pytest.raises(ValueError):
        util.as_n_d(x, 5)
    with pytest.raises(ValueError):
        util.as_n_d(x[0])
    for mult, value in ((4, 0), (8, -1), (11, 3), (1, 0)):
        got, n = util.pad_rows(torch.from_numpy(x), mult, value)
        want, n_ref = jutil.pad_rows(jnp.asarray(x), mult, value)
        assert n == n_ref == 6
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tree_helpers():
    tree = {"a": torch.ones(2, dtype=torch.bfloat16),
            "b": [torch.arange(3), (np.zeros(1), 4)]}
    out = util.to_numpy(tree)
    assert out["a"].dtype == np.float32 and out["a"].tolist() == [1.0, 1.0]
    assert out["b"][0].tolist() == [0, 1, 2]
    assert isinstance(out["b"][1], tuple) and int(out["b"][1][1]) == 4
    assert util.block_until_ready(tree) is tree
    # the ids every entry point returns
    assert util.id_dtype() == util.ID_DTYPE == torch.int32
    cells = tp.container.CellContainer(code_size=2, n_cells=2, device="cpu")
    assert cells.add(np.zeros((2, 3), np.float32),
                     np.zeros(3, np.int64)).dtype == util.id_dtype()
