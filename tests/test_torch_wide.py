"""Port parity of a bf16 index whose cache rows are wider than 256 bytes:
d = 320, lane-padded to a 384-wide cache (768-byte rows, which the card's
warp-specialised block scan walks in three 256-byte k chunks), at the GIST
records' settings scaled down: spill 8 cells at the initial capacity
2 x n / n_cells, scan_group 4, approximate top-k, k = 10 and k = 100
(pack32 k_pair 64 over 512 strided groups). The same numpy inputs go
through the JAX package (its Pallas block scan, interpreted through
tests/conftest.py, at d 384) and the port (on the CPU: the kernels' plain
version, the same arithmetic as the card's routes, which pick_route names
here).

Tolerances: the layouts are integers and must be equal. Exact selects:
values within 1e-4 absolute + 1e-5 relative, ids equal outside ties
(assert_topk_match). pack32 keys keep a score only above its 10 slot bits
(a truncation step of ~1e-4 at these scores), so f32 summation order can
move a score across one step: ids overlap >= 0.99 and values within 5e-3
absolute."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torchpq_tpu.index import IVFPQIndex as JaxIndex
from torchpq_tpu.ops import adc as jadc
import torchpq_tpu_torch as tp
from torchpq_tpu_torch.ops import adc as tadc
from torchpq_tpu_torch.ops import block_scan as bs

from _torch_helpers import CPU, assert_topk_match, overlap, to_np

D, M, N_CELLS, N, GROUP = 320, 8, 16, 1300, 4
PACK_ATOL = 5e-3

_PAIR = {}


def _pair():
    """A JAX-trained bf16 index and the port's copy of its codecs, each
    filled by the same two adds with spill on (8 choices at the initial
    capacity, device route), scan_group 4; and 9 queries."""
    if not _PAIR:
        rng = np.random.default_rng(21)
        x = (rng.normal(size=(N + 9, D)) / np.sqrt(D)).astype(np.float32)
        kw = dict(d_vector=D, n_subvectors=M, n_cells=N_CELLS,
                  initial_size=N // N_CELLS * 2)
        jidx = JaxIndex(**kw)
        jidx.vq_codec.kmeans.max_iter = 6
        jidx.pq_codec.kmeans.max_iter = 6
        jidx.train(jnp.asarray(x[:N].T))
        port = tp.IVFPQIndex(**kw, device=CPU)
        port.load_state_dict(jidx.state_dict())
        for idx in (jidx, port):
            idx.spill_cells = 8
            idx.spill_capacity = idx.max_cell_capacity
        for chunk in (x[:700], x[700:N]):
            _, a_ref = jidx.add(jnp.asarray(chunk.T), return_address=True)
            _, a = port.add(chunk.T, return_address=True)
            np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
        for idx in (jidx, port):
            idx.scan_group = GROUP
            idx.scan_mode, idx.use_smart_probing = "cell_major", False
        _PAIR.update(jidx=jidx, port=port, q=x[N:])
    return _PAIR["jidx"], _PAIR["port"], _PAIR["q"]


def test_wide_layout_and_routes():
    """The port's cache is 384 wide, bf16, at the JAX package's capacity,
    with the same stored layout; the card would take its scans on the
    warp-specialised tensor-core route in k chunks (pick_route: wgmma over
    a TMA ring), exact and pack32 at k_pair 10 and 64."""
    jidx, port, _ = _pair()
    dec = port.aux("decoded")
    assert tuple(dec.shape[1:]) == (384,) and dec.dtype == torch.bfloat16
    assert port.max_cell_capacity == jidx.max_cell_capacity == 256
    for name in ("_is_empty", "_cell_start", "_cell_capacity", "_cell_size",
                 "_address2id"):
        np.testing.assert_array_equal(to_np(getattr(port, name)),
                                      to_np(getattr(jidx, name)),
                                      err_msg=name)
    s_eff = GROUP * port.max_cell_capacity
    for k_pair, pack32, route in ((10, False, "tc_wg_exact"),
                                  (10, True, "tc_wg_pack32"),
                                  (64, True, "tc_wg_pack32")):
        assert bs.pick_route(dtype=torch.bfloat16, d=384, p_tile=128,
                             s_eff=s_eff, k_pair=k_pair,
                             pack32=pack32) == route


@pytest.mark.parametrize("k,k_pair", [(10, 10), (100, 64)])
def test_wide_pack32_matches(k, k_pair):
    """pack32 at n_probe 8 over supercells of 4 (s_eff 1024): k = 10
    selects k_pair 10 over 128 groups, k = 100 k_pair 64 over 512 (the
    records' deep select); ids overlap >= 0.99, values within 5e-3."""
    jidx, port, q = _pair()
    for idx in (jidx, port):
        idx.n_probe, idx.use_approx_topk = 8, True
    v_ref, i_ref = jidx.search(jnp.asarray(q.T), k=k)
    assert (jadc.LAST_GATE["impl"], jadc.LAST_GATE["d"]) == ("pallas", 384)
    v, i = port.search(q.T, k=k)
    g = tadc.LAST_GATE
    assert (g["impl"], g["pack32"], g["k_pair"], g["s_eff"]) == (
        "block_scan", True, k_pair, GROUP * port.max_cell_capacity)
    assert bs.n_groups(g["s_eff"], k_pair) == (512 if k_pair > 32 else 128)
    assert overlap(i, i_ref) >= 0.99
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), atol=PACK_ATOL,
                               rtol=1e-4)


def test_wide_exact_matches():
    """The exact select at n_probe 8 (grouping acts there too): values
    within 1e-4 + 1e-5 |v|, ids equal outside ties."""
    jidx, port, q = _pair()
    for idx in (jidx, port):
        idx.n_probe, idx.use_approx_topk = 8, False
    v_ref, i_ref = jidx.search(jnp.asarray(q.T), k=10)
    assert jadc.LAST_GATE["impl"] == "pallas"
    v, i = port.search(q.T, k=10)
    g = tadc.LAST_GATE
    assert (g["pack32"], g["group"], g["k_pair"]) == (False, GROUP, 10)
    assert_topk_match(v_ref, i_ref, v, i)
