"""The block scan's integer-valued inputs, its routes and the launch hook's
refusals, on the CPU.

`integer_block_inputs` (ops/block_scan.py) is what the card holds the
tensor-core block scan (csrc/block_scan_tc.cu) to bit for bit: every score
is an integer that f32 sums hold exactly in any order, with runs of equal
rows so that exact ties occur. Here the plain version `block_scan_ref` is
held to the JAX package's Pallas kernel (interpret mode, through
tests/conftest.py) on those inputs, bit for bit, keys and addresses, pad
rows included (both score them with query 0). `pick_route` is checked
against the shapes each kernel takes (bf16 and int8 tensor-core routes,
CUDA-core ones), and `launch` against the routes it refuses."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torchpq_tpu.ops import pallas_scan
from torchpq_tpu_torch.ops import block_scan as bs


def _integer_case(*, s_eff, seed, d=32):
    return bs.integer_block_inputs("cpu", s_eff=s_eff, n_blocks=3, nq=200,
                                   d=d, cap_total=2048, seed=seed)


def _pallas(qt, pr, sc, off, cap, penalty, dec, **kw):
    """The JAX kernel (interpret mode) on its staged inputs: per-block query
    tiles (query 0 for -1 pads) and penalty rows with the cell mask."""
    s_eff = kw["s_eff"]
    j = np.arange(s_eff)
    in_cell = (j[None] >= off[:, None]) & (j[None] < (off + cap)[:, None])
    pen_all = (penalty[sc[:, None] + j[None]]
               + np.where(in_cell, 0.0, bs.BIG)).astype(np.float32)
    return np.asarray(pallas_scan.scan_blocks_pallas(
        jnp.asarray(qt, jnp.bfloat16)[jnp.asarray(np.maximum(pr, 0))],
        jnp.asarray(sc), jnp.asarray(pen_all),
        jnp.asarray(dec, jnp.bfloat16), p_tile=128, bps=1, interpret=True,
        **kw))


@pytest.mark.parametrize("pack32", [False, True])
@pytest.mark.parametrize("distance", ["euclidean", "inner"])
@pytest.mark.parametrize("k_pair,s_eff", [(10, 256), (40, 512)])
def test_integer_inputs_plain_equals_pallas(pack32, distance, k_pair, s_eff):
    """k_pair 40 at s_eff 512 selects over G = 256 strided groups in
    pack32 (and runs past the exact lists of 16 in exact mode)."""
    if pack32:
        assert bs.n_groups(s_eff, k_pair) == (256 if k_pair > 32 else 128)
    args = _integer_case(s_eff=s_eff, seed=k_pair + s_eff)
    kw = dict(s_eff=s_eff, k_pair=k_pair, slot_mask=s_eff - 1)
    got = bs.block_scan_ref(*args, euclidean=distance == "euclidean",
                            pack32=pack32, **kw).numpy()
    qt, pr, sc, off, cap, penalty, dec = (
        x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
        for x in args)
    ref = _pallas(qt, pr, sc, off, cap, penalty, dec, distance=distance,
                  approx=pack32, **kw)
    np.testing.assert_array_equal(got, ref)
    if not pack32:  # the inputs do tie, so the slot order is exercised
        keys = got[..., :k_pair]
        assert (keys[..., 1:] == keys[..., :-1]).sum() > 0


def test_integer_inputs_layout():
    """Integer bf16 values, the block layout of random_inputs (live probers
    first, then -1 pads), runs of equal rows, BIG at some slots, integer
    norms elsewhere."""
    qt, pr, sc, off, cap, penalty, dec = _integer_case(s_eff=256, seed=0)
    for t in (qt, dec):
        assert t.dtype == torch.bfloat16
        assert torch.equal(t.float(), t.float().round())
        assert int(t.float().abs().max()) <= 3
    live = pr >= 0
    assert bool((live.int().diff(dim=1) <= 0).all()), "live probers first"
    assert bool((sc % 16 == 0).all()) and bool((off % 16 == 0).all())
    assert bool(((off + cap) <= 256).all())
    assert bool((dec[205:332] == dec[204]).all())
    big = penalty >= bs.BIG
    assert 0 < int(big.sum()) < penalty.numel() // 5
    norms = dec.float().pow(2).sum(-1)
    assert torch.equal(penalty[~big], norms[~big])


@pytest.mark.parametrize("shape,route", [
    (dict(dtype=torch.bfloat16, d=128, p_tile=128, s_eff=640, k_pair=10,
          pack32=False), "tc_exact"),       # the main path, exact
    (dict(dtype=torch.bfloat16, d=128, p_tile=128, s_eff=640, k_pair=10,
          pack32=True), "tc_pack32"),       # the main path, G = 128
    (dict(dtype=torch.bfloat16, d=128, p_tile=128, s_eff=2048, k_pair=40,
          pack32=True), "tc_pack32"),       # G = 512
    (dict(dtype=torch.bfloat16, d=128, p_tile=128, s_eff=512, k_pair=40,
          pack32=True), "tc_pack32"),       # G = 256
    (dict(dtype=torch.bfloat16, d=32, p_tile=128, s_eff=96, k_pair=10,
          pack32=True), "tc_pack32"),       # G = s_eff, one tile
    (dict(dtype=torch.bfloat16, d=40, p_tile=64, s_eff=1024, k_pair=16,
          pack32=False), "tc_exact"),       # K padded to 48
    (dict(dtype=torch.float32, d=128, p_tile=128, s_eff=640, k_pair=10,
          pack32=False), "exact"),          # f32 cache
    (dict(dtype=torch.int8, d=128, p_tile=128, s_eff=640, k_pair=10,
          pack32=True), "tc_int8_pack32"),  # int8 cache, A in registers
    (dict(dtype=torch.int8, d=128, p_tile=128, s_eff=640, k_pair=10,
          pack32=False), "tc_int8_exact"),  # the int8 tier's exact plan
    (dict(dtype=torch.int8, d=256, p_tile=128, s_eff=640, k_pair=16,
          pack32=False), "tc_int8_exact"),  # the widest row in registers
    (dict(dtype=torch.int8, d=288, p_tile=128, s_eff=640, k_pair=10,
          pack32=True), "tc_int8_pack32"),  # k chunks of 256 + 32 bytes
    (dict(dtype=torch.int8, d=1024, p_tile=128, s_eff=640, k_pair=10,
          pack32=True), "tc_int8_pack32"),  # the GIST-class cache
    (dict(dtype=torch.int8, d=1024, p_tile=128, s_eff=2048, k_pair=48,
          pack32=True), "tc_int8_pack32"),  # G = 512 at d = 1024
    (dict(dtype=torch.int8, d=1040, p_tile=128, s_eff=640, k_pair=10,
          pack32=False), "int8_exact"),     # wider than 1024 bytes
    (dict(dtype=torch.int8, d=136, p_tile=128, s_eff=640, k_pair=10,
          pack32=True), "int8_pack32"),     # d % 16 != 0
    (dict(dtype=torch.int8, d=128, p_tile=128, s_eff=640, k_pair=17,
          pack32=False), "int8_exact"),     # the lists hold 16
    (dict(dtype=torch.int8, d=128, p_tile=128, s_eff=2048, k_pair=49,
          pack32=True), "int8_pack32"),     # the shared lists hold 48
    (dict(dtype=torch.int8, d=128, p_tile=120, s_eff=640, k_pair=10,
          pack32=True), "int8_pack32"),     # not whole m tiles
    (dict(dtype=torch.int8, d=1024, p_tile=128, s_eff=200, k_pair=10,
          pack32=True), "int8_pack32"),     # G = s_eff = 200
    (dict(dtype=torch.bfloat16, d=160, p_tile=128, s_eff=640, k_pair=10,
          pack32=True), "pack32"),          # d > 128
    (dict(dtype=torch.bfloat16, d=100, p_tile=128, s_eff=640, k_pair=10,
          pack32=False), "exact"),          # d % 8 != 0
    (dict(dtype=torch.bfloat16, d=128, p_tile=128, s_eff=640, k_pair=17,
          pack32=False), "exact"),          # the lists hold 16
    (dict(dtype=torch.bfloat16, d=128, p_tile=128, s_eff=2048, k_pair=49,
          pack32=True), "pack32"),          # the shared lists hold 48
    (dict(dtype=torch.bfloat16, d=128, p_tile=120, s_eff=640, k_pair=10,
          pack32=True), "pack32"),          # not whole m tiles
    (dict(dtype=torch.bfloat16, d=128, p_tile=256, s_eff=640, k_pair=10,
          pack32=False), "exact"),          # more probers than 8 x 16
    (dict(dtype=torch.bfloat16, d=128, p_tile=128, s_eff=200, k_pair=10,
          pack32=True), "pack32"),          # G = s_eff = 200
    (dict(dtype=torch.bfloat16, d=128, p_tile=128, s_eff=200, k_pair=10,
          pack32=False), "tc_exact"),       # a ragged last tile
])
def test_pick_route(shape, route):
    assert bs.pick_route(**shape) == route
    assert route in bs.launches


def test_launch_refuses_a_route_that_does_not_fit():
    """launch() checks the route against pick_route before it touches the
    library (None here): the tensor-core route for exact k_pair 20 or an
    f32 cache, a route of the other select, and a bf16 route for an int8
    cache."""
    args = _integer_case(s_eff=256, seed=1)
    kw = dict(s_eff=256, euclidean=True, pack32=False, slot_mask=255)
    with pytest.raises(ValueError, match="tensor-core"):
        bs.launch(None, 0, *args, route="tc_exact", k_pair=20, **kw)
    with pytest.raises(ValueError, match="select"):
        bs.launch(None, 0, *args, route="tc_pack32", k_pair=10, **kw)
    f32 = list(args)
    f32[0], f32[6] = args[0].float(), args[6].float()
    with pytest.raises(ValueError, match="tensor-core"):
        bs.launch(None, 0, *f32, route="tc_exact", k_pair=10, **kw)
    i8 = list(args)
    i8[0], i8[6] = args[0].to(torch.int8), args[6].to(torch.int8)
    with pytest.raises(ValueError, match="select"):
        bs.launch(None, 0, *i8, route="exact", k_pair=10, **kw)
    with pytest.raises(ValueError, match="select"):
        bs.launch(None, 0, *i8, route="tc_exact", k_pair=10, **kw)
    with pytest.raises(ValueError, match="select"):
        bs.launch(None, 0, *args, route="tc_int8_exact", k_pair=10, **kw)


@pytest.mark.parametrize("d,p_tile,k_pair,pack32,s_eff", [
    (1040, 128, 10, False, 256),  # wider than the 1,024-byte rows
    (136, 128, 10, True, 256),    # rows not of 16-byte pieces
    (128, 128, 17, False, 256),   # the exact lists hold 16
    (128, 128, 49, True, 2048),   # the pack32 lists hold 48
    (128, 120, 10, True, 256),    # not whole m tiles
    (1024, 128, 10, True, 200),   # G = s_eff = 200 > one tile
])
def test_launch_refuses_the_int8_tensor_core_route(d, p_tile, k_pair, pack32,
                                                   s_eff):
    """launch(route="tc_int8_*") raises for int8 shapes the tensor-core
    kernel does not take, before it touches the library (None here); the
    CUDA-core int8 route is what pick_route names for them."""
    args, scale, q_scale = bs.int8_tie_inputs(
        "cpu", s_eff=s_eff, n_blocks=2, nq=20, d=d, cap_total=2048, seed=d)
    args[1] = args[1][:, :p_tile].contiguous()
    mode = "pack32" if pack32 else "exact"
    assert bs.pick_route(dtype=torch.int8, d=d, p_tile=p_tile, s_eff=s_eff,
                         k_pair=k_pair, pack32=pack32) == "int8_" + mode
    with pytest.raises(ValueError, match="tensor-core"):
        bs.launch(None, 0, *args, route="tc_int8_" + mode, s_eff=s_eff,
                  k_pair=k_pair, euclidean=True, pack32=pack32,
                  slot_mask=bs.util.next_pow2(s_eff) - 1, scale=scale,
                  q_scale=q_scale)

