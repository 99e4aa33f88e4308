"""The block scan's integer-valued inputs, its routes and the launch hook's
refusals, on the CPU.

`integer_block_inputs` (ops/block_scan.py) is what the card holds the
tensor-core block scans (csrc/block_scan_wg.cu) to bit for bit: every score
is an integer that f32 sums hold exactly in any order, with runs of equal
rows so that exact ties occur. Here the plain version `block_scan_ref` is
held to the JAX package's Pallas kernel (interpret mode, through
tests/conftest.py) on those inputs, bit for bit, keys and addresses, pad
rows included (both score them with query 0). `pick_route` is checked
against the shapes each kernel takes (the warp-specialised routes, bf16
and int8, narrow and k-chunked, their deep pack32 selects among them;
CUDA-core ones),
`launch` against the routes it refuses, and the shared memory mirrors that
decide the routes against the headers' formulas."""

import re
from pathlib import Path

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
          pack32=False), "tc_wgn_exact"),   # the main path, exact
    (dict(dtype=torch.bfloat16, d=128, p_tile=128, s_eff=640, k_pair=10,
          pack32=True), "tc_wgn_pack32"),   # the main path, G = 128
    (dict(dtype=torch.bfloat16, d=128, p_tile=128, s_eff=2048, k_pair=40,
          pack32=True), "tc_wgn_pack32"),   # G = 512, 4 tiles a phase
    (dict(dtype=torch.bfloat16, d=128, p_tile=128, s_eff=512, k_pair=40,
          pack32=True), "tc_wgn_pack32"),   # G = 256, 2 tiles a phase
    (dict(dtype=torch.bfloat16, d=32, p_tile=128, s_eff=96, k_pair=10,
          pack32=True), "tc_wgn_pack32"),   # G = s_eff, one tile
    (dict(dtype=torch.bfloat16, d=40, p_tile=64, s_eff=1024, k_pair=16,
          pack32=False), "tc_wgn_exact"),   # ends in half a k step
    (dict(dtype=torch.float32, d=128, p_tile=128, s_eff=640, k_pair=10,
          pack32=False), "exact"),          # f32 cache
    (dict(dtype=torch.int8, d=128, p_tile=128, s_eff=640, k_pair=10,
          pack32=True), "tc_wgn_int8_pack32"),  # the int8 tier, s8 wgmma
    (dict(dtype=torch.int8, d=128, p_tile=128, s_eff=640, k_pair=10,
          pack32=False), "tc_wgn_int8_exact"),  # the int8 tier's exact plan
    (dict(dtype=torch.int8, d=256, p_tile=128, s_eff=640, k_pair=16,
          pack32=False), "tc_wgn_int8_exact"),  # the widest narrow row
    (dict(dtype=torch.int8, d=288, p_tile=128, s_eff=640, k_pair=10,
          pack32=True), "tc_wg_int8_pack32"),  # three stages a tile
    (dict(dtype=torch.int8, d=1024, p_tile=128, s_eff=640, k_pair=10,
          pack32=True), "tc_wg_int8_pack32"),  # the GIST-class cache
    (dict(dtype=torch.int8, d=1024, p_tile=128, s_eff=2048, k_pair=48,
          pack32=True), "tc_wg_int8_pack32"),  # G = 512 at d = 1024
    (dict(dtype=torch.int8, d=1040, p_tile=128, s_eff=640, k_pair=10,
          pack32=False), "int8_exact"),     # wider than 1024 bytes
    (dict(dtype=torch.int8, d=136, p_tile=128, s_eff=640, k_pair=10,
          pack32=True), "int8_pack32"),     # d % 16 != 0
    (dict(dtype=torch.int8, d=128, p_tile=128, s_eff=640, k_pair=17,
          pack32=False), "int8_exact"),     # the lists hold 16
    (dict(dtype=torch.int8, d=128, p_tile=128, s_eff=2048, k_pair=49,
          pack32=True), "tc_wgn_int8_pack32"),  # G = 512: 4 tiles a phase
    (dict(dtype=torch.int8, d=256, p_tile=128, s_eff=4096, k_pair=64,
          pack32=True), "tc_wgn_int8_pack32"),  # G = 512: 8 tiles a phase
    (dict(dtype=torch.int8, d=1024, p_tile=128, s_eff=2048, k_pair=49,
          pack32=True), "tc_wg_int8_pack32"),  # k-chunked: four stages
    (dict(dtype=torch.int8, d=1024, p_tile=128, s_eff=4096, k_pair=64,
          pack32=True), "tc_wg_int8_pack32"),  # 204,416 B at k_pair 64
    (dict(dtype=torch.int8, d=128, p_tile=120, s_eff=640, k_pair=10,
          pack32=True), "int8_pack32"),     # not whole m tiles
    (dict(dtype=torch.int8, d=1024, p_tile=128, s_eff=200, k_pair=10,
          pack32=True), "int8_pack32"),     # G = s_eff = 200
    (dict(dtype=torch.bfloat16, d=160, p_tile=128, s_eff=640, k_pair=10,
          pack32=True), "tc_wg_pack32"),    # d > 128: k chunks, wgmma
    (dict(dtype=torch.bfloat16, d=100, p_tile=128, s_eff=640, k_pair=10,
          pack32=False), "exact"),          # d % 8 != 0
    (dict(dtype=torch.bfloat16, d=128, p_tile=128, s_eff=640, k_pair=17,
          pack32=False), "exact"),          # the lists hold 16
    (dict(dtype=torch.bfloat16, d=128, p_tile=128, s_eff=2048, k_pair=49,
          pack32=True), "tc_wgn_pack32"),   # the deep select: 49-64
    (dict(dtype=torch.bfloat16, d=128, p_tile=128, s_eff=4096, k_pair=64,
          pack32=True), "tc_wgn_pack32"),   # the deep-k head, G = 512
    (dict(dtype=torch.bfloat16, d=128, p_tile=128, s_eff=512, k_pair=64,
          pack32=True), "tc_wgn_pack32"),   # the untapered deep-k, G = 256
    (dict(dtype=torch.bfloat16, d=128, p_tile=128, s_eff=4096, k_pair=65,
          pack32=True), "pack32"),          # past the lists' 64
    (dict(dtype=torch.bfloat16, d=128, p_tile=120, s_eff=640, k_pair=10,
          pack32=True), "pack32"),          # not whole m tiles
    (dict(dtype=torch.bfloat16, d=128, p_tile=256, s_eff=640, k_pair=10,
          pack32=False), "exact"),          # more probers than 8 x 16
    (dict(dtype=torch.bfloat16, d=128, p_tile=128, s_eff=200, k_pair=10,
          pack32=True), "pack32"),          # G = s_eff = 200
    (dict(dtype=torch.bfloat16, d=128, p_tile=128, s_eff=200, k_pair=10,
          pack32=False), "tc_wgn_exact"),   # a ragged last tile
    # the GIST-class bf16 cache (d 1024: 2,048-byte rows in 256-byte k
    # chunks), exact and pack32 over G = 128 and 512, on the
    # warp-specialised route (wgmma, TMA ring)
    (dict(dtype=torch.bfloat16, d=1024, p_tile=128, s_eff=2048, k_pair=10,
          pack32=False), "tc_wg_exact"),    # 194,656 B
    (dict(dtype=torch.bfloat16, d=1024, p_tile=128, s_eff=2048, k_pair=16,
          pack32=False), "tc_wg_exact"),    # 200,800 B
    (dict(dtype=torch.bfloat16, d=1024, p_tile=128, s_eff=640, k_pair=10,
          pack32=True), "tc_wg_pack32"),    # G = 128
    (dict(dtype=torch.bfloat16, d=1024, p_tile=128, s_eff=2048, k_pair=10,
          pack32=True), "tc_wg_pack32"),    # the records' k = 10, G = 128
    (dict(dtype=torch.bfloat16, d=1024, p_tile=128, s_eff=2048, k_pair=48,
          pack32=True), "tc_wg_pack32"),    # G = 512, 227,472 B: 5 stages
    (dict(dtype=torch.bfloat16, d=1024, p_tile=128, s_eff=2048, k_pair=64,
          pack32=True), "tc_wg_pack32"),    # the records' k = 100: 4 stages
    (dict(dtype=torch.bfloat16, d=1024, p_tile=128, s_eff=512, k_pair=64,
          pack32=True), "tc_wg_pack32"),    # G = 256
    (dict(dtype=torch.bfloat16, d=1024, p_tile=128, s_eff=640, k_pair=17,
          pack32=False), "exact"),          # the lists hold 16
    (dict(dtype=torch.bfloat16, d=1032, p_tile=128, s_eff=640, k_pair=10,
          pack32=True), "pack32"),          # a row over 2,048 bytes
    (dict(dtype=torch.bfloat16, d=200, p_tile=128, s_eff=640, k_pair=10,
          pack32=False), "tc_wg_exact"),    # ends in half a k step
    (dict(dtype=torch.int8, d=288, p_tile=128, s_eff=2048, k_pair=64,
          pack32=True), "tc_wg_int8_pack32"),  # the deep select at d 288
    # the warp-specialised route's edges: bf16 rows over 256 bytes only
    (dict(dtype=torch.bfloat16, d=136, p_tile=128, s_eff=640, k_pair=16,
          pack32=False), "tc_wg_exact"),    # the narrowest k-chunked row
    (dict(dtype=torch.bfloat16, d=128, p_tile=128, s_eff=2048, k_pair=10,
          pack32=False), "tc_wgn_exact"),   # the narrow rows' widest
    (dict(dtype=torch.bfloat16, d=1024, p_tile=64, s_eff=2048, k_pair=49,
          pack32=True), "tc_wg_pack32"),    # one 64-prober tile a block
    (dict(dtype=torch.bfloat16, d=1024, p_tile=120, s_eff=640, k_pair=10,
          pack32=False), "exact"),          # not whole m tiles
    (dict(dtype=torch.bfloat16, d=1024, p_tile=128, s_eff=200, k_pair=10,
          pack32=True), "pack32"),          # G = s_eff = 200
    (dict(dtype=torch.int8, d=1024, p_tile=128, s_eff=2048, k_pair=10,
          pack32=False), "tc_wg_int8_exact"),  # one s32 chain a row
    # the narrow warp-specialised instances (d <= 128: the query rows
    # resident), every bf16 shape the mma.sync kernel took
    (dict(dtype=torch.bfloat16, d=8, p_tile=16, s_eff=640, k_pair=10,
          pack32=False), "tc_wgn_exact"),   # one k step, one 16-prober tile
    (dict(dtype=torch.bfloat16, d=64, p_tile=64, s_eff=640, k_pair=16,
          pack32=True), "tc_wgn_pack32"),   # one stage a tile
    (dict(dtype=torch.bfloat16, d=72, p_tile=128, s_eff=4096, k_pair=48,
          pack32=True), "tc_wgn_pack32"),   # two stages, the second 8 wide
    (dict(dtype=torch.bfloat16, d=128, p_tile=128, s_eff=2560, k_pair=10,
          pack32=True), "tc_wgn_pack32"),   # the 4-bit record, G = 128
    (dict(dtype=torch.bfloat16, d=128, p_tile=128, s_eff=4096, k_pair=16,
          pack32=True), "tc_wgn_pack32"),   # the deep-k tail, G = 128
    # pack32 above k_pair 16 on the narrow deep instance (the deep select)
    # however few window tiles a phase covers
    (dict(dtype=torch.bfloat16, d=128, p_tile=128, s_eff=640, k_pair=17,
          pack32=True), "tc_wgn_pack32"),   # G = 128: 5 tiles, one phase
    (dict(dtype=torch.bfloat16, d=128, p_tile=128, s_eff=640, k_pair=64,
          pack32=True), "tc_wgn_pack32"),   # the residual k = 100
    (dict(dtype=torch.bfloat16, d=128, p_tile=128, s_eff=2048, k_pair=64,
          pack32=True), "tc_wgn_pack32"),   # pqr3 k = 100: 4 tiles
    (dict(dtype=torch.bfloat16, d=128, p_tile=128, s_eff=1024, k_pair=64,
          pack32=True), "tc_wgn_pack32"),   # G = 512: 2 tiles
    (dict(dtype=torch.bfloat16, d=128, p_tile=128, s_eff=4096, k_pair=17,
          pack32=True), "tc_wgn_pack32"),   # G = 128: 32 tiles
    (dict(dtype=torch.bfloat16, d=128, p_tile=128, s_eff=2304, k_pair=40,
          pack32=True), "tc_wgn_pack32"),   # G = 256: 9 tiles
    (dict(dtype=torch.bfloat16, d=136, p_tile=128, s_eff=512, k_pair=64,
          pack32=True), "tc_wg_pack32"),    # k chunks, the deep select
    (dict(dtype=torch.bfloat16, d=136, p_tile=128, s_eff=640, k_pair=10,
          pack32=True), "tc_wg_pack32"),    # past 256 bytes: k chunks
    # the int8 warp-specialised instances (s8 wgmma k32): narrow up to 256
    # bytes a row, k-chunked up to 1,024, every select they take, pack32
    # above k_pair 16 of narrow rows whatever the tiles of a phase
    (dict(dtype=torch.int8, d=16, p_tile=128, s_eff=640, k_pair=10,
          pack32=False), "tc_wgn_int8_exact"),  # half a k32 step
    (dict(dtype=torch.int8, d=160, p_tile=64, s_eff=640, k_pair=16,
          pack32=True), "tc_wgn_int8_pack32"),  # two stages, the second 32 B
    (dict(dtype=torch.int8, d=272, p_tile=128, s_eff=640, k_pair=16,
          pack32=False), "tc_wg_int8_exact"),  # the narrowest k-chunked
    (dict(dtype=torch.int8, d=128, p_tile=128, s_eff=4096, k_pair=64,
          pack32=True), "tc_wgn_int8_pack32"),  # G = 512: 8 tiles a phase
    (dict(dtype=torch.int8, d=128, p_tile=128, s_eff=640, k_pair=17,
          pack32=True), "tc_wgn_int8_pack32"),  # G = 128: 5 tiles, one phase
    (dict(dtype=torch.int8, d=256, p_tile=128, s_eff=512, k_pair=40,
          pack32=True), "tc_wgn_int8_pack32"),  # G = 256: 2 tiles
    (dict(dtype=torch.int8, d=128, p_tile=128, s_eff=512, k_pair=64,
          pack32=True), "tc_wgn_int8_pack32"),  # G = 256: 2 tiles, k_pair 64
    (dict(dtype=torch.int8, d=128, p_tile=128, s_eff=640, k_pair=64,
          pack32=True), "tc_wgn_int8_pack32"),  # G = 128: 5 tiles, k_pair 64
    (dict(dtype=torch.int8, d=256, p_tile=128, s_eff=2048, k_pair=64,
          pack32=True), "tc_wgn_int8_pack32"),  # the widest narrow, 4 tiles
    (dict(dtype=torch.int8, d=64, p_tile=64, s_eff=1024, k_pair=48,
          pack32=True), "tc_wgn_int8_pack32"),  # G = 512: 2 tiles, 64 probers
    (dict(dtype=torch.int8, d=128, p_tile=128, s_eff=4096, k_pair=17,
          pack32=True), "tc_wgn_int8_pack32"),  # G = 128: 32 tiles
    (dict(dtype=torch.int8, d=272, p_tile=128, s_eff=512, k_pair=64,
          pack32=True), "tc_wg_int8_pack32"),  # k-chunked, the deep select
    (dict(dtype=torch.int8, d=1008, p_tile=32, s_eff=200, k_pair=16,
          pack32=False), "tc_wg_int8_exact"),  # a ragged tile and row
    (dict(dtype=torch.int8, d=1024, p_tile=128, s_eff=2048, k_pair=65,
          pack32=True), "int8_pack32"),     # past the lists' 64
])
def test_pick_route(shape, route):
    assert bs.pick_route(**shape) == route
    assert route in bs.launches


def test_launch_refuses_a_route_that_does_not_fit():
    """launch() checks the route against pick_route before it touches the
    library (None here): the tensor-core route for exact k_pair 20 or an
    f32 cache, a route of the other select, a bf16 route for an int8 cache
    and the bf16 mma.sync route, which no kernel serves now."""
    args = _integer_case(s_eff=256, seed=1)
    kw = dict(s_eff=256, euclidean=True, pack32=False, slot_mask=255)
    with pytest.raises(ValueError, match="tensor-core"):
        bs.launch(None, 0, *args, route="tc_wgn_exact", k_pair=20, **kw)
    with pytest.raises(ValueError, match="select"):
        bs.launch(None, 0, *args, route="tc_wgn_pack32", k_pair=10, **kw)
    with pytest.raises(ValueError, match="select"):
        bs.launch(None, 0, *args, route="tc_exact", k_pair=10, **kw)
    f32 = list(args)
    f32[0], f32[6] = args[0].float(), args[6].float()
    with pytest.raises(ValueError, match="tensor-core"):
        bs.launch(None, 0, *f32, route="tc_wgn_exact", k_pair=10, **kw)
    i8 = list(args)
    i8[0], i8[6] = args[0].to(torch.int8), args[6].to(torch.int8)
    with pytest.raises(ValueError, match="select"):
        bs.launch(None, 0, *i8, route="exact", k_pair=10, **kw)
    with pytest.raises(ValueError, match="select"):
        bs.launch(None, 0, *i8, route="tc_wgn_exact", k_pair=10, **kw)
    with pytest.raises(ValueError, match="select"):
        bs.launch(None, 0, *args, route="tc_wgn_int8_exact", k_pair=10, **kw)


@pytest.mark.parametrize("d,dtype,k_pair,match", [
    (32, torch.bfloat16, 10, "tensor-core"),   # rows of 64 bytes: narrow
    (128, torch.bfloat16, 10, "tensor-core"),  # the narrow instances' widest
    (1040, torch.bfloat16, 10, "tensor-core"),  # a row over 2,048 bytes
    (1024, torch.bfloat16, 17, "tensor-core"),  # the exact lists hold 16
    (1024, torch.float32, 10, "tensor-core"),   # an f32 cache
    (1024, torch.int8, 10, "select"),           # an int8 cache
])
def test_launch_refuses_the_wg_route(d, dtype, k_pair, match):
    """launch(route="tc_wg_exact") raises for shapes the warp-specialised
    kernel does not take, before it touches the library (None here)."""
    args = bs.random_inputs("cpu", s_eff=256, n_blocks=2, nq=20, d=d,
                            cap_total=2048, dtype=dtype, seed=d)
    kw = dict(s_eff=256, euclidean=True, pack32=False, slot_mask=255)
    with pytest.raises(ValueError, match=match):
        bs.launch(None, 0, *args, route="tc_wg_exact", k_pair=k_pair, **kw)


@pytest.mark.parametrize("d,p_tile,k_pair,pack32,s_eff", [
    (1040, 128, 10, False, 256),  # wider than the 1,024-byte rows
    (136, 128, 10, True, 256),    # rows not of 16-byte pieces
    (128, 128, 17, False, 256),   # the exact lists hold 16
    (1024, 128, 65, True, 2048),  # past the lists' 64
    (128, 120, 10, True, 256),    # not whole m tiles
    (1024, 128, 10, True, 200),   # G = s_eff = 200 > one tile
])
def test_launch_refuses_the_int8_tensor_core_route(d, p_tile, k_pair, pack32,
                                                   s_eff):
    """launch(route=) of the int8 warp-specialised instances of these rows'
    family ("tc_wgn_int8_*" up to 256 bytes, "tc_wg_int8_*" above) raises
    for int8 shapes the tensor-core kernels do not take, before it touches
    the library (None here); the CUDA-core int8 route is what pick_route
    names for them; and no mma.sync route serves an int8 cache
    (its "tc_int8_*" routes are refused as routes of no select)."""
    args, scale, q_scale = bs.int8_tie_inputs(
        "cpu", s_eff=s_eff, n_blocks=2, nq=20, d=d, cap_total=2048, seed=d)
    args[1] = args[1][:, :p_tile].contiguous()
    mode = "pack32" if pack32 else "exact"
    assert bs.pick_route(dtype=torch.int8, d=d, p_tile=p_tile, s_eff=s_eff,
                         k_pair=k_pair, pack32=pack32) == "int8_" + mode
    family = "tc_wgn_" if d <= 256 else "tc_wg_"
    for route, match in ((family + "int8_" + mode, "tensor-core"),
                         ("tc_int8_" + mode, "select")):
        with pytest.raises(ValueError, match=match):
            bs.launch(None, 0, *args, route=route, s_eff=s_eff,
                      k_pair=k_pair, euclidean=True, pack32=pack32,
                      slot_mask=bs.util.next_pow2(s_eff) - 1, scale=scale,
                      q_scale=q_scale)



_HEADER = Path(bs.__file__).resolve().parents[1] / "csrc" / "scan_tc.cuh"
_WG_HEADER = _HEADER.with_name("wg_layout.cuh")


def _header_constants(header=_HEADER):
    """The namespace-level `constexpr int` constants of csrc/scan_tc.cuh
    (or `header`), evaluated in order (each is a literal or an expression
    of earlier ones)."""
    env = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);",
                                 header.read_text(), re.M):
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))
    return env


def test_header_constants_mirror():
    """The select helpers' constants of csrc/scan_tc.cuh (consumer warps,
    tile columns, probers a block, staging stride, queue, the lists' largest
    k_pair) are ops/block_scan.py's _TC_* mirrors; the header keeps no row
    widths or chunks of a scan body of its own (the rows are
    block_scan_wg.cu's, whose limits wg_layout.cuh holds, with the shared
    memory limit)."""
    c = _header_constants()
    assert (c["WARPS"], c["TN"], c["MAX_PT"], c["SLD"], c["QUEUE"],
            c["MAX_PACK_K"], c["MAX_EXACT_K"]) == (
        bs._TC_WARPS, bs._TC_TN, bs._TC_MAX_PT, bs._TC_SLD, bs._TC_QUEUE,
        bs._TC_MAX_PACK_K, bs._TC_KMAX)
    assert not {"CHUNK", "MAX_CHUNKED_ROW", "MAX_ROW", "KSTEPS"} & set(c)
    wg = _header_constants(_WG_HEADER)
    assert (wg["MAX_ROW_BF16"], wg["MAX_ROW_I8"]) == (
        bs._WG_MAX_ROW_BF16, bs._WG_MAX_ROW_I8)
    limit = re.search(r"constexpr size_t SMEM_LIMIT = (\d+);",
                      _WG_HEADER.read_text())
    assert int(limit.group(1)) == bs._SMEM_LIMIT


@pytest.mark.parametrize("pack32", [False, True])
def test_wg_smem_mirror_equals_header(pack32):
    """ops/block_scan.py:wg_smem_bytes, which pick_route reads without the
    library, equals csrc/wg_layout.cuh:smem_bytes transcribed over the
    header's own constants (alignment slack, the instance's ring stages of
    two [128][128 B] tiles, penalties and two barriers, prober rows, tile
    flags, then pack32 above k_pair 16 the deep select's arrays
    (csrc/deep_select.cuh: the warps' staging rows, one running list a row
    and counts), else the slice lists, then pack32's two running lists or
    exact's values, staging rows, row bounds and queues) at every k_pair of
    each instance: exact k_pair 1-10 (five stages) and 11-16 (four); pack32
    1-16 (six) and 17-64 (four); the header's constants are
    the mirror's and scan_tc.cuh's, every such shape fits the limit, and
    one more stage would not at each instance's largest k_pair."""
    c = _header_constants(_WG_HEADER)
    t = _header_constants()
    ds = _header_constants(_HEADER.with_name("deep_select.cuh"))
    assert (c["SW_ATOM"], c["STAGE_BYTES"], c["BOX_ROWS"], c["RING_EXACT_10"],
            c["RING_EXACT"], c["RING_PACK_16"], c["RING_DEEP"]) == (
        bs._WG_SW_ATOM, bs._WG_STAGE_BYTES, bs._WG_BOX_ROWS,
        bs._WG_RING_EXACT_10, bs._WG_RING_EXACT, bs._WG_RING_PACK_16,
        bs._WG_RING_DEEP)
    assert (c["MAX_PT"], c["WARPS"], c["SLD"], c["QUEUE"], c["CONSUMERS"]) \
        == (t["MAX_PT"], t["WARPS"], t["SLD"], t["QUEUE"], t["THREADS"])
    assert (ds["SHALLOW_K"], ds["MAX_K"], ds["SLOTS"], ds["SST"],
            ds["ROWS"], ds["WARPS"]) == (
        bs._DS_SHALLOW_K, bs._DS_MAX_K, bs._DS_SLOTS, bs._DS_SST,
        c["MAX_PT"], c["WARPS"])

    def header(k_pair, ring):
        kls = k_pair | 1 if pack32 else k_pair
        if pack32 and k_pair > ds["SHALLOW_K"]:
            select = 4 * (ds["WARPS"] * ds["SLOTS"] * ds["SST"]
                          + ds["ROWS"] * (kls + 2))
        else:
            select = 4 * c["WARPS"] * 16 * kls + (
                2 * 4 * c["MAX_PT"] * kls if pack32 else
                4 * c["WARPS"] * 16 * k_pair
                + 4 * c["WARPS"] * 16 * (c["SLD"] + 1)
                + 8 * c["QUEUE"] * c["CONSUMERS"])
        return (c["SW_ATOM"] + ring * (2 * c["STAGE_BYTES"]
                                       + 4 * c["BOX_ROWS"] + 16)
                + 4 * c["MAX_PT"] + 4 * 8 + select)

    if pack32:
        tops = ((16, c["RING_PACK_16"]), (64, c["RING_DEEP"]))
    else:
        tops = ((10, c["RING_EXACT_10"]), (16, c["RING_EXACT"]))
    lo = 1
    for top, ring in tops:
        for k_pair in range(lo, top + 1):
            want = header(k_pair, ring)
            assert bs.wg_smem_bytes(pack32, k_pair) == want, k_pair
            assert want <= bs._SMEM_LIMIT
            assert bs.wg_shapes_ok(d=1024, p_tile=128, s_eff=2048,
                                   k_pair=k_pair, pack32=pack32)
        assert header(top, ring + 1) > bs._SMEM_LIMIT, (top, ring)
        lo = top + 1


@pytest.mark.parametrize("d,dtype,k_pair,match", [
    (136, torch.bfloat16, 10, "tensor-core"),  # past 256 bytes: k chunks
    (100, torch.bfloat16, 10, "tensor-core"),  # d % 8 != 0
    (128, torch.bfloat16, 17, "tensor-core"),  # the exact lists hold 16
    (128, torch.float32, 10, "tensor-core"),   # an f32 cache
    (128, torch.int8, 10, "select"),           # an int8 cache
])
def test_launch_refuses_the_narrow_route(d, dtype, k_pair, match):
    """launch(route="tc_wgn_exact") raises for shapes the narrow
    warp-specialised instances do not take, before it touches the library
    (None here)."""
    args = bs.random_inputs("cpu", s_eff=256, n_blocks=2, nq=20, d=d,
                            cap_total=2048, dtype=dtype, seed=d)
    kw = dict(s_eff=256, euclidean=True, pack32=False, slot_mask=255)
    with pytest.raises(ValueError, match=match):
        bs.launch(None, 0, *args, route="tc_wgn_exact", k_pair=k_pair, **kw)
