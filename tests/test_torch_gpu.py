"""The port's CUDA kernels (block scan on its warp-specialised routes, bf16
and int8, narrow and k-chunked, their deep pack32 selects among them, and
in its bf16/f32 and int8 modes on the CUDA cores, codes scan and flat scan
on their tensor-core and CUDA-core routes, row gather)
against their plain PyTorch versions, and the device spill routing against
its CPU result, on a card; the indexes card against CPU; the sharded
searcher and data-parallel k-means over a world of one NCCL rank, the host
spill, the v1 facade and the profiling helpers on the card; util.matmul's
three precisions against their plain versions (the tests holding a card
result to the CPU's search at "highest", since the CPU computes f32 at
every precision).

Marked `gpu`: without a CUDA card every test here skips. This file imports
neither JAX nor the JAX package, so it also runs where JAX is not
installed, without the repository's conftest:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from torchpq_tpu_torch.ops import adc
from torchpq_tpu_torch.ops import block_scan as bs
from torchpq_tpu_torch.ops import codes_scan as cs
from torchpq_tpu_torch.ops import flat_adc
from torchpq_tpu_torch.ops import flat_scan as fs
from torchpq_tpu_torch.ops import gather as gr

from _torch_helpers import seed_fits


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def f32_search():
    """The search precision "highest" for the test, then restored: a card
    result held to the CPU's compares the algorithm, and the CPU computes
    f32 at every precision."""
    from torchpq_tpu_torch import config
    keep = config.SEARCH_PRECISION
    config.set_search_precision("highest")
    yield
    config.set_search_precision(keep)


def _block_launch(args, kw):
    """One block_scan call on the card: (output, route), with the route's
    launch counted once and no other key moved."""
    route = bs.pick_route(dtype=args[6].dtype, d=args[6].shape[1],
                          p_tile=args[1].shape[1], s_eff=kw["s_eff"],
                          k_pair=kw["k_pair"], pack32=kw["pack32"])
    before = dict(bs.launches)
    got = bs.block_scan(*args, **kw)
    torch.cuda.synchronize()
    assert bs.launches == dict(before, **{route: before[route] + 1})
    return got, route


def _block_uncounted(args, kw, route, **extra):
    """The block scan's kernel of `route` on args through launch(), no
    launch counted."""
    from torchpq_tpu_torch import _build
    before = dict(bs.launches)
    got = bs.launch(_build.library(), torch.cuda.current_stream().cuda_stream,
                    *args, route=route, **kw, **extra)
    torch.cuda.synchronize()
    assert bs.launches == before
    return got


def _assert_close_rows(got, ref, k_pair, pack32):
    """Rows of the kernel against the plain version's: the kernels sum in
    another order than the plain version's GEMM (bf16 products are exact
    in f32), so exact values agree to 1e-3 relative and addresses and
    pack32 keys on >= 0.99 of entries."""
    if pack32:
        assert (got == ref).float().mean().item() >= 0.99
        return
    v = bs.sortable_i32_to_f32(got[..., :k_pair])
    v_ref = bs.sortable_i32_to_f32(ref[..., :k_pair])
    torch.testing.assert_close(v, v_ref, rtol=1e-3, atol=1e-3)
    assert (got[..., k_pair:] == ref[..., k_pair:]).float().mean() \
        .item() >= 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pack32", [False, True])
@pytest.mark.parametrize("s_eff,k_pair", [(512, 10), (512, 40), (1024, 40)])
def test_kernel_matches_plain(cuda, dtype, pack32, s_eff, k_pair):
    """Through the kernel pick_route names: bf16 takes the tensor-core one
    (exact k_pair 40: the CUDA-core one), f32 the CUDA-core one. (1024, 40)
    selects over 512 strided groups (64 probers per CTA on the CUDA cores).
    Rows to the tolerances of _assert_close_rows: every row from the
    CUDA-core kernel (it scores pad rows with query 0, as the plain version
    does), the live rows from the tensor-core one, whose pad rows are dead
    (_assert_pads)."""
    args = bs.random_inputs(cuda, s_eff=s_eff, n_blocks=64, nq=500,
                            cap_total=8192, dtype=dtype)
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=True, pack32=pack32,
              slot_mask=s_eff - 1)
    mode = "pack32" if pack32 else "exact"
    got, route = _block_launch(args, kw)
    tc = dtype == torch.bfloat16 and (pack32 or k_pair <= 16)
    assert route == ("tc_wgn_" if tc else "") + mode
    ref = bs.block_scan_ref(*args, **kw)
    if tc:
        _assert_pads(got, ref, args[1], route, k_pair, pack32)
        live = args[1] >= 0
        got, ref = got[live], ref[live]
    _assert_close_rows(got, ref, k_pair, pack32)


@pytest.mark.gpu
@pytest.mark.parametrize("s_eff", [512, 640, 1024, 2048])
@pytest.mark.parametrize("pack32,k_pair", [(False, 10), (False, 16),
                                           (True, 10), (True, 40)])
def test_block_wgn_kernel_matches_plain(cuda, s_eff, pack32, k_pair):
    """The narrow warp-specialised block scan on random bf16 inputs at the
    main path's width (d = 128): s_eff 640 is the compacted layout's (a
    ragged pack32
    phase count of 5 tiles), pack32 k_pair 40 selects over 512 / 128 / 256
    / 512 strided groups. Live rows to the tolerances of
    _assert_close_rows, pad rows dead. The CUDA-core kernel, launched
    uncounted on the same inputs, matches the plain version on every row
    (it scores pad rows with query 0, as the plain version does)."""
    args = bs.random_inputs(cuda, s_eff=s_eff, n_blocks=64, nq=500,
                            cap_total=8192, seed=s_eff + k_pair)
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=True, pack32=pack32,
              slot_mask=bs.util.next_pow2(s_eff) - 1)
    mode = "pack32" if pack32 else "exact"
    got, route = _block_launch(args, kw)
    # pack32 k_pair 40: phases of 2-5 tiles, the deep select
    assert route == "tc_wgn_" + mode
    ref = bs.block_scan_ref(*args, **kw)
    _assert_pads(got, ref, args[1], route, k_pair, pack32)
    live = args[1] >= 0
    _assert_close_rows(got[live], ref[live], k_pair, pack32)
    _assert_close_rows(_block_uncounted(args, kw, mode), ref, k_pair, pack32)


@pytest.mark.gpu
@pytest.mark.parametrize("pack32,k_pair,s_eff", [
    (False, 10, 640), (False, 16, 200), (True, 10, 640), (True, 40, 2048),
    (True, 10, 96)])
@pytest.mark.parametrize("euclidean", [True, False])
@pytest.mark.parametrize("d", [128, 40])
def test_block_wgn_kernel_integer_ties_exact(cuda, pack32, k_pair, s_eff,
                                             euclidean, d):
    """Integer-valued inputs with runs of equal rows: every sum is exact in
    any order, so the narrow warp-specialised kernel equals the plain
    version bit for bit on live rows, keys, addresses and pack32 keys, ties
    included; pad rows dead. s_eff 200 has a ragged last tile, 96 is one
    tile of G = s_eff groups; d = 40 ends in half a k step (its last 8
    elements zero in both operands). The CUDA-core kernel, launched
    uncounted, equals the plain version on every row."""
    args = bs.integer_block_inputs(cuda, s_eff=s_eff, n_blocks=64, nq=500,
                                   d=d, cap_total=max(8192, 2 * s_eff),
                                   seed=d + s_eff)
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=euclidean,
              pack32=pack32, slot_mask=bs.util.next_pow2(s_eff) - 1)
    got, route = _block_launch(args, kw)
    assert route.startswith("tc_")
    ref = bs.block_scan_ref(*args, **kw)
    _assert_pads(got, ref, args[1], route, k_pair, pack32)
    live = args[1] >= 0
    assert torch.equal(got[live], ref[live])
    if not pack32:
        keys = ref[live][:, :k_pair]
        assert int((keys[:, 1:] == keys[:, :-1]).sum()) > 0, "no ties"
    mode = "pack32" if pack32 else "exact"
    assert torch.equal(_block_uncounted(args, kw, mode), ref)


@pytest.mark.gpu
@pytest.mark.parametrize("pack32,k_pair,s_eff", [
    (False, 10, 640), (False, 16, 1024), (True, 10, 640), (True, 40, 1024),
    (True, 64, 4096), (True, 64, 512)])
def test_block_wgn_kernel_persistent_grid(cuda, pack32, k_pair, s_eff):
    """A grid of 3 persistent CTAs over 64 blocks: each CTA walks ~21
    blocks, so the state it resets between blocks (live-tile rows, the
    pack32 phases of deep G = 512 and 256 and the running lists the deep
    select prunes by and merges into, the exact lists and queues, the
    resident query buffers and their barriers' phases, the ring in flight)
    is reused.
    Integer inputs: live rows equal the plain version bit for bit, pad rows
    dead."""
    args = bs.integer_block_inputs(cuda, s_eff=s_eff, n_blocks=64, nq=500,
                                   cap_total=8192, seed=k_pair)
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=True, pack32=pack32,
              slot_mask=bs.util.next_pow2(s_eff) - 1)
    route = bs.pick_route(dtype=torch.bfloat16, d=128, p_tile=128,
                          s_eff=s_eff, k_pair=k_pair, pack32=pack32)
    assert route.startswith("tc_")
    got = _block_uncounted(args, kw, route, n_ctas=3)
    ref = bs.block_scan_ref(*args, **kw)
    _assert_pads(got, ref, args[1], route, k_pair, pack32)
    live = args[1] >= 0
    assert torch.equal(got[live], ref[live])


@pytest.mark.gpu
@pytest.mark.parametrize("inputs", ["random", "integer"])
@pytest.mark.parametrize("pack32,k_pair,route", [
    (True, 64, "tc_wgn_pack32"), (True, 64, "pack32"),
    (True, 16, "tc_wgn_pack32"), (False, 64, "exact")])
def test_block_deepk_shapes_match_plain(cuda, pack32, k_pair, route, inputs):
    """The deep-k configuration's windows: supercells of 8 cells of 512
    slots (s_eff 4096), d 128, bf16. pack32 k_pair 64 selects over 512
    strided groups (the split's head) on the tensor cores, four phases of
    128 groups each; the CUDA-core kernel, forced with route="pack32",
    keeps it covered (its shared group maxima, 4 B x 512 x probers, fit
    only 64 probers per CTA, so the grid takes two CTAs per block). pack32
    k_pair 16 over 128 groups runs on the tensor cores (the tail, 32 column
    tiles); exact k_pair 64 on the CUDA cores. Integer inputs: equal to the
    plain version bit for bit (the tensor-core kernel on live rows, pad
    rows dead); random ones to the tolerances of _assert_close_rows."""
    s_eff = 4096
    make = bs.integer_block_inputs if inputs == "integer" else \
        bs.random_inputs
    args = make(cuda, s_eff=s_eff, n_blocks=48, nq=500, cap_total=16384,
                seed=k_pair + pack32)
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=True, pack32=pack32,
              slot_mask=s_eff - 1)
    if route == "pack32":
        from torchpq_tpu_torch import _build
        lib = _build.library()
        assert bs.n_groups(s_eff, k_pair) == 512
        assert bs._cta_probers(lambda pt: lib.torchpq_block_scan_smem(
            pt, 128, 1, 512, 1), 128) == 64
        assert bs.pick_route(dtype=torch.bfloat16, d=128, p_tile=128,
                             s_eff=s_eff, k_pair=k_pair,
                             pack32=True) == "tc_wgn_pack32"
        got = _block_uncounted(args, kw, route)
    else:
        got, r = _block_launch(args, kw)
        assert r == route
    ref = bs.block_scan_ref(*args, **kw)
    if route.startswith("tc_"):
        _assert_pads(got, ref, args[1], route, k_pair, pack32)
        live = args[1] >= 0
        got, ref = got[live], ref[live]
    if inputs == "integer":
        assert torch.equal(got, ref)
    else:
        _assert_close_rows(got, ref, k_pair, pack32)


@pytest.mark.gpu
@pytest.mark.parametrize("inputs", ["random", "integer"])
@pytest.mark.parametrize("k_pair", [49, 57, 64])
@pytest.mark.parametrize("s_eff", [512, 4096])
def test_block_wgn_deep_pack32_matches_plain(cuda, s_eff, k_pair, inputs):
    """pack32 k_pair 49-64, on the narrow deep instance (two query
    buffers, five ring stages, the deep select): over 256 strided
    groups at s_eff 512 (the untapered deep-k scan: two phases of 128
    groups) and 512 at s_eff 4096 (the split's head: four phases), d 128
    bf16; the slices of blocks with few live tiles hold fewer groups than
    k_pair. Integer inputs: live rows equal the plain version bit for bit,
    pad rows dead; random ones to the tolerances of _assert_close_rows. The
    CUDA-core kernel, launched uncounted, on every row."""
    make = bs.integer_block_inputs if inputs == "integer" else \
        bs.random_inputs
    args = make(cuda, s_eff=s_eff, n_blocks=48, nq=500, cap_total=16384,
                seed=s_eff + k_pair)
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=True, pack32=True,
              slot_mask=s_eff - 1)
    assert bs.n_groups(s_eff, k_pair) == (256 if s_eff == 512 else 512)
    got, route = _block_launch(args, kw)
    assert route == "tc_wgn_pack32"
    ref = bs.block_scan_ref(*args, **kw)
    _assert_pads(got, ref, args[1], route, k_pair, True)
    live = args[1] >= 0
    cc = _block_uncounted(args, kw, "pack32")
    if inputs == "integer":
        assert torch.equal(got[live], ref[live])
        assert torch.equal(cc, ref)
    else:
        _assert_close_rows(got[live], ref[live], k_pair, True)
        _assert_close_rows(cc, ref, k_pair, True)


# the deep pack32 select (csrc/deep_select.cuh, k_pair 17-64) over each
# group count it meets: (k_pair, s_eff) at G = s_eff (96: one tile), G =
# 128 (640: one phase of 5 tiles; 4096: 32 tiles), G = 256 (512: two phases
# of 2 tiles) and G = 512 (2048 and 4096: four phases of 4 and 8 tiles)
_DEEP_SELECTS = [(17, 96), (17, 640), (33, 512), (33, 2048), (48, 640),
                 (49, 2048), (57, 512), (64, 640), (64, 4096)]


def _deep_inputs(cuda, kind, d, s_eff, blocks, seed):
    """Block-scan inputs for the deep select's card tests: (args, extra
    kwargs) bf16 integer (`integer_block_inputs`), int8 with ties
    (`int8_tie_inputs`), or bf16 "ascending": zero cache rows and the
    penalty -row (exact scores start_c + slot, the whole window in the
    cell), so that every phase's group maxima beat all earlier ones and
    all survive the running lists' bounds."""
    if kind == "int8":
        args, scale, q_scale = bs.int8_tie_inputs(
            cuda, s_eff=s_eff, n_blocks=blocks, nq=500, d=d,
            cap_total=max(8192, 2 * s_eff), seed=seed)
        return args, dict(scale=scale, q_scale=q_scale)
    args = bs.integer_block_inputs(cuda, s_eff=s_eff, n_blocks=blocks,
                                   nq=500, d=d,
                                   cap_total=max(8192, 2 * s_eff), seed=seed)
    if kind == "ascending":
        args[6] = torch.zeros_like(args[6])
        args[5] = -torch.arange(args[5].numel(), device=cuda,
                                dtype=torch.float32)
        args[3] = torch.zeros_like(args[3])
        args[4] = torch.full_like(args[4], s_eff)
    return args, {}


@pytest.mark.gpu
@pytest.mark.parametrize("n_ctas", [None, 3])
@pytest.mark.parametrize("kind", ["bf16", "int8", "ascending"])
@pytest.mark.parametrize("k_pair,s_eff", _DEEP_SELECTS)
@pytest.mark.parametrize("d", [128, 1024])
def test_block_deep_select_matches_plain(cuda, d, k_pair, s_eff, kind,
                                         n_ctas):
    """The deep pack32 instances, narrow (d 128) and k-chunked (d 1024),
    bf16 and int8, at k_pair 17-64 over G = s_eff, 128, 256 and 512 strided
    groups, on the card's grid and on 3 persistent CTAs (each walking many
    blocks, its lists and staging rows reused): every sum exact (integer
    inputs, int8 ties), so the live rows equal block_scan_ref bit for bit;
    pad rows dead. "ascending": every phase's maxima survive the bounds
    (the staging's rounds past its 64 a row)."""
    args, extra = _deep_inputs(cuda, kind, d, s_eff,
                               32 if d > 128 else 64, d + k_pair + s_eff)
    dtype = torch.int8 if kind == "int8" else torch.bfloat16
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=True, pack32=True,
              slot_mask=bs.util.next_pow2(s_eff) - 1)
    route = bs.pick_route(dtype=dtype, d=d, p_tile=128, s_eff=s_eff,
                          k_pair=k_pair, pack32=True)
    assert route == ("tc_wgn_" if d <= 128 else "tc_wg_") + (
        "int8_" if kind == "int8" else "") + "pack32"
    got = _block_uncounted(args, dict(kw, **extra), route, n_ctas=n_ctas)
    ref = bs.block_scan_ref(*args, **kw, **extra)
    _assert_pads(got, ref, args[1], route, k_pair, True)
    live = args[1] >= 0
    assert torch.equal(got[live], ref[live])
    if kind == "ascending":  # the window's last slots win every row
        top = ref[live][:, 0] & kw["slot_mask"]
        assert bool((top >= s_eff - bs.n_groups(s_eff, k_pair)).all())


# the narrow warp-specialised instances' selects: exact k_pair 1 / 10 / 16
# (s_eff 200: a ragged last tile); pack32 over G = the whole row (96),
# 128, 256 and 512 strided groups (k_pair 48 / 64: the deep instance, at
# phases of 9 and 8 tiles, where pick_route keeps it)
_WGN_SELECTS = [(False, 1, 640), (False, 10, 640), (False, 16, 200),
                (True, 10, 96), (True, 16, 640), (True, 48, 2304),
                (True, 64, 4096)]


@pytest.mark.gpu
@pytest.mark.parametrize("euclidean", [True, False])
@pytest.mark.parametrize("pack32,k_pair,s_eff", _WGN_SELECTS)
@pytest.mark.parametrize("d", [8, 32, 64, 72, 128])
def test_block_wgn_integer_ties_exact(cuda, d, pack32, k_pair, s_eff,
                                      euclidean):
    """The narrow instances (d <= 128: one ring stage a tile up to d = 64,
    two above; d = 8 and 72 end in half a k step, zero in both operands)
    on integer inputs with runs of equal rows: live rows equal
    block_scan_ref bit for bit, ties included, pad rows dead; one launch
    counted under the route's own key."""
    if pack32:
        assert bs.n_groups(s_eff, k_pair) in (96, 128, 256, 512)
    args = bs.integer_block_inputs(cuda, s_eff=s_eff, n_blocks=48, nq=500,
                                   d=d, cap_total=max(8192, 2 * s_eff),
                                   seed=d + k_pair)
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=euclidean,
              pack32=pack32, slot_mask=bs.util.next_pow2(s_eff) - 1)
    got, route = _block_launch(args, kw)
    assert route == "tc_wgn_" + ("pack32" if pack32 else "exact")
    ref = bs.block_scan_ref(*args, **kw)
    _assert_pads(got, ref, args[1], route, k_pair, pack32)
    live = args[1] >= 0
    assert torch.equal(got[live], ref[live])


@pytest.mark.gpu
@pytest.mark.parametrize("pack32,k_pair,s_eff", [(False, 10, 640),
                                                 (True, 16, 640),
                                                 (True, 64, 4096)])
@pytest.mark.parametrize("p_tile,n_live", [
    (16, 1), (16, 15), (64, 1), (64, 15), (64, 63), (128, 1), (128, 15),
    (128, 63), (128, 128)])
def test_block_wgn_liveness(cuda, p_tile, n_live, pack32, k_pair, s_eff):
    """Blocks of p_tile probers with n_live live ones, first in odd blocks
    and last in even ones (a live 64-prober tile behind a dead one, warp
    slices of no live prober between live ones), on random inputs at d =
    128: live rows within _assert_close_rows' tolerances, pad rows dead,
    on the card's grid and on 3 persistent CTAs alike."""
    seed = p_tile + n_live + k_pair
    args = bs.random_inputs(cuda, s_eff=s_eff, n_blocks=32, nq=500,
                            cap_total=8192, seed=seed)
    g = torch.Generator(device=cuda).manual_seed(seed)
    pr = torch.randint(0, 500, (32, p_tile), generator=g, device=cuda,
                       dtype=torch.int32)
    pr[:, n_live:] = -1
    pr[0::2] = pr[0::2].roll(p_tile - n_live, dims=1)
    args[1] = pr.contiguous()
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=True, pack32=pack32,
              slot_mask=bs.util.next_pow2(s_eff) - 1)
    got, route = _block_launch(args, kw)
    assert route == "tc_wgn_" + ("pack32" if pack32 else "exact")
    ref = bs.block_scan_ref(*args, **kw)
    live = args[1] >= 0
    assert int(live.sum()) == 32 * n_live
    for out in (got, _block_uncounted(args, kw, route, n_ctas=3)):
        _assert_pads(out, ref, args[1], route, k_pair, pack32)
        _assert_close_rows(out[live], ref[live], k_pair, pack32)


@pytest.mark.gpu
@pytest.mark.parametrize("n_ctas", [None, 3])
@pytest.mark.parametrize("inputs", ["random", "ties"])
@pytest.mark.parametrize("d,s_eff", [(128, 4096), (256, 512)])
def test_block_wgn_int8_deep_pack32(cuda, d, s_eff, inputs, n_ctas):
    """The int8 rows of at most 256 bytes at pack32 k_pair 64, over 512
    strided groups at s_eff 4096 (8 tiles a phase) and 256 at s_eff 512 (2
    tiles), both on the narrow deep s8 wgmma instance, on the card's grid
    and on 3 persistent CTAs: exact integer sums, so bit for bit on every
    input, ties included (int8_tie_inputs); pad rows dead; the CUDA-core
    int8 kernel equal on every row."""
    make = bs.int8_tie_inputs if inputs == "ties" else bs.random_int8_inputs
    args, scale, q_scale = make(cuda, s_eff=s_eff, n_blocks=64, nq=500, d=d,
                                cap_total=8192, seed=d + s_eff)
    kw = dict(s_eff=s_eff, k_pair=64, euclidean=True, pack32=True,
              slot_mask=s_eff - 1)
    _int8_held(args, kw, scale, q_scale, "tc_wgn_int8_pack32", n_ctas=n_ctas)


# the chunked bf16 rows' cases: (pack32, k_pair, s_eff); pack32 k_pair 49-64
# run the three-stage instance (57 over 256 groups, 64 over 512)
_CHUNKED_CASES = [(False, 10, 640), (False, 16, 200), (True, 10, 640),
                  (True, 48, 2048), (True, 57, 512), (True, 64, 2048)]


@pytest.mark.gpu
@pytest.mark.parametrize("euclidean", [True, False])
@pytest.mark.parametrize("pack32,k_pair,s_eff", _CHUNKED_CASES)
@pytest.mark.parametrize("d", [160, 384, 1024])
def test_block_wg_chunked_integer_ties_exact(cuda, d, pack32, k_pair, s_eff,
                                             euclidean):
    """bf16 rows wider than 256 bytes, walked in 256-byte k chunks (d 160:
    256 + 64 bytes; 384: three chunks; 1024: eight, the GIST-class cache),
    on integer inputs with runs of equal rows: every sum is exact in any
    order, so the warp-specialised kernel they route to equals the plain
    version bit for bit on live rows, ties included, pad rows dead; the
    CUDA-core kernel, uncounted, equal on every row."""
    args = bs.integer_block_inputs(cuda, s_eff=s_eff, n_blocks=48, nq=500,
                                   d=d, cap_total=8192, seed=d + k_pair)
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=euclidean,
              pack32=pack32, slot_mask=bs.util.next_pow2(s_eff) - 1)
    mode = "pack32" if pack32 else "exact"
    got, route = _block_launch(args, kw)
    assert route == "tc_wg_" + mode
    ref = bs.block_scan_ref(*args, **kw)
    live = args[1] >= 0
    _assert_pads(got, ref, args[1], route, k_pair, pack32)
    assert torch.equal(got[live], ref[live])
    if not pack32:
        keys = ref[live][:, :k_pair]
        assert int((keys[:, 1:] == keys[:, :-1]).sum()) > 0, "no ties"
    assert torch.equal(_block_uncounted(args, kw, mode), ref)


@pytest.mark.gpu
@pytest.mark.parametrize("pack32,k_pair,s_eff", _CHUNKED_CASES)
@pytest.mark.parametrize("d", [160, 200, 1024])
def test_block_wg_chunked_matches_plain(cuda, d, pack32, k_pair, s_eff):
    """The chunked bf16 rows on random inputs (d 200 ends in half a k step:
    the bytes past the row are zeros), on the warp-specialised route: live
    rows to the tolerances of _assert_close_rows, pad rows dead; the
    CUDA-core kernel, uncounted, on every row."""
    args = bs.random_inputs(cuda, s_eff=s_eff, n_blocks=48, nq=500, d=d,
                            cap_total=8192, seed=d + s_eff + k_pair)
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=True, pack32=pack32,
              slot_mask=bs.util.next_pow2(s_eff) - 1)
    mode = "pack32" if pack32 else "exact"
    got, route = _block_launch(args, kw)
    assert route == "tc_wg_" + mode
    ref = bs.block_scan_ref(*args, **kw)
    live = args[1] >= 0
    _assert_pads(got, ref, args[1], route, k_pair, pack32)
    _assert_close_rows(got[live], ref[live], k_pair, pack32)
    _assert_close_rows(_block_uncounted(args, kw, mode), ref, k_pair,
                       pack32)


# the warp-specialised route's cases (csrc/block_scan_wg.cu): exact KMAX 10
# and 16, pack32 on four stages (k_pair <= 48, G = 128 and 512) and on
# three (k_pair 57 over 256 groups, 64 over 512)
_WG_CASES = [(False, 10, 2048), (False, 16, 200), (True, 10, 2048),
             (True, 48, 2048), (True, 57, 512), (True, 64, 2048)]


def _wg_held(args, kw, n_ctas=None, equal=True):
    """The warp-specialised kernel (counted through block_scan, or on a grid
    of n_ctas uncounted) against block_scan_ref: live rows bit for bit
    (equal) or to _assert_close_rows' tolerances, pad rows dead, the keys
    equal over two launches."""
    mode = "pack32" if kw["pack32"] else "exact"
    if n_ctas is None:
        got, route = _block_launch(args, kw)
        assert route == "tc_wg_" + mode
    else:
        got = _block_uncounted(args, kw, "tc_wg_" + mode, n_ctas=n_ctas)
    ref = bs.block_scan_ref(*args, **kw)
    _assert_pads(got, ref, args[1], "tc_wg_" + mode, kw["k_pair"],
                 kw["pack32"])
    live = args[1] >= 0
    if equal:
        assert torch.equal(got[live], ref[live])
    else:
        _assert_close_rows(got[live], ref[live], kw["k_pair"], kw["pack32"])
    again = _block_uncounted(args, kw, "tc_wg_" + mode, n_ctas=n_ctas)
    assert torch.equal(again, got)


@pytest.mark.gpu
@pytest.mark.parametrize("euclidean", [True, False])
@pytest.mark.parametrize("pack32,k_pair,s_eff", _WG_CASES)
@pytest.mark.parametrize("d", [200, 1024])
def test_block_wg_integer_ties_exact(cuda, d, pack32, k_pair, s_eff,
                                     euclidean):
    """The warp-specialised route at the GIST-class width (d 1024: 16 ring
    stages a tile) and a ragged one (d 200: the last stage holds 8 of its
    64 elements, one k16 step) on integer inputs with runs of equal rows:
    live rows bit for bit, ties included; pad rows dead; equal over two
    launches."""
    args = bs.integer_block_inputs(cuda, s_eff=s_eff, n_blocks=48, nq=500,
                                   d=d, cap_total=8192, seed=d + k_pair)
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=euclidean,
              pack32=pack32, slot_mask=bs.util.next_pow2(s_eff) - 1)
    _wg_held(args, kw)


@pytest.mark.gpu
@pytest.mark.parametrize("pack32,k_pair,s_eff", _WG_CASES)
@pytest.mark.parametrize("d", [200, 1024])
def test_block_wg_matches_plain(cuda, d, pack32, k_pair, s_eff):
    """The warp-specialised route on random inputs: exact values within
    1e-3 and addresses and pack32 keys on >= 0.99 of entries
    (_assert_close_rows), pad rows dead, equal over two launches."""
    args = bs.random_inputs(cuda, s_eff=s_eff, n_blocks=48, nq=500, d=d,
                            cap_total=8192, seed=d + s_eff + k_pair)
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=True, pack32=pack32,
              slot_mask=bs.util.next_pow2(s_eff) - 1)
    _wg_held(args, kw, equal=False)


@pytest.mark.gpu
@pytest.mark.parametrize("pack32,k_pair,s_eff", _WG_CASES)
@pytest.mark.parametrize("d", [200, 1024])
def test_block_wg_persistent_grid(cuda, d, pack32, k_pair, s_eff):
    """The warp-specialised route on a grid of 3 persistent CTAs over 64
    blocks: each CTA walks ~21 blocks through one ring (its stages and
    barrier phases carried from block to block, blocks of one and of two
    live 64-prober tiles mixed), integer inputs, live rows bit for bit, pad
    rows dead, equal over two launches."""
    args = bs.integer_block_inputs(cuda, s_eff=s_eff, n_blocks=64, nq=500,
                                   d=d, cap_total=8192, seed=d + k_pair)
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=True, pack32=pack32,
              slot_mask=bs.util.next_pow2(s_eff) - 1)
    _wg_held(args, kw, n_ctas=3)


def _alternating_probers(probers, nq, seed):
    """Prober rows of the consumers' schedule cases (128 a block): two live
    64-prober tiles, then two blocks of one (the first or the second,
    drawn), ...; in a live tile up to three of its four 16-row slices dead;
    every tenth block with no live prober (skipped)."""
    g = torch.Generator(device=probers.device).manual_seed(seed)
    b, p_tile = probers.shape
    assert p_tile == 128
    pr = torch.randint(0, nq, (b, 128), generator=g, device=probers.device,
                       dtype=torch.int32)
    slices = torch.rand((b, 8), generator=g, device=probers.device) < 0.3
    slices.view(b, 2, 4)[:, :, 0] = False  # a live tile keeps a slice
    one = torch.arange(b, device=probers.device) % 3 != 0
    first = torch.rand(b, generator=g, device=probers.device) < 0.5
    tiles = torch.stack([~one | first, ~one | ~first], 1)  # [b, 2] live
    tiles[9::10] = False
    live = tiles.repeat_interleave(4, 1) & ~slices
    pr[~live.repeat_interleave(16, 1)] = -1
    return pr.contiguous()


# the warp-specialised routes under the consumers' schedule (turns of the
# two warpgroups, pair barriers, no barrier of all consumers): (kind, d or
# (m, dsub), s_eff, k_pair, pack32): narrow bf16 (a last tile of 64
# columns: warpgroup 1 has no half where one tile is live), the k-chunked
# bf16 rows (d 256), int8 narrow and k-chunked, the codes instances; exact,
# pack32 pass by pass and the deep select
_SCHEDULE_CASES = [
    ("bf16", 128, 192, 10, False), ("bf16", 128, 640, 10, True),
    ("bf16", 128, 1024, 40, True), ("bf16", 256, 320, 16, False),
    ("bf16", 256, 640, 16, True), ("bf16", 256, 2048, 64, True),
    ("int8", 128, 640, 10, False), ("int8", 128, 640, 16, True),
    ("int8", 512, 1024, 40, True), ("codes", (64, 2), 1024, 10, False),
    ("codes", (64, 2), 1024, 16, True), ("codes", (64, 2), 1024, 52, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("n_ctas", [None, 3])
@pytest.mark.parametrize("kind,d,s_eff,k_pair,pack32", _SCHEDULE_CASES)
def test_wg_schedule_alternating_tiles(cuda, kind, d, s_eff, k_pair, pack32,
                                       n_ctas):
    """Blocks whose live 64-prober tiles alternate between one and two (the
    warpgroups taking a column half each, then a tile each), dead 16-row
    slices and skipped blocks, on the card's grid and on a persistent grid
    of 3 CTAs (each walking ~32 blocks, its barriers' phases and shared
    lists reused): every warp-specialised route, bf16 and int8, narrow and
    k-chunked, codes, exact, pass by pass and deep, equal to its plain
    version bit for bit on integer inputs (int8: int8_tie_inputs) on live
    rows, pad rows dead."""
    from torchpq_tpu_torch import _build
    seed = s_eff + k_pair + (0 if n_ctas is None else 1)
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=True, pack32=pack32,
              slot_mask=bs.util.next_pow2(s_eff) - 1)
    stream = torch.cuda.current_stream().cuda_stream
    if kind == "codes":
        m, dsub = d
        args = cs.integer_codes_inputs(cuda, s_eff=s_eff, n_blocks=96,
                                       nq=500, m=m, dsub=dsub,
                                       cap_total=8192, seed=seed)
        args[1] = _alternating_probers(args[1], 500, seed)
        route = cs.pick_route(m=m, dsub=dsub, p_tile=128, s_eff=s_eff,
                              k_pair=k_pair, pack32=pack32)
        assert route.startswith("tc_wgn_")
        got = cs.launch(_build.library(), stream, *args, route=route,
                        n_ctas=n_ctas, **kw)
        torch.cuda.synchronize()
        ref = cs.codes_scan_ref(*args, **kw)
    elif kind == "int8":
        args, scale, q_scale = bs.int8_tie_inputs(
            cuda, s_eff=s_eff, n_blocks=96, nq=500, d=d,
            cap_total=max(8192, 4 * s_eff), seed=seed)
        args[1] = _alternating_probers(args[1], 500, seed)
        kw = dict(kw, scale=scale, q_scale=q_scale)
        route = _int8_wg_route(d, pack32)
        got = _block_uncounted(args, kw, route, n_ctas=n_ctas)
        ref = bs.block_scan_ref(*args, **kw)
    else:
        args = bs.integer_block_inputs(cuda, s_eff=s_eff, n_blocks=96,
                                       nq=500, d=d,
                                       cap_total=max(8192, 4 * s_eff),
                                       seed=seed)
        args[1] = _alternating_probers(args[1], 500, seed)
        route = bs.pick_route(dtype=torch.bfloat16, d=d, p_tile=128,
                              s_eff=s_eff, k_pair=k_pair, pack32=pack32)
        assert route.startswith(("tc_wg_", "tc_wgn_"))
        got = _block_uncounted(args, kw, route, n_ctas=n_ctas)
        ref = bs.block_scan_ref(*args, **kw)
    live = args[1] >= 0
    tiles = live.view(96, 2, 64).any(-1).sum(-1)
    assert {0, 1, 2} <= set(tiles.tolist())
    _assert_pads(got, ref, args[1], route, k_pair, pack32)
    assert torch.equal(got[live], ref[live])


@pytest.mark.gpu
def test_block_wg_entry_refuses_and_sizes(cuda):
    """The warp-specialised entry point: its shared memory equals the
    mirror (ops/block_scan.py:wg_smem_bytes) at every k_pair, narrow (d
    8, 72, 128) and k-chunked (d 1024), within the limit; it refuses,
    without launching (cudaErrorInvalidValue, the output keeps its fill),
    rows not of 16-byte pieces (d 100), exact k_pair 17 and a window past
    the cache, narrow and k-chunked; and it holds an SM with one CTA."""
    from torchpq_tpu_torch import _build
    lib = _build.library()
    for d in (8, 72, 128, 1024):
        for pack32 in (0, 1):
            for k_pair in range(1, 65 if pack32 else 17):
                assert lib.torchpq_block_scan_wg_smem(d, pack32, k_pair) \
                    == bs.wg_smem_bytes(pack32, k_pair, d) <= bs._SMEM_LIMIT
                assert lib.torchpq_block_scan_wg_occupancy(
                    d, pack32, k_pair) == 1
    for d, k_pair, capacity in ((100, 10, 4096), (1024, 17, 4096),
                                (1024, 10, 256), (128, 17, 4096),
                                (128, 10, 256)):
        args = bs.random_inputs(cuda, s_eff=512, n_blocks=4, nq=50, d=d,
                                cap_total=4096)
        out = torch.full((4, 128, 2 * k_pair), 7, dtype=torch.int32,
                         device=cuda)
        rc = lib.torchpq_block_scan_wg(
            *(t.data_ptr() for t in args), out.data_ptr(), 4, 128, d,
            capacity, 512, k_pair, 1, 0, 511, 0, 2,
            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert rc == 1  # cudaErrorInvalidValue
        assert bool((out == 7).all())


@pytest.mark.gpu
def test_block_wg_instance_entry(cuda):
    """torchpq_block_scan_wg_instance (the one-key timing's entry) runs the
    instance of a deeper select: at inst_k == k_pair it equals the routed
    launch; a pack32 launch of one key a row on the deep instance (four
    stages, the deep select) equals the one on the routed k_pair 1
    instance (six, passes); it
    refuses, without launching, inst_k below k_pair or past the lists."""
    from torchpq_tpu_torch import _build
    lib = _build.library()
    s_eff, d = 2048, 1024
    args = bs.integer_block_inputs(cuda, s_eff=s_eff, n_blocks=48, nq=500,
                                   d=d, cap_total=8192, seed=5)
    stream = torch.cuda.current_stream().cuda_stream

    def entry(k_pair, inst_k, fill=None):
        out = torch.full((48, 128, k_pair), 7, dtype=torch.int32,
                         device=cuda)
        rc = lib.torchpq_block_scan_wg_instance(
            *(t.data_ptr() for t in args), out.data_ptr(), 48, 128, d,
            args[6].shape[0], s_eff, k_pair, 1, 1, s_eff - 1,
            bs.n_groups(s_eff, k_pair), 3, stream, inst_k)
        torch.cuda.synchronize()
        return rc, out

    kw = dict(s_eff=s_eff, euclidean=True, pack32=True, slot_mask=s_eff - 1)
    for k_pair in (1, 64):
        rc, out = entry(k_pair, k_pair)
        assert rc == 0
        assert torch.equal(out, _block_uncounted(args, dict(kw, k_pair=k_pair),
                                                 "tc_wg_pack32"))
    rc, deep = entry(1, 64)
    assert rc == 0
    assert torch.equal(deep, entry(1, 1)[1])
    for k_pair, inst_k in ((10, 9), (10, 65)):
        rc, out = entry(k_pair, inst_k)
        assert rc == 1  # cudaErrorInvalidValue
        assert bool((out == 7).all())


@pytest.mark.gpu
@pytest.mark.parametrize("n_ctas", [None, 3])
@pytest.mark.parametrize("inputs", ["random", "ties"])
@pytest.mark.parametrize("k_pair,s_eff", [(49, 2048), (57, 512),
                                          (64, 2048)])
@pytest.mark.parametrize("d", [288, 1024])
def test_block_wg_int8_one_list(cuda, d, k_pair, s_eff, inputs, n_ctas):
    """int8 rows over 256 bytes at pack32 k_pair 49-64 (the shapes the
    mma.sync kernel's one-list instance served): the k-chunked s8 wgmma
    instance of four ring stages and one running list a row (the deep
    select; 204,416 B at k_pair 64), over 512 and
    256 strided groups, on the card's grid and on 3 persistent CTAs: bit
    for bit on every input, ties included; pad rows dead; the CUDA-core
    int8 kernel equal on every row."""
    make = bs.int8_tie_inputs if inputs == "ties" else bs.random_int8_inputs
    args, scale, q_scale = make(cuda, s_eff=s_eff, n_blocks=64, nq=500, d=d,
                                cap_total=8192, seed=d + k_pair)
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=True, pack32=True,
              slot_mask=s_eff - 1)
    _int8_held(args, kw, scale, q_scale, "tc_wg_int8_pack32", n_ctas=n_ctas)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d,k_pair", [
    (torch.bfloat16, 1032, 10),   # a row of 2,064 bytes
    (torch.int8, 1040, 10),       # a row of 1,040 bytes
    (torch.bfloat16, 1024, 17),   # the exact lists hold 16
])
def test_block_wg_refuses_shapes_past_the_limit(cuda, dtype, d, k_pair):
    """Shapes past the tensor-core body's limits: launch(route="tc_*")
    raises before the library is called, pick_route names the CUDA-core
    kernel, and the C entry point itself returns cudaErrorInvalidValue
    without launching (the output keeps its fill)."""
    from torchpq_tpu_torch import _build
    lib = _build.library()
    s_eff, int8 = 512, dtype == torch.int8
    if int8:
        args, scale, q_scale = bs.random_int8_inputs(
            cuda, s_eff=s_eff, n_blocks=4, nq=50, d=d, cap_total=4096)
        extra = dict(scale=scale, q_scale=q_scale)
    else:
        args = bs.random_inputs(cuda, s_eff=s_eff, n_blocks=4, nq=50, d=d,
                                cap_total=4096)
        extra = {}
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=True, pack32=False,
              slot_mask=s_eff - 1, **extra)
    route = bs.pick_route(dtype=dtype, d=d, p_tile=128, s_eff=s_eff,
                          k_pair=k_pair, pack32=False)
    assert route == ("int8_" if int8 else "") + "exact"
    with pytest.raises(ValueError, match="tensor-core"):
        _block_uncounted(args, kw, "tc_wg_" + route)
    out = torch.full((4, 128, 2 * k_pair), 7, dtype=torch.int32,
                     device=cuda)
    ptrs = [t.data_ptr() for t in args]
    tail = (s_eff, k_pair, 1, 0, s_eff - 1, 0, 2,
            torch.cuda.current_stream().cuda_stream)
    if int8:
        rc = lib.torchpq_block_scan_wg_int8(
            ptrs[0], q_scale.data_ptr(), *ptrs[1:6], scale.data_ptr(),
            ptrs[6], out.data_ptr(), 4, 128, d, args[6].shape[0], *tail)
    else:
        rc = lib.torchpq_block_scan_wg(*ptrs, out.data_ptr(), 4, 128, d,
                                       args[6].shape[0], *tail)
    torch.cuda.synchronize()
    assert rc == 1  # cudaErrorInvalidValue
    assert bool((out == 7).all())


@pytest.mark.gpu
def test_wg_smem_matches_mirror(cuda):
    """The library's shared-memory sizes of the tensor-core scans equal
    ops/block_scan.py's mirrors (which pick_route reads without the
    library): the warp-specialised scan's wg_smem_bytes, bf16 and int8,
    narrow and k-chunked, at every k_pair (the deep select's above pack32
    k_pair 16), the codes scan's its own mirror
    ops/codes_scan.py:wg_smem_bytes (the wgmma codes instances: the
    codebook, the raw slot and the query buffer beside the ring and the
    lists, the deep select's above CODES_PASS_K) at every k_pair it
    serves; every routed shape within the limit; and the codes entry point
    launches its deep instance at pack32 k_pair 64, d = 128 (three ring
    stages, 227,680 B), equal to the plain version on integer inputs, and
    refuses exact k_pair 17."""
    from torchpq_tpu_torch import _build
    lib = _build.library()
    for d in (32, 40, 64, 128, 136, 1024):
        for pack32 in (0, 1):
            for k_pair in (1, 10, 16, 17, 33, 40, 48, 49, 57, 64):
                if not pack32 and k_pair > 16:
                    continue
                want = bs.wg_smem_bytes(pack32, k_pair, d)
                assert lib.torchpq_block_scan_wg_smem(d, pack32, k_pair) \
                    == want
                if d % 16 == 0:
                    assert lib.torchpq_block_scan_wg_int8_smem(
                        d, pack32, k_pair) == bs.wg_smem_bytes(
                            pack32, k_pair, d, torch.int8)
    for m, dsub in ((8, 4), (8, 5), (16, 4), (64, 2), (32, 4), (128, 1)):
        for pack32 in (0, 1):
            for k_pair in (1, 10, 16, 17, 20, 32, 33, 35, 36, 40, 48, 49,
                           52, 57, 64):
                if not pack32 and k_pair > 16:
                    continue
                want = cs.wg_smem_bytes(m=m, dsub=dsub, pack32=pack32,
                                        k_pair=k_pair)
                assert lib.torchpq_codes_scan_wg_smem(
                    m, dsub, pack32, k_pair) == want
                assert want <= cs._SMEM_LIMIT
    assert cs.wg_smem_bytes(m=64, dsub=2, pack32=1, k_pair=64) == 227680
    out = torch.empty((4, 128, 64), dtype=torch.int32, device=cuda)
    cargs = cs.integer_codes_inputs(cuda, s_eff=1024, n_blocks=4, nq=50,
                                    m=64, dsub=2, cap_total=4096)
    rc = lib.torchpq_codes_scan_wg(
        *(t.data_ptr() for t in cargs[:6]), cargs[6].data_ptr(),
        cargs[7].data_ptr(), out.data_ptr(), 4, 128, 64, 2,
        cargs[6].shape[1] // 64, 1024, 64, 1, 1, 1023, 512, 4,
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    ref = cs.codes_scan_ref(*cargs, s_eff=1024, k_pair=64, euclidean=True,
                            pack32=True, slot_mask=1023)
    live = cargs[1] >= 0
    assert torch.equal(out[live], ref[live])
    assert bool((out[~live] == torch.iinfo(torch.int32).min).all())
    assert lib.torchpq_codes_scan_wg(
        *(t.data_ptr() for t in cargs[:6]), cargs[6].data_ptr(),
        cargs[7].data_ptr(), out.data_ptr(), 4, 128, 64, 2,
        cargs[6].shape[1] // 64, 1024, 17, 1, 0, 1023, 0, 4,
        torch.cuda.current_stream().cuda_stream) != 0


@pytest.mark.gpu
def test_block_routes_on_card(cuda):
    """bf16 at d = 128 and 1024 and int8 at d = 128 and 1024 take the
    tensor-core kernels (the warp-specialised one's narrow and k-chunked
    instances), pack32 k_pair 64 too at every such width (the deep
    select; at bf16 d = 128 over 2 tiles a phase); an
    f32
    cache, bf16 exact k_pair 20 or d = 1032, and int8 at d = 1040 or exact
    k_pair 20 take the CUDA-core one; each counts under its own key, and
    asking the tensor-core route for the others raises before anything
    launches."""
    for dtype, d, k_pair, pack32, route in (
            (torch.bfloat16, 128, 10, False, "tc_wgn_exact"),
            (torch.bfloat16, 128, 10, True, "tc_wgn_pack32"),
            (torch.float32, 128, 10, False, "exact"),
            (torch.float32, 128, 10, True, "pack32"),
            (torch.bfloat16, 128, 20, False, "exact"),
            (torch.int8, 128, 10, False, "tc_wgn_int8_exact"),
            (torch.int8, 128, 10, True, "tc_wgn_int8_pack32"),
            (torch.int8, 1024, 10, True, "tc_wg_int8_pack32"),
            (torch.int8, 1040, 10, False, "int8_exact"),
            (torch.int8, 128, 20, False, "int8_exact"),
            (torch.bfloat16, 128, 64, True, "tc_wgn_pack32"),
            (torch.int8, 128, 64, True, "tc_wgn_int8_pack32"),
            (torch.int8, 1024, 64, True, "tc_wg_int8_pack32"),
            (torch.bfloat16, 1024, 10, False, "tc_wg_exact"),
            (torch.bfloat16, 1024, 64, True, "tc_wg_pack32"),
            (torch.bfloat16, 1032, 10, True, "pack32")):
        extra = {}
        if dtype == torch.int8:
            args, scale, q_scale = bs.random_int8_inputs(
                cuda, s_eff=512, n_blocks=16, nq=300, d=d, cap_total=8192)
            extra = dict(scale=scale, q_scale=q_scale)
        else:
            args = bs.random_inputs(cuda, s_eff=512, n_blocks=16, nq=300,
                                    d=d, cap_total=8192, dtype=dtype)
        kw = dict(s_eff=512, k_pair=k_pair, euclidean=True, pack32=pack32,
                  slot_mask=511, **extra)
        got, r = _block_launch(args, kw)
        assert r == route
        if not route.startswith("tc_"):
            with pytest.raises(ValueError):
                _block_uncounted(args, kw, "tc_" + route)
            if dtype != torch.int8:
                with pytest.raises(ValueError):
                    _block_uncounted(args, kw, "tc_wgn_" + route)


@pytest.mark.gpu
def test_scan_cell_major_on_card_matches_cpu(cuda, f32_search):
    """The whole cell-major scan on the card (kernel) against the same scan
    on the CPU (plain version)."""
    g = torch.Generator().manual_seed(1)
    n_cells, per, d = 16, 256, 128
    decoded = torch.randn(n_cells * per, d, generator=g).to(torch.bfloat16)
    norms = decoded.float().pow(2).sum(-1)
    is_empty = torch.rand(n_cells * per, generator=g) < 0.2
    start = torch.arange(n_cells, dtype=torch.int32) * per
    cap = torch.full((n_cells,), per, dtype=torch.int32)
    q = torch.randn(300, d, generator=g)
    cells = torch.stack([torch.randperm(n_cells, generator=g)[:4]
                         for _ in range(300)]).int()
    mask = torch.ones(cells.shape, dtype=torch.bool)
    cpu = (q, cells, mask, decoded, norms, is_empty, start, cap)
    for approx in (False, True):
        kw = dict(k=10, distance="euclidean", s_max=per, n_cells=n_cells,
                  approx=approx, impl="auto")
        v_ref, a_ref = adc.scan_cell_major(*cpu, **kw)
        v, a = adc.scan_cell_major(*[t.to(cuda) for t in cpu], **kw)
        torch.testing.assert_close(v.cpu(), v_ref, rtol=1e-3, atol=1e-2)
        agree = (a.cpu() == a_ref).float().mean().item()
        assert agree >= 0.99, agree


def _assert_pack32_values(v, v_ref, i, i_ref, q, s_eff):
    """pack32 keeps a raw score r = v + |q|^2 only above the slot bits: its
    f32 bits below log2(slot_mask + 1) are cut, one step being
    (slot_mask + 1) ulps of r. Two sums of r that differ in the last bits
    can fall on either side of a step, so where the ids agree the values
    differ by at most one step (of the larger binade), plus the summation
    and -|q|^2 rounding (1e-5 |r|). The group reduce may keep another of
    two near-tied slots, so compare where ids agree."""
    import numpy as np
    import torchpq_tpu_torch as tp

    slot_mask = tp.util.next_pow2(s_eff) - 1
    same = i.cpu() == i_ref
    raw = (v_ref.double() + torch.from_numpy(
        (q.astype(np.float64) ** 2).sum(1))[:, None]).abs()
    step = (slot_mask + 1) * torch.exp2(
        torch.floor(torch.log2(raw * (1 + 1e-5))) - 23)
    tol = step + 1e-5 * raw
    err = (v.cpu().double() - v_ref.double()).abs()
    assert bool((err[same] <= tol[same]).all()), \
        float((err - tol)[same].max())


@pytest.mark.gpu
def test_index_on_card_matches_cpu(cuda, f32_search):
    """The same trained state and adds on the card and on the CPU: the adds
    relayout the cells, the stores come out equal, and every plan finds the
    same neighbours."""
    import numpy as np
    import torchpq_tpu_torch as tp

    rng = np.random.default_rng(0)
    centers = rng.normal(size=(40, 32)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 40, 6000)]
         + rng.normal(size=(6000, 32))).astype(np.float32)
    q = x[:200] + 0.1 * rng.normal(size=(200, 32)).astype(np.float32)
    cpu = tp.IVFPQIndex(32, 8, 16, initial_size=32, device="cpu")
    cpu.train(x[:2000].T)
    gpu = tp.IVFPQIndex(32, 8, 16, initial_size=32, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    for chunk in (x[:3000], x[3000:]):
        cpu.add(chunk.T)
        gpu.add(torch.from_numpy(chunk).to(cuda).T)
    assert gpu.max_cell_capacity > 32, "the adds must relayout"
    assert torch.equal(gpu._storage.cpu(), cpu._storage)
    assert torch.equal(gpu._address2id.cpu(), cpu._address2id)
    for mode, approx in (("cell_major", False), ("cell_major", True),
                         ("query_major", False), ("flat", False)):
        for idx in (cpu, gpu):
            idx.scan_mode, idx.use_approx_topk, idx.n_probe = mode, approx, 4
        v_ref, i_ref = cpu.search(q.T, k=10)
        v, i = gpu.search(torch.from_numpy(q).to(cuda).T, k=10)
        shared = sum(len(set(a.tolist()) & set(b.tolist()))
                     for a, b in zip(i.cpu(), i_ref)) / i_ref.numel()
        assert shared >= 0.99, (mode, approx, shared)
        if not approx:
            torch.testing.assert_close(v.cpu(), v_ref, rtol=1e-3, atol=1e-2)
            continue
        gate = adc.LAST_GATE
        assert gate["pack32"] and gate["impl"] == "block_scan", gate
        _assert_pack32_values(v, v_ref, i, i_ref, q, gate["s_eff"])


def _assert_topk_ties(v, i, v_ref, i_ref, rtol=1e-3, atol=1e-2):
    """An exact plan's top-k against the CPU's: values within the
    tolerance, position by position, and ids equal wherever a value is
    apart from the others of its row and from the row's last (4-bit codes
    decode many rows alike, and the two devices' top-k order exact ties
    differently)."""
    v, i = v.cpu(), i.cpu()
    torch.testing.assert_close(v, v_ref, rtol=rtol, atol=atol)
    tol = atol + rtol * v_ref.abs()
    near = (v_ref[:, :, None] - v_ref[:, None, :]).abs() <= tol[:, :, None]
    apart = (near.sum(-1) == 1) & ((v_ref - v_ref[:, -1:]).abs() > tol)
    assert torch.equal(i[apart], i_ref[apart])


@pytest.mark.gpu
@pytest.mark.parametrize("d,m,kwargs", [
    (32, 8, dict(n_bits=4)),
    (64, 32, dict(n_bits=4, scan_cache_dtype="none")),
    (32, 8, dict(pq_use_residual=True)),
    (32, 8, dict(distance="inner", anisotropic_eta=4.0)),
    (32, 8, dict(distance="manhattan")),
])
def test_pq_variants_on_card_match_cpu(cuda, f32_search, tmp_path, d, m,
                                       kwargs):
    """The PQ variants on the card: an index trains there; with the CPU
    index's trained state, the same adds (a relayout), a remove and more
    adds, the stores equal the CPU's (anisotropic codes on >= 0.999: the
    cost cancels, so near-ties follow the card's summation order) and
    every plan finds the same neighbours; a save loads back on the card
    and searches alike. The 4-bit code domain at 32 codes runs the
    tensor-core codes kernel over the byte-pair codebook (dsub 4); no
    kernel takes manhattan."""
    import numpy as np
    import torchpq_tpu_torch as tp

    rng = np.random.default_rng(1)
    centers = rng.normal(size=(40, d)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 40, 5000)]
         + rng.normal(size=(5000, d))).astype(np.float32)
    q = x[:200] + 0.1 * rng.normal(size=(200, d)).astype(np.float32)
    kw = dict(initial_size=32, **kwargs)
    trained = tp.IVFPQIndex(d, m, 16, device=cuda, **kw)
    trained.vq_max_iter = trained.pq_max_iter = 5
    trained.train(torch.from_numpy(x[:1500]).to(cuda).T)
    assert trained.is_trained
    assert bool(torch.isfinite(trained.pq_codec.codebook_internal).all())
    cpu = tp.IVFPQIndex(d, m, 16, device="cpu", **kw)
    cpu.vq_max_iter = cpu.pq_max_iter = 5
    cpu.train(x[:1500].T)
    gpu = tp.IVFPQIndex(d, m, 16, device=cuda, **kw)
    gpu.load_state_dict(cpu.state_dict())
    for chunk in (x[:2500], x[2500:4000]):
        cpu.add(chunk.T)
        gpu.add(torch.from_numpy(chunk).to(cuda).T)
    rm = np.arange(0, 4000, 7)
    assert gpu.remove(rm) == cpu.remove(rm)
    cpu.add(x[4000:].T)
    gpu.add(torch.from_numpy(x[4000:]).to(cuda).T)
    assert gpu.max_cell_capacity > 32, "the adds must relayout"
    same = (gpu._storage.cpu() == cpu._storage).float().mean().item()
    assert same >= (0.999 if "anisotropic_eta" in kwargs else 1.0), same
    assert torch.equal(gpu._address2id.cpu(), cpu._address2id)
    path = str(tmp_path / "variant.npz")
    gpu.save(path)
    back = tp.IVFPQIndex(d, m, 16, device=cuda, **kw)
    back.load(path)
    before = {**bs.launches, **cs.launches}
    for mode, approx in (("cell_major", False), ("cell_major", True),
                         ("flat", False)):
        for idx in (cpu, gpu, back):
            idx.scan_mode, idx.use_approx_topk, idx.n_probe = mode, approx, 4
        v_ref, i_ref = cpu.search(q.T, k=10)
        v, i = gpu.search(torch.from_numpy(q).to(cuda).T, k=10)
        v_b, i_b = back.search(torch.from_numpy(q).to(cuda).T, k=10)
        assert torch.equal(i_b, i) and torch.equal(v_b, v)
        shared = sum(len(set(a.tolist()) & set(b.tolist()))
                     for a, b in zip(i.cpu(), i_ref)) / i_ref.numel()
        if approx or "anisotropic_eta" in kwargs:
            assert shared >= 0.95, (mode, approx, shared)
        if approx:
            _assert_pack32_values(v, v_ref, i, i_ref, q,
                                  adc.LAST_GATE["s_eff"])
        elif "anisotropic_eta" not in kwargs:
            _assert_topk_ties(v, i, v_ref, i_ref)
    if kwargs.get("scan_cache_dtype") == "none":
        assert cs.launches["tc_wgn_exact"] > before["tc_wgn_exact"]
        assert cs.launches["tc_wgn_pack32"] > before["tc_wgn_pack32"]
    if kwargs.get("distance") == "manhattan":
        assert {**bs.launches, **cs.launches} == before


@pytest.mark.gpu
def test_spill_assign_on_card_matches_cpu(cuda, f32_search):
    """The device spill routing on the card equals the CPU's bit for bit:
    a hot cell whose items spill, items whose every candidate is full (the
    least-occupied fallback), occupancy from earlier adds."""
    from torchpq_tpu_torch.ops.spill import spill_assign_device

    g = torch.Generator().manual_seed(5)
    n, n_cells, l, cap = 20000, 512, 8, 48
    top = torch.stack([torch.randperm(n_cells, generator=g)[:l]
                       for _ in range(n)]).int()
    top[:3000, 0] = 7
    top[:500] = torch.arange(100, 100 + l, dtype=torch.int32)
    occ = torch.randint(0, cap, (n_cells,), generator=g).int()
    occ[100:100 + l] = cap
    ref = spill_assign_device(top, occ, cap=cap, n_cells=n_cells)
    got = spill_assign_device(top.to(cuda), occ.to(cuda), cap=cap,
                              n_cells=n_cells)
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)
    assert int(ref[1][100:100 + l].sum()) >= 500   # the fallback items


def _codes_launch(cuda, args, kw):
    """One codes_scan call on the card: (output, route), with the route's
    launch counted once and no other key moved."""
    m, _, dsub = args[7].shape
    route = cs.pick_route(m=m, dsub=dsub, p_tile=args[1].shape[1],
                          s_eff=kw["s_eff"], k_pair=kw["k_pair"],
                          pack32=kw["pack32"])
    before = dict(cs.launches)
    got = cs.codes_scan(*args, **kw)
    torch.cuda.synchronize()
    assert cs.launches == dict(before, **{route: before[route] + 1})
    return got, route


def _assert_pads(got, ref, probers, route, k_pair, pack32):
    """Pad rows (prober -1): dead from the tensor-core kernel (INT_MIN;
    sortable(-inf) keys and -1 addresses), scored as the plain version
    scores them by the CUDA-core one."""
    pad = probers < 0
    if not route.startswith("tc_"):
        assert torch.equal(got[pad], ref[pad])
    elif pack32:
        assert bool((got[pad] == torch.iinfo(torch.int32).min).all())
    else:
        dead = bs.sortable_i32(torch.tensor([-torch.inf], device=got.device))
        assert bool((got[pad][:, :k_pair] == dead).all())
        assert bool((got[pad][:, k_pair:] == -1).all())


def _codes_route_family(m, dsub, k_pair, pack32):
    """The codes route these test shapes take: the wgmma codes instances
    for exact k_pair <= 16 and every pack32 k_pair (above CODES_PASS_K the
    deep select), the CUDA cores for exact above 16 (test_pick_route pins
    the boundaries)."""
    if not pack32:
        return "tc_wgn_exact" if k_pair <= 16 else "exact"
    return "tc_wgn_pack32"


@pytest.mark.gpu
@pytest.mark.parametrize("pack32", [False, True])
@pytest.mark.parametrize("m,dsub", [(64, 2), (8, 4), (128, 1), (32, 4),
                                    (8, 9)])
@pytest.mark.parametrize("s_eff", [256, 1024, 8192])
@pytest.mark.parametrize("k_pair", [10, 16, 20, 40, 52, 64])
def test_codes_kernel_matches_plain(cuda, pack32, m, dsub, s_eff, k_pair):
    """g = 2 (d=128, PQ64), g = 16 (d=32, PQ8; d=72, PQ8 of dsub 9: a
    ragged second k half), g = 1 (d=128, PQ128: the raw codes in two
    passes) and g = 4 (d=128, 4-bit PQ64: 32 byte pairs over the byte-pair
    codebook) on random inputs, through the kernel pick_route names (the
    wgmma codes instances, exact k_pair <= 16 and every pack32 k_pair, the
    deeper ones over 512 strided groups at s_eff 1024 and 8192 by the deep
    select; exact k_pair 20 to 64: the CUDA-core one). Live rows: the
    tensor cores sum in another
    order than the plain version's GEMM (bf16 products are exact in f32),
    so exact values agree to 1e-3 relative and addresses and pack32 keys
    on >= 0.99 of entries; pad rows as _assert_pads."""
    args = cs.random_codes_inputs(cuda, s_eff=s_eff, n_blocks=64, nq=500,
                                  m=m, dsub=dsub,
                                  cap_total=max(8192, 2 * s_eff))
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=True, pack32=pack32,
              slot_mask=s_eff - 1)
    got, route = _codes_launch(cuda, args, kw)
    assert route == _codes_route_family(m, dsub, k_pair, pack32)
    ref = cs.codes_scan_ref(*args, **kw)
    _assert_pads(got, ref, args[1], route, k_pair, pack32)
    live = args[1] >= 0
    got, ref = got[live], ref[live]
    if pack32:
        assert (got == ref).float().mean().item() >= 0.99
    else:
        v = bs.sortable_i32_to_f32(got[..., :k_pair])
        v_ref = bs.sortable_i32_to_f32(ref[..., :k_pair])
        torch.testing.assert_close(v, v_ref, rtol=1e-3, atol=1e-3)
        assert (got[..., k_pair:] == ref[..., k_pair:]).float().mean() \
            .item() >= 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("pack32", [False, True])
@pytest.mark.parametrize("m,dsub,s_eff", [(64, 2, 1024), (8, 4, 256),
                                          (128, 1, 512), (64, 2, 8192),
                                          (32, 4, 1024), (8, 9, 256),
                                          (16, 5, 640)])
@pytest.mark.parametrize("k_pair,euclidean", [(10, True), (16, False),
                                              (20, True), (40, False),
                                              (52, True), (64, False)])
def test_codes_tc_kernel_integer_ties_exact(cuda, pack32, m, dsub, s_eff,
                                            k_pair, euclidean):
    """Integer-valued inputs with runs of equal codes: every sum is exact
    in any order, so the tensor-core kernels equal the plain version bit
    for bit on live rows, keys, addresses and pack32 keys, ties included
    (exact k_pair <= 16 and every pack32 k_pair: the wgmma codes
    instances, the deep select above CODES_PASS_K, d = 72 and 80 a ragged
    second k half; exact k_pair 20 to 64 runs on the CUDA-core kernel,
    equal there too)."""
    args = cs.integer_codes_inputs(cuda, s_eff=s_eff, n_blocks=64, nq=500,
                                   m=m, dsub=dsub,
                                   cap_total=max(8192, 2 * s_eff), seed=m)
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=euclidean,
              pack32=pack32, slot_mask=bs.util.next_pow2(s_eff) - 1)
    got, route = _codes_launch(cuda, args, kw)
    assert route == _codes_route_family(m, dsub, k_pair, pack32)
    ref = cs.codes_scan_ref(*args, **kw)
    _assert_pads(got, ref, args[1], route, k_pair, pack32)
    live = args[1] >= 0
    assert torch.equal(got[live], ref[live])
    if not pack32:
        keys = ref[live][:, :k_pair]
        assert int((keys[:, 1:] == keys[:, :-1]).sum()) > 0, "no ties"


@pytest.mark.gpu
@pytest.mark.parametrize("pack32,k_pair", [(False, 10), (False, 16),
                                           (True, 10), (True, 20),
                                           (True, 40), (True, 52),
                                           (True, 64)])
@pytest.mark.parametrize("m,dsub,s_eff", [(64, 2, 1024), (8, 4, 256),
                                          (128, 1, 512)])
def test_codes_tc_kernel_persistent_grid(cuda, pack32, k_pair, m, dsub,
                                         s_eff):
    """A grid of 3 persistent CTAs over 64 blocks: each CTA walks ~21
    blocks, so the state it resets between blocks (live-tile rows, the
    pack32 phase parity of deep G = 512, the exact lists and queues; the
    wgmma instances' ring stages, barrier phases, query buffer and raw
    slot; the deep select's running lists, staging rows and counts) is
    reused.
    Integer inputs: live rows equal the plain version bit for bit, pad
    rows dead."""
    from torchpq_tpu_torch import _build
    args = cs.integer_codes_inputs(cuda, s_eff=s_eff, n_blocks=64, nq=500,
                                   m=m, dsub=dsub, cap_total=8192,
                                   seed=m + k_pair)
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=True, pack32=pack32,
              slot_mask=s_eff - 1)
    route = _codes_route_family(m, dsub, k_pair, pack32)
    got = cs.launch(_build.library(), torch.cuda.current_stream().cuda_stream,
                    *args, route=route, n_ctas=3, **kw)
    torch.cuda.synchronize()
    ref = cs.codes_scan_ref(*args, **kw)
    _assert_pads(got, ref, args[1], route, k_pair, pack32)
    live = args[1] >= 0
    assert torch.equal(got[live], ref[live])


@pytest.mark.gpu
@pytest.mark.parametrize("m,dsub", [(64, 2), (128, 1), (32, 4)])
@pytest.mark.parametrize("s_eff", [256, 512, 1024])
@pytest.mark.parametrize("k_pair", [17, 33, 40, 52, 64])
def test_codes_deep_select_matches_plain(cuda, m, dsub, s_eff, k_pair):
    """The codes instances' pack32 selects above k_pair 16: pass by pass up
    to CODES_PASS_K = 32 (k_pair 17: G = 128, one phase, at every s_eff),
    the deep select (csrc/deep_select.cuh) above it over G = 128 (s_eff
    256), 256 (s_eff 512) and 512 (s_eff 1024) strided groups: one, two and
    four phases, at PQ64, PQ128 (two raw passes) and the 4-bit byte pairs,
    d = 128.
    Integer inputs with runs of equal codes: live rows equal
    codes_scan_ref bit for bit, pad rows dead; random inputs: keys equal
    on >= 0.99 of live entries (only the f32 sums' order differs)."""
    groups = bs.n_groups(s_eff, k_pair)
    assert groups == (128 if k_pair <= 32 else min(s_eff // 2, 512))
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=True, pack32=True,
              slot_mask=s_eff - 1)
    for make in (cs.integer_codes_inputs, cs.random_codes_inputs):
        args = make(cuda, s_eff=s_eff, n_blocks=64, nq=500, m=m, dsub=dsub,
                    cap_total=8192, seed=k_pair + s_eff)
        got, route = _codes_launch(cuda, args, kw)
        assert route == "tc_wgn_pack32"
        ref = cs.codes_scan_ref(*args, **kw)
        _assert_pads(got, ref, args[1], route, k_pair, True)
        live = args[1] >= 0
        if make is cs.integer_codes_inputs:
            assert torch.equal(got[live], ref[live])
        else:
            assert (got[live] == ref[live]).float().mean().item() >= 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("m,dsub,s_eff,k_pair", [(64, 2, 1024, 64),
                                                 (64, 2, 1024, 52),
                                                 (128, 1, 512, 40),
                                                 (32, 4, 256, 64)])
def test_codes_deep_select_ascending_window(cuda, m, dsub, s_eff, k_pair):
    """A window whose scores rise along its columns by more than the
    products span (every block at slot 0, the whole window its cell, the
    penalty of the slot that column c holds -8192 c): each phase's group
    maxima lie above every earlier key, so all of them survive the running
    lists' bounds, every staging row fills and each merge takes the most
    candidates. Integer sums (|2 <q, y>| <= 2,304 at d = 128; penalties
    below 2^24): live rows equal codes_scan_ref bit for bit, pad rows
    dead."""
    args = cs.integer_codes_inputs(cuda, s_eff=s_eff, n_blocks=64, nq=500,
                                   m=m, dsub=dsub, cap_total=8192, seed=m)
    args[2].zero_()
    args[3].zero_()
    args[4].fill_(s_eff)
    cols = torch.arange(s_eff, device=cuda, dtype=torch.float32)
    slots = cs.column_slots(s_eff, args[6].shape[1] // m, cuda).long()
    args[5].fill_(cs.BIG)
    args[5][slots] = -8192.0 * cols
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=True, pack32=True,
              slot_mask=s_eff - 1)
    got, route = _codes_launch(cuda, args, kw)
    assert route == "tc_wgn_pack32"
    ref = cs.codes_scan_ref(*args, **kw)
    _assert_pads(got, ref, args[1], route, k_pair, True)
    live = args[1] >= 0
    assert torch.equal(got[live], ref[live])
    # the keys are the window's last k_pair groups' maxima, descending
    keys = bs.sortable_i32_to_f32(ref[live] & ~(s_eff - 1))
    assert bool((keys[:, :-1] > keys[:, 1:]).all())


@pytest.mark.gpu
def test_codes_routes_on_card(cuda):
    """Exact k_pair > 16 and rows wider than 128 take the CUDA-core kernel,
    counted under its own key; asking a tensor-core route for them raises.
    Exact k_pair 10 and pack32 k_pair 20, 40 and 52 at d = 128 take the
    wgmma codes instances (the two deepest the deep select, where the
    sorted mma.sync codes kernel ran before), k_pair 64 at d = 160 the CUDA
    cores."""
    from torchpq_tpu_torch import _build
    for m, dsub, k_pair, route in ((64, 2, 20, "exact"),
                                   (32, 5, 10, "exact"),
                                   (64, 2, 10, "tc_wgn_exact"),
                                   (64, 2, 20, "tc_wgn_pack32"),
                                   (64, 2, 40, "tc_wgn_pack32"),
                                   (64, 2, 52, "tc_wgn_pack32"),
                                   (32, 5, 64, "pack32")):
        pack32 = route.endswith("pack32")
        args = cs.random_codes_inputs(cuda, s_eff=512, n_blocks=16, nq=300,
                                      m=m, dsub=dsub, cap_total=8192)
        kw = dict(s_eff=512, k_pair=k_pair, euclidean=True, pack32=pack32,
                  slot_mask=511)
        got, r = _codes_launch(cuda, args, kw)
        assert r == route
        if not route.startswith("tc_"):
            with pytest.raises(ValueError):
                cs.launch(_build.library(),
                          torch.cuda.current_stream().cuda_stream, *args,
                          route="tc_wgn_" + route, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("m,dsub,pack32", [(64, 2, False), (128, 1, True),
                                           (32, 4, False), (128, 1, False)])
def test_codes_kernel_matches_block_scan(cuda, m, dsub, pack32):
    """The codes kernel against the block-scan kernel over the bf16 decoded
    rows, live rows only. The two kernels sum in different orders (tensor
    cores, f32 FMA chain), so on integer inputs the exact keys are equal
    and addresses equal outside ties (the block scan breaks ties by slot,
    the codes scan by column); on random inputs the values agree to 1e-3
    relative. pack32 is compared at g = 1 (m = 128), where the column order
    is the slot order: keys equal on integer inputs, >= 0.99 on random."""
    for make in (cs.integer_codes_inputs, cs.random_codes_inputs):
        args = make(cuda, s_eff=512, n_blocks=64, nq=500, m=m, dsub=dsub,
                    cap_total=8192)
        qtable, probers, start_c, off, cap, penalty, codes, codebook = args
        decoded = cs.decode_codes(codes.view(-1, m), codebook).contiguous()
        kw = dict(s_eff=512, k_pair=10, euclidean=True, pack32=pack32,
                  slot_mask=511)
        got = cs.codes_scan(*args, **kw)
        ref = bs.block_scan(qtable, probers, start_c, off, cap, penalty,
                            decoded, **kw)
        torch.cuda.synchronize()
        live = probers >= 0
        got, ref = got[live], ref[live]
        exact = make is cs.integer_codes_inputs
        if pack32:
            agree = (got == ref).float().mean().item()
            assert agree == 1.0 if exact else agree >= 0.99
            continue
        v = bs.sortable_i32_to_f32(got[..., :10])
        v_ref = bs.sortable_i32_to_f32(ref[..., :10])
        torch.testing.assert_close(v, v_ref, rtol=0 if exact else 1e-3,
                                   atol=0 if exact else 1e-3)
        keys = ref[..., :10]
        tied = torch.zeros_like(keys, dtype=torch.bool)
        tied[..., 1:] |= keys[..., 1:] == keys[..., :-1]
        tied[..., :-1] |= keys[..., :-1] == keys[..., 1:]
        tied |= keys == keys[..., -1:]  # may tie with the 11th, unseen
        same = got[..., 10:] == ref[..., 10:]
        if exact:
            assert bool(same[~tied].all())
        else:
            assert same.float().mean().item() >= 0.99


@pytest.mark.gpu
def test_code_domain_index_on_card_matches_cpu(cuda, f32_search):
    """A code-domain index (scan_cache_dtype="none", PQ8 at d=32: g = 16)
    with the same state and adds on the card and on the CPU: equal stores,
    and every plan finds the same neighbours (the probed plans through the
    tensor-core codes kernel on the card)."""
    import numpy as np
    import torchpq_tpu_torch as tp

    rng = np.random.default_rng(0)
    centers = rng.normal(size=(40, 32)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 40, 6000)]
         + rng.normal(size=(6000, 32))).astype(np.float32)
    q = x[:200] + 0.1 * rng.normal(size=(200, 32)).astype(np.float32)
    cpu = tp.IVFPQIndex(32, 8, 16, initial_size=32, scan_cache_dtype="none",
                        device="cpu")
    cpu.train(x[:2000].T)
    gpu = tp.IVFPQIndex(32, 8, 16, initial_size=32, scan_cache_dtype="none",
                        device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    for chunk in (x[:3000], x[3000:]):
        cpu.add(chunk.T)
        gpu.add(torch.from_numpy(chunk).to(cuda).T)
    assert gpu.max_cell_capacity > 32, "the adds must relayout"
    assert torch.equal(gpu._storage.cpu(), cpu._storage)
    assert "decoded" not in gpu._aux
    before = dict(cs.launches)
    for mode, approx in (("cell_major", False), ("cell_major", True),
                         ("query_major", False), ("flat", False)):
        for idx in (cpu, gpu):
            idx.scan_mode, idx.use_approx_topk, idx.n_probe = mode, approx, 4
        v_ref, i_ref = cpu.search(q.T, k=10)
        v, i = gpu.search(torch.from_numpy(q).to(cuda).T, k=10)
        shared = sum(len(set(a.tolist()) & set(b.tolist()))
                     for a, b in zip(i.cpu(), i_ref)) / i_ref.numel()
        assert shared >= 0.99, (mode, approx, shared)
        if not approx:
            torch.testing.assert_close(v.cpu(), v_ref, rtol=1e-3, atol=1e-2)
            continue
        gate = adc.LAST_GATE
        assert gate["pack32"] and gate["impl"] == "codes_scan", gate
        _assert_pack32_values(v, v_ref, i, i_ref, q, gate["s_eff"])
    # the probed plans run the tensor-core codes kernel only
    assert cs.launches == dict(
        before, tc_wgn_exact=before["tc_wgn_exact"] + 2,
        tc_wgn_pack32=before["tc_wgn_pack32"] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("pack32", [False, True])
@pytest.mark.parametrize("d,s_eff", [(128, 512), (1024, 512), (32, 256)])
def test_int8_kernel_matches_plain(cuda, pack32, d, s_eff):
    """The int8 mode: exact integer products (s32 wgmma or __dp4a against
    f32 sums of int8 values, exact below d = 1040) and one fused
    multiply-add in all (fmaf against the plain version's once-rounded
    f64), so the outputs are equal bit for bit: the tensor-core kernel's
    (the route at these shapes) on live rows, its pad rows dead, and the
    CUDA-core kernel's, launched uncounted, on every row. d = 1024 is the
    GIST cache width."""
    args, scale, q_scale = bs.random_int8_inputs(
        cuda, s_eff=s_eff, n_blocks=64, nq=500, d=d, cap_total=8192)
    kw = dict(s_eff=s_eff, k_pair=10, euclidean=True, pack32=pack32,
              slot_mask=s_eff - 1, scale=scale, q_scale=q_scale)
    mode = "int8_pack32" if pack32 else "int8_exact"
    got, route = _block_launch(args, kw)
    assert route == ("tc_wgn_" if d <= 256 else "tc_wg_") + mode
    ref = bs.block_scan_ref(*args, **kw)
    _assert_pads(got, ref, args[1], route, 10, pack32)
    live = args[1] >= 0
    assert torch.equal(got[live], ref[live])
    assert torch.equal(_block_uncounted(args, kw, mode), ref)


_INT8_CASES = [(False, 10, 640), (False, 16, 2048), (False, 10, 200),
               (True, 10, 640), (True, 40, 512), (True, 48, 2048)]


def _int8_wg_route(d, pack32):
    """The warp-specialised route of an int8 scan of rows of d bytes, the
    one tensor-core kernel of every int8 shape: the narrow instances up to
    256 bytes a row, the k-chunked ones above."""
    return ("tc_wgn_" if d <= 256 else "tc_wg_") + (
        "int8_pack32" if pack32 else "int8_exact")


def _int8_held(args, kw, scale, q_scale, route, n_ctas=None):
    """The tensor-core int8 kernel (counted through block_scan, or launched
    uncounted on a grid of n_ctas) equal to block_scan_ref bit for bit on
    live rows, pad rows dead; the CUDA-core int8 kernel, uncounted, equal
    on every row. Returns the plain output."""
    kw = dict(kw, scale=scale, q_scale=q_scale)
    if n_ctas is None:
        got, r = _block_launch(args, kw)
        assert r == route
    else:
        got = _block_uncounted(args, kw, route, n_ctas=n_ctas)
    ref = bs.block_scan_ref(*args, **kw)
    _assert_pads(got, ref, args[1], route, kw["k_pair"], kw["pack32"])
    live = args[1] >= 0
    assert torch.equal(got[live], ref[live])
    mode = "int8_pack32" if kw["pack32"] else "int8_exact"
    assert torch.equal(_block_uncounted(args, kw, mode), ref)
    return ref


@pytest.mark.gpu
@pytest.mark.parametrize("euclidean", [True, False])
@pytest.mark.parametrize("pack32,k_pair,s_eff", _INT8_CASES)
@pytest.mark.parametrize("d", [128, 160, 256, 1024])
def test_block_wg_int8_matches_plain(cuda, d, pack32, k_pair, s_eff,
                                     euclidean):
    """The tensor-core int8 routes on random int8 inputs: rows of 128, 160
    and 256 bytes (the narrow s8 wgmma instances: one or two stages a
    tile) and 1,024 bytes (the k-chunked ones, eight); s_eff 640 (the
    compacted layout's, 5 tiles), 2048 and 200 (a ragged last tile); exact
    k_pair 10 and 16; pack32 k_pair 10, 40 over 256 and 48 over 512
    strided groups (at the narrow widths, 2 and 4 tiles a phase: the
    narrow deep instance). Exact integer sums: bit for bit on every
    input."""
    args, scale, q_scale = bs.random_int8_inputs(
        cuda, s_eff=s_eff, n_blocks=64, nq=500, d=d, cap_total=8192,
        seed=d + s_eff + k_pair)
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=euclidean,
              pack32=pack32, slot_mask=bs.util.next_pow2(s_eff) - 1)
    _int8_held(args, kw, scale, q_scale,
               _int8_wg_route(d, pack32))


@pytest.mark.gpu
@pytest.mark.parametrize("euclidean", [True, False])
@pytest.mark.parametrize("pack32", [False, True])
@pytest.mark.parametrize("d", [32, 128, 288, 1024])
def test_block_wg_int8_ties_exact(cuda, d, pack32, euclidean):
    """int8_tie_inputs (equal rows all over each window, runs of them):
    the tensor-core int8 routes equal the plain version bit for bit on
    live rows, ties and their column order included; d = 32 is one k32
    step, d = 288 ends in a 32-byte stage."""
    args, scale, q_scale = bs.int8_tie_inputs(
        cuda, s_eff=640, n_blocks=64, nq=500, d=d, cap_total=8192, seed=d)
    k_pair = 40 if pack32 else 10
    kw = dict(s_eff=640, k_pair=k_pair, euclidean=euclidean, pack32=pack32,
              slot_mask=1023)
    ref = _int8_held(args, kw, scale, q_scale,
                     _int8_wg_route(d, pack32))
    if not pack32:
        keys = ref[args[1] >= 0][:, :k_pair]
        assert int((keys[:, 1:] == keys[:, :-1]).sum()) > 0, "no ties"


@pytest.mark.gpu
@pytest.mark.parametrize("pack32,k_pair,s_eff", [
    (False, 10, 640), (False, 16, 1024), (True, 10, 640), (True, 40, 1024)])
@pytest.mark.parametrize("d", [128, 1024])
def test_block_wg_int8_persistent_grid_windows(cuda, d, pack32, k_pair, s_eff):
    """A grid of 3 persistent CTAs over 64 blocks: each CTA walks ~21
    blocks, so the state it resets between blocks (live-tile rows, the
    pack32 phase parity, the exact lists and queues, the query rows, the
    ring's stages and barrier phases, the copies in flight) is reused."""
    args, scale, q_scale = bs.int8_tie_inputs(
        cuda, s_eff=s_eff, n_blocks=64, nq=500, d=d, cap_total=8192,
        seed=k_pair)
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=True, pack32=pack32,
              slot_mask=s_eff - 1)
    _int8_held(args, kw, scale, q_scale,
               _int8_wg_route(d, pack32), n_ctas=3)


# the int8 warp-specialised instances' selects: exact k_pair 10 and 16
# (s_eff 200: a ragged last tile), pack32 k_pair 10 and 16 over 128 strided
# groups, 48 and 64 over 512 at s_eff 4096 (8 tiles a phase: the wgmma
# instances at every width, the narrow deep one included)
_WG8_SELECTS = [(False, 10, 640), (False, 16, 200), (True, 10, 640),
                (True, 16, 2048), (True, 48, 4096), (True, 64, 4096)]


@pytest.mark.gpu
@pytest.mark.parametrize("inputs", ["random", "ties"])
@pytest.mark.parametrize("pack32,k_pair,s_eff", _WG8_SELECTS)
@pytest.mark.parametrize("d", [16, 128, 256, 272, 1024])
def test_block_wg_int8_bit_equal(cuda, d, pack32, k_pair, s_eff, inputs):
    """The int8 warp-specialised instances (s8 wgmma k32 over a TMA ring):
    rows of 16 bytes (half a k32 step, zeros past it in both operands),
    128 and 256 (narrow: one and two stages a tile), 272 (k-chunked: the
    last of three stages 16 bytes wide) and 1,024 (eight stages, one s32
    chain); on random int8 inputs and on int8_tie_inputs (equal rows all
    over each window): live rows equal block_scan_ref bit for bit, ties
    included, pad rows dead, one launch counted under the route's own key,
    equal over two launches; the CUDA-core int8 kernel equal on every
    row."""
    make = bs.int8_tie_inputs if inputs == "ties" else bs.random_int8_inputs
    args, scale, q_scale = make(cuda, s_eff=s_eff, n_blocks=48, nq=500, d=d,
                                cap_total=8192, seed=d + k_pair + s_eff)
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=inputs == "random",
              pack32=pack32, slot_mask=bs.util.next_pow2(s_eff) - 1)
    route = _int8_wg_route(d, pack32)
    ref = _int8_held(args, kw, scale, q_scale, route)
    again = _block_uncounted(args, dict(kw, scale=scale, q_scale=q_scale),
                             route)
    live = args[1] >= 0
    assert torch.equal(again[live], ref[live])


@pytest.mark.gpu
@pytest.mark.parametrize("pack32,k_pair,s_eff", _WG8_SELECTS)
@pytest.mark.parametrize("d", [128, 256, 1024])
def test_block_wg_int8_persistent_grid(cuda, d, pack32, k_pair, s_eff):
    """The int8 warp-specialised instances on a grid of 3 persistent CTAs
    over 64 blocks: each CTA walks ~21 blocks through one ring (its stages,
    barrier phases and, narrow, its query buffers carried from block to
    block; blocks of one and of two live 64-prober tiles mixed), tie
    inputs, live rows bit for bit, pad rows dead."""
    args, scale, q_scale = bs.int8_tie_inputs(
        cuda, s_eff=s_eff, n_blocks=64, nq=500, d=d, cap_total=8192,
        seed=d + k_pair)
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=True, pack32=pack32,
              slot_mask=bs.util.next_pow2(s_eff) - 1)
    _int8_held(args, kw, scale, q_scale, _int8_wg_route(d, pack32),
               n_ctas=3)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [128, 1024])
@pytest.mark.parametrize("pack32,k_pair,s_eff", [(False, 10, 640),
                                                 (True, 16, 640),
                                                 (True, 64, 4096)])
@pytest.mark.parametrize("p_tile,n_live", [
    (16, 1), (16, 15), (64, 1), (64, 63), (128, 1), (128, 15), (128, 63),
    (128, 128)])
def test_block_wg_int8_liveness(cuda, p_tile, n_live, pack32, k_pair, s_eff,
                                d):
    """Blocks of p_tile probers with n_live live ones, first in odd blocks
    and last in even ones (a live 64-prober tile behind a dead one, warp
    slices of no live prober between live ones), on random int8 inputs at
    d = 128 (narrow) and 1024 (k-chunked): every live row covered and equal
    to block_scan_ref bit for bit, pad rows dead, on the card's grid and on
    3 persistent CTAs alike."""
    seed = p_tile + n_live + k_pair + d
    args, scale, q_scale = bs.random_int8_inputs(
        cuda, s_eff=s_eff, n_blocks=32, nq=500, d=d, cap_total=8192,
        seed=seed)
    g = torch.Generator(device=cuda).manual_seed(seed)
    pr = torch.randint(0, 500, (32, p_tile), generator=g, device=cuda,
                       dtype=torch.int32)
    pr[:, n_live:] = -1
    pr[0::2] = pr[0::2].roll(p_tile - n_live, dims=1)
    args[1] = pr.contiguous()
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=True, pack32=pack32,
              slot_mask=bs.util.next_pow2(s_eff) - 1, scale=scale,
              q_scale=q_scale)
    got, route = _block_launch(args, kw)
    assert route == _int8_wg_route(d, pack32)
    ref = bs.block_scan_ref(*args, **kw)
    live = args[1] >= 0
    assert int(live.sum()) == 32 * n_live
    for out in (got, _block_uncounted(args, kw, route, n_ctas=3)):
        _assert_pads(out, ref, args[1], route, k_pair, pack32)
        assert torch.equal(out[live], ref[live])


@pytest.mark.gpu
def test_block_wg_int8_entry_refuses_and_sizes(cuda):
    """The int8 warp-specialised entry points: their shared memory equals
    the mirror (ops/block_scan.py:wg_smem_bytes over an int8 cache) at
    every k_pair, narrow (d 16, 128, 256) and k-chunked (d 272, 1024),
    within the limit, one CTA an SM; the instance entry at inst_k ==
    k_pair equals the routed launch and refuses inst_k below k_pair; the
    entry refuses, without launching (cudaErrorInvalidValue, the output
    keeps its fill), rows not of 16-byte pieces (d 136), rows over 1,024
    bytes, exact k_pair 17 and a window past the cache."""
    from torchpq_tpu_torch import _build
    lib = _build.library()
    for d in (16, 128, 256, 272, 1024):
        for pack32 in (0, 1):
            for k_pair in range(1, 65 if pack32 else 17):
                assert lib.torchpq_block_scan_wg_int8_smem(
                    d, pack32, k_pair) == bs.wg_smem_bytes(
                        pack32, k_pair, d, torch.int8) <= bs._SMEM_LIMIT
                assert lib.torchpq_block_scan_wg_int8_occupancy(
                    d, pack32, k_pair) == 1
    stream = torch.cuda.current_stream().cuda_stream
    for d, k_pair, capacity, inst_k in ((136, 10, 4096, 10),
                                        (1040, 10, 4096, 10),
                                        (1024, 17, 4096, 17),
                                        (128, 10, 256, 10),
                                        (1024, 10, 4096, 9)):
        args, scale, q_scale = bs.random_int8_inputs(
            cuda, s_eff=512, n_blocks=4, nq=50, d=d, cap_total=4096)
        out = torch.full((4, 128, 2 * k_pair), 7, dtype=torch.int32,
                         device=cuda)
        ptrs = [x.data_ptr() for x in args]
        rc = lib.torchpq_block_scan_wg_int8_instance(
            ptrs[0], q_scale.data_ptr(), *ptrs[1:6], scale.data_ptr(),
            ptrs[6], out.data_ptr(), 4, 128, d, capacity, 512, k_pair, 1, 0,
            511, 0, 2, stream, inst_k)
        torch.cuda.synchronize()
        assert rc == 1  # cudaErrorInvalidValue
        assert bool((out == 7).all())
    args, scale, q_scale = bs.int8_tie_inputs(
        cuda, s_eff=2048, n_blocks=16, nq=500, d=1024, cap_total=8192)
    kw = dict(s_eff=2048, k_pair=64, euclidean=True, pack32=True,
              slot_mask=2047, scale=scale, q_scale=q_scale)
    out = torch.empty((16, 128, 64), dtype=torch.int32, device=cuda)
    ptrs = [x.data_ptr() for x in args]
    rc = lib.torchpq_block_scan_wg_int8_instance(
        ptrs[0], q_scale.data_ptr(), *ptrs[1:6], scale.data_ptr(), ptrs[6],
        out.data_ptr(), 16, 128, 1024, args[6].shape[0], 2048, 64, 1, 1,
        2047, 512, 3, stream, 64)
    torch.cuda.synchronize()
    assert rc == 0
    assert torch.equal(out, _block_uncounted(args, kw, "tc_wg_int8_pack32"))


@pytest.mark.gpu
def test_int8_index_on_card_matches_cpu(cuda, f32_search):
    """An int8 index (scan_cache_dtype="int8") with the same state and adds
    on the card and on the CPU: equal int8 rows and scales, and every plan
    finds the same neighbours, the probed ones through both int8 selects
    of the tensor-core kernel on the card (and never the CUDA-core one)."""
    import numpy as np
    import torchpq_tpu_torch as tp

    rng = np.random.default_rng(0)
    centers = rng.normal(size=(40, 32)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 40, 6000)]
         + rng.normal(size=(6000, 32))).astype(np.float32)
    q = x[:200] + 0.1 * rng.normal(size=(200, 32)).astype(np.float32)
    cpu = tp.IVFPQIndex(32, 8, 16, initial_size=32, scan_cache_dtype="int8",
                        device="cpu")
    cpu.train(x[:2000].T)
    gpu = tp.IVFPQIndex(32, 8, 16, initial_size=32, scan_cache_dtype="int8",
                        device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    for chunk in (x[:3000], x[3000:]):
        cpu.add(chunk.T)
        gpu.add(torch.from_numpy(chunk).to(cuda).T)
    assert gpu.max_cell_capacity > 32, "the adds must relayout"
    assert torch.equal(gpu.aux("decoded").cpu(), cpu.aux("decoded"))
    assert torch.equal(gpu.aux("scale").cpu(), cpu.aux("scale"))
    before = dict(bs.launches)
    for mode, approx in (("cell_major", False), ("cell_major", True),
                         ("query_major", False), ("flat", False)):
        for idx in (cpu, gpu):
            idx.scan_mode, idx.use_approx_topk, idx.n_probe = mode, approx, 4
        v_ref, i_ref = cpu.search(q.T, k=10)
        v, i = gpu.search(torch.from_numpy(q).to(cuda).T, k=10)
        shared = sum(len(set(a.tolist()) & set(b.tolist()))
                     for a, b in zip(i.cpu(), i_ref)) / i_ref.numel()
        assert shared >= 0.99, (mode, approx, shared)
        if not approx:
            # the norms (penalties) are sums in another order on the card
            torch.testing.assert_close(v.cpu(), v_ref, rtol=1e-3, atol=1e-2)
            continue
        assert adc.LAST_GATE["cache"] == "int8"
        _assert_pack32_values(v, v_ref, i, i_ref, q, adc.LAST_GATE["s_eff"])
    assert bs.launches == dict(
        before, tc_wgn_int8_exact=before["tc_wgn_int8_exact"] + 2,
        tc_wgn_int8_pack32=before["tc_wgn_int8_pack32"] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nq,cap,r_keep", [(300, 20000, 16), (1000, 65536, 32),
                                           (40, 4096, 8)])
def test_flat_kernel_matches_plain(cuda, dtype, nq, cap, r_keep):
    """The flat scan against flat_scan_ref: the same bucket candidates and
    order; scores differ only by the f32 summation order of the plain
    version's GEMM (bf16 products are exact in f32), so values agree to
    1e-3 relative and addresses on >= 0.99 of entries (near ties may
    swap). cap 20000 is not a multiple of the 2048-slot window. bf16 at
    d = 128 takes the warp-specialised kernel, f32 the CUDA-core one."""
    args = fs.random_flat_inputs(cuda, nq=nq, cap=cap, dtype=dtype)
    route = fs.pick_route(dtype, 128)
    before = fs.launches[route]
    v, a = fs.flat_scan(*args, r_keep=r_keep, euclidean=True)
    torch.cuda.synchronize()
    assert fs.launches[route] == before + 1
    v_ref, a_ref = fs.flat_scan_ref(*args, r_keep=r_keep, euclidean=True)
    torch.testing.assert_close(v, v_ref, rtol=1e-3, atol=1e-3)
    assert (a == a_ref).float().mean().item() >= 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("d", [136, 256, 1024])
@pytest.mark.parametrize("nq,cap,r_keep", [(300, 20000, 16), (1000, 60000, 32),
                                           (40, 4100, 8)])
def test_flat_tc_kernel_matches_plain(cuda, d, nq, cap, r_keep):
    """The mma.sync route (bf16, 128 < d <= 1024) against flat_scan_ref on
    random bf16 inputs, at the tolerances of the test above (the tensor
    cores sum in another order than the plain version's GEMM). Every cap
    is off the 2048-slot window; the cache is walked in K chunks of 128
    with the queries in shared memory (d 136: a chunk of 8)."""
    args = fs.random_flat_inputs(cuda, nq=nq, cap=cap, d=d, seed=d + cap)
    before = dict(fs.launches)
    v, a = fs.flat_scan(*args, r_keep=r_keep, euclidean=True)
    torch.cuda.synchronize()
    assert fs.launches == dict(before, flat_tc=before["flat_tc"] + 1)
    v_ref, a_ref = fs.flat_scan_ref(*args, r_keep=r_keep, euclidean=True)
    torch.testing.assert_close(v, v_ref, rtol=1e-3, atol=1e-3)
    assert (a == a_ref).float().mean().item() >= 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("d,r_keep,euclidean", [(136, 16, True),
                                                (256, 32, False),
                                                (1024, 16, True),
                                                (200, 8, True)])
def test_flat_tc_kernel_integer_ties_exact(cuda, d, r_keep, euclidean):
    """Integer-valued inputs with equal rows inside and across buckets:
    every sum is exact in any order, so the mma.sync kernel equals the
    plain version bit for bit, values and addresses, ties included."""
    args = fs.integer_flat_inputs(cuda, nq=500, cap=30000, d=d, seed=d)
    before = fs.launches["flat_tc"]
    v, a = fs.flat_scan(*args, r_keep=r_keep, euclidean=euclidean)
    torch.cuda.synchronize()
    assert fs.launches["flat_tc"] == before + 1
    v_ref, a_ref = fs.flat_scan_ref(*args, r_keep=r_keep, euclidean=euclidean)
    assert torch.equal(v, v_ref)
    assert torch.equal(a, a_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 64, 72, 128])
@pytest.mark.parametrize("r_keep", [8, 16, 32])
def test_flat_wg_kernel_matches_plain(cuda, d, r_keep):
    """The warp-specialised route (bf16, d % 8 == 0, d <= 128: one k half
    at d <= 64, two above, the last one partial at d 72) against
    flat_scan_ref on random bf16 inputs, at the tolerances of the tests
    above (the tensor cores sum in another order than the plain version's
    GEMM); cap 20,000 is off the 2048-slot window and off a run."""
    args = fs.random_flat_inputs(cuda, nq=300, cap=20000, d=d,
                                 seed=d + r_keep)
    before = dict(fs.launches)
    v, a = fs.flat_scan(*args, r_keep=r_keep, euclidean=True)
    torch.cuda.synchronize()
    assert fs.launches == dict(before, flat_wg=before["flat_wg"] + 1)
    v_ref, a_ref = fs.flat_scan_ref(*args, r_keep=r_keep, euclidean=True)
    torch.testing.assert_close(v, v_ref, rtol=1e-3, atol=1e-3)
    assert (a == a_ref).float().mean().item() >= 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("nq", [1, 63, 10000])
@pytest.mark.parametrize("cap", [2048, 20000])
def test_flat_wg_kernel_shapes(cuda, nq, cap):
    """The warp-specialised route at the query counts of one row, of one
    partial query tile (63 of 192) and of the flat plan (10,000: 53 tiles,
    the last partial), over one window and over a cache off the window and
    off the runs: within the tolerances above."""
    args = fs.random_flat_inputs(cuda, nq=nq, cap=cap, seed=nq + cap)
    v, a = fs.flat_scan(*args, r_keep=16, euclidean=True)
    torch.cuda.synchronize()
    v_ref, a_ref = fs.flat_scan_ref(*args, r_keep=16, euclidean=True)
    torch.testing.assert_close(v, v_ref, rtol=1e-3, atol=1e-3)
    assert (a == a_ref).float().mean().item() >= 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("r_keep", [8, 16, 32])
@pytest.mark.parametrize("euclidean", [True, False])
def test_flat_wg_kernel_integer_ties_exact(cuda, d, r_keep, euclidean):
    """Integer-valued inputs with equal rows inside and across buckets:
    every sum is exact in any order, so the warp-specialised kernel equals
    the plain version bit for bit, values and addresses, ties included (c
    folded into the query, the bound-pruned epilogue, the runs' shared
    bound)."""
    args = fs.integer_flat_inputs(cuda, nq=500, cap=30000, d=d, seed=d)
    before = fs.launches["flat_wg"]
    v, a = fs.flat_scan(*args, r_keep=r_keep, euclidean=euclidean)
    torch.cuda.synchronize()
    assert fs.launches["flat_wg"] == before + 1
    v_ref, a_ref = fs.flat_scan_ref(*args, r_keep=r_keep, euclidean=euclidean)
    assert torch.equal(v, v_ref)
    assert torch.equal(a, a_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("n_splits", [1, 3, 15])
def test_flat_wg_kernel_runs_agree(cuda, n_splits):
    """The warp-specialised kernel over the cache in 1, 3 or 15 runs (each
    run's list filling on its own, the runs sharing their bound, merged in
    address order) returns the same lists, bit for bit on integer inputs,
    as flat_scan_ref."""
    from torchpq_tpu_torch import _build
    args = fs.integer_flat_inputs(cuda, nq=700, cap=15 * 2048, d=128,
                                  seed=n_splits)
    v, a = fs._launch_wg(_build.library(),
                         torch.cuda.current_stream().cuda_stream, *args,
                         r_keep=16, euclidean=True, n_splits=n_splits)
    torch.cuda.synchronize()
    v_ref, a_ref = fs.flat_scan_ref(*args, r_keep=16, euclidean=True)
    assert torch.equal(v, v_ref)
    assert torch.equal(a, a_ref)


@pytest.mark.gpu
def test_flat_wg_smem_matches_mirror(cuda):
    """The kernel's shared memory (its _smem entry) equals
    ops/flat_scan.py's mirror at every width and r_keep it takes, and a CTA
    of it fits an SM (its _occupancy entry)."""
    from torchpq_tpu_torch import _build
    lib = _build.library()
    for d in range(8, 129, 8):
        for r_keep in (1, 8, 16, 17, 32):
            assert lib.torchpq_flat_scan_wg_smem(d, r_keep) == \
                fs.wg_smem_bytes(d, r_keep), (d, r_keep)
    assert lib.torchpq_flat_scan_wg_occupancy(128, 32) >= 1


@pytest.mark.gpu
def test_flat_routes_on_card(cuda):
    """bf16 at d = 128 launches the warp-specialised kernel, at d = 256 the
    mma.sync one; an f32 cache and a bf16 cache at d = 100 launch the
    CUDA-core one; each counts under its own key and matches the plain
    version."""
    for dtype, d, route in ((torch.bfloat16, 128, "flat_wg"),
                            (torch.bfloat16, 256, "flat_tc"),
                            (torch.float32, 128, "flat"),
                            (torch.bfloat16, 100, "flat")):
        args = fs.random_flat_inputs(cuda, nq=200, cap=8192, d=d,
                                     dtype=dtype)
        before = dict(fs.launches)
        v, a = fs.flat_scan(*args, r_keep=16, euclidean=True)
        torch.cuda.synchronize()
        assert fs.launches == dict(before, **{route: before[route] + 1})
        v_ref, a_ref = fs.flat_scan_ref(*args, r_keep=16, euclidean=True)
        torch.testing.assert_close(v, v_ref, rtol=1e-3, atol=1e-3)
        assert (a == a_ref).float().mean().item() >= 0.99


@pytest.mark.gpu
def test_pallas_flat_index_on_card(cuda):
    """scan_impl="pallas_flat": the flat plan launches the flat kernel on
    the card (the bf16 cache at d = 32: the warp-specialised route) and finds
    what the same index finds on the CPU (the plain version; only the f32
    sum order differs); scan_impl="pallas" raises on the card where the
    block scan's gate fails (k_pair > 64)."""
    import numpy as np
    import torchpq_tpu_torch as tp

    rng = np.random.default_rng(1)
    centers = rng.normal(size=(40, 32)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 40, 6000)]
         + rng.normal(size=(6000, 32))).astype(np.float32)
    q = x[:300] + 0.1 * rng.normal(size=(300, 32)).astype(np.float32)
    cpu = tp.IVFPQIndex(32, 8, 16, initial_size=32, device="cpu")
    cpu.train(x[:2000].T)
    gpu = tp.IVFPQIndex(32, 8, 16, initial_size=32, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    cpu.add(x.T)
    gpu.add(torch.from_numpy(x).to(cuda).T)
    for idx in (cpu, gpu):
        idx.scan_mode, idx.scan_impl, idx.use_approx_topk = \
            "flat", "pallas_flat", True
    v_ref, i_ref = cpu.search(q.T, k=10)
    before = fs.launches["flat_wg"]
    v, i = gpu.search(torch.from_numpy(q).to(cuda).T, k=10)
    assert fs.launches["flat_wg"] == before + 1
    assert flat_adc.LAST_FLAT["impl"] == "flat_scan"
    shared = sum(len(set(a.tolist()) & set(b.tolist()))
                 for a, b in zip(i.cpu(), i_ref)) / i_ref.numel()
    assert shared >= 0.99, shared
    torch.testing.assert_close(v.cpu(), v_ref, rtol=1e-3, atol=1e-2)
    gpu.scan_mode, gpu.scan_impl, gpu.use_approx_topk = \
        "cell_major", "pallas", False
    with pytest.raises(ValueError, match="pallas"):
        gpu.search(torch.from_numpy(q).to(cuda).T, k=80)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("d", [128, 3])
def test_gather_kernel_matches_plain(cuda, dtype, idx_dtype, d):
    """Bit for bit, out-of-range indices clipped; d = 3 rows are too narrow
    for 16-byte copies."""
    g = torch.Generator(device=cuda).manual_seed(0)
    table = (torch.randn(1000, d, generator=g, device=cuda) * 50).to(dtype)
    idx = torch.randint(-50, 1100, (4096,), generator=g, device=cuda,
                        dtype=idx_dtype)
    before = gr.launches["gather"]
    got = gr.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert gr.launches["gather"] == before + 1
    assert torch.equal(got, gr.gather_rows_ref(table, idx))


def _ids_by_plan(cpu, gpu, q, k, plans):
    """Every plan on both devices: values within 1e-3 (rel 1e-3; pack32 by
    _assert_pack32_values where the ids agree) and ids equal outside ties
    (exact plans) or shared on >= 0.99 (pack32)."""
    for mode, approx in plans:
        for idx in (cpu, gpu):
            idx.scan_mode, idx.use_approx_topk, idx.n_probe = mode, approx, 4
        v_ref, i_ref = cpu.search(q.T, k=k)
        v, i = gpu.search(torch.from_numpy(q).to(gpu.device).T, k=k)
        if approx and mode == "cell_major" and not gpu._code_domain:
            shared = sum(len(set(a.tolist()) & set(b.tolist()))
                         for a, b in zip(i.cpu(), i_ref)) / i_ref.numel()
            assert shared >= 0.99, (mode, approx, shared)
            _assert_pack32_values(v, v_ref, i, i_ref, q,
                                  adc.LAST_GATE["s_eff"])
        elif approx:
            shared = sum(len(set(a.tolist()) & set(b.tolist()))
                         for a, b in zip(i.cpu(), i_ref)) / i_ref.numel()
            assert shared >= 0.95, (mode, approx, shared)
        else:
            _assert_topk_ties(v, i, v_ref, i_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("cache", [None, "int8", "none"])
def test_ivfpqr_on_card_matches_cpu(cuda, f32_search, cache, tmp_path):
    """IVFPQRIndex on the card against the CPU: train from equal initial
    centroids on both (codebooks within 1e-2), then the CPU's trained state
    on both, two adds that relayout (equal codes, rerank codes and ids; the
    refined cache rows or the norm deltas within 1e-3), every plan, a
    remove, a forced relayout (expand) and an npz saved on the card and
    loaded on the CPU, each held to the CPU tie-aware."""
    import numpy as np
    import torchpq_tpu_torch as tp

    rng = np.random.default_rng(1)
    centers = rng.normal(size=(40, 32)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 40, 6000)]
         + rng.normal(size=(6000, 32))).astype(np.float32)
    q = x[:200] + 0.1 * rng.normal(size=(200, 32)).astype(np.float32)
    kw = dict(d_vector=32, n_subvectors=8, n_subvectors_rerank=8,
              n_cells=16, initial_size=32, scan_cache_dtype=cache)
    cpu = tp.IVFPQRIndex(**kw, device="cpu")
    gpu = tp.IVFPQRIndex(**kw, device=cuda)
    for idx in (cpu, gpu):
        seed_fits(idx)
    cpu.train(x[:2000].T)
    gpu.train(torch.from_numpy(x[:2000]).to(cuda).T)
    for name in ("vq_codec", "pq_codec", "rerank_codec"):
        torch.testing.assert_close(
            getattr(gpu, name).kmeans._centroids.cpu(),
            getattr(cpu, name).kmeans._centroids, rtol=1e-2, atol=1e-2)
    gpu.load_state_dict(cpu.state_dict())
    for chunk in (x[:3000], x[3000:]):
        cpu.add(chunk.T)
        gpu.add(torch.from_numpy(chunk).to(cuda).T)
    assert gpu.max_cell_capacity > 32, "the adds must relayout"
    for name in ("_storage", "_address2id", "_aux_rerank_codes"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name))
    derived = "dnorm2" if cache == "none" else "decoded"
    torch.testing.assert_close(gpu.aux(derived).cpu().float(),
                               cpu.aux(derived).float(), rtol=1e-3,
                               atol=1e-3 if cache != "int8" else 1.0)
    plans = (("cell_major", False), ("cell_major", True), ("flat", False))
    _ids_by_plan(cpu, gpu, q, 10, plans)
    rm = np.arange(0, 6000, 9)
    assert gpu.remove(rm) == cpu.remove(rm)
    for idx in (cpu, gpu):
        idx.expand()
    _ids_by_plan(cpu, gpu, q, 10, plans)
    gpu.save(str(tmp_path / "r.npz"))
    back = tp.IVFPQRIndex(**kw, device="cpu")
    back.load(str(tmp_path / "r.npz"))
    _ids_by_plan(back, gpu, q, 10, plans[:1])


@pytest.mark.gpu
@pytest.mark.parametrize("distance", ["euclidean", "cosine", "manhattan"])
def test_flat_index_on_card_matches_cpu(cuda, f32_search, distance, tmp_path):
    """FlatIndex on the card against the CPU: the same adds, removes and
    growth give equal stores and id maps; searches (k 10 and k above the
    rows held) within 1e-3 with ids equal outside ties; an npz saved on
    the card loads on the CPU."""
    import numpy as np
    import torchpq_tpu_torch as tp

    rng = np.random.default_rng(2)
    x = rng.normal(size=(5000, 48)).astype(np.float32)
    q = rng.normal(size=(300, 48)).astype(np.float32)
    kw = dict(d_vector=48, distance=distance, initial_size=1024)
    cpu, gpu = tp.FlatIndex(**kw, device="cpu"), tp.FlatIndex(**kw,
                                                              device=cuda)
    for chunk in (x[:3000], x[3000:]):
        cpu.add(chunk.T)
        gpu.add(torch.from_numpy(chunk).to(cuda).T)
    rm = rng.choice(5000, 500, replace=False)
    assert gpu.remove(rm) == cpu.remove(rm) == 500
    for name in ("_address2id", "_id2address"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name))
    torch.testing.assert_close(gpu._storage.cpu(), cpu._storage)
    v_ref, i_ref = cpu.search(q.T, k=10)
    v, i = gpu.search(torch.from_numpy(q).to(cuda).T, k=10)
    _assert_topk_ties(v, i, v_ref, i_ref, rtol=1e-4, atol=1e-3)
    gpu.save(str(tmp_path / "f.npz"))
    back = tp.FlatIndex(**kw, device="cpu")
    back.load(str(tmp_path / "f.npz"))
    small = tp.FlatIndex(**kw, device=cuda)
    small.add(torch.from_numpy(x[:4]).to(cuda).T)
    v4, i4 = small.search(torch.from_numpy(q).to(cuda).T, k=6)
    assert bool((i4[:, 4:] == -1).all()) and bool(torch.isinf(v4[:, 4:]).all())
    v_b, i_b = back.search(q.T, k=10)
    _assert_topk_ties(v, i, v_b, i_b, rtol=1e-4, atol=1e-3)


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A world of one rank over NCCL (this process) and its mesh; the
    group is destroyed after the module's tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL runs on cards only")
    import torch.distributed as dist
    import torchpq_tpu_torch as tp
    torch.cuda.set_device(0)
    store = dist.FileStore(str(tmp_path_factory.mktemp("nccl") / "store"),
                           1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        yield tp.parallel.get_mesh(1)
    finally:
        dist.destroy_process_group()


def _card_index(cuda, cache, n=6000, seed=3):
    """A small index on the card (IVF16 x PQ8, d 32) with the CPU's trained
    state, filled by two adds; returns (card index, rows, queries)."""
    import numpy as np
    import torchpq_tpu_torch as tp
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(40, 32)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 40, n)]
         + rng.normal(size=(n, 32))).astype(np.float32)
    q = x[:300] + 0.1 * rng.normal(size=(300, 32)).astype(np.float32)
    kw = dict(d_vector=32, n_subvectors=8, n_cells=16, initial_size=256,
              scan_cache_dtype=cache)
    cpu = tp.IVFPQIndex(**kw, device="cpu")
    cpu.vq_max_iter = cpu.pq_max_iter = 6
    cpu.train(x[:2000].T)
    gpu = tp.IVFPQIndex(**kw, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    for chunk in (x[: n // 2], x[n // 2:]):
        gpu.add(torch.from_numpy(chunk).to(cuda).T)
    return gpu, x, q


@pytest.mark.gpu
@pytest.mark.parametrize("cache", [None, "int8", "none"])
def test_sharded_d1_on_card_matches_single(cuda, nccl_mesh, cache):
    """ShardedIVFPQSearcher over a world of one NCCL rank: each tier's
    probed plans launch the tensor-core scans and match the index's own
    search over the same (uncompacted) layout, exact plans tie-aware,
    pack32 on >= 0.99 of ids; flat; then an add and a remove against the
    same on the index."""
    import numpy as np
    import torchpq_tpu_torch as tp
    gpu, x, q = _card_index(cuda, cache)
    gpu.scan_compact = False
    s = tp.parallel.ShardedIVFPQSearcher(gpu, mesh=nccl_mesh)
    qt = torch.from_numpy(q).to(cuda)
    counters = cs.launches if cache == "none" else bs.launches
    for mode, approx in (("cell_major", False), ("cell_major", True),
                         ("flat", False)):
        gpu.scan_mode, gpu.use_approx_topk, gpu.n_probe = mode, approx, 4
        s.scan_mode = mode
        before = dict(counters)
        v, i = s.search(qt.T, k=10)
        launched = {key: counters[key] - before[key] for key in counters}
        v_ref, i_ref = gpu.search(qt.T, k=10)
        if mode == "cell_major":
            assert sum(n for key, n in launched.items()
                       if key.startswith("tc_")) == 1, launched
        if approx:
            shared = sum(len(set(a.tolist()) & set(b.tolist()))
                         for a, b in zip(i.cpu(), i_ref.cpu())) / i.numel()
            assert shared >= 0.99, shared
        else:
            _assert_topk_ties(v, i, v_ref.cpu(), i_ref.cpu())
    extra = torch.from_numpy(x[:500] + 0.5).to(cuda)
    ids_ref = gpu.add(extra.T)
    assert torch.equal(s.add(extra.T), ids_ref)
    rm = np.arange(0, 6500, 7)
    assert s.remove(rm) == gpu.remove(rm)
    gpu.scan_mode, gpu.use_approx_topk = "cell_major", False
    s.scan_mode = "cell_major"
    v, i = s.search(qt.T, k=10)
    v_ref, i_ref = gpu.search(qt.T, k=10)
    _assert_topk_ties(v, i, v_ref.cpu(), i_ref.cpu())


@pytest.mark.gpu
def test_dp_kmeans_d1_on_card(cuda, nccl_mesh):
    """data_parallel_kmeans_fit over one NCCL rank equals a plain Lloyd loop
    from the same initial rows (relative 1e-5: the same operations), and
    the lloyd step one iteration of it."""
    import numpy as np
    import torchpq_tpu_torch as tp
    from torchpq_tpu_torch.ops.max_sim import max_sim
    from torchpq_tpu_torch.ops.segment_ops import compute_centroids
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(5000, 16)).astype(np.float32)).to(cuda)
    cents, it = tp.parallel.data_parallel_kmeans_fit(
        x, 32, mesh=nccl_mesh, max_iter=5, tol=0.0, seed=2)
    ref = x[torch.as_tensor(np.random.default_rng(2).choice(
        5000, 32, replace=False), device=cuda)]
    step = tp.parallel.data_parallel_lloyd_step(nccl_mesh, x, ref,
                                                "euclidean")
    for i in range(5):
        _, labels = max_sim(x, ref, "euclidean")
        sums, cnt = compute_centroids(x, labels, 32)
        ref = torch.where((cnt > 0)[:, None],
                          sums / torch.clamp(cnt, min=1.0)[:, None], ref)
        if i == 0:
            torch.testing.assert_close(step, ref, rtol=1e-5, atol=1e-5)
    assert it == 5
    torch.testing.assert_close(cents, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_host_spill_on_card_matches_cpu(cuda, f32_search):
    """spill_impl="host" on the card: the cells the CPU gives from the same
    state, on >= 0.99 of items (the greedy runs on the host either way; the
    top cells come from each device's coarse GEMM, whose near ties may
    order two candidates apart)."""
    import numpy as np
    import torchpq_tpu_torch as tp
    gpu, x, _ = _card_index(cuda, None, n=2000)
    cpu = tp.IVFPQIndex(d_vector=32, n_subvectors=8, n_cells=16,
                        initial_size=256, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    for idx in (cpu, gpu):
        idx.spill_cells, idx.spill_capacity = 4, 200
        idx.spill_impl = "host"
    y = x + np.float32(0.25)
    _, a_ref = cpu.add(y.T, return_address=True)
    _, a = gpu.add(torch.from_numpy(y).to(cuda).T, return_address=True)
    assert tp.native.LAST_ROUTE["spill_assign"] == "cpp"
    cells = gpu.get_cell_by_address(a).cpu()
    assert (cells == cpu.get_cell_by_address(a_ref)).float().mean() \
        .item() >= 0.99
    assert gpu.n_items == cpu.n_items == 4000


@pytest.mark.gpu
def test_legacy_and_profiling_on_card(cuda, f32_search, tmp_path):
    """The v1 IVFPQ facade on the card against its CPU twin from the same
    state (ids equal outside ties), with its CPU-RAM SQ tier; one search
    inside profiling.trace and named_scope: the scope and the card's
    kernels are in the Chrome trace; PhaseTimer and Timer sync the card."""
    import json
    import numpy as np
    import torchpq_tpu_torch as tp
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4000, 32)).astype(np.float32)
    kw = dict(d_vector=32, n_subvectors=8, n_cq_clusters=16, blocksize=256)
    card = tp.legacy.IVFPQ(**kw, device=cuda,
                           cpu_quantizer=tp.legacy.SQ(bits=8, device=cuda))
    card.train(torch.from_numpy(x[:2000]).to(cuda).T)
    cpu = tp.legacy.IVFPQ(**kw, device="cpu")
    cpu._index.load_state_dict(card._index.state_dict())
    ids = card.add(torch.from_numpy(x).to(cuda).T)
    assert torch.equal(ids.cpu(), cpu.add(x.T))
    card.n_probe = cpu.n_probe = 4
    # the plan the CPU's planner picks, pinned on both: the card's planner
    # reads the card's costs (index/ivfpq.py:plan_for)
    cpu._index.scan_mode = cpu._index.plan_scan_mode(200, 5)
    card._index.scan_mode = cpu._index.scan_mode
    timer = tp.profiling.PhaseTimer()
    with tp.profiling.trace(str(tmp_path)) as prof:
        with tp.profiling.named_scope("legacy_topk"), timer.phase("topk"):
            v, i = card.topk(torch.from_numpy(x[:200]).to(cuda).T, k=5)
    v_ref, i_ref = cpu.topk(x[:200].T, k=5)
    _assert_topk_ties(v, i, v_ref, i_ref)
    rec = card.reconstruct_from_cpu_ram(ids[:50])
    assert float((rec.cpu().T - torch.from_numpy(x[:50])).abs().mean()) \
        < 0.05
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "legacy_topk" for e in events)
    assert any(e.get("cat") == "kernel" for e in events)
    assert timer.report()["topk"] > 0
    assert tp.util.Timer().tick(sync=v) >= 0


@pytest.mark.gpu
@pytest.mark.parametrize("cls", ["KMeans", "MultiKMeans"])
def test_kmeans_trains_reproducibly_on_card(cuda, cls):
    """Two trainings from seed 0 on the card give bit-equal centroids: the
    Lloyd sums sort by label and sum each cluster in a fixed order
    (ops/segment_ops.py), with PyTorch's deterministic switch left off."""
    import numpy as np
    import torchpq_tpu_torch as tp
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(4, 8, 20_000)).astype(np.float32)).to(cuda)
    cents = []
    for _ in range(2):
        if cls == "KMeans":
            km = tp.clustering.KMeans(n_clusters=256, seed=0, device=cuda)
            km.fit(x[0])
        else:
            km = tp.clustering.MultiKMeans(n_clusters=64, seed=0,
                                           device=cuda)
            km.fit(x)
        cents.append(km.centroids)
        assert not torch.are_deterministic_algorithms_enabled()
    assert torch.equal(cents[0], cents[1])


@pytest.mark.gpu
def test_planner_on_card(cuda):
    """A CUDA index's "auto" plan is plan_for's on the card's table from
    its shadows (the CPU twin keeps the JAX package's rule), and a search
    under it equals the search pinned to that plan; the batch threshold
    of card queries is the card's, and search_cells under "auto" runs
    card_probed_plan's plan."""
    import torchpq_tpu_torch as tp
    from torchpq_tpu_torch.fn.ivfpq_topk import (BATCH_THRESHOLD,
                                                 batch_threshold_for)
    from torchpq_tpu_torch.index.ivfpq import card_probed_plan, plan_for
    gpu, _, q = _card_index(cuda, None)
    qt = torch.from_numpy(q).to(cuda).T
    gpu.use_approx_topk = True
    for nq, k, n_probe in ((300, 10, 4), (1, 10, 4), (300, 100, 16)):
        gpu.scan_mode, gpu.n_probe = "auto", n_probe
        plan = gpu.plan_scan_mode(nq, k)
        assert plan == plan_for(nq, k, **gpu._plan_shadows())
        assert plan == plan_for(nq, k, **dict(gpu._plan_shadows(),
                                              device="cuda"))
        v, i = gpu.search(qt[:, :nq], k=k)
        gpu.scan_mode = plan
        v_p, i_p = gpu.search(qt[:, :nq], k=k)
        assert torch.equal(v, v_p) and torch.equal(i, i_p), (nq, k, plan)
    assert batch_threshold_for(gpu.device) == BATCH_THRESHOLD["cuda"]
    for mode in ("flat", "cell_major", "query_major"):
        gpu.scan_mode = mode
        assert gpu.plan_scan_mode(300, 10) == mode
    # the IVFPQTopk facade (search_cells) picks its probed plan the same way
    cells = torch.arange(4, device=cuda).repeat(8, 1)
    plan = card_probed_plan(
        8, 10, n_probe=4, s_pow2=tp.util.next_pow2(gpu.max_cell_capacity),
        d_vector=gpu.aux("decoded").shape[1], tier="bf16", approx=True)
    gpu.scan_mode = "auto"
    v, i = gpu.search_cells(qt[:, :8], cells, k=10)
    gpu.scan_mode = plan
    v_p, i_p = gpu.search_cells(qt[:, :8], cells, k=10)
    assert torch.equal(v, v_p) and torch.equal(i, i_p), plan


@pytest.mark.gpu
@pytest.mark.parametrize("d", [32, 128, 1024])
def test_matmul_precisions_on_card(cuda, d):
    """util.matmul on the card: "default" and "high" within the f32
    summation bound of their plain versions' f64 counterparts (the
    tensor cores' accumulation truncates: one f32 unit, 2^-23, per term
    summed; "high" three GEMMs of it and bf16_3x's dropped terms, 2^-14);
    "highest" bit-equal to a.float() @ b.float().T; on bf16 operands
    "default" and "high" are the one GEMM, within the bound of the f64
    product; alpha and bias as the f32 addmm's up to that bound."""
    from torchpq_tpu_torch import util
    gen = torch.Generator(device=cuda).manual_seed(d)
    a = torch.randn(300, d, device=cuda, generator=gen) \
        * torch.rand(300, 1, device=cuda, generator=gen) * 10
    b = torch.randn(700, d, device=cuda, generator=gen)
    unit = 2.0 ** -23

    def bound(x, y, precision):
        mag = x.double().abs() @ y.double().abs().T
        if precision == "high":
            return (2.0 ** -14 + 2 * (d + 4) * unit) * mag
        return (d + 2) * unit * mag

    assert torch.equal(util.matmul(a, b, "highest"), a.float() @ b.float().T)
    for p in ("default", "high"):
        x, y = (a.to(torch.bfloat16), b.to(torch.bfloat16)) \
            if p == "default" else (a, b)
        want = x.double() @ y.double().T
        tol = bound(x, y, p)
        got = util.matmul(a, b, p)
        assert got.dtype == torch.float32
        assert bool(((got.double() - want).abs() <= tol).all()), p
        plain = util.matmul_plain(a, b, p)
        assert bool(((plain.double() - want).abs() <= tol).all()), p
        bias = torch.randn(1, 700, device=cuda, generator=gen)
        got = util.matmul(a, b, p, alpha=2.0, bias=bias)
        assert bool(((got.double() - (2 * want + bias.double())).abs()
                     <= 2 * tol + 2 * unit * bias.double().abs()).all()), p
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    got = util.matmul(a16, b16, "default")
    assert torch.equal(got, util.matmul(a16, b16, "high"))
    want = a16.double() @ b16.double().T
    assert bool(((got.double() - want).abs()
                 <= bound(a16, b16, "default")).all())
    # batched, as the query-major scan and the LUT use it
    got = util.matmul(a16.reshape(10, 30, d), b16.reshape(10, 70, d),
                      "default")
    want = a16.reshape(10, 30, d).double() @ b16.reshape(
        10, 70, d).double().transpose(1, 2)
    assert bool(((got.double() - want).abs() <= (d + 2) * unit * (
        a16.reshape(10, 30, d).double().abs()
        @ b16.reshape(10, 70, d).double().abs().transpose(1, 2))).all())


@pytest.mark.gpu
def test_search_precision_on_card(cuda):
    """A card index's flat plan and FlatIndex at each search precision
    record it; "default" finds what "highest" finds on >= 0.99 of ids;
    use_tensor_core = False searches at "highest"."""
    import numpy as np
    import torchpq_tpu_torch as tp
    from torchpq_tpu_torch import config
    gpu, _, q = _card_index(cuda, None)
    qt = torch.from_numpy(q).to(cuda).T
    flat = tp.FlatIndex(d_vector=gpu.d_vector, device=cuda)
    rng = np.random.default_rng(3)
    flat.add(torch.from_numpy(rng.normal(size=(gpu.d_vector, 5000))
                              .astype(np.float32)).to(cuda))
    keep = config.SEARCH_PRECISION
    ids = {}
    try:
        for p in ("default", "high", "highest"):
            config.set_search_precision(p)
            gpu.scan_mode = "flat"
            ids[p] = gpu.search(qt, k=10)[1]
            assert flat_adc.LAST_FLAT["precision"] == p
            flat.search(qt, k=10)
            assert tp.index.flat.LAST_SEARCH["precision"] == p
        agree = (ids["default"] == ids["highest"]).float().mean().item()
        assert agree >= 0.99, agree
        config.set_search_precision("default")
        gpu.scan_mode, gpu.use_tensor_core = "cell_major", False
        gpu.search(qt, k=10)
        assert adc.LAST_GATE["precision"] == "highest"
    finally:
        config.set_search_precision(keep)
        gpu.use_tensor_core = True
