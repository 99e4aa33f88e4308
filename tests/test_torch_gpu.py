"""The port's CUDA kernels (block scan on its bf16 and int8 tensor-core
routes and in its bf16/f32 and int8 modes on the CUDA cores, codes scan and
flat scan on their tensor-core and CUDA-core routes, row gather)
against their plain PyTorch versions, and the device spill routing against
its CPU result, on a card; the indexes card against CPU; the sharded
searcher and data-parallel k-means over a world of one NCCL rank, the host
spill, the v1 facade and the profiling helpers on the card.

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
    assert route == ("tc_" if tc else "") + mode
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
def test_block_tc_kernel_matches_plain(cuda, s_eff, pack32, k_pair):
    """The tensor-core block scan on random bf16 inputs at the main path's
    width (d = 128): s_eff 640 is the compacted layout's (a ragged pack32
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
    assert route == "tc_" + mode
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
def test_block_tc_kernel_integer_ties_exact(cuda, pack32, k_pair, s_eff,
                                            euclidean, d):
    """Integer-valued inputs with runs of equal rows: every sum is exact in
    any order, so the tensor-core kernel equals the plain version bit for
    bit on live rows, keys, addresses and pack32 keys, ties included; pad
    rows dead. s_eff 200 has a ragged last tile, 96 is one tile of G =
    s_eff groups; d = 40 pads K to 48. The CUDA-core kernel, launched
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
def test_block_tc_kernel_persistent_grid(cuda, pack32, k_pair, s_eff):
    """A grid of 3 persistent CTAs over 64 blocks: each CTA walks ~21
    blocks, so the state it resets between blocks (live-tile rows, the
    pack32 phase parity of deep G = 512 and 256 and the running lists the
    extraction reads, the exact lists and queues, the A fragments, the
    copies in flight) is reused. Integer inputs: live rows equal the plain
    version bit for bit, pad rows dead."""
    args = bs.integer_block_inputs(cuda, s_eff=s_eff, n_blocks=64, nq=500,
                                   cap_total=8192, seed=k_pair)
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=True, pack32=pack32,
              slot_mask=bs.util.next_pow2(s_eff) - 1)
    route = "tc_" + ("pack32" if pack32 else "exact")
    got = _block_uncounted(args, kw, route, n_ctas=3)
    ref = bs.block_scan_ref(*args, **kw)
    _assert_pads(got, ref, args[1], route, k_pair, pack32)
    live = args[1] >= 0
    assert torch.equal(got[live], ref[live])


@pytest.mark.gpu
@pytest.mark.parametrize("inputs", ["random", "integer"])
@pytest.mark.parametrize("pack32,k_pair,route", [
    (True, 64, "tc_pack32"), (True, 64, "pack32"), (True, 16, "tc_pack32"),
    (False, 64, "exact")])
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
                             pack32=True) == "tc_pack32"
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
def test_block_tc_deep_pack32_matches_plain(cuda, s_eff, k_pair, inputs):
    """pack32 k_pair 49-64, which the tensor-core body takes since its
    lists grew past 48: over 256 strided groups at s_eff 512 (the
    untapered deep-k scan: two phases of 128 groups) and 512 at s_eff 4096
    (the split's head: four phases), d 128 bf16. Above k_pair 16 each
    phase end sorts the quad's group maxima, and the slices of blocks with
    few live tiles hold fewer groups than k_pair (their lists end early).
    Integer inputs: live rows equal the plain version bit for bit, pad rows
    dead; random ones to the tolerances of _assert_close_rows. The
    CUDA-core kernel, launched uncounted, on every row."""
    make = bs.integer_block_inputs if inputs == "integer" else \
        bs.random_inputs
    args = make(cuda, s_eff=s_eff, n_blocks=48, nq=500, cap_total=16384,
                seed=s_eff + k_pair)
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=True, pack32=True,
              slot_mask=s_eff - 1)
    assert bs.n_groups(s_eff, k_pair) == (256 if s_eff == 512 else 512)
    got, route = _block_launch(args, kw)
    assert route == "tc_pack32"
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


@pytest.mark.gpu
@pytest.mark.parametrize("n_ctas", [None, 3])
@pytest.mark.parametrize("inputs", ["random", "ties"])
@pytest.mark.parametrize("d,s_eff", [(128, 4096), (256, 512)])
def test_block_tc_int8_deep_pack32(cuda, d, s_eff, inputs, n_ctas):
    """The tensor-core int8 kernel at pack32 k_pair 64 with A in registers
    (d 128 and 256: 140,320 and 173,088 B of shared memory; the chunked
    rows' 242,720 B stay on the CUDA cores), over 512 and 256 strided
    groups, on the card's grid and on 3 persistent CTAs: exact integer
    sums, so bit for bit on every input, ties included (int8_tie_inputs);
    pad rows dead; the CUDA-core int8 kernel equal on every row."""
    make = bs.int8_tie_inputs if inputs == "ties" else bs.random_int8_inputs
    args, scale, q_scale = make(cuda, s_eff=s_eff, n_blocks=64, nq=500, d=d,
                                cap_total=8192, seed=d + s_eff)
    kw = dict(s_eff=s_eff, k_pair=64, euclidean=True, pack32=True,
              slot_mask=s_eff - 1)
    _int8_held(args, kw, scale, q_scale, "tc_int8_pack32", n_ctas=n_ctas)


@pytest.mark.gpu
def test_tc_smem_matches_mirror(cuda):
    """The library's shared-memory sizes of the three tensor-core scans
    equal ops/block_scan.py's mirror of scan_tc.cuh:body_smem_bytes (which
    pick_route reads without the library), the codes scan's with its
    512 * d-byte codebook; and an entry point refuses, without launching,
    a shape whose shared memory exceeds the limit: the chunked int8 rows
    and the codes source at pack32 k_pair 64."""
    from torchpq_tpu_torch import _build
    lib = _build.library()
    for d in (32, 40, 64, 128):
        for pack32 in (0, 1):
            for k_pair in (1, 10, 16, 40, 48, 49, 57, 64):
                want = bs.tc_route_smem(d=d, pack32=pack32, k_pair=k_pair)
                assert lib.torchpq_block_scan_tc_smem(d, pack32, k_pair) \
                    == want
                assert lib.torchpq_codes_scan_tc_smem(d, pack32, k_pair) \
                    == want + 512 * d
    for d in (32, 128, 160, 256, 288, 512, 1024):
        for pack32 in (0, 1):
            for k_pair in (1, 10, 16, 40, 48, 49, 64):
                assert lib.torchpq_block_scan_tc_int8_smem(
                    d, pack32, k_pair) == bs.tc_route_smem(
                        d=d, pack32=pack32, k_pair=k_pair, dtype=torch.int8)
    assert bs.tc_route_smem(d=1024, pack32=True, k_pair=64,
                            dtype=torch.int8) > bs._SMEM_LIMIT
    args, scale, q_scale = bs.random_int8_inputs(
        cuda, s_eff=1024, n_blocks=4, nq=50, d=1024, cap_total=4096)
    out = torch.empty((4, 128, 64), dtype=torch.int32, device=cuda)
    rc = lib.torchpq_block_scan_tc_int8(
        args[0].data_ptr(), q_scale.data_ptr(), args[1].data_ptr(),
        args[2].data_ptr(), args[3].data_ptr(), args[4].data_ptr(),
        args[5].data_ptr(), scale.data_ptr(), args[6].data_ptr(),
        out.data_ptr(), 4, 128, 1024, 1024, 64, 1, 1, 1023, 512, 4,
        torch.cuda.current_stream().cuda_stream)
    assert rc == 1  # cudaErrorInvalidValue
    cargs = cs.random_codes_inputs(cuda, s_eff=1024, n_blocks=4, nq=50,
                                   m=64, dsub=2, cap_total=4096)
    rc = lib.torchpq_codes_scan_tc(
        *(t.data_ptr() for t in cargs[:6]), cargs[6].data_ptr(),
        cargs[7].data_ptr(), out.data_ptr(), 4, 128, 64, 2,
        cargs[6].shape[1] // 64, 1024, 64, 1, 1, 1023, 512, 4,
        torch.cuda.current_stream().cuda_stream)
    assert rc == 1
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_block_routes_on_card(cuda):
    """bf16 at d = 128 and int8 at d = 128 and 1024 take the tensor-core
    kernels, pack32 k_pair 64 too at bf16 and int8 d = 128; an f32 cache,
    bf16 exact k_pair 20, int8 at d = 1040 or exact k_pair 20 and int8
    pack32 k_pair 64 at d = 1024 (shared memory) take the CUDA-core one;
    each counts under its own key, and asking the tensor-core route for
    the others raises before anything launches."""
    for dtype, d, k_pair, pack32, route in (
            (torch.bfloat16, 128, 10, False, "tc_exact"),
            (torch.bfloat16, 128, 10, True, "tc_pack32"),
            (torch.float32, 128, 10, False, "exact"),
            (torch.float32, 128, 10, True, "pack32"),
            (torch.bfloat16, 128, 20, False, "exact"),
            (torch.int8, 128, 10, False, "tc_int8_exact"),
            (torch.int8, 128, 10, True, "tc_int8_pack32"),
            (torch.int8, 1024, 10, True, "tc_int8_pack32"),
            (torch.int8, 1040, 10, False, "int8_exact"),
            (torch.int8, 128, 20, False, "int8_exact"),
            (torch.bfloat16, 128, 64, True, "tc_pack32"),
            (torch.int8, 128, 64, True, "tc_int8_pack32"),
            (torch.int8, 1024, 64, True, "int8_pack32")):
        extra = {}
        if dtype == torch.int8:
            args, scale, q_scale = bs.random_int8_inputs(
                cuda, s_eff=512, n_blocks=16, nq=300, d=d, cap_total=8192)
            extra = dict(scale=scale, q_scale=q_scale)
        else:
            args = bs.random_inputs(cuda, s_eff=512, n_blocks=16, nq=300,
                                    cap_total=8192, dtype=dtype)
        kw = dict(s_eff=512, k_pair=k_pair, euclidean=True, pack32=pack32,
                  slot_mask=511, **extra)
        got, r = _block_launch(args, kw)
        assert r == route
        if not route.startswith("tc_"):
            with pytest.raises(ValueError):
                _block_uncounted(args, kw, "tc_" + route)


@pytest.mark.gpu
def test_scan_cell_major_on_card_matches_cpu(cuda):
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
def test_index_on_card_matches_cpu(cuda):
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
def test_pq_variants_on_card_match_cpu(cuda, tmp_path, d, m, kwargs):
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
        assert cs.launches["tc_exact"] > before["tc_exact"]
        assert cs.launches["tc_pack32"] > before["tc_pack32"]
    if kwargs.get("distance") == "manhattan":
        assert {**bs.launches, **cs.launches} == before


@pytest.mark.gpu
def test_spill_assign_on_card_matches_cpu(cuda):
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


@pytest.mark.gpu
@pytest.mark.parametrize("pack32", [False, True])
@pytest.mark.parametrize("m,dsub", [(64, 2), (8, 4), (128, 1), (32, 4)])
@pytest.mark.parametrize("s_eff", [256, 1024, 8192])
@pytest.mark.parametrize("k_pair", [10, 40])
def test_codes_kernel_matches_plain(cuda, pack32, m, dsub, s_eff, k_pair):
    """g = 2 (d=128, PQ64), g = 16 (d=32, PQ8), g = 1 (d=128, PQ128) and
    g = 4 (d=128, 4-bit PQ64: 32 byte pairs over the byte-pair codebook)
    on random inputs, through the kernel pick_route names (exact k_pair 40:
    the CUDA-core one; pack32 k_pair 40 selects over 512 strided groups at
    s_eff 1024 and 8192). Live rows: the tensor cores sum in another order
    than the plain version's GEMM (bf16 products are exact in f32), so
    exact values agree to 1e-3 relative and addresses and pack32 keys on
    >= 0.99 of entries; pad rows as _assert_pads."""
    args = cs.random_codes_inputs(cuda, s_eff=s_eff, n_blocks=64, nq=500,
                                  m=m, dsub=dsub,
                                  cap_total=max(8192, 2 * s_eff))
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=True, pack32=pack32,
              slot_mask=s_eff - 1)
    got, route = _codes_launch(cuda, args, kw)
    assert route == ("tc_" if pack32 or k_pair <= 16 else "") + \
        ("pack32" if pack32 else "exact")
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
                                          (32, 4, 1024)])
@pytest.mark.parametrize("k_pair,euclidean", [(10, True), (40, False)])
def test_codes_tc_kernel_integer_ties_exact(cuda, pack32, m, dsub, s_eff,
                                            k_pair, euclidean):
    """Integer-valued inputs with runs of equal codes: every sum is exact
    in any order, so the tensor-core kernel equals the plain version bit
    for bit on live rows, keys, addresses and pack32 keys, ties included
    (exact k_pair 40 runs on the CUDA-core kernel, equal there too)."""
    args = cs.integer_codes_inputs(cuda, s_eff=s_eff, n_blocks=64, nq=500,
                                   m=m, dsub=dsub,
                                   cap_total=max(8192, 2 * s_eff), seed=m)
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=euclidean,
              pack32=pack32, slot_mask=s_eff - 1)
    got, route = _codes_launch(cuda, args, kw)
    ref = cs.codes_scan_ref(*args, **kw)
    _assert_pads(got, ref, args[1], route, k_pair, pack32)
    live = args[1] >= 0
    assert torch.equal(got[live], ref[live])
    if not pack32:
        keys = ref[live][:, :k_pair]
        assert int((keys[:, 1:] == keys[:, :-1]).sum()) > 0, "no ties"


@pytest.mark.gpu
@pytest.mark.parametrize("pack32,k_pair", [(False, 10), (False, 16),
                                           (True, 10), (True, 40)])
@pytest.mark.parametrize("m,dsub,s_eff", [(64, 2, 1024), (8, 4, 256)])
def test_codes_tc_kernel_persistent_grid(cuda, pack32, k_pair, m, dsub,
                                         s_eff):
    """A grid of 3 persistent CTAs over 64 blocks: each CTA walks ~21
    blocks, so the state it resets between blocks (live-tile rows, the
    pack32 phase parity of deep G = 512, the exact lists and queues, the
    A fragments) is reused. Integer inputs: live rows equal the plain
    version bit for bit, pad rows dead."""
    from torchpq_tpu_torch import _build
    args = cs.integer_codes_inputs(cuda, s_eff=s_eff, n_blocks=64, nq=500,
                                   m=m, dsub=dsub, cap_total=8192,
                                   seed=m + k_pair)
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=True, pack32=pack32,
              slot_mask=s_eff - 1)
    route = "tc_" + ("pack32" if pack32 else "exact")
    got = cs.launch(_build.library(), torch.cuda.current_stream().cuda_stream,
                    *args, route=route, n_ctas=3, **kw)
    torch.cuda.synchronize()
    ref = cs.codes_scan_ref(*args, **kw)
    _assert_pads(got, ref, args[1], route, k_pair, pack32)
    live = args[1] >= 0
    assert torch.equal(got[live], ref[live])


@pytest.mark.gpu
def test_codes_routes_on_card(cuda):
    """Exact k_pair > 16 and rows wider than 128 take the CUDA-core kernel,
    counted under its own key; asking the tensor-core route for them
    raises."""
    from torchpq_tpu_torch import _build
    for m, dsub, k_pair, route in ((64, 2, 20, "exact"),
                                   (32, 5, 10, "exact"),
                                   (64, 2, 20, "tc_pack32")):
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
                          route="tc_" + route, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("m,dsub,pack32", [(64, 2, False), (128, 1, True)])
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
def test_code_domain_index_on_card_matches_cpu(cuda):
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
    assert cs.launches == dict(before, tc_exact=before["tc_exact"] + 2,
                               tc_pack32=before["tc_pack32"] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("pack32", [False, True])
@pytest.mark.parametrize("d,s_eff", [(128, 512), (1024, 512), (32, 256)])
def test_int8_kernel_matches_plain(cuda, pack32, d, s_eff):
    """The int8 mode: exact integer products (s32 mma.sync or __dp4a
    against f32 sums of int8 values, exact below d = 1040) and one fused
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
    assert route == "tc_" + mode
    ref = bs.block_scan_ref(*args, **kw)
    _assert_pads(got, ref, args[1], route, 10, pack32)
    live = args[1] >= 0
    assert torch.equal(got[live], ref[live])
    assert torch.equal(_block_uncounted(args, kw, mode), ref)


_INT8_CASES = [(False, 10, 640), (False, 16, 2048), (False, 10, 200),
               (True, 10, 640), (True, 40, 512), (True, 48, 2048)]


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
    assert torch.equal(_block_uncounted(args, kw, route[3:]), ref)
    return ref


@pytest.mark.gpu
@pytest.mark.parametrize("euclidean", [True, False])
@pytest.mark.parametrize("pack32,k_pair,s_eff", _INT8_CASES)
@pytest.mark.parametrize("d", [128, 160, 256, 1024])
def test_block_tc_int8_matches_plain(cuda, d, pack32, k_pair, s_eff,
                                     euclidean):
    """The tensor-core int8 kernel on random int8 inputs: rows of 128 and
    256 bytes (A in registers; 160 pads K to 160 of 176-byte tile rows)
    and 1,024 bytes (four 256-byte k chunks per tile); s_eff 640 (the
    compacted layout's, 5 tiles), 2048 and 200 (a ragged last tile); exact
    k_pair 10 and 16; pack32 k_pair 10, 40 over 256 and 48 over 512
    strided groups. Exact integer sums: bit for bit on every input."""
    args, scale, q_scale = bs.random_int8_inputs(
        cuda, s_eff=s_eff, n_blocks=64, nq=500, d=d, cap_total=8192,
        seed=d + s_eff + k_pair)
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=euclidean,
              pack32=pack32, slot_mask=bs.util.next_pow2(s_eff) - 1)
    _int8_held(args, kw, scale, q_scale,
               "tc_int8_" + ("pack32" if pack32 else "exact"))


@pytest.mark.gpu
@pytest.mark.parametrize("euclidean", [True, False])
@pytest.mark.parametrize("pack32", [False, True])
@pytest.mark.parametrize("d", [32, 128, 288, 1024])
def test_block_tc_int8_ties_exact(cuda, d, pack32, euclidean):
    """int8_tie_inputs (equal rows all over each window, runs of them):
    the tensor-core int8 kernel equals the plain version bit for bit on
    live rows, ties and their column order included; d = 288 ends in a
    32-byte k chunk."""
    args, scale, q_scale = bs.int8_tie_inputs(
        cuda, s_eff=640, n_blocks=64, nq=500, d=d, cap_total=8192, seed=d)
    k_pair = 40 if pack32 else 10
    kw = dict(s_eff=640, k_pair=k_pair, euclidean=euclidean, pack32=pack32,
              slot_mask=1023)
    ref = _int8_held(args, kw, scale, q_scale,
                     "tc_int8_" + ("pack32" if pack32 else "exact"))
    if not pack32:
        keys = ref[args[1] >= 0][:, :k_pair]
        assert int((keys[:, 1:] == keys[:, :-1]).sum()) > 0, "no ties"


@pytest.mark.gpu
@pytest.mark.parametrize("pack32,k_pair,s_eff", [
    (False, 10, 640), (False, 16, 1024), (True, 10, 640), (True, 40, 1024)])
@pytest.mark.parametrize("d", [128, 1024])
def test_block_tc_int8_persistent_grid(cuda, d, pack32, k_pair, s_eff):
    """A grid of 3 persistent CTAs over 64 blocks: each CTA walks ~21
    blocks, so the state it resets between blocks (live-tile rows, the
    pack32 phase parity, the exact lists and queues, the A fragments or
    the staged query chunks, the copies in flight) is reused."""
    args, scale, q_scale = bs.int8_tie_inputs(
        cuda, s_eff=s_eff, n_blocks=64, nq=500, d=d, cap_total=8192,
        seed=k_pair)
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=True, pack32=pack32,
              slot_mask=s_eff - 1)
    _int8_held(args, kw, scale, q_scale,
               "tc_int8_" + ("pack32" if pack32 else "exact"), n_ctas=3)


@pytest.mark.gpu
def test_int8_index_on_card_matches_cpu(cuda):
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
        before, tc_int8_exact=before["tc_int8_exact"] + 2,
        tc_int8_pack32=before["tc_int8_pack32"] + 1)


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
    d = 128 takes the tensor-core kernel, f32 the CUDA-core one."""
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
@pytest.mark.parametrize("d", [64, 128, 1024])
@pytest.mark.parametrize("nq,cap,r_keep", [(300, 20000, 16), (1000, 60000, 32),
                                           (40, 4100, 8)])
def test_flat_tc_kernel_matches_plain(cuda, d, nq, cap, r_keep):
    """The tensor-core route against flat_scan_ref on random bf16 inputs,
    at the tolerances of the test above (the tensor cores sum in another
    order than the plain version's GEMM). Every cap is off the 2048-slot
    window; d = 1024 walks the cache in K chunks with the queries in shared
    memory, as r_keep = 32 does at any d; r_keep 8 and 16 below d = 128
    keep them in registers."""
    args = fs.random_flat_inputs(cuda, nq=nq, cap=cap, d=d, seed=d + cap)
    before = dict(fs.launches)
    v, a = fs.flat_scan(*args, r_keep=r_keep, euclidean=True)
    torch.cuda.synchronize()
    assert fs.launches == dict(before, flat_tc=before["flat_tc"] + 1)
    v_ref, a_ref = fs.flat_scan_ref(*args, r_keep=r_keep, euclidean=True)
    torch.testing.assert_close(v, v_ref, rtol=1e-3, atol=1e-3)
    assert (a == a_ref).float().mean().item() >= 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("d,r_keep,euclidean", [(128, 16, True),
                                                (128, 32, False),
                                                (1024, 16, True),
                                                (40, 8, True)])
def test_flat_tc_kernel_integer_ties_exact(cuda, d, r_keep, euclidean):
    """Integer-valued inputs with equal rows inside and across buckets:
    every sum is exact in any order, so the tensor-core kernel equals the
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
def test_flat_routes_on_card(cuda):
    """bf16 at d = 128 launches the tensor-core kernel; an f32 cache and a
    bf16 cache at d = 100 launch the CUDA-core one; each counts under its
    own key and matches the plain version."""
    for dtype, d, route in ((torch.bfloat16, 128, "flat_tc"),
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
    the card (the bf16 cache at d = 32: the tensor-core route) and finds
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
    before = fs.launches["flat_tc"]
    v, i = gpu.search(torch.from_numpy(q).to(cuda).T, k=10)
    assert fs.launches["flat_tc"] == before + 1
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
def test_ivfpqr_on_card_matches_cpu(cuda, cache, tmp_path):
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
def test_flat_index_on_card_matches_cpu(cuda, distance, tmp_path):
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
def test_host_spill_on_card_matches_cpu(cuda):
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
def test_legacy_and_profiling_on_card(cuda, tmp_path):
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
