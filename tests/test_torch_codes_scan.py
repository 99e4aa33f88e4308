"""The codes scan's integer-valued inputs and its route, on the CPU.

`integer_codes_inputs` (ops/codes_scan.py) is what the card holds the
tensor-core codes kernel to bit for bit: every score is an integer that f32
sums hold exactly in any order, with runs of equal codes so that exact ties
occur. Here the plain version `codes_scan_ref` is held to the JAX package's
Pallas codes kernel (interpret mode, through tests/conftest.py) on those
inputs, bit for bit, keys and addresses, pad rows included (both score them
with query 0). `pick_route` is checked against the shapes each kernel
takes (the wgmma codes instances of csrc/block_scan_wg.cu, the CUDA-core
codes_scan.cu), and its shared-memory mirror `wg_smem_bytes` against its
terms and the limit."""

import numpy as np
import pytest
import torch

from torchpq_tpu_torch.ops import block_scan
from torchpq_tpu_torch.ops import codes_scan as cs
from torchpq_tpu_torch.ops.block_scan import n_groups

from _torch_helpers import pallas_codes


def _integer_case(*, m, dsub, s_eff, seed):
    args = cs.integer_codes_inputs("cpu", s_eff=s_eff, n_blocks=3, nq=200,
                                   m=m, dsub=dsub, cap_total=2048,
                                   seed=seed)
    return args


@pytest.mark.parametrize("m,dsub", [(64, 2), (8, 4), (32, 4)])
@pytest.mark.parametrize("pack32", [False, True])
@pytest.mark.parametrize("k_pair,s_eff", [(10, 256), (40, 512)])
def test_integer_inputs_plain_equals_pallas(m, dsub, pack32, k_pair, s_eff):
    """g = 2 (PQ64, d = 128), g = 16 (PQ8, d = 32) and g = 4 (4-bit PQ64:
    32 byte pairs over the byte-pair codebook, d = 128); k_pair 40 at
    s_eff 512 selects over G = 256 strided groups in pack32."""
    if pack32:
        assert n_groups(s_eff, k_pair) == (256 if k_pair > 32 else 128)
    args = _integer_case(m=m, dsub=dsub, s_eff=s_eff, seed=m + k_pair)
    qt, pr, sc, off, cap, penalty, codes, cb = args
    slot_mask = s_eff - 1
    kw = dict(s_eff=s_eff, k_pair=k_pair, pack32=pack32,
              slot_mask=slot_mask)
    got = cs.codes_scan_ref(*args, euclidean=True, **kw).numpy()
    ref = pallas_codes(
        qt.float().numpy(), pr.numpy(), sc.numpy(), off.numpy(),
        cap.numpy(), penalty.numpy(), codes.view(-1, m).numpy(),
        cb.float().numpy(), m=m, distance="euclidean", **kw)
    np.testing.assert_array_equal(got, ref)
    if not pack32:  # the inputs do tie, so the column order is exercised
        keys = got[..., :k_pair]
        assert (keys[..., 1:] == keys[..., :-1]).sum() > 0


def test_integer_inputs_layout():
    """Integer values, the block layout of random_inputs (live probers
    first, then -1 pads), runs of equal codes, BIG at some slots."""
    qt, pr, sc, off, cap, penalty, codes, cb = _integer_case(
        m=64, dsub=2, s_eff=256, seed=0)
    for t in (qt, cb):
        assert t.dtype == torch.bfloat16
        assert torch.equal(t.float(), t.float().round())
        assert int(t.float().abs().max()) <= 3
    live = pr >= 0
    assert bool((live.int().diff(dim=1) <= 0).all()), "live probers first"
    assert bool((sc % 16 == 0).all()) and bool((off % 16 == 0).all())
    assert bool(((off + cap) <= 256).all())
    flat = codes.view(-1, 64)
    assert bool((flat[205:300] == flat[204]).all())
    big = penalty >= cs.BIG
    assert 0 < int(big.sum()) < penalty.numel() // 5
    assert torch.equal(penalty[~big], penalty[~big].round())


@pytest.mark.parametrize("shape,route", [
    (dict(m=64, dsub=2, p_tile=128, s_eff=1024, k_pair=10, pack32=False),
     "tc_wgn_exact"),
    (dict(m=64, dsub=2, p_tile=128, s_eff=1024, k_pair=10, pack32=True),
     "tc_wgn_pack32"),
    (dict(m=32, dsub=4, p_tile=128, s_eff=1024, k_pair=10, pack32=True),
     "tc_wgn_pack32"),  # 4-bit byte pairs
    (dict(m=64, dsub=2, p_tile=128, s_eff=1024, k_pair=20, pack32=True),
     "tc_wgn_pack32"),  # pqr3_codes k = 10 at n_probe 8: four stages
    (dict(m=64, dsub=2, p_tile=128, s_eff=1024, k_pair=35, pack32=True),
     "tc_wgn_pack32"),  # the deep select: 212,320 B
    (dict(m=64, dsub=2, p_tile=128, s_eff=1024, k_pair=36, pack32=True),
     "tc_wgn_pack32"),  # 213,344 B (passes on four stages: 234,608 B)
    (dict(m=64, dsub=2, p_tile=128, s_eff=1024, k_pair=40, pack32=True),
     "tc_wgn_pack32"),  # G = 512: 215,392 B
    (dict(m=64, dsub=2, p_tile=128, s_eff=512, k_pair=40, pack32=True),
     "tc_wgn_pack32"),  # G = 256
    (dict(m=8, dsub=4, p_tile=128, s_eff=1024, k_pair=48, pack32=True),
     "tc_wgn_pack32"),  # d = 32
    (dict(m=8, dsub=4, p_tile=128, s_eff=1024, k_pair=49, pack32=True),
     "tc_wgn_pack32"),  # above the passes instance's old 48
    (dict(m=8, dsub=4, p_tile=128, s_eff=96, k_pair=10, pack32=True),
     "tc_wgn_pack32"),  # G = s_eff, one tile
    (dict(m=128, dsub=1, p_tile=128, s_eff=8192, k_pair=16, pack32=False),
     "tc_wgn_exact"),   # PQ128: two passes of the raw slot
    (dict(m=8, dsub=9, p_tile=128, s_eff=256, k_pair=16, pack32=False),
     "tc_wgn_exact"),   # d = 72: a ragged second k half
    (dict(m=64, dsub=2, p_tile=128, s_eff=1024, k_pair=17, pack32=False),
     "exact"),         # the lists hold 16
    (dict(m=32, dsub=5, p_tile=128, s_eff=512, k_pair=10, pack32=True),
     "pack32"),        # d = 160 > 128
    (dict(m=4, dsub=32, p_tile=128, s_eff=512, k_pair=10, pack32=False),
     "exact"),         # m = 4: chunks of 8 codes
    (dict(m=8, dsub=3, p_tile=128, s_eff=512, k_pair=10, pack32=False),
     "tc_wgn_exact"),  # d = 24: a chunk of 8 codes is 3 pieces
    (dict(m=64, dsub=2, p_tile=256, s_eff=512, k_pair=10, pack32=False),
     "exact"),         # more probers than 8 warps x 16
    (dict(m=64, dsub=2, p_tile=120, s_eff=512, k_pair=10, pack32=True),
     "pack32"),        # not whole m tiles
    (dict(m=16, dsub=2, p_tile=128, s_eff=200, k_pair=10, pack32=True),
     "pack32"),        # G = s_eff = 200: neither one tile nor 128s
    (dict(m=16, dsub=2, p_tile=128, s_eff=200, k_pair=10, pack32=False),
     "tc_wgn_exact"),
    (dict(m=64, dsub=2, p_tile=128, s_eff=4096, k_pair=48, pack32=True),
     "tc_wgn_pack32"),  # G = 512 at k_pair 48
    (dict(m=64, dsub=2, p_tile=128, s_eff=4096, k_pair=64, pack32=True),
     "tc_wgn_pack32"),  # 8 tiles a phase, three stages: 227,680 B
    (dict(m=64, dsub=2, p_tile=128, s_eff=512, k_pair=49, pack32=True),
     "tc_wgn_pack32"),  # G = 256
    (dict(m=8, dsub=4, p_tile=128, s_eff=512, k_pair=57, pack32=True),
     "tc_wgn_pack32"),  # d = 32: 167,264 B
    (dict(m=64, dsub=2, p_tile=128, s_eff=1024, k_pair=52, pack32=True),
     "tc_wgn_pack32"),  # IVFPQR code domain, k = 100 at n_probe 32
    (dict(m=32, dsub=4, p_tile=128, s_eff=1024, k_pair=64, pack32=True),
     "tc_wgn_pack32"),  # 4-bit byte pairs: 223,584 B
    (dict(m=128, dsub=1, p_tile=128, s_eff=1024, k_pair=64, pack32=True),
     "tc_wgn_pack32"),  # PQ128: 227,680 B
    # the deep select on three stages at k_pair 39 / 40 (four would fit at
    # 39, 231,792 B, and not at 40, 232,816 B), 52 and 64, d = 128
    (dict(m=64, dsub=2, p_tile=128, s_eff=1024, k_pair=39, pack32=True),
     "tc_wgn_pack32"),
    (dict(m=128, dsub=1, p_tile=128, s_eff=1024, k_pair=39, pack32=True),
     "tc_wgn_pack32"),
    (dict(m=128, dsub=1, p_tile=128, s_eff=1024, k_pair=40, pack32=True),
     "tc_wgn_pack32"),
    (dict(m=32, dsub=4, p_tile=128, s_eff=1024, k_pair=39, pack32=True),
     "tc_wgn_pack32"),
    (dict(m=32, dsub=4, p_tile=128, s_eff=1024, k_pair=40, pack32=True),
     "tc_wgn_pack32"),
    (dict(m=128, dsub=1, p_tile=128, s_eff=1024, k_pair=52, pack32=True),
     "tc_wgn_pack32"),
    (dict(m=32, dsub=4, p_tile=128, s_eff=1024, k_pair=52, pack32=True),
     "tc_wgn_pack32"),
    (dict(m=64, dsub=2, p_tile=128, s_eff=1024, k_pair=64, pack32=True),
     "tc_wgn_pack32"),  # IVFPQR code domain, k = 100 at n_probe 8
    (dict(m=32, dsub=5, p_tile=128, s_eff=1024, k_pair=64, pack32=True),
     "pack32"),        # d = 160 > 128
    (dict(m=16, dsub=16, p_tile=128, s_eff=1024, k_pair=52, pack32=True),
     "pack32"),        # d = 256 > 128
    (dict(m=8, dsub=20, p_tile=128, s_eff=1024, k_pair=10, pack32=False),
     "exact"),         # d = 160
])
def test_pick_route(shape, route):
    assert cs.pick_route(**shape) == route
    assert route in cs.launches


def test_launch_refuses_a_route_that_does_not_fit():
    """launch() checks the route against pick_route before anything runs:
    the tensor-core route for exact k_pair 20, a route of the other select,
    the mma.sync sorted key no route serves any more ("tc_pack32", whose
    kernel went), and the wgmma route for query rows that are not 16-byte
    aligned."""
    args = _integer_case(m=64, dsub=2, s_eff=256, seed=1)
    kw = dict(s_eff=256, k_pair=20, euclidean=True, pack32=False,
              slot_mask=255)
    with pytest.raises(ValueError, match="tensor-core"):
        cs.launch(None, 0, *args, route="tc_wgn_exact", **kw)
    with pytest.raises(ValueError, match="select"):
        cs.launch(None, 0, *args, route="tc_pack32", **kw)
    with pytest.raises(ValueError, match="select"):
        cs.launch(None, 0, *args, route="tc_exact", **dict(kw, k_pair=10))
    with pytest.raises(ValueError, match="'tc_pack32' does not serve"):
        cs.launch(None, 0, *args, route="tc_pack32",
                  **dict(kw, k_pair=52, pack32=True))
    qt = args[0]
    shifted = torch.empty(qt.numel() + 1, dtype=qt.dtype)[1:].view(qt.shape)
    shifted.copy_(qt)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        cs.launch(None, 0, shifted, *args[1:], route="tc_wgn_exact",
                  **dict(kw, k_pair=10))


def _codes_constants():
    """CRING_*, CQB, CODES_PASS_K and PASS_CHUNKS of csrc/wg_layout.cuh."""
    import re
    from pathlib import Path
    csrc = Path(cs.__file__).resolve().parents[1] / "csrc"
    layout = (csrc / "wg_layout.cuh").read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                layout).group(1))
            for name in ("CRING_EXACT", "CRING_PACK_16", "CRING_PACK",
                         "CRING_DEEP", "CQB", "CODES_PASS_K", "PASS_CHUNKS")}


def test_codes_constants_mirror_the_header():
    """The codes instances' constants of csrc/wg_layout.cuh (the ring
    stages by select, one query buffer, the deepest pack32 k_pair
    extracted pass by pass, a pass's chunks) are ops/codes_scan.py's."""
    assert _codes_constants() == dict(
        CRING_EXACT=cs._WG_CRING_EXACT, CRING_PACK_16=cs._WG_CRING_PACK_16,
        CRING_PACK=cs._WG_CRING_PACK, CRING_DEEP=cs._WG_CRING_DEEP,
        CQB=cs._WG_CQB, CODES_PASS_K=cs._WG_CODES_PASS_K,
        PASS_CHUNKS=cs._WG_PASS_CHUNKS)


@pytest.mark.parametrize("m,dsub", [(64, 2), (32, 4), (128, 1), (8, 4),
                                    (16, 5)])
def test_wg_smem_mirror_terms(m, dsub):
    """ops/codes_scan.py:wg_smem_bytes term for term: 1,024 bytes of slack,
    one query buffer of 32,768 bytes and its two barriers, each ring stage
    a 16,384-byte k half with its 128 penalties (pack32: and slots) and two
    barriers, the 512 * d-byte codebook, the raw slot of 128 columns x 8 *
    min(m / 8, 8) bytes, prober rows and tile flags (544), the select's
    arrays (pass by pass: the slice and running lists; above pack32
    k_pair 32 the deep select's staging rows, one list a row and counts);
    the rings are 3 (exact), 5 (pack32 k_pair <= 16), 4 (17-32) and 3
    (the deep select)."""
    found = _codes_constants()
    assert found["CODES_PASS_K"] == 32
    for pack32, k_pair in ((0, 1), (0, 10), (0, 16), (1, 1), (1, 10),
                           (1, 16), (1, 17), (1, 20), (1, 32), (1, 33),
                           (1, 35), (1, 40), (1, 48), (1, 52), (1, 64)):
        stage = 16384 + 512 * (2 if pack32 else 1) + 16
        deep = pack32 and k_pair > 32
        ring = (found["CRING_EXACT"] if not pack32 else
                found["CRING_PACK_16"] if k_pair <= 16 else
                found["CRING_DEEP"] if deep else found["CRING_PACK"])
        select = (4 * (8 * 8 * 129 + 128 * ((k_pair | 1) + 2)) if deep
                  else block_scan._wg_list_bytes(pack32, k_pair))
        want = (1024 + (32768 + 16) + ring * stage + 512 * m * dsub
                + 128 * 8 * min(m // 8, 8) + 544 + select)
        assert cs.wg_ring(pack32, k_pair) == ring, (pack32, k_pair)
        assert cs.wg_smem_bytes(m=m, dsub=dsub, pack32=pack32,
                                k_pair=k_pair) == want, (pack32, k_pair)


@pytest.mark.parametrize("shape,nbytes,over", [
    (dict(m=64, dsub=2, k_pair=64, pack32=True), 227680, "pack32"),
    (dict(m=128, dsub=1, k_pair=16, pack32=False), 224864, "exact"),
    (dict(m=64, dsub=2, k_pair=10, pack32=False), 218720, "exact"),
    (dict(m=32, dsub=4, k_pair=16, pack32=True), 217216, "pack32"),
])
def test_wg_route_boundary_reads_the_mirror(monkeypatch, shape, nbytes,
                                            over):
    """pick_route's wgmma boundary sits where wg_smem_bytes meets the
    limit: at the instance's size the shape takes the wgmma codes route,
    one byte less and it goes to the CUDA cores (the deep select of pack32
    k_pair 64 at PQ64 already on its three stages)."""
    assert cs.wg_smem_bytes(**shape) == nbytes
    full = dict(shape, p_tile=128, s_eff=1024)
    mode = "pack32" if shape["pack32"] else "exact"
    monkeypatch.setattr(cs, "_SMEM_LIMIT", nbytes)
    assert cs.pick_route(**full) == "tc_wgn_" + mode
    monkeypatch.setattr(cs, "_SMEM_LIMIT", nbytes - 1)
    assert cs.pick_route(**full) == over
