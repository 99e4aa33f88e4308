"""The codes scan's integer-valued inputs and its route, on the CPU.

`integer_codes_inputs` (ops/codes_scan.py) is what the card holds the
tensor-core codes kernel to bit for bit: every score is an integer that f32
sums hold exactly in any order, with runs of equal codes so that exact ties
occur. Here the plain version `codes_scan_ref` is held to the JAX package's
Pallas codes kernel (interpret mode, through tests/conftest.py) on those
inputs, bit for bit, keys and addresses, pad rows included (both score them
with query 0). `pick_route` is checked against the shapes each kernel
takes (the wgmma codes instances of csrc/block_scan_wg.cu, the mma.sync
sorted instance of csrc/codes_scan_tc.cu, the CUDA-core codes_scan.cu),
and its shared-memory mirrors `wg_smem_bytes` and `tc_smem_bytes` against
their terms and the limit."""

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
     "tc_wgn_pack32"),  # the largest that fits at d = 128: 231,536 B
    (dict(m=64, dsub=2, p_tile=128, s_eff=1024, k_pair=36, pack32=True),
     "tc_pack32"),      # 234,608 B: the sorted mma.sync instance
    (dict(m=64, dsub=2, p_tile=128, s_eff=1024, k_pair=40, pack32=True),
     "tc_pack32"),     # G = 512
    (dict(m=64, dsub=2, p_tile=128, s_eff=512, k_pair=40, pack32=True),
     "tc_pack32"),     # G = 256
    (dict(m=8, dsub=4, p_tile=128, s_eff=1024, k_pair=48, pack32=True),
     "tc_wgn_pack32"),  # d = 32: the codebook leaves room
    (dict(m=8, dsub=4, p_tile=128, s_eff=1024, k_pair=49, pack32=True),
     "tc_pack32"),     # above CODES_DEEP_K
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
     "tc_pack32"),     # G = 512 at k_pair 48
    (dict(m=64, dsub=2, p_tile=128, s_eff=4096, k_pair=64, pack32=True),
     "tc_pack32"),     # the sorted instance, one tile: 210,976 B
    (dict(m=64, dsub=2, p_tile=128, s_eff=512, k_pair=49, pack32=True),
     "tc_pack32"),     # G = 256
    (dict(m=8, dsub=4, p_tile=128, s_eff=512, k_pair=57, pack32=True),
     "tc_pack32"),     # d = 32: 130,080 B
    (dict(m=64, dsub=2, p_tile=128, s_eff=1024, k_pair=52, pack32=True),
     "tc_pack32"),     # IVFPQR code domain, k = 100 at n_probe 32
    (dict(m=32, dsub=4, p_tile=128, s_eff=1024, k_pair=64, pack32=True),
     "tc_pack32"),     # 4-bit byte pairs: 206,880 B
    (dict(m=128, dsub=1, p_tile=128, s_eff=1024, k_pair=64, pack32=True),
     "tc_pack32"),     # PQ128: the ring of 16 KB, 219,168 B
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
    the mma.sync sorted route where the wgmma one serves, and the wgmma
    route for query rows that are not 16-byte aligned."""
    args = _integer_case(m=64, dsub=2, s_eff=256, seed=1)
    kw = dict(s_eff=256, k_pair=20, euclidean=True, pack32=False,
              slot_mask=255)
    with pytest.raises(ValueError, match="tensor-core"):
        cs.launch(None, 0, *args, route="tc_wgn_exact", **kw)
    with pytest.raises(ValueError, match="select"):
        cs.launch(None, 0, *args, route="tc_pack32", **kw)
    with pytest.raises(ValueError, match="select"):
        cs.launch(None, 0, *args, route="tc_exact", **dict(kw, k_pair=10))
    with pytest.raises(ValueError, match="tc_pack32"):
        cs.launch(None, 0, *args, route="tc_pack32",
                  **dict(kw, k_pair=10, pack32=True))
    qt = args[0]
    shifted = torch.empty(qt.numel() + 1, dtype=qt.dtype)[1:].view(qt.shape)
    shifted.copy_(qt)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        cs.launch(None, 0, shifted, *args[1:], route="tc_wgn_exact",
                  **dict(kw, k_pair=10))


def _codes_constants():
    """CODES_DEEP_K and CRING_* of csrc/wg_layout.cuh, TN of
    csrc/scan_tc.cuh."""
    import re
    from pathlib import Path
    csrc = Path(cs.__file__).resolve().parents[1] / "csrc"
    layout = (csrc / "wg_layout.cuh").read_text()
    found = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                 layout).group(1))
             for name in ("CODES_DEEP_K", "CRING_EXACT", "CRING_PACK_16",
                          "CRING_PACK", "CQB", "PASS_CHUNKS")}
    tn = re.search(r"constexpr int TN = (\d+);",
                   (csrc / "scan_tc.cuh").read_text())
    return found, int(tn.group(1))


def test_codes_constants_mirror_the_header():
    """The codes instances' constants of csrc/wg_layout.cuh (the largest
    pack32 k_pair, the ring stages by select, one query buffer, a pass's
    chunks) are ops/codes_scan.py's."""
    found, _ = _codes_constants()
    assert found == dict(CODES_DEEP_K=cs._WG_CODES_DEEP_K,
                         CRING_EXACT=cs._WG_CRING_EXACT,
                         CRING_PACK_16=cs._WG_CRING_PACK_16,
                         CRING_PACK=cs._WG_CRING_PACK, CQB=cs._WG_CQB,
                         PASS_CHUNKS=cs._WG_PASS_CHUNKS)


@pytest.mark.parametrize("m,dsub", [(64, 2), (32, 4), (128, 1), (8, 4),
                                    (8, 5)])
def test_tc_smem_mirror_terms(m, dsub):
    """ops/codes_scan.py:tc_smem_bytes, which pick_route reads without the
    library (the card test holds the library's sizes to it), term for term:
    the mma.sync sorted instance's 512 * d-byte codebook and raw codes'
    ring [TN][m] beside the body with one decoded tile."""
    _, tn = _codes_constants()
    d = m * dsub
    tile = tn * ((2 * d + 31) // 32 * 32 + 16)
    for k_pair in (17, 20, 36, 40, 48, 49, 52, 57, 64):
        body = block_scan.tc_smem_bytes(2 * d, True, k_pair)
        assert cs.tc_smem_bytes(m=m, dsub=dsub, k_pair=k_pair) \
            == 512 * d + tn * m + body - tile


@pytest.mark.parametrize("m,dsub", [(64, 2), (32, 4), (128, 1), (8, 4),
                                    (16, 5)])
def test_wg_smem_mirror_terms(m, dsub):
    """ops/codes_scan.py:wg_smem_bytes term for term: 1,024 bytes of slack,
    one query buffer of 32,768 bytes and its two barriers, each ring stage
    a 16,384-byte k half with its 128 penalties (pack32: and slots) and two
    barriers, the 512 * d-byte codebook, the raw slot of 128 columns x 8 *
    min(m / 8, 8) bytes, prober rows and tile flags (544), the select's
    arrays; the rings are 3 (exact), 5 (pack32 k_pair <= 16) and 4."""
    found, _ = _codes_constants()
    for pack32, k_pair in ((0, 1), (0, 10), (0, 16), (1, 1), (1, 10),
                           (1, 16), (1, 17), (1, 20), (1, 35), (1, 48)):
        ring = (found["CRING_EXACT"] if not pack32 else
                found["CRING_PACK_16"] if k_pair <= 16 else
                found["CRING_PACK"])
        stage = 16384 + 512 * (2 if pack32 else 1) + 16
        want = (1024 + (32768 + 16) + ring * stage + 512 * m * dsub
                + 128 * 8 * min(m // 8, 8) + 544
                + block_scan._wg_list_bytes(pack32, k_pair))
        assert cs.wg_smem_bytes(m=m, dsub=dsub, pack32=pack32,
                                k_pair=k_pair) == want, (pack32, k_pair)


def test_tc_route_boundary_reads_the_mirror(monkeypatch):
    """The sorted instance's sizes at d = 128, k_pair 64 (two decoded tiles
    beside the codebook and the lists would take 237,600 B there, over the
    limit), and pick_route's mma.sync boundary sits where the mirror
    meets the limit: one byte less and the same shape goes to the CUDA
    cores."""
    sizes = {(m, dsub): cs.tc_smem_bytes(m=m, dsub=dsub, k_pair=64)
             for m, dsub in ((64, 2), (32, 4), (128, 1))}
    assert sizes == {(64, 2): 210976, (32, 4): 206880, (128, 1): 219168}
    assert cs.tc_smem_bytes(m=64, dsub=2, k_pair=48) == 186400
    assert 512 * 128 + block_scan.tc_smem_bytes(256, True, 64) \
        == 237600 > cs._SMEM_LIMIT
    shape = dict(m=64, dsub=2, p_tile=128, s_eff=1024, k_pair=64,
                 pack32=True)
    monkeypatch.setattr(cs, "_SMEM_LIMIT", 210976)
    assert cs.pick_route(**shape) == "tc_pack32"
    monkeypatch.setattr(cs, "_SMEM_LIMIT", 210975)
    assert cs.pick_route(**shape) == "pack32"
    assert cs.pick_route(**dict(shape, k_pair=52)) == "tc_pack32"


@pytest.mark.parametrize("shape,nbytes,over", [
    (dict(m=64, dsub=2, k_pair=35, pack32=True), 231536, "tc_pack32"),
    (dict(m=128, dsub=1, k_pair=16, pack32=False), 224864, "exact"),
    (dict(m=64, dsub=2, k_pair=10, pack32=False), 218720, "exact"),
    (dict(m=32, dsub=4, k_pair=16, pack32=True), 217216, "pack32"),
])
def test_wg_route_boundary_reads_the_mirror(monkeypatch, shape, nbytes,
                                            over):
    """pick_route's wgmma boundary sits where wg_smem_bytes meets the
    limit: at the instance's size the shape takes the wgmma codes route,
    one byte less and it goes to the next route (the sorted mma.sync
    instance for pack32 above k_pair 16, else the CUDA cores)."""
    assert cs.wg_smem_bytes(**shape) == nbytes
    full = dict(shape, p_tile=128, s_eff=1024)
    mode = "pack32" if shape["pack32"] else "exact"
    monkeypatch.setattr(cs, "_SMEM_LIMIT", nbytes)
    assert cs.pick_route(**full) == "tc_wgn_" + mode
    monkeypatch.setattr(cs, "_SMEM_LIMIT", nbytes - 1)
    assert cs.pick_route(**full) == over
