"""The codes scan's integer-valued inputs and its route, on the CPU.

`integer_codes_inputs` (ops/codes_scan.py) is what the card holds the
tensor-core codes kernel to bit for bit: every score is an integer that f32
sums hold exactly in any order, with runs of equal codes so that exact ties
occur. Here the plain version `codes_scan_ref` is held to the JAX package's
Pallas codes kernel (interpret mode, through tests/conftest.py) on those
inputs, bit for bit, keys and addresses, pad rows included (both score them
with query 0). `pick_route` is checked against the shapes each kernel
takes, and its shared-memory mirror `tc_smem_bytes` against its terms."""

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
     "tc_exact"),
    (dict(m=64, dsub=2, p_tile=128, s_eff=1024, k_pair=10, pack32=True),
     "tc_pack32"),
    (dict(m=64, dsub=2, p_tile=128, s_eff=1024, k_pair=40, pack32=True),
     "tc_pack32"),     # G = 512
    (dict(m=64, dsub=2, p_tile=128, s_eff=512, k_pair=40, pack32=True),
     "tc_pack32"),     # G = 256
    (dict(m=8, dsub=4, p_tile=128, s_eff=96, k_pair=10, pack32=True),
     "tc_pack32"),     # G = s_eff, one tile
    (dict(m=128, dsub=1, p_tile=128, s_eff=8192, k_pair=16, pack32=False),
     "tc_exact"),
    (dict(m=64, dsub=2, p_tile=128, s_eff=1024, k_pair=17, pack32=False),
     "exact"),         # the lists hold 16
    (dict(m=32, dsub=5, p_tile=128, s_eff=512, k_pair=10, pack32=True),
     "pack32"),        # d = 160 > 128
    (dict(m=64, dsub=2, p_tile=256, s_eff=512, k_pair=10, pack32=False),
     "exact"),         # more probers than 8 warps x 16
    (dict(m=64, dsub=2, p_tile=120, s_eff=512, k_pair=10, pack32=True),
     "pack32"),        # not whole m tiles
    (dict(m=16, dsub=2, p_tile=128, s_eff=200, k_pair=10, pack32=True),
     "pack32"),        # G = s_eff = 200: neither one tile nor 128s
    (dict(m=16, dsub=2, p_tile=128, s_eff=200, k_pair=10, pack32=False),
     "tc_exact"),
    (dict(m=64, dsub=2, p_tile=128, s_eff=4096, k_pair=48, pack32=True),
     "tc_pack32"),     # G = 512 at k_pair 48
    (dict(m=64, dsub=2, p_tile=128, s_eff=4096, k_pair=64, pack32=True),
     "tc_pack32"),     # the deep instance, one tile: 210,976 B
    (dict(m=64, dsub=2, p_tile=128, s_eff=512, k_pair=49, pack32=True),
     "tc_pack32"),     # the deep instance from k_pair 49, G = 256
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
     "exact"),         # d = 160: its shared memory fits (230,432 B), but
                       # the decode source walks no k chunks
])
def test_pick_route(shape, route):
    assert cs.pick_route(**shape) == route
    assert route in cs.launches


def test_launch_refuses_a_route_that_does_not_fit():
    """launch() checks the route against pick_route before anything runs:
    the tensor-core route for exact k_pair 20, and a route of the other
    select."""
    args = _integer_case(m=64, dsub=2, s_eff=256, seed=1)
    kw = dict(s_eff=256, k_pair=20, euclidean=True, pack32=False,
              slot_mask=255)
    with pytest.raises(ValueError, match="tensor-core"):
        cs.launch(None, 0, *args, route="tc_exact", **kw)
    with pytest.raises(ValueError, match="select"):
        cs.launch(None, 0, *args, route="tc_pack32", **kw)


def _codes_constants():
    """DEEP_PACK_K of csrc/codes_scan_tc.cu and TN of csrc/scan_tc.cuh."""
    import re
    from pathlib import Path
    csrc = Path(cs.__file__).resolve().parents[1] / "csrc"
    deep = re.search(r"constexpr int DEEP_PACK_K = (\d+);",
                     (csrc / "codes_scan_tc.cu").read_text())
    tn = re.search(r"constexpr int TN = (\d+);",
                   (csrc / "scan_tc.cuh").read_text())
    return int(deep.group(1)), int(tn.group(1))


@pytest.mark.parametrize("m,dsub", [(64, 2), (32, 4), (128, 1), (8, 4),
                                    (8, 5)])
def test_tc_smem_mirror_terms(m, dsub):
    """ops/codes_scan.py:tc_smem_bytes, which pick_route reads without the
    library (the card test holds the library's sizes to it), term for term:
    the 512 * d-byte codebook beside the body; above pack32 k_pair
    DEEP_PACK_K (the header's constant) the deep instance adds the raw
    codes' ring [TN][m] and keeps one decoded tile of the body's two."""
    deep_k, tn = _codes_constants()
    assert deep_k == cs._TC_DEEP_PACK_K == 48
    d = m * dsub
    tile = tn * ((2 * d + 31) // 32 * 32 + 16)
    for pack32 in (False, True):
        for k_pair in (1, 10, 16, 40, 48, 49, 52, 57, 64):
            body = block_scan.tc_smem_bytes(2 * d, pack32, k_pair)
            got = cs.tc_smem_bytes(m=m, dsub=dsub, pack32=pack32,
                                   k_pair=k_pair)
            if pack32 and k_pair > deep_k:
                assert got == 512 * d + tn * m + body - tile
            else:
                assert got == 512 * d + body


def test_tc_route_boundary_reads_the_mirror(monkeypatch):
    """The deep instance's sizes at d = 128, k_pair 64 (the two tiles of the
    shallow instances would take 237,600 B there, over the limit), and
    pick_route's tensor-core boundary sits where the mirror meets the
    limit: one byte less and the same shape goes to the CUDA cores."""
    sizes = {(m, dsub): cs.tc_smem_bytes(m=m, dsub=dsub, pack32=True,
                                         k_pair=64)
             for m, dsub in ((64, 2), (32, 4), (128, 1))}
    assert sizes == {(64, 2): 210976, (32, 4): 206880, (128, 1): 219168}
    assert cs.tc_smem_bytes(m=64, dsub=2, pack32=True, k_pair=48) == 213024
    assert 512 * 128 + block_scan.tc_smem_bytes(256, True, 64) \
        == 237600 > cs._SMEM_LIMIT
    shape = dict(m=64, dsub=2, p_tile=128, s_eff=1024, k_pair=64,
                 pack32=True)
    monkeypatch.setattr(cs, "_SMEM_LIMIT", 210976)
    assert cs.pick_route(**shape) == "tc_pack32"
    monkeypatch.setattr(cs, "_SMEM_LIMIT", 210975)
    assert cs.pick_route(**shape) == "pack32"
    assert cs.pick_route(**dict(shape, k_pair=52)) == "tc_pack32"
