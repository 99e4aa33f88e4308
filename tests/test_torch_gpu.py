"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked `gpu`: without a CUDA card every test here skips. This file imports
neither JAX nor the JAX package, so it also runs where JAX is not
installed, without the repository's conftest:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from torchpq_tpu_torch.ops import adc
from torchpq_tpu_torch.ops import block_scan as bs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pack32", [False, True])
@pytest.mark.parametrize("s_eff,k_pair", [(512, 10), (512, 40), (1024, 40)])
def test_kernel_matches_plain(cuda, dtype, pack32, s_eff, k_pair):
    """(1024, 40) selects over 512 strided groups: 64 probers per CTA."""
    args = bs.random_inputs(cuda, s_eff=s_eff, n_blocks=64, nq=500,
                            cap_total=8192, dtype=dtype)
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=True, pack32=pack32,
              slot_mask=s_eff - 1)
    mode = "pack32" if pack32 else "exact"
    before = bs.launches[mode]
    got = bs.block_scan(*args, **kw)
    torch.cuda.synchronize()
    assert bs.launches[mode] == before + 1
    ref = bs.block_scan_ref(*args, **kw)
    if pack32:
        assert (got == ref).float().mean().item() >= 0.99
    else:
        # bf16 products are exact in f32; only the summation order differs
        v = bs.sortable_i32_to_f32(got[..., :k_pair])
        v_ref = bs.sortable_i32_to_f32(ref[..., :k_pair])
        torch.testing.assert_close(v, v_ref, rtol=1e-3, atol=1e-3)
        assert (got[..., k_pair:] == ref[..., k_pair:]).float().mean() \
            .item() >= 0.99


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
                  approx=approx)
        v_ref, a_ref = adc.scan_cell_major(*cpu, **kw)
        v, a = adc.scan_cell_major(*[t.to(cuda) for t in cpu], **kw)
        torch.testing.assert_close(v.cpu(), v_ref, rtol=1e-3, atol=1e-2)
        agree = (a.cpu() == a_ref).float().mean().item()
        assert agree >= 0.99, agree


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
    cpu = tp.IVFPQIndex(32, 8, 16, initial_size=32)
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
        # pack32 keeps a raw score r = v + |q|^2 only above the slot bits:
        # its f32 bits below log2(slot_mask + 1) are cut, one step being
        # (slot_mask + 1) ulps of r. Two sums of r that differ in the last
        # bits can fall on either side of a step, so where the ids agree
        # the values differ by at most one step (of the larger binade), plus
        # the summation and -|q|^2 rounding (1e-5 |r|). The group reduce may
        # keep another of two near-tied slots, so compare where ids agree.
        gate = adc.LAST_GATE
        assert gate["pack32"] and gate["impl"] == "block_scan", gate
        slot_mask = tp.util.next_pow2(gate["s_eff"]) - 1
        same = i.cpu() == i_ref
        raw = (v_ref.double() + torch.from_numpy(
            (q.astype(np.float64) ** 2).sum(1))[:, None]).abs()
        step = (slot_mask + 1) * torch.exp2(
            torch.floor(torch.log2(raw * (1 + 1e-5))) - 23)
        tol = step + 1e-5 * raw
        err = (v.cpu().double() - v_ref.double()).abs()
        assert bool((err[same] <= tol[same]).all()), \
            float((err - tol)[same].max())
