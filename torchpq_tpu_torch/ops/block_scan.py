"""IVF block scan: score blocks of probers against their cell's window and
keep each prober's top k_pair.

Replaces the TPU kernel torchpq_tpu/ops/pallas_scan.py:scan_blocks_pallas
(bf16/f32/int8 decoded cache, exact and pack32 selects, query rows read by
prober id). Two sources' kernels serve it, chosen before launch by
`pick_route`, each built by `_build.py`, bound through plain C entry points
and counted under its route's key of `launches`:
  - `csrc/block_scan_wg.cu`, bf16 caches with rows of d <= 1024 (d % 8 ==
    0) and int8 caches with rows of d <= 1024 (d % 16 == 0), blocks of at
    most 128 probers, on Hopper's warpgroup products (wgmma bf16 with f32
    sums, s8 with exact s32 sums) fed by TMA through a shared-memory ring,
    one producer and two consumer warpgroups, in two families of
    instances: "tc_wgn_exact" / "tc_wgn_pack32" and "tc_wgn_int8_exact" /
    "tc_wgn_int8_pack32", rows of at most 256 bytes (bf16 d <= 128, the
    main path's cache: the bf16 tier's probed plans and the deep-k scans,
    pack32 k_pair 64, included; int8 d <= 256, the int8 tier's probed
    plans), the block's query rows resident in shared memory and one chain
    of k steps; "tc_wg_exact" / "tc_wg_pack32" and "tc_wg_int8_exact" /
    "tc_wg_int8_pack32", wider rows (the GIST-class cache, 1,024 wide),
    bf16 in 256-byte k chunks each summed from zero, int8 in one s32 chain;
    pack32 above k_pair 16 in both families through the deep select
    (`csrc/deep_select.cuh`: phase ends pruned by each row's running
    list, one list a row);
  - "exact" / "pack32" and "int8_exact" / "int8_pack32",
    `csrc/block_scan.cu`: f32 caches and the shapes the tensor-core kernels
    do not take, on the CUDA cores (f32 FMAs, __dp4a).

What it computes, for block b, prober p and window slot j < s_eff:
    score = c * <q[probers[b, p]], decoded[start_c[b] + j]> - pen[b, j]
    pen   = penalty[start_c[b] + j] + (off[b] <= j < off[b] + cap[b] ? 0 : BIG)
with c = 2 for euclidean and 1 otherwise, then one of two selects in the
JAX package's wire format (see `select_exact` / `select_pack32`). In int8
mode (int8 query rows and cache, f32 scales `q_scale` [nq] and `scale`
[capacity]) the score is one fused multiply-add of the exact integer
product, as the JAX kernel's (checked against it in interpret mode):
    ab    = sum_k q8[p, k] * y8[j, k]
    score = fma(ab, (c * q_scale[p]) * scale[j], -pen[b, j])

What bounds it on an H100: a block reads s_eff * d window elements and
does 2 * d operations per live prober and slot, so bytes and products
alike are far below the card's rates (the bf16 plans' bound is ~0.09 ms,
set by the window bytes). The CUDA-core kernel spends its time on an f32
FMA (or __dp4a) chain per prober, pad probers included (every window
element feeds 128 of them). The tensor-core kernel runs the products on
the tensor cores (wgmma) for the live 64-prober tiles only and brings the
window rows as they lie (TMA boxes, no conversion); what is left is the
select, one pass over every live score, and the latency of each tile's
copy.

The products of bf16 values are exact in f32, so the kernels and the plain
version differ only in summation order: they agree bit for bit where every
sum is exact (`integer_block_inputs`), and within 1e-3 elsewhere. The int8
sums are exact integers in every kernel, so the int8 kernels and the plain
version agree bit for bit on every input (`int8_tie_inputs` adds ties).
Pad rows (prober -1): the plain version and the CUDA-core kernel score
them with query 0, as the JAX kernel does; the tensor-core kernels write
them dead (exact: sortable(-inf) keys, -1 addresses; pack32: INT_MIN). The
merge never reads them.

`block_scan` takes the plain version `block_scan_ref` only for tensors on
the CPU. For CUDA tensors it launches the kernel of its route or raises.
"""

import ctypes
import functools

import numpy as np
import torch

from .. import util

# FLT_MAX / 4: the penalty that marks a slot dead (torchpq_tpu/ops/adc.py)
BIG = float(np.float32(np.finfo(np.float32).max) / np.float32(4))

# kernel launches per route, counted by `block_scan` where it launches
# ("tc_*": the tensor-core kernels, bf16 and int8; the others: the CUDA-core
# one, per cache mode and select)
launches = {"exact": 0, "pack32": 0, "int8_exact": 0, "int8_pack32": 0,
            "tc_wg_exact": 0, "tc_wg_pack32": 0, "tc_wgn_exact": 0,
            "tc_wgn_pack32": 0, "tc_wg_int8_exact": 0,
            "tc_wg_int8_pack32": 0, "tc_wgn_int8_exact": 0,
            "tc_wgn_int8_pack32": 0}

_SMEM_LIMIT = 227 * 1024  # dynamic shared memory one CTA may use on sm_90
_CHUNK_SCORES = 1 << 25   # f32 scores per chunk of the plain version (128 MB)
_H100_SMS = 132           # SMs assumed for tensors that are not on a card
# the selects' shared arrays (csrc/scan_tc.cuh)
_TC_WARPS = 8       # consumer warps
_TC_MAX_PT = 128    # probers per block: 16 a warp
_TC_KMAX = 16       # the exact k_pair the lane lists take
_TC_MAX_PACK_K = 64  # the pack32 k_pair the lists take
_TC_TN = 128        # a tile of window columns
_TC_SLD = 72        # exact staging row stride (floats)
_TC_QUEUE = 6       # exact: a lane's queued candidates
# the warp-specialised scan (csrc/wg_layout.cuh)
_WG_MAX_ROW_BF16 = 2048  # widest row (bytes): bf16 d <= 1024
_WG_SW_ATOM = 1024      # bytes of a 128-byte swizzle atom (alignment slack)
_WG_STAGE_BYTES = 16384  # one operand of a ring stage: [128][128 B]
_WG_BOX_ROWS = 128      # window columns per tile
# ring stages: exact k_pair <= 10, exact; pack32 k_pair <= 16, deeper
_WG_RING_EXACT_10, _WG_RING_EXACT = 5, 4
_WG_RING_PACK_16, _WG_RING_DEEP = 6, 4
# its narrow rows (d <= 128): resident query buffers of [2][128][128 B],
# ring stages of one [128][128 B] window tile; stages exact k_pair <= 10,
# exact, pack32 k_pair <= 16, deeper; query buffers, the deep instance's
_WG_NARROW_ROW = 256
_WG_QBUF_BYTES = 2 * _WG_STAGE_BYTES
_WG_NRING_EXACT_10, _WG_NRING_EXACT = 6, 5
_WG_NRING_PACK_16, _WG_NRING_DEEP = 8, 5
_WG_NQB, _WG_NQB_DEEP = 2, 2
# the deep pack32 select (csrc/deep_select.cuh, k_pair 17-64): a warp's
# staging rows (one a quad) and their stride (a phase's 128 groups, plus
# one)
_DS_SHALLOW_K, _DS_MAX_K, _DS_SLOTS, _DS_SST = 16, 64, 8, 129
# int8 rows (d <= 1024, d % 16 == 0): each ring stage also carries its
# columns' scales; the narrow pack32 instance of k_pair <= 16 keeps 7 stages
_WG_SCALE_BYTES = 4 * _WG_BOX_ROWS
_WG_NRING_PACK_16_I8 = 7
_WG_MAX_ROW_I8 = 1024   # widest int8 row (bytes): d <= 1024


def sortable_i32(x):
    """Order-preserving f32 -> int32 bijection, bit-exact with the JAX
    package's _f32_sortable_i32: negative floats flip their low 31 bits."""
    i = x.contiguous().view(torch.int32)
    return torch.where(i < 0, i ^ 0x7FFFFFFF, i)


def sortable_i32_to_f32(key):
    """Inverse of sortable_i32."""
    return torch.where(key < 0, key ^ 0x7FFFFFFF, key).contiguous() \
        .view(torch.float32)


def n_groups(s_eff, k_pair):
    """Strided group count of the pack32 select (pallas_scan.py:327-341):
    128 when that halves the row at least, or the first of 512/256/128
    that does for deep selects (k_pair > 32); otherwise the whole row."""
    for g in ((512, 256, 128) if k_pair > 32 else (128,)):
        if s_eff % g == 0 and s_eff >= 2 * g:
            return g
    return s_eff


def fma_f32(a, b, c):
    """a * b - c rounded once to f32, as fmaf(a, b, -c) on the card: a
    holds f32 values (exact integers here), b and c are f32. a * b is exact
    in f64 (two 24-bit significands); the f64 difference s rounds once more,
    which can only move the final f32 rounding where s lands exactly on a
    tie between two f32 values, so there s steps one f64 ulp towards the
    exact result (its rounding error, TwoSum)."""
    p = a.double() * b.double()
    cd = c.double()
    s = p - cd
    t = s - p
    err = (p - (s - t)) - (cd + t)
    tie = (s.view(torch.int64) & ((1 << 29) - 1)) == (1 << 28)
    step = torch.nextafter(s, torch.where(err > 0, torch.inf, -torch.inf))
    return torch.where(tie & (err != 0), step, s).float()


def int8_products(q, y):
    """Exact int8 dot products q [B, P, d] . y [B, s, d] -> f32 [B, P, s],
    rounded to f32 as the JAX package's int32 -> f32 cast. Never in int8
    arithmetic (torch's int8 matmul wraps): f32 sums of int8 products are
    exact while d * 127^2 < 2^24 (d <= 1040), f64 beyond that."""
    d = q.shape[-1]
    acc = torch.float32 if d * 127 * 127 < (1 << 24) else torch.float64
    return torch.bmm(q.to(acc), y.to(acc).transpose(1, 2)).float()


def window_scores(qtable, probers, start_c, off, cap, penalty, gather, slot,
                  *, euclidean, scale=None, q_scale=None,
                  precision="highest"):
    """Plain per-block scores [B, P, s] f32 over window columns whose
    in-window slots are `slot` [s] (long); gather(rows [B, s]) gives the
    candidate rows [B, s, d]. Products of the operands' values (bf16 rounds
    nothing more), summed in f32; in int8 mode (scale [capacity] and
    q_scale [nq] given) the exact integer products, dequantized by one
    fused multiply-add. `precision` (util.matmul) is the XLA select's: the
    kernels' plain version keeps "highest"."""
    rows = start_c.long()[:, None] + slot[None, :]
    pidx = probers.clamp(min=0).long()
    in_cell = (slot[None, :] >= off[:, None]) \
        & (slot[None, :] < (off + cap)[:, None])
    pen = penalty[rows] + torch.where(in_cell, 0.0, BIG)
    factor = 2.0 if euclidean else 1.0
    if scale is not None:
        ab = int8_products(qtable[pidx], gather(rows))
        m = (factor * q_scale[pidx])[:, :, None] * scale[rows][:, None, :]
        return fma_f32(ab, m, pen[:, None, :])
    ab = util.matmul(qtable[pidx], gather(rows), precision)  # [B, P, s]
    return (2.0 * ab if euclidean else ab) - pen[:, None, :]


def block_scores(qtable, probers, start_c, off, cap, penalty, decoded, *,
                 s_eff, euclidean, scale=None, q_scale=None,
                 precision="highest"):
    """Plain per-block scores [B, P, s_eff] over the cache's rows."""
    slot = torch.arange(s_eff, device=decoded.device)
    return window_scores(qtable, probers, start_c, off, cap, penalty,
                         lambda rows: decoded[rows], slot,
                         euclidean=euclidean, scale=scale, q_scale=q_scale,
                         precision=precision)


def select_exact(scores, start_c, k_pair, slot=None):
    """Top k_pair per row, by value descending then column ascending (the
    Pallas kernel's "first maximal column per pass" order) ->
    [B, P, 2*k_pair] int32 sortable keys ++ addresses; -inf / -1 dead.
    `slot` [s] maps a column to its in-window slot (default: the column)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k_pair], idx[..., :k_pair]
    if slot is not None:
        idx = slot[idx]
    alive = vals > -BIG / 2
    keys = sortable_i32(torch.where(alive, vals, -torch.inf))
    addr = torch.where(alive, start_c.long()[:, None, None] + idx, -1)
    return torch.cat([keys, addr.int()], dim=-1)


def select_pack32(scores, k_pair, slot_mask, slot=None):
    """pack32: key = (sortable(score) & ~slot_mask) | slot, one winner per
    strided group of columns (group g holds columns g, g+G, ...), then the
    k_pair largest winners descending -> [B, P, k_pair] int32. Keys are
    unique per row. `slot` [s] int32 maps a column to its in-window slot
    (default: the column)."""
    b, p, s = scores.shape
    g = n_groups(s, k_pair)
    if slot is None:
        slot = torch.arange(s, dtype=torch.int32, device=scores.device)
    packed = (sortable_i32(scores) & ~slot_mask) | slot
    best = packed.view(b, p, s // g, g).amax(dim=2)
    return torch.topk(best, k_pair, dim=-1).values


def select_chunks(scores, select, probers, start_c, *, s_eff, width,
                  cost=1):
    """select(scores(sl), start_c[sl]) over slices sl of the blocks, each
    holding at most _CHUNK_SCORES / cost f32 scores (cost: temporaries per
    score) -> int32 [B, p_tile, width]."""
    b, p = probers.shape
    step = max(1, _CHUNK_SCORES // max(p * s_eff * cost, 1))
    outs = [select(scores(slice(i, i + step)), start_c[i:i + step])
            for i in range(0, b, step)]
    if not outs:
        return torch.empty((0, p, width), dtype=torch.int32,
                           device=probers.device)
    return torch.cat(outs)


def select_blocks(select, qtable, probers, start_c, off, cap, penalty,
                  decoded, *, s_eff, euclidean, width, scale=None,
                  q_scale=None, precision="highest"):
    """select(block_scores(...), start_c) over chunks of blocks ->
    int32 [B, p_tile, width]."""
    def scores(sl):
        return block_scores(qtable, probers[sl], start_c[sl], off[sl],
                            cap[sl], penalty, decoded, s_eff=s_eff,
                            euclidean=euclidean, scale=scale,
                            q_scale=q_scale, precision=precision)
    # the int8 scores' f64 fused multiply-add keeps a few f64 temporaries
    return select_chunks(scores, select, probers, start_c, s_eff=s_eff,
                         width=width, cost=1 if scale is None else 8)


def block_scan_ref(qtable, probers, start_c, off, cap, penalty, decoded, *,
                   s_eff, k_pair, euclidean, pack32, slot_mask, scale=None,
                   q_scale=None):
    """Plain PyTorch version of the kernel."""
    if pack32:
        def select(sc, _):
            return select_pack32(sc, k_pair, slot_mask)
    else:
        def select(sc, st):
            return select_exact(sc, st, k_pair)
    return select_blocks(select, qtable, probers, start_c, off, cap, penalty,
                         decoded, s_eff=s_eff, euclidean=euclidean,
                         width=k_pair if pack32 else 2 * k_pair, scale=scale,
                         q_scale=q_scale)


def random_inputs(device, *, s_eff, n_blocks, nq, d=128, cap_total,
                  dtype=torch.bfloat16, seed=0):
    """Seeded block-scan inputs in the layout the cell-major scan gives:
    each block's live probers first, then -1 pads; 16-aligned windows; the
    cell at a 16-aligned offset inside its window; 5% empty slots."""
    g = torch.Generator(device=device).manual_seed(seed)
    qtable = torch.randn(nq, d, generator=g, device=device).to(dtype)
    decoded = torch.randn(cap_total, d, generator=g, device=device).to(dtype)
    empty = torch.rand(cap_total, generator=g, device=device) < 0.05
    penalty = torch.where(empty, BIG,
                          decoded.float().pow(2).sum(-1)).contiguous()
    probers = torch.randint(0, nq, (n_blocks, 128), generator=g,
                            device=device, dtype=torch.int32)
    n_live = torch.randint(1, 129, (n_blocks, 1), generator=g, device=device)
    probers = torch.where(torch.arange(128, device=device)[None] < n_live,
                          probers, -1).int().contiguous()
    start_c = (torch.randint(0, (cap_total - s_eff) // 16, (n_blocks,),
                             generator=g, device=device) * 16).int()
    off = (torch.randint(0, 8, (n_blocks,), generator=g, device=device)
           * 16).int()
    cap = torch.randint(s_eff // 4, s_eff // 2, (n_blocks,), generator=g,
                        device=device).int()
    return [qtable, probers, start_c, off, cap, penalty, decoded]


def random_int8_inputs(device, *, s_eff, n_blocks, nq, d=128, cap_total,
                       seed=0):
    """Seeded int8-mode inputs: `random_inputs`' layout with the query rows
    and cache quantized per row (util.int8_quantize_rows) -> (args, scale,
    q_scale); the penalty keeps the f32 rows' squared norms."""
    qtable, probers, start_c, off, cap, penalty, decoded = random_inputs(
        device, s_eff=s_eff, n_blocks=n_blocks, nq=nq, d=d,
        cap_total=cap_total, dtype=torch.float32, seed=seed)
    q8, q_scale = util.int8_quantize_rows(qtable)
    y8, scale = util.int8_quantize_rows(decoded)
    return ([q8, probers, start_c, off, cap, penalty, y8],
            scale.contiguous(), q_scale.contiguous())


def int8_tie_inputs(device, *, s_eff, n_blocks, nq, d=128, cap_total,
                    seed=0):
    """Seeded int8-mode inputs with exact ties (numpy draws): query and
    cache rows of integers in {-3..3} quantized per row
    (util.int8_quantize_rows: few distinct scales and byte values), the
    cache rows drawn from 64 distinct ones (equal rows all over each
    window), a run of equal rows inside one window and equal rows far
    apart across windows, the rows' squared norms (integers) as penalty
    with BIG at ~5% of slots; blocks in `random_inputs`' layout -> (args,
    scale, q_scale). The int8 sums are exact integers in every kernel, so
    the kernels and the plain version agree bit for bit on any input; these
    make equal scores at any d."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-3, 4, (nq, d)).astype(np.float32)
    pool = rng.integers(-3, 4, (64, d)).astype(np.float32)
    y = pool[rng.integers(0, 64, cap_total)]
    run = slice(cap_total // 10, cap_total // 10 + min(200, s_eff // 2))
    y[run] = y[run.start]          # a run of equal rows
    y[cap_total // 2::97] = y[1]   # equal rows far apart
    norms = (y ** 2).sum(1).astype(np.float32)
    penalty = np.where(rng.random(cap_total) < 0.05, np.float32(BIG),
                       norms).astype(np.float32)
    n_live = rng.integers(1, 129, (n_blocks, 1))
    probers = np.where(np.arange(128)[None] < n_live,
                       rng.integers(0, nq, (n_blocks, 128)), -1)
    start_c = rng.integers(0, (cap_total - s_eff) // 16 + 1, n_blocks) * 16
    off = rng.integers(0, min(8, s_eff // 16), n_blocks) * 16
    cap = np.minimum(rng.integers(s_eff // 4, s_eff // 2 + 1, n_blocks),
                     s_eff - off)
    q8, q_scale = util.int8_quantize_rows(torch.from_numpy(q))
    y8, scale = util.int8_quantize_rows(torch.from_numpy(y))
    t = [x.to(device).contiguous() for x in (
        q8, torch.from_numpy(probers.astype(np.int32)),
        torch.from_numpy(start_c.astype(np.int32)),
        torch.from_numpy(off.astype(np.int32)),
        torch.from_numpy(cap.astype(np.int32)), torch.from_numpy(penalty),
        y8)]
    return t, scale.to(device).contiguous(), q_scale.to(device).contiguous()


def integer_block_inputs(device, *, s_eff, n_blocks, nq, d=128, cap_total,
                         seed=0):
    """Seeded integer-valued bf16 block-scan inputs (numpy draws): query and
    cache values in {-3..3}, the rows' squared norms (integers) as penalty
    with BIG at ~5% of slots, and runs of equal rows inside one window and
    far apart across windows, so exact ties occur. Blocks in
    `random_inputs`' layout: each block's live probers first, then -1
    pads; 16-aligned windows; the cell at a 16-aligned offset. Every score
    is an integer the f32 sums hold exactly in any order, so the kernels
    and the plain version agree bit for bit, ties included."""
    rng = np.random.default_rng(seed)
    qtable = rng.integers(-3, 4, (nq, d)).astype(np.float32)
    decoded = rng.integers(-3, 4, (cap_total, d)).astype(np.float32)
    run = slice(cap_total // 10, cap_total // 10 + min(200, s_eff // 2))
    decoded[run] = decoded[run.start]          # a run of equal rows
    decoded[cap_total // 2::97] = decoded[1]   # equal rows far apart
    norms = (decoded ** 2).sum(1).astype(np.float32)
    penalty = np.where(rng.random(cap_total) < 0.05, np.float32(BIG),
                       norms).astype(np.float32)
    n_live = rng.integers(1, 129, (n_blocks, 1))
    probers = np.where(np.arange(128)[None] < n_live,
                       rng.integers(0, nq, (n_blocks, 128)), -1)
    start_c = rng.integers(0, (cap_total - s_eff) // 16 + 1, n_blocks) * 16
    off = rng.integers(0, min(8, s_eff // 16), n_blocks) * 16
    cap = np.minimum(rng.integers(s_eff // 4, s_eff // 2 + 1, n_blocks),
                     s_eff - off)
    t = [torch.from_numpy(x).to(device) for x in (
        qtable, probers.astype(np.int32), start_c.astype(np.int32),
        off.astype(np.int32), cap.astype(np.int32), penalty, decoded)]
    t[0], t[6] = t[0].to(torch.bfloat16), t[6].to(torch.bfloat16)
    return [x.contiguous() for x in t]


def _check(qtable, probers, start_c, off, cap, penalty, decoded, s_eff,
           k_pair, pack32, slot_mask, scale, q_scale):
    dev = decoded.device
    if decoded.dtype not in (torch.bfloat16, torch.float32, torch.int8):
        raise TypeError(
            f"decoded must be bf16, f32 or int8, got {decoded.dtype}")
    if qtable.dtype != decoded.dtype:
        raise TypeError(
            f"qtable dtype {qtable.dtype} != decoded dtype {decoded.dtype}")
    int8 = decoded.dtype == torch.int8
    if int8 != (scale is not None) or int8 != (q_scale is not None):
        raise ValueError("scale and q_scale are given for an int8 cache, "
                         "and only then")
    if int8:
        for name, t, n in (("scale", scale, decoded.shape[0]),
                           ("q_scale", q_scale, qtable.shape[0])):
            if t.dtype != torch.float32 or tuple(t.shape) != (n,):
                raise TypeError(f"{name} must be float32 [{n}]")
            if t.device != dev or not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous on {dev}")
    if decoded.ndim != 2 or qtable.ndim != 2 \
            or qtable.shape[1] != decoded.shape[1]:
        raise ValueError(f"qtable {tuple(qtable.shape)} and decoded "
                         f"{tuple(decoded.shape)} must be [*, d] alike")
    if probers.ndim != 2 or probers.dtype != torch.int32:
        raise TypeError("probers must be int32 [B, p_tile]")
    b = probers.shape[0]
    for name, t in (("start_c", start_c), ("off", off), ("cap", cap)):
        if t.dtype != torch.int32 or tuple(t.shape) != (b,):
            raise TypeError(f"{name} must be int32 [{b}]")
    if penalty.dtype != torch.float32 \
            or tuple(penalty.shape) != (decoded.shape[0],):
        raise TypeError("penalty must be float32 [capacity]")
    for name, t in (("qtable", qtable), ("probers", probers),
                    ("start_c", start_c), ("off", off), ("cap", cap),
                    ("penalty", penalty), ("decoded", decoded)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, decoded on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= k_pair <= min(64, s_eff) or s_eff > decoded.shape[0]:
        raise ValueError(f"need 1 <= k_pair={k_pair} <= min(64, "
                         f"s_eff={s_eff}) and s_eff <= capacity")
    if pack32 and slot_mask != util.next_pow2(s_eff) - 1:
        raise ValueError("slot_mask must be next_pow2(s_eff) - 1")


def _cta_probers(smem, p_tile):
    """Probers per CTA: the most (of 128/64/32) whose shared memory
    smem(pt) fits."""
    for pt in (128, 64, 32):
        if p_tile % pt == 0 and smem(pt) <= _SMEM_LIMIT:
            return pt
    raise ValueError(f"block scan: no CTA shape fits shared memory "
                     f"(p_tile={p_tile})")


def wg_ring(pack32, k_pair):
    """Ring stages of the warp-specialised instance that serves this select
    (csrc/wg_layout.cuh:ring_of)."""
    if pack32:
        return _WG_RING_PACK_16 if k_pair <= 16 else _WG_RING_DEEP
    return _WG_RING_EXACT_10 if k_pair <= 10 else _WG_RING_EXACT


def _wg_list_bytes(pack32, k_pair):
    """The pass by pass and exact selects' shared arrays of the
    warp-specialised scan (wg_layout.cuh:list_bytes; the codes instances'
    too): the slice lists [8][16][kls], then pack32: the running lists
    [2][128][kls]; exact: the lists' values, the staging rows [8][16][SLD],
    row bounds [8][16] and queues [QUEUE][256] x 2. kls: the lists' row
    stride, k_pair (pack32: made odd)."""
    kls = k_pair | 1 if pack32 else k_pair
    lists = 4 * _TC_WARPS * 16 * kls
    return lists + (2 * 4 * _TC_MAX_PT * kls if pack32 else
                    lists + 4 * _TC_WARPS * 16 * (_TC_SLD + 1)
                    + 8 * _TC_QUEUE * 32 * _TC_WARPS)


def _wg_select_bytes(pack32, k_pair):
    """The select's shared arrays of the warp-specialised scan's bf16 and
    int8 instances (wg_layout.cuh:select_bytes): pack32 above k_pair 16,
    the deep select's (deep_select.cuh:select_bytes: the warps' staging
    rows [8][8][129], one running list a row [128][kls] and the staged
    counts [128][2]); else _wg_list_bytes."""
    if pack32 and k_pair > _DS_SHALLOW_K:
        return 4 * (_TC_WARPS * _DS_SLOTS * _DS_SST
                    + _TC_MAX_PT * ((k_pair | 1) + 2))
    return _wg_list_bytes(pack32, k_pair)


def wg_smem_bytes(pack32, k_pair, d=1024, dtype=torch.bfloat16):
    """Dynamic shared memory of the warp-specialised scan at width d over a
    `dtype` cache (bf16 or int8; csrc/wg_layout.cuh:smem_bytes for
    k-chunked rows, narrow_smem_bytes for rows of at most 256 bytes, term
    for term; the library's torchpq_block_scan_wg_smem /
    torchpq_block_scan_wg_int8_smem report the same). k-chunked: alignment
    slack, the ring's stages (window and query tiles, penalties, int8: the
    columns' scales, two barriers; 3 to 6 stages by the instance,
    wg_layout.cuh:ring_of), prober rows and tile flags, the select's
    arrays. Narrow: alignment slack, the resident query buffers [2][128][128
    B] and their two barriers (two each instance), the ring's stages (a
    window tile, penalties, int8: scales, two barriers; 5 to 8 by the
    instance), prober rows and tile flags, the select's arrays."""
    int8 = dtype == torch.int8
    head = _WG_SW_ATOM + 4 * _TC_MAX_PT + 4 * 8 \
        + _wg_select_bytes(pack32, k_pair)
    scales = _WG_SCALE_BYTES if int8 else 0
    if d * (1 if int8 else 2) <= _WG_NARROW_ROW:
        _, ring, qbufs = wg_narrow_instance(pack32, k_pair, dtype)
        return head + qbufs * (_WG_QBUF_BYTES + 16) \
            + ring * (_WG_STAGE_BYTES + 4 * _WG_BOX_ROWS + scales + 16)
    return head + wg_ring(pack32, k_pair) * (
        2 * _WG_STAGE_BYTES + 4 * _WG_BOX_ROWS + scales + 16)


def wg_narrow_instance(pack32, k_pair, dtype=torch.bfloat16):
    """(KMAX, ring stages, query buffers) of the narrow warp-specialised
    instance that serves this select over a `dtype` cache
    (csrc/block_scan_wg.cu's dispatch, wg_layout.cuh:narrow_ring_of /
    narrow_qbufs_of): pack32 above k_pair 16 runs five stages (KMAX 64: the
    deep select, deep_select.cuh), pack32 up to k_pair 16 eight (int8:
    seven, its stages carrying the columns' scales; KMAX 16: passes), each
    instance with two query buffers."""
    if pack32:
        if k_pair > _DS_SHALLOW_K:
            return _DS_MAX_K, _WG_NRING_DEEP, _WG_NQB_DEEP
        return 16, (_WG_NRING_PACK_16_I8 if dtype == torch.int8
                    else _WG_NRING_PACK_16), _WG_NQB
    if k_pair <= 10:
        return 10, _WG_NRING_EXACT_10, _WG_NQB
    return 16, _WG_NRING_EXACT, _WG_NQB


def wg_shapes_ok(*, d, p_tile, s_eff, k_pair, pack32, dtype=torch.bfloat16):
    """Whether the warp-specialised scan (csrc/block_scan_wg.cu) takes these
    shapes: a bf16 cache with rows of d <= 1024, d % 8 == 0 (narrow
    instances up to d = 128, k-chunked ones above), or an int8 cache with
    rows of d <= 1024, d % 16 == 0 (narrow up to d = 256); the blocks,
    selects and groups of _blocks_ok; its shared memory
    (wg_smem_bytes) within the limit, which every such shape meets (the
    ring as deep as the instance's largest k_pair lets it be: k-chunked,
    exact k_pair 10 227,952 B on five stages (int8 230,512 B), pack32
    k_pair 64 202,080 B on four; narrow, exact k_pair 10 228,512 B on six
    (int8 231,584 B), pack32 k_pair 64 219,024 B on five)."""
    if dtype == torch.int8:
        rows_ok = d % 16 == 0 and 0 < d <= _WG_MAX_ROW_I8
    else:
        rows_ok = (dtype == torch.bfloat16 and d % 8 == 0 and 0 < d
                   and 2 * d <= _WG_MAX_ROW_BF16)
    return (rows_ok
            and wg_smem_bytes(pack32, k_pair, d, dtype) <= _SMEM_LIMIT
            and _blocks_ok(p_tile, s_eff, k_pair, pack32))


def _blocks_ok(p_tile, s_eff, k_pair, pack32):
    """The blocks and selects the tensor-core scans take: p_tile a
    multiple of 16 up to 128; exact with k_pair <= 16; pack32 with k_pair
    <= 64 and the strided group count G = n_groups(s_eff, k_pair) a
    multiple of 8 that is either the whole row (s_eff <= 128) or a
    multiple of 128 dividing s_eff (G = 128, 256, 512)."""
    if p_tile % 16 or p_tile > _TC_MAX_PT:
        return False
    if not pack32:
        return k_pair <= _TC_KMAX
    g = n_groups(s_eff, k_pair)
    return k_pair <= _TC_MAX_PACK_K and g % 8 == 0 and (
        g <= _TC_TN if g == s_eff else g % _TC_TN == 0 and s_eff % g == 0)


def pick_route(*, dtype, d, p_tile, s_eff, k_pair, pack32):
    """The kernel that serves a scan of these shapes, which is also its key
    in `launches`:
      - "tc_wgn_exact" / "tc_wgn_pack32" and "tc_wgn_int8_exact" /
        "tc_wgn_int8_pack32" (`csrc/block_scan_wg.cu`'s narrow instances,
        wgmma and TMA, the query rows resident): a bf16 or int8 cache at
        the shapes of `wg_shapes_ok` with rows of at most 256 bytes (bf16
        d <= 128, int8 d <= 256);
      - "tc_wg_exact" / "tc_wg_pack32" and "tc_wg_int8_exact" /
        "tc_wg_int8_pack32" (`csrc/block_scan_wg.cu`'s k-chunked
        instances): the same with wider rows, up to d = 1024;
      - "exact" / "pack32" (`csrc/block_scan.cu`, CUDA cores): f32 caches
        and the bf16 shapes above it does not take (rows over 2,048 bytes,
        exact k_pair > 16, other blocks or groups);
      - "int8_exact" / "int8_pack32" (`csrc/block_scan.cu`): the int8
        shapes the tensor-core kernels do not take (rows over 1,024 bytes
        or not of 16-byte pieces, exact k_pair > 16, other blocks or
        groups)."""
    mode = ("int8_" if dtype == torch.int8 else "") + (
        "pack32" if pack32 else "exact")
    if wg_shapes_ok(d=d, p_tile=p_tile, s_eff=s_eff, k_pair=k_pair,
                    pack32=pack32, dtype=dtype):
        rb = d * (1 if dtype == torch.int8 else 2)
        return ("tc_wgn_" if rb <= _WG_NARROW_ROW else "tc_wg_") + mode
    return mode


def block_scan(qtable, probers, start_c, off, cap, penalty, decoded, *,
               s_eff, k_pair, euclidean, pack32, slot_mask, scale=None,
               q_scale=None):
    """Run the block scan.

    qtable [nq, d] (decoded's dtype), probers [B, p_tile] int32 query rows
    (-1 pads), start_c / off / cap [B] int32 (window start, the cell's offset
    in the window, its capacity), penalty [capacity] f32 (norm-or-BIG),
    decoded [capacity, d] bf16/f32/int8; for int8 also scale [capacity] and
    q_scale [nq] f32. Returns int32 [B, p_tile, k_pair] (pack32) or
    [B, p_tile, 2*k_pair] (exact)."""
    _check(qtable, probers, start_c, off, cap, penalty, decoded, s_eff,
           k_pair, pack32, slot_mask, scale, q_scale)
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=euclidean,
              pack32=pack32, slot_mask=slot_mask, scale=scale,
              q_scale=q_scale)
    if decoded.device.type == "cpu":
        return block_scan_ref(qtable, probers, start_c, off, cap, penalty,
                              decoded, **kw)
    if decoded.device.type != "cuda":
        raise ValueError(f"block_scan runs on cpu or cuda, not "
                         f"{decoded.device}")
    from .. import _build
    route = pick_route(dtype=decoded.dtype, d=decoded.shape[1],
                       p_tile=probers.shape[1], s_eff=s_eff, k_pair=k_pair,
                       pack32=pack32)
    with torch.cuda.device(decoded.device):
        stream = torch.cuda.current_stream().cuda_stream
        out = launch(_build.library(), stream, qtable, probers, start_c, off,
                     cap, penalty, decoded, route=route, **kw)
    launches[route] += 1
    return out


@functools.lru_cache(maxsize=None)
def resident_ctas(lib, occupancy, device, *shape):
    """CTAs of a persistent kernel that `device` holds at once: its SMs
    times the CTAs one SM holds, as the library's entry point `occupancy`
    gives them for `shape`; asked once per library, entry point, device and
    shape."""
    resident = getattr(lib, occupancy)(*shape)
    if resident <= 0:
        raise RuntimeError(f"{occupancy}{shape}: no CTA fits an SM (CUDA "
                           f"error {-resident})")
    n_sm = (torch.cuda.get_device_properties(device).multi_processor_count
            if device.type == "cuda" else _H100_SMS)
    return n_sm * resident


def launch(lib, stream, qtable, probers, start_c, off, cap, penalty,
           decoded, *, s_eff, k_pair, euclidean, pack32, slot_mask,
           scale=None, q_scale=None, route=None, n_ctas=None):
    """Launch the kernel of `route` (a key of `launches`; default
    pick_route's) of `lib` on `stream` with checked arguments. n_ctas: a
    tensor-core kernel's persistent grid (default: as many CTAs as the
    card's SMs hold at once, at most one per block). Raises if the route
    does not take the shapes or the launch fails."""
    b, p_tile = probers.shape
    d = decoded.shape[1]
    groups = n_groups(s_eff, k_pair) if pack32 else 0
    mode = "pack32" if pack32 else "exact"
    best = pick_route(dtype=decoded.dtype, d=d, p_tile=p_tile, s_eff=s_eff,
                      k_pair=k_pair, pack32=pack32)
    route = route or best
    int8 = decoded.dtype == torch.int8
    kind = "int8_" + mode if int8 else mode
    if route not in (kind, "tc_wg_" + kind, "tc_wgn_" + kind):
        raise ValueError(f"route {route!r} does not serve the {mode} select "
                         f"of a {decoded.dtype} cache")
    if route.startswith("tc_") and best != route:
        raise ValueError(
            f"the tensor-core block scan ({route}) does not take "
            f"{decoded.dtype} d={d}, p_tile={p_tile}, s_eff={s_eff}, "
            f"k_pair={k_pair}, pack32={pack32}")
    out = torch.empty((b, p_tile, k_pair if pack32 else 2 * k_pair),
                      dtype=torch.int32, device=decoded.device)
    if b == 0:
        return out
    if route.startswith("tc_") and (qtable.data_ptr() % 16
                                    or decoded.data_ptr() % 16):
        raise ValueError("the tensor-core block scans copy 16-byte pieces: "
                         "qtable and decoded must be 16-byte aligned")
    if route.startswith(("tc_wg_", "tc_wgn_")):
        name = "torchpq_block_scan_wg" + ("_int8" if int8 else "")
        if n_ctas is None:
            n_ctas = resident_ctas(lib, name + "_occupancy", decoded.device,
                                   d, int(pack32), k_pair)
        rows = (decoded.data_ptr(), out.data_ptr(), b, p_tile, d,
                decoded.shape[0], s_eff, k_pair, int(euclidean), int(pack32),
                slot_mask, groups, min(n_ctas, b), ctypes.c_void_p(stream))
        if int8:
            rc = lib.torchpq_block_scan_wg_int8(
                qtable.data_ptr(), q_scale.data_ptr(), probers.data_ptr(),
                start_c.data_ptr(), off.data_ptr(), cap.data_ptr(),
                penalty.data_ptr(), scale.data_ptr(), *rows)
        else:
            rc = lib.torchpq_block_scan_wg(
                qtable.data_ptr(), probers.data_ptr(), start_c.data_ptr(),
                off.data_ptr(), cap.data_ptr(), penalty.data_ptr(), *rows)
    elif int8:
        if d % 16 or qtable.data_ptr() % 16 or decoded.data_ptr() % 16:
            raise ValueError(f"int8 block scan kernel needs d % 16 == 0 "
                             f"and 16-byte aligned rows, got d={d}")
        pt = _cta_probers(lambda pt: lib.torchpq_block_scan_int8_smem(
            pt, d, int(pack32), groups), p_tile)
        rc = lib.torchpq_block_scan_int8(
            qtable.data_ptr(), q_scale.data_ptr(), probers.data_ptr(),
            start_c.data_ptr(), off.data_ptr(), cap.data_ptr(),
            penalty.data_ptr(), scale.data_ptr(), decoded.data_ptr(),
            out.data_ptr(), b, p_tile, d, s_eff, k_pair, int(euclidean),
            int(pack32), slot_mask, groups, pt, ctypes.c_void_p(stream))
    else:
        if d % 4:
            raise ValueError(f"block scan kernel needs d % 4 == 0, got d={d}")
        is_bf16 = int(decoded.dtype == torch.bfloat16)
        pt = _cta_probers(lambda pt: lib.torchpq_block_scan_smem(
            pt, d, int(pack32), groups, is_bf16), p_tile)
        rc = lib.torchpq_block_scan(
            qtable.data_ptr(), probers.data_ptr(), start_c.data_ptr(),
            off.data_ptr(), cap.data_ptr(), penalty.data_ptr(),
            decoded.data_ptr(), out.data_ptr(), b, p_tile, d, s_eff, k_pair,
            int(euclidean), int(pack32), slot_mask, groups, is_bf16, pt,
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{route} block scan kernel launch failed: CUDA "
                           f"error {rc}")
    return out
