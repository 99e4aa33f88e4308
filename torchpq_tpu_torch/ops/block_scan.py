"""IVF block scan: score blocks of probers against their cell's window and
keep each prober's top k_pair.

Replaces the TPU kernel torchpq_tpu/ops/pallas_scan.py:scan_blocks_pallas
(bf16/f32 decoded cache, exact and pack32 selects, query rows read by
prober id). The kernel is `csrc/block_scan.cu`, built by `_build.py` and
bound through a plain C entry point.

What it computes, for block b, prober p and window slot j < s_eff:
    score = c * <q[probers[b, p]], decoded[start_c[b] + j]> - pen[b, j]
    pen   = penalty[start_c[b] + j] + (off[b] <= j < off[b] + cap[b] ? 0 : BIG)
with c = 2 for euclidean and 1 otherwise, then one of two selects in the
JAX package's wire format (see `select_exact` / `select_pack32`).

What bounds it on an H100: a block reads s_eff * d window elements once
and does p_tile (128) FMAs with each of them, so it is bound by arithmetic,
not by HBM bytes (128 FMA per 2-byte element against a machine balance of
~20 f32 FLOP per byte). The first kernel keeps the window in shared memory
tiles and runs f32 FMAs on the CUDA cores, one prober per thread; moving
the product onto the tensor cores (wgmma on bf16) is the next step.

`block_scan` takes the plain version `block_scan_ref` only for tensors on
the CPU. For CUDA tensors it launches the kernel or raises.
"""

import ctypes

import numpy as np
import torch

from .. import util

# FLT_MAX / 4: the penalty that marks a slot dead (torchpq_tpu/ops/adc.py)
BIG = float(np.float32(np.finfo(np.float32).max) / np.float32(4))

# kernel launches per select mode, counted by `block_scan` where it launches
launches = {"exact": 0, "pack32": 0}

_SMEM_LIMIT = 227 * 1024  # dynamic shared memory one CTA may use on sm_90
_CHUNK_SCORES = 1 << 25   # f32 scores per chunk of the plain version (128 MB)


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


def block_scores(qtable, probers, start_c, off, cap, penalty, decoded, *,
                 s_eff, euclidean):
    """Plain per-block scores [B, P, s_eff] f32: products of the cache's
    values (bf16 rounds nothing more), summed in f32."""
    dev = decoded.device
    slot = torch.arange(s_eff, device=dev)
    rows = start_c.long()[:, None] + slot[None, :]
    win = decoded[rows].float()                            # [B, s, d]
    q = qtable[probers.clamp(min=0).long()].float()         # [B, P, d]
    ab = torch.bmm(q, win.transpose(1, 2))
    in_cell = (slot[None, :] >= off[:, None]) \
        & (slot[None, :] < (off + cap)[:, None])
    pen = penalty[rows] + torch.where(in_cell, 0.0, BIG)
    return (2.0 * ab if euclidean else ab) - pen[:, None, :]


def select_exact(scores, start_c, k_pair):
    """Top k_pair per row, by value descending then slot ascending (the
    Pallas kernel's "first maximal column per pass" order) ->
    [B, P, 2*k_pair] int32 sortable keys ++ addresses; -inf / -1 dead."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k_pair], idx[..., :k_pair]
    alive = vals > -BIG / 2
    keys = sortable_i32(torch.where(alive, vals, -torch.inf))
    addr = torch.where(alive, start_c.long()[:, None, None] + idx, -1)
    return torch.cat([keys, addr.int()], dim=-1)


def select_pack32(scores, k_pair, slot_mask):
    """pack32: key = (sortable(score) & ~slot_mask) | slot, one winner per
    strided group (group g holds slots g, g+G, ...), then the k_pair largest
    winners descending -> [B, P, k_pair] int32. Keys are unique per row."""
    b, p, s = scores.shape
    g = n_groups(s, k_pair)
    slot = torch.arange(s, dtype=torch.int32, device=scores.device)
    packed = (sortable_i32(scores) & ~slot_mask) | slot
    best = packed.view(b, p, s // g, g).amax(dim=2)
    return torch.topk(best, k_pair, dim=-1).values


def select_blocks(select, qtable, probers, start_c, off, cap, penalty,
                  decoded, *, s_eff, euclidean, width):
    """select(block_scores(...), start_c) over chunks of blocks, each chunk
    holding at most _CHUNK_SCORES f32 scores -> int32 [B, p_tile, width]."""
    b, p = probers.shape
    step = max(1, _CHUNK_SCORES // max(p * s_eff, 1))
    outs = []
    for i in range(0, b, step):
        sl = slice(i, i + step)
        sc = block_scores(qtable, probers[sl], start_c[sl], off[sl], cap[sl],
                          penalty, decoded, s_eff=s_eff, euclidean=euclidean)
        outs.append(select(sc, start_c[sl]))
    if not outs:
        return torch.empty((0, p, width), dtype=torch.int32,
                           device=decoded.device)
    return torch.cat(outs)


def block_scan_ref(qtable, probers, start_c, off, cap, penalty, decoded, *,
                   s_eff, k_pair, euclidean, pack32, slot_mask):
    """Plain PyTorch version of the kernel."""
    if pack32:
        def select(sc, _):
            return select_pack32(sc, k_pair, slot_mask)
    else:
        def select(sc, st):
            return select_exact(sc, st, k_pair)
    return select_blocks(select, qtable, probers, start_c, off, cap, penalty,
                         decoded, s_eff=s_eff, euclidean=euclidean,
                         width=k_pair if pack32 else 2 * k_pair)


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


def _check(qtable, probers, start_c, off, cap, penalty, decoded, s_eff,
           k_pair, pack32, slot_mask):
    dev = decoded.device
    if decoded.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"decoded must be bf16 or f32, got {decoded.dtype}")
    if qtable.dtype != decoded.dtype:
        raise TypeError(
            f"qtable dtype {qtable.dtype} != decoded dtype {decoded.dtype}")
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


def _cta_probers(lib, p_tile, d, pack32, groups, is_bf16):
    """Probers per CTA: the most (of 128/64/32) whose shared memory fits."""
    for pt in (128, 64, 32):
        if p_tile % pt == 0 and lib.torchpq_block_scan_smem(
                pt, d, int(pack32), groups, is_bf16) <= _SMEM_LIMIT:
            return pt
    raise ValueError(
        f"block scan: no CTA shape fits shared memory at d={d}, "
        f"p_tile={p_tile}, groups={groups}")


def block_scan(qtable, probers, start_c, off, cap, penalty, decoded, *,
               s_eff, k_pair, euclidean, pack32, slot_mask):
    """Run the block scan.

    qtable [nq, d] (decoded's dtype), probers [B, p_tile] int32 query rows
    (-1 pads), start_c / off / cap [B] int32 (window start, the cell's offset
    in the window, its capacity), penalty [capacity] f32 (norm-or-BIG),
    decoded [capacity, d] bf16/f32. Returns int32 [B, p_tile, k_pair]
    (pack32) or [B, p_tile, 2*k_pair] (exact)."""
    _check(qtable, probers, start_c, off, cap, penalty, decoded, s_eff,
           k_pair, pack32, slot_mask)
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=euclidean,
              pack32=pack32, slot_mask=slot_mask)
    if decoded.device.type == "cpu":
        return block_scan_ref(qtable, probers, start_c, off, cap, penalty,
                              decoded, **kw)
    if decoded.device.type != "cuda":
        raise ValueError(f"block_scan runs on cpu or cuda, not "
                         f"{decoded.device}")
    from .. import _build
    lib = _build.library()
    b, p_tile = probers.shape
    d = decoded.shape[1]
    groups = n_groups(s_eff, k_pair) if pack32 else 0
    out = torch.empty((b, p_tile, k_pair if pack32 else 2 * k_pair),
                      dtype=torch.int32, device=decoded.device)
    if b == 0:
        return out
    if d % 4:
        raise ValueError(f"block scan kernel needs d % 4 == 0, got d={d}")
    is_bf16 = int(decoded.dtype == torch.bfloat16)
    pt = _cta_probers(lib, p_tile, d, pack32, groups, is_bf16)
    with torch.cuda.device(decoded.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.torchpq_block_scan(
            qtable.data_ptr(), probers.data_ptr(), start_c.data_ptr(),
            off.data_ptr(), cap.data_ptr(), penalty.data_ptr(),
            decoded.data_ptr(), out.data_ptr(), b, p_tile, d, s_eff, k_pair,
            int(euclidean), int(pack32), slot_mask, groups, is_bf16, pt,
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"block_scan kernel launch failed: CUDA error {rc}")
    launches["pack32" if pack32 else "exact"] += 1
    return out
