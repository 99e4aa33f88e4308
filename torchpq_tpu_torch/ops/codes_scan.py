"""IVF block scan over PQ codes: decode each block's window of uint8 codes
against the codebook, score it and keep each prober's top k_pair.

Replaces the TPU kernel
torchpq_tpu/ops/pallas_codes_scan.py:scan_blocks_pallas_codes, the probed
scan of the code-domain tier (scan_cache_dtype="none": the index keeps only
its codes and norms). The kernel is `csrc/codes_scan.cu`, built by
`_build.py` and bound through a plain C entry point.

What it computes, for block b, prober p and window column c < s_eff that
holds slot j:
    y_j   = concat_i bf16(codebook)[i, codes[start_c[b] + j, i], :]
    score = c * <bf16(q[probers[b, p]]), y_j> - pen[b, j]    (f32 sum)
    pen   = penalty[start_c[b] + j] + (off[b] <= j < off[b] + cap[b] ? 0 : BIG)
with c = 2 for euclidean and 1 otherwise. Codes are the packed
[cap/g, g*m] storage; the TPU kernel scores per in-row offset q and
concatenates, so column c = q * (s_eff/g) + r holds slot r*g + q. The
selects are the block scan's (`select_exact` / `select_pack32`) over the
columns in that order: exact ties go to the first column, and pack32 groups
columns {j, j+G, ...}. So pack32 results may differ from the decoded-cache
scan's where g > 1, while the scores themselves equal the block scan's over
a bf16 decoded cache.

What bounds it on an H100: the same f32 FMA issue as the block scan (every
decoded element feeds p_tile FMAs); the window costs m bytes per slot of
HBM instead of 2d. The kernel stages the bf16 codebook in shared memory.

`codes_scan` takes the plain version `codes_scan_ref` only for tensors on
the CPU. For CUDA tensors it launches the kernel or raises.
"""

import ctypes

import torch

from .. import util
from .block_scan import (BIG, n_groups, random_inputs, select_chunks,
                         select_exact, select_pack32, window_scores,
                         _SMEM_LIMIT)

# The JAX package's bound on the resident [m*256, d_pad] bf16 decode matrix
# (pallas_codes_scan.py:PALLAS_BDIAG_VMEM_BYTES). It is a TPU VMEM budget,
# but it decides numerics: inside it the JAX package decodes then scores,
# outside it scores with a bf16 LUT. The port keeps it as that dividing
# line so both packages take the same numerics at every shape.
CODEBOOK_BOUND_BYTES = 9 * 1024 * 1024

# kernel launches per select mode, counted by `codes_scan` where it launches
launches = {"exact": 0, "pack32": 0}


def codes_kernel_static_gate(m, g, d, distance):
    """Shape part of the codes-kernel gate, shared by the scan dispatch
    (ops/onehot_adc.py) and the index's planner, as in the JAX package
    (pallas_codes_scan.py:codes_kernel_static_gate): not manhattan, packed
    full rows (g * m == 128), and the decode matrix within its bound. The
    JAX gate's d_pad % 128 term is a Mosaic tiling term that its interpret
    mode waives; it is dropped here, so narrow shapes (d=32) take the
    kernel's semantics in both packages' CPU runs."""
    d_pad = util.round_up(d, 128) if d > 128 else d
    return (distance != "manhattan" and g * m == 128
            and m * 256 * d_pad * 2 <= CODEBOOK_BOUND_BYTES)


def decode_codes(codes, codebook):
    """codes [..., m] uint8, codebook [m, nc, dsub] -> [..., m*dsub] rows in
    the codebook's dtype (a gather: the one-hot @ block-diagonal product of
    the JAX package selects the same values exactly)."""
    m = codebook.shape[0]
    sub = torch.arange(m, device=codebook.device)
    rows = codebook[sub, codes.long()]                     # [..., m, dsub]
    return rows.reshape(*codes.shape[:-1], -1)


def column_slots(s_eff, g, device):
    """In-window slot of each window column: column q*(s_eff/g) + r holds
    slot r*g + q -> int32 [s_eff]."""
    c = torch.arange(s_eff, dtype=torch.int32, device=device)
    s_rows = s_eff // g
    return (c % s_rows) * g + c // s_rows


def codes_block_scores(qtable, probers, start_c, off, cap, penalty, codes,
                       codebook, *, s_eff, euclidean):
    """Plain per-block scores [B, P, s_eff] f32 in column order: bf16 rows
    decoded from the codes (the block scan's scores over the same rows)."""
    m = codebook.shape[0]
    flat = codes.reshape(-1, m)
    slot = column_slots(s_eff, codes.shape[1] // m, codes.device).long()
    return window_scores(qtable, probers, start_c, off, cap, penalty,
                         lambda rows: decode_codes(flat[rows], codebook),
                         slot, euclidean=euclidean)


def codes_scan_ref(qtable, probers, start_c, off, cap, penalty, codes,
                   codebook, *, s_eff, k_pair, euclidean, pack32, slot_mask):
    """Plain PyTorch version of the kernel."""
    g = codes.shape[1] // codebook.shape[0]
    slot = column_slots(s_eff, g, codes.device)
    if pack32:
        def select(sc, _):
            return select_pack32(sc, k_pair, slot_mask, slot=slot)
    else:
        def select(sc, st):
            return select_exact(sc, st, k_pair, slot=slot.long())

    def scores(sl):
        return codes_block_scores(qtable, probers[sl], start_c[sl], off[sl],
                                  cap[sl], penalty, codes, codebook,
                                  s_eff=s_eff, euclidean=euclidean)
    return select_chunks(scores, select, probers, start_c, s_eff=s_eff,
                         width=k_pair if pack32 else 2 * k_pair)


def random_codes_inputs(device, *, s_eff, n_blocks, nq, m, dsub, cap_total,
                        seed=0):
    """Seeded codes-scan inputs in the layout the code-domain cell-major
    scan gives (the block scan's random_inputs for the blocks; random codes
    in the packed [cap/g, 128] layout and a bf16 codebook; norms of the
    decoded rows as penalty, BIG at 5% empty slots)."""
    d = m * dsub
    qtable, probers, start_c, off, cap, penalty, _ = random_inputs(
        device, s_eff=s_eff, n_blocks=n_blocks, nq=nq, d=d,
        cap_total=cap_total, seed=seed)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    codes = torch.randint(0, 256, (cap_total // (128 // m), 128),
                          generator=g, device=device, dtype=torch.uint8)
    codebook = torch.randn(m, 256, dsub, generator=g, device=device) \
        .to(torch.bfloat16)
    norms = decode_codes(codes.view(-1, m), codebook).float().pow(2).sum(-1)
    penalty = torch.where(penalty >= BIG, BIG, norms).contiguous()
    return [qtable, probers, start_c, off, cap, penalty, codes, codebook]


def _check(qtable, probers, start_c, off, cap, penalty, codes, codebook,
           s_eff, k_pair, pack32, slot_mask):
    dev = codes.device
    if codes.dtype != torch.uint8 or codes.ndim != 2:
        raise TypeError("codes must be uint8 [cap/g, g*m]")
    if codebook.dtype != torch.bfloat16 or codebook.ndim != 3:
        raise TypeError("codebook must be bf16 [m, 256, dsub]")
    m, nc, dsub = codebook.shape
    if nc != 256 or codes.shape[1] % m:
        raise ValueError(f"codebook {tuple(codebook.shape)} does not fit "
                         f"codes rows of {codes.shape[1]} bytes")
    if qtable.dtype != torch.bfloat16 or qtable.ndim != 2 \
            or qtable.shape[1] != m * dsub:
        raise TypeError(f"qtable must be bf16 [nq, {m * dsub}]")
    if probers.ndim != 2 or probers.dtype != torch.int32:
        raise TypeError("probers must be int32 [B, p_tile]")
    b = probers.shape[0]
    for name, t in (("start_c", start_c), ("off", off), ("cap", cap)):
        if t.dtype != torch.int32 or tuple(t.shape) != (b,):
            raise TypeError(f"{name} must be int32 [{b}]")
    cap_total = codes.numel() // m
    if penalty.dtype != torch.float32 \
            or tuple(penalty.shape) != (cap_total,):
        raise TypeError(f"penalty must be float32 [{cap_total}]")
    for name, t in (("qtable", qtable), ("probers", probers),
                    ("start_c", start_c), ("off", off), ("cap", cap),
                    ("penalty", penalty), ("codes", codes),
                    ("codebook", codebook)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, codes on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    g = codes.shape[1] // m
    if not 1 <= k_pair <= min(64, s_eff) or s_eff > cap_total or s_eff % g:
        raise ValueError(f"need 1 <= k_pair={k_pair} <= min(64, s_eff="
                         f"{s_eff}), s_eff <= capacity, g={g} | s_eff")
    if pack32 and slot_mask != util.next_pow2(s_eff) - 1:
        raise ValueError("slot_mask must be next_pow2(s_eff) - 1")


def _cta_probers(lib, p_tile, d, pack32, groups):
    """Probers per CTA: the most (of 128/64/32) whose shared memory fits."""
    for pt in (128, 64, 32):
        if p_tile % pt == 0 and lib.torchpq_codes_scan_smem(
                pt, d, int(pack32), groups) <= _SMEM_LIMIT:
            return pt
    raise ValueError(
        f"codes scan: no CTA shape fits shared memory at d={d}, "
        f"p_tile={p_tile}, groups={groups}")


def codes_scan(qtable, probers, start_c, off, cap, penalty, codes, codebook,
               *, s_eff, k_pair, euclidean, pack32, slot_mask):
    """Run the codes scan.

    qtable [nq, d] bf16 query rows, probers [B, p_tile] int32 (-1 pads),
    start_c / off / cap [B] int32 (16-aligned window start, the cell's
    offset in the window, its capacity), penalty [capacity] f32
    (norm-or-BIG), codes [cap/g, g*m] uint8 packed storage, codebook
    [m, 256, dsub] bf16 with d = m*dsub. Returns int32 [B, p_tile, k_pair]
    (pack32) or [B, p_tile, 2*k_pair] (exact)."""
    _check(qtable, probers, start_c, off, cap, penalty, codes, codebook,
           s_eff, k_pair, pack32, slot_mask)
    kw = dict(s_eff=s_eff, k_pair=k_pair, euclidean=euclidean,
              pack32=pack32, slot_mask=slot_mask)
    if codes.device.type == "cpu":
        return codes_scan_ref(qtable, probers, start_c, off, cap, penalty,
                              codes, codebook, **kw)
    if codes.device.type != "cuda":
        raise ValueError(f"codes_scan runs on cpu or cuda, not "
                         f"{codes.device}")
    from .. import _build
    lib = _build.library()
    b, p_tile = probers.shape
    m, _, dsub = codebook.shape
    d = m * dsub
    groups = n_groups(s_eff, k_pair) if pack32 else 0
    out = torch.empty((b, p_tile, k_pair if pack32 else 2 * k_pair),
                      dtype=torch.int32, device=codes.device)
    if b == 0:
        return out
    if d % 4 or m % 8 or m > 128 or codebook.data_ptr() % 16 \
            or codes.data_ptr() % 8:
        raise ValueError(f"codes scan kernel needs d % 4 == 0 (d={d}), "
                         f"m % 8 == 0 and m <= 128 (m={m}), a 16-byte "
                         "aligned codebook and 8-byte aligned codes")
    pt = _cta_probers(lib, p_tile, d, pack32, groups)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.torchpq_codes_scan(
            qtable.data_ptr(), probers.data_ptr(), start_c.data_ptr(),
            off.data_ptr(), cap.data_ptr(), penalty.data_ptr(),
            codes.data_ptr(), codebook.data_ptr(), out.data_ptr(), b, p_tile,
            m, dsub, codes.shape[1] // m, s_eff, k_pair, int(euclidean),
            int(pack32), slot_mask, groups, pt, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"codes_scan kernel launch failed: CUDA error {rc}")
    launches["pack32" if pack32 else "exact"] += 1
    return out
