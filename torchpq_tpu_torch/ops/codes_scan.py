"""IVF block scan over PQ codes: decode each block's window of uint8 codes
against the codebook, score it and keep each prober's top k_pair.

Replaces the TPU kernel
torchpq_tpu/ops/pallas_codes_scan.py:scan_blocks_pallas_codes, the probed
scan of the code-domain tier (scan_cache_dtype="none": the index keeps only
its codes and norms). Three kernels serve it, chosen before launch by
`pick_route`, each built by `_build.py`, bound through a plain C entry point
and counted under its own key of `launches`:
  - "tc_wgn_exact" / "tc_wgn_pack32", the codes instances of
    `csrc/block_scan_wg.cu`'s narrow body (wgmma over a ring of decoded
    tiles that its producer warpgroup fills from the codes and the staged
    codebook; two consumer warpgroups score and select): rows of d <= 128,
    blocks of at most 128 probers, exact k_pair <= 16 and pack32 k_pair
    <= 64 (up to 32 extracted pass by pass, above by the deep select,
    `csrc/deep_select.cuh`) where their shared memory fits
    (`wg_smem_bytes`);
  - "exact" / "pack32", `csrc/codes_scan.cu`: the rest, on the CUDA cores
    (f32 FMAs).
The tensor-core kernel scores only the live 16-prober tiles of a block
(bf16 products, f32 sums).

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
scan's where g > 1. The products are exact in f32 (bf16 operands); the
kernels and the plain version sum them in different orders, so scores agree
to the last bits, and bit for bit where every sum is exact
(`integer_codes_inputs`).

Pad rows (prober -1): the plain version and the CUDA-core kernel score them
with query 0, as the JAX kernel does; the tensor-core kernel writes them
dead (exact: sortable(-inf) keys, -1 addresses; pack32: INT_MIN). The merge
never reads them.

`codes_scan` takes the plain version `codes_scan_ref` only for tensors on
the CPU. For CUDA tensors it launches the kernel of its route or raises.
"""

import ctypes

import numpy as np
import torch

from .. import util
from .block_scan import (BIG, n_groups, random_inputs, resident_ctas,
                         select_chunks, select_exact, select_pack32,
                         window_scores, _blocks_ok, _wg_list_bytes,
                         _wg_select_bytes, _DS_SHALLOW_K, _SMEM_LIMIT,
                         _TC_MAX_PT, _WG_BOX_ROWS, _WG_NARROW_ROW,
                         _WG_QBUF_BYTES, _WG_STAGE_BYTES, _WG_SW_ATOM)

# The JAX package's bound on the resident [m*256, d_pad] bf16 decode matrix
# (pallas_codes_scan.py:PALLAS_BDIAG_VMEM_BYTES). It is a TPU VMEM budget,
# but it decides numerics: inside it the JAX package decodes then scores,
# outside it scores with a bf16 LUT. The port keeps it as that dividing
# line so both packages take the same numerics at every shape.
CODEBOOK_BOUND_BYTES = 9 * 1024 * 1024

# The codes instances of csrc/block_scan_wg.cu (csrc/wg_layout.cuh): ring
# stages by select (exact; pack32 k_pair <= 16; pack32 up to CODES_PASS_K,
# pass by pass; deeper, the deep select), one query buffer, the deepest
# pack32 k_pair extracted pass by pass, and a pass's code chunks of 8 bytes
# a column (PASS_CHUNKS: m = 128 in two).
_WG_CRING_EXACT, _WG_CRING_PACK_16, _WG_CRING_PACK, _WG_CRING_DEEP = \
    3, 5, 4, 3
_WG_CQB = 1
_WG_CODES_PASS_K = 32
_WG_PASS_CHUNKS = 8

# kernel launches per route and select, counted by `codes_scan` where it
# launches ("tc_wgn_*": the wgmma codes instances; the others: the
# CUDA-core kernel)
launches = {"exact": 0, "pack32": 0, "tc_wgn_exact": 0, "tc_wgn_pack32": 0}


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


def integer_codes_inputs(device, *, s_eff, n_blocks, nq, m, dsub, cap_total,
                         seed=0):
    """Seeded integer-valued codes-scan inputs (numpy draws): codebook
    entries and query values in {-3..3}, the decoded rows' squared norms
    (integers) as penalty with BIG at 5% of slots, and runs of equal codes
    inside one window and far apart across windows, so exact ties occur.
    Blocks in `random_inputs`' layout: each block's live probers first,
    then -1 pads; 16-aligned windows; the cell at a 16-aligned offset.
    Every score is an integer the f32 sums hold exactly in any order, so
    the kernels and the plain version agree bit for bit, ties included."""
    rng = np.random.default_rng(seed)
    d = m * dsub
    qtable = rng.integers(-3, 4, (nq, d)).astype(np.float32)
    codebook = rng.integers(-3, 4, (m, 256, dsub)).astype(np.float32)
    codes = rng.integers(0, 256, (cap_total, m)).astype(np.uint8)
    run = slice(cap_total // 10, cap_total // 10 + min(200, s_eff // 2))
    codes[run] = codes[run.start]            # a run of equal rows
    codes[cap_total // 2::97] = codes[1]     # equal rows far apart
    sub = np.arange(m)[None, :]
    norms = (codebook[sub, codes] ** 2).sum((1, 2)).astype(np.float32)
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
        off.astype(np.int32), cap.astype(np.int32), penalty,
        codes.reshape(-1, 128), codebook)]
    t[0], t[7] = t[0].to(torch.bfloat16), t[7].to(torch.bfloat16)
    return [x.contiguous() for x in t]


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


def wg_ring(pack32, k_pair):
    """Ring stages of the wgmma codes instance that serves this select
    (csrc/wg_layout.cuh:codes_ring_of)."""
    if not pack32:
        return _WG_CRING_EXACT
    if k_pair <= _DS_SHALLOW_K:
        return _WG_CRING_PACK_16
    return _WG_CRING_PACK if k_pair <= _WG_CODES_PASS_K else _WG_CRING_DEEP


def wg_smem_bytes(*, m, dsub, pack32, k_pair):
    """Dynamic shared memory of the wgmma codes instance that serves these
    shapes: csrc/wg_layout.cuh:codes_smem_bytes, term for term (the
    library's torchpq_codes_scan_wg_smem reports the same; a card test
    holds them equal). Alignment slack, one query buffer [2][128][128 B]
    and its two barriers, the ring's stages (a decoded tile's k half, the
    columns' penalties, pack32 their slots, two barriers; wg_ring), the
    codebook [m][256][dsub] bf16, the raw slot [128][8 * chunks a pass]
    (m <= 64: all of a column's codes, m = 128: half), prober rows and
    tile flags, the select's arrays (block_scan._wg_list_bytes; above
    pack32 k_pair _WG_CODES_PASS_K the deep select's,
    block_scan._wg_select_bytes)."""
    chunks = min(m // 8, _WG_PASS_CHUNKS)
    stage = _WG_STAGE_BYTES + 4 * _WG_BOX_ROWS \
        + (4 * _WG_BOX_ROWS if pack32 else 0) + 16
    select = (_wg_select_bytes(pack32, k_pair)
              if pack32 and k_pair > _WG_CODES_PASS_K
              else _wg_list_bytes(pack32, k_pair))
    return (_WG_SW_ATOM + _WG_CQB * (_WG_QBUF_BYTES + 16)
            + wg_ring(pack32, k_pair) * stage + 512 * m * dsub
            + _WG_BOX_ROWS * 8 * chunks + 4 * _TC_MAX_PT + 4 * 8 + select)


def _cta_probers(lib, p_tile, d, pack32, groups):
    """Probers per CTA: the most (of 128/64/32) whose shared memory fits."""
    for pt in (128, 64, 32):
        if p_tile % pt == 0 and lib.torchpq_codes_scan_smem(
                pt, d, int(pack32), groups) <= _SMEM_LIMIT:
            return pt
    raise ValueError(
        f"codes scan: no CTA shape fits shared memory at d={d}, "
        f"p_tile={p_tile}, groups={groups}")


def pick_route(*, m, dsub, p_tile, s_eff, k_pair, pack32):
    """The kernel that serves a scan of these shapes, which is also its key
    in `launches`:
      - "tc_wgn_exact" / "tc_wgn_pack32" (`csrc/block_scan_wg.cu`'s codes
        instances, wgmma): m a power of two from 8 to 128 (the packed
        storage's, g*m = 128), rows of d = m*dsub <= 128, d % 8 == 0, the
        blocks and selects of `block_scan._blocks_ok` (exact k_pair <= 16,
        pack32 k_pair <= 64), where the instance's shared memory
        (`wg_smem_bytes`) fits, as it does at every such shape;
      - "exact" / "pack32" (`csrc/codes_scan.cu`, CUDA cores): the rest
        (exact k_pair > 16, rows wider than 128, other blocks or groups,
        a shared memory above the limit)."""
    mode = "pack32" if pack32 else "exact"
    d = m * dsub
    if (m & (m - 1) == 0 and 8 <= m <= 128 and d % 8 == 0
            and 2 * d <= _WG_NARROW_ROW
            and _blocks_ok(p_tile, s_eff, k_pair, pack32)
            and wg_smem_bytes(m=m, dsub=dsub, pack32=pack32,
                              k_pair=k_pair) <= _SMEM_LIMIT):
        return "tc_wgn_" + mode
    return mode


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
    m, _, dsub = codebook.shape
    route = pick_route(m=m, dsub=dsub, p_tile=probers.shape[1], s_eff=s_eff,
                       k_pair=k_pair, pack32=pack32)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        out = launch(_build.library(), stream, qtable, probers, start_c, off,
                     cap, penalty, codes, codebook, route=route, **kw)
    launches[route] += 1
    return out


def launch(lib, stream, qtable, probers, start_c, off, cap, penalty, codes,
           codebook, *, s_eff, k_pair, euclidean, pack32, slot_mask,
           route=None, n_ctas=None):
    """Launch the kernel of `route` (a key of `launches`; default
    pick_route's) of `lib` on `stream` with checked arguments. n_ctas: the
    tensor-core kernel's persistent grid (default: as many CTAs as the
    card's SMs hold at once, at most one per block). Raises if the route
    does not take the shapes or the launch fails."""
    b, p_tile = probers.shape
    m, _, dsub = codebook.shape
    d = m * dsub
    g = codes.shape[1] // m
    groups = n_groups(s_eff, k_pair) if pack32 else 0
    mode = "pack32" if pack32 else "exact"
    best = pick_route(m=m, dsub=dsub, p_tile=p_tile, s_eff=s_eff,
                      k_pair=k_pair, pack32=pack32)
    route = route or best
    if route not in (mode, "tc_wgn_" + mode):
        raise ValueError(f"route {route!r} does not serve the {mode} select")
    out = torch.empty((b, p_tile, k_pair if pack32 else 2 * k_pair),
                      dtype=torch.int32, device=codes.device)
    if b == 0:
        return out
    if m % 8 or m > 128 or codebook.data_ptr() % 16 or codes.data_ptr() % 8:
        raise ValueError(f"codes scan kernels need m % 8 == 0 and m <= 128 "
                         f"(m={m}), a 16-byte aligned codebook and 8-byte "
                         "aligned codes")
    args = (qtable.data_ptr(), probers.data_ptr(), start_c.data_ptr(),
            off.data_ptr(), cap.data_ptr(), penalty.data_ptr(),
            codes.data_ptr(), codebook.data_ptr(), out.data_ptr(), b, p_tile,
            m, dsub, g, s_eff, k_pair, int(euclidean), int(pack32), slot_mask,
            groups)
    if route.startswith("tc_"):
        if best != route:
            raise ValueError(
                f"the tensor-core codes scan ({route}) does not take d={d}, "
                f"p_tile={p_tile}, s_eff={s_eff}, k_pair={k_pair}, "
                f"pack32={pack32}")
        name = "torchpq_codes_scan_wg"
        if qtable.data_ptr() % 16:
            raise ValueError("the wgmma codes scan copies 16-byte pieces of "
                             "the query rows: qtable must be 16-byte aligned")
        if getattr(lib, name + "_smem")(m, dsub, int(pack32), k_pair) \
                > _SMEM_LIMIT:
            raise ValueError(f"{name}: shared memory exceeds the limit at "
                             f"m={m}, dsub={dsub}, k_pair={k_pair}")
        if n_ctas is None:
            n_ctas = resident_ctas(lib, name + "_occupancy", codes.device, m,
                                   dsub, int(pack32), k_pair)
        rc = getattr(lib, name)(*args, min(n_ctas, b),
                                ctypes.c_void_p(stream))
    else:
        if d % 4:
            raise ValueError(f"codes scan kernel needs d % 4 == 0 (d={d})")
        pt = _cta_probers(lib, p_tile, d, pack32, groups)
        rc = lib.torchpq_codes_scan(*args, pt, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{route} codes scan kernel launch failed: CUDA "
                           f"error {rc}")
    return out
