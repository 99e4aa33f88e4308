"""Code-domain IVFPQ scans: the index keeps only its uint8 PQ codes (m B per
slot) and norms (4 B), no decoded cache (counterpart of
torchpq_tpu/ops/onehot_adc.py).

* `scan_cell_major_codes` is the probed scan. It packs (query, cell) pairs
  into blocks and merges them like adc.scan_cell_major; only the block
  scoring differs. Inside the codes-kernel gate (packed storage, the
  decode bound; ops/codes_scan.py) the blocks run the codes scan, which
  decodes each window against the bf16 codebook and scores it (on the card
  the kernel `codes_scan.pick_route` names, the tensor-core one at the
  index's shapes, which writes -1 pad rows dead; on the CPU its plain
  version, which scores them as the JAX kernel does; the merge reads only
  live rows). Outside it the JAX package scores with a bf16 LUT summed in
  f32; that path is computed in XLA there, not Pallas, so here it is plain
  torch, and it is the JAX package's own routing, not a fallback.
* `flat_decode_scan` is the exhaustive sweep: each chunk of codes is
  decoded to bf16 rows once and scored against every (bf16) query with an
  f32 product.
* `flat_onehot_scan` is the exhaustive LUT sweep, which manhattan takes:
  L1 decomposes per subvector (an exact code-domain L1), but not through a
  product. No kernel takes manhattan; its probed plans run the LUT path.

Each returns (values [nq, k] f32, addresses [nq, k] int32, -1 padding).
`precision` (None: the search precision) is the LUT's and the sweep's
products' (util.matmul); the codes kernel, like the Pallas one, takes none.
`block_chunk`, `chunk`, `sub` and `interpret` (the JAX package's tiling and
interpret mode) are accepted and ignored.
"""

import torch

from .. import config
from .. import util
from ..metric import canonical_distance
from .adc import LAST_GATE, _block_select, _merge_pairs, _pack_pairs, \
    gate_kernel, subvector_products
from .block_scan import BIG, select_chunks
from .codes_scan import codes_kernel_static_gate, codes_scan, decode_codes
from .flat_adc import final_merge, flat_sweep


def build_scan_lut(query, codebook, distance, precision=None):
    """Per-subvector partial-similarity table with sum semantics: summing
    lut[q, i, code_i] over i gives <q, y> (the euclidean caller applies
    2<q,y> - |y|^2 - |q|^2), or -|q - y|_1 exactly for manhattan. query
    [nq, d], codebook [m, nc, dsub] -> [nq, m, nc] f32, the products at
    `precision`."""
    m, _, dsub = codebook.shape
    q = query.float().reshape(query.shape[0], m, dsub)
    if canonical_distance(distance) == "manhattan":
        return -torch.sum(torch.abs(q[:, :, None, :]
                                    - codebook.float()[None]), dim=-1)
    return subvector_products(q, codebook.float(), precision)


def _packing(codes, m):
    """(g, m, cap_total) of a codes array: [cap, m] when m is None or equals
    its width, else the packed [cap/g, g*m] layout."""
    if m is None or m == codes.shape[1]:
        return 1, codes.shape[1], codes.shape[0]
    g = codes.shape[1] // m
    assert codes.shape[1] == g * m and 16 % g == 0, (codes.shape, m)
    return g, m, codes.shape[0] * g


def _lut_block_scores(lut_flat, probers, start_c, off, cap, penalty, codes,
                      *, s_eff, euclidean):
    """The JAX package's outside-gate block scores: bf16 LUT entries
    [nq, m*nc] looked up by each slot's codes and summed in f32, in slot
    order -> [B, P, s_eff]."""
    m = codes.shape[1]
    nc = lut_flat.shape[1] // m
    b, p = probers.shape
    slot = torch.arange(s_eff, device=codes.device)
    rows = start_c.long()[:, None] + slot[None, :]
    col = codes[rows].long() + torch.arange(m, device=codes.device) * nc
    lut_t = lut_flat[probers.clamp(min=0).long()]            # [B, P, m*nc]
    picked = torch.gather(lut_t, 2,
                          col.reshape(b, 1, s_eff * m).expand(b, p, -1))
    sums = picked.reshape(b, p, s_eff, m).float().sum(-1)
    in_cell = (slot[None, :] >= off[:, None]) \
        & (slot[None, :] < (off + cap)[:, None])
    pen = penalty[rows] + torch.where(in_cell, 0.0, BIG)
    return (2.0 * sums if euclidean else sums) - pen[:, None, :]


def scan_cell_major_codes(query, cells, probe_mask, codes, norms, is_empty,
                          cell_start, cell_capacity, codebook, *, k,
                          distance, s_max, n_cells, p_tile=128, block_chunk=8,
                          approx=False, precision=None, k_pair=None, m=None,
                          impl="auto", interpret=False):
    """Cell-major scan over raw uint8 codes (onehot_adc.py:
    scan_cell_major_codes). codes is [cap, m], or the packed [cap/g, g*m]
    storage with `m` given; codebook [m, nc, dsub]. k_pair: the per-pair
    width (None: the code scan's own rule; explicit: as given), clipped to
    k, s_max and the capacity. impl routes as in adc.scan_cell_major: "xla"
    and "pallas_flat" take the LUT path, "pallas" raises where the codes
    kernel's gate fails."""
    distance = canonical_distance(distance)
    precision = config.resolve_precision(precision)
    query = query.float()
    nq, n_probe = cells.shape
    g, m, cap_total = _packing(codes, m)
    # the code scan's own k_pair rule (:125-136), not adc.scan_cell_major's
    if k_pair is None:
        if approx and k > 16:
            k_pair = min(k, max(16, 4 * util.cdiv(k, n_probe)),
                         max(64, util.cdiv(k, n_probe)))
        else:
            k_pair = k
    k_pair = min(k_pair, k, s_max, cap_total)
    s_eff = min(s_max, cap_total)
    assert s_eff % g == 0, (s_eff, g)
    s_pow2 = util.next_pow2(s_eff)
    slot_mask = s_pow2 - 1
    euclidean = distance == "euclidean"
    d = m * codebook.shape[-1]
    # pack32 slot bits: the kernel path takes windows up to 8192 slots, the
    # LUT path keeps the decoded scan's 4096 (:158-163, :193-194)
    pack32 = approx and s_pow2 <= 8192
    use_kernel = gate_kernel(impl, (
        k_pair <= 64 and codes_kernel_static_gate(m, g, d, distance)
        and (not approx or (pack32 and (
            s_eff % 128 == 0 or (s_pow2 == s_eff and s_eff < 128))))),
        "scan_cell_major_codes")
    if not use_kernel:
        pack32 = approx and s_pow2 <= 4096

    pair_block, pair_slot, block_cell, probers, n_blocks = _pack_pairs(
        cells, probe_mask, n_cells=n_cells, p_tile=p_tile)
    start = cell_start[block_cell]
    cap_b = cell_capacity[block_cell].int()
    start_c = start.clamp(0, cap_total - s_eff)
    off = (start - start_c).int()
    start_c = start_c.int().contiguous()
    penalty = torch.where(is_empty, BIG,
                          norms.float() if euclidean else 0.0)
    penalty = penalty.float().contiguous()
    LAST_GATE.clear()
    LAST_GATE.update(impl="codes_scan" if use_kernel else "onehot",
                     k_pair=k_pair, s_eff=s_eff, pack32=pack32, m=m, g=g,
                     blocks=n_blocks, precision=precision)
    width = k_pair if pack32 else 2 * k_pair
    if use_kernel:
        combo = codes_scan(
            query.to(torch.bfloat16).contiguous(), probers, start_c, off,
            cap_b, penalty, codes.contiguous(),
            codebook.to(torch.bfloat16).contiguous(), s_eff=s_eff,
            k_pair=k_pair, euclidean=euclidean, pack32=pack32,
            slot_mask=slot_mask)
    else:
        # The JAX package's row-gather window fetch (gather_windows,
        # :166, :266-275) is a TPU layout workaround for huge codes arrays
        # with identical results; windows here are plain index gathers.
        lut_flat = build_scan_lut(query, codebook, distance, precision) \
            .reshape(nq, -1).to(torch.bfloat16)
        flat = codes.reshape(cap_total, m)

        def scores(sl):
            return _lut_block_scores(lut_flat, probers[sl], start_c[sl],
                                     off[sl], cap_b[sl], penalty, flat,
                                     s_eff=s_eff, euclidean=euclidean)

        def select(sc, st):
            return _block_select(sc, st, k_pair=k_pair, pack32=pack32,
                                 slot_mask=slot_mask)
        # temporaries per score: the looked-up entries and each block's
        # gathered LUT rows
        cost = m * (2 + lut_flat.shape[1] // max(m * s_eff, 1))
        combo = select_chunks(scores, select, probers, start_c, s_eff=s_eff,
                              width=width, cost=cost)
    return _merge_pairs(
        combo, query, pair_block, pair_slot, start_c, n_blocks=n_blocks,
        p_tile=p_tile, k=k, k_pair=k_pair, nq=nq, n_probe=n_probe,
        pack32=pack32, slot_mask=slot_mask, distance=distance)


def flat_onehot_scan(query, codes, penalty, codebook, *, k, distance,
                     chunk=16384, approx=True, precision=None, m=None,
                     max_elems=1 << 26):
    """Exhaustive code-domain sweep over the bf16 LUT (onehot_adc.py:324):
    per chunk of slots, each slot's LUT entries looked up by its codes and
    summed in f32 (the JAX package's one-hot [nq, m*nc] product sums the
    same bf16 values), minus the penalty; then the chunk's top k and the
    exact final merge. `max_elems` bounds the [nq, chunk, m] lookup."""
    distance = canonical_distance(distance)
    query = query.float()
    nq = query.shape[0]
    _, m, cap = _packing(codes, m)
    flat = codes.reshape(cap, m)
    lut = build_scan_lut(query, codebook, distance, precision)
    nc = lut.shape[-1]
    lut_flat = lut.reshape(nq, m * nc).to(torch.bfloat16)
    off = torch.arange(m, device=codes.device) * nc
    step = min(cap, max(1, max_elems // max(nq * m, 1)))
    k_c = min(k, step)
    vals, idx = [], []
    for c0 in range(0, cap, step):
        col = (flat[c0:c0 + step].long() + off).reshape(-1)
        sums = lut_flat[:, col].reshape(nq, -1, m).float().sum(-1)
        s = (2.0 * sums if distance == "euclidean" else sums) \
            - penalty[c0:c0 + step][None, :]
        v, i = torch.topk(s, min(k_c, s.shape[1]), dim=-1)
        vals.append(v)
        idx.append(i + c0)
    return final_merge(torch.cat(vals, dim=1), torch.cat(idx, dim=1), query,
                       k=k, distance=distance)


def flat_decode_scan(query, codes, penalty, codebook, *, k, distance,
                     chunk=65536, sub=8192, approx=True, precision=None,
                     m=None, max_elems=1 << 28):
    """Exhaustive code-domain sweep: per chunk of slots, decode the codes to
    bf16 rows (a gather from the bf16-rounded codebook, bit-identical to the
    JAX package's one-hot @ blockdiag_codebook product, which the port
    therefore does not need), score them against the bf16-rounded query
    (exact products, f32 sums, at `precision`), keep the chunk's top k;
    then the exact final merge. penalty [cap] f32 =
    norms-or-0 with BIG at empty slots. Manhattan does not factor through
    a product: it takes flat_onehot_scan."""
    distance = canonical_distance(distance)
    assert distance != "manhattan", "manhattan: use flat_onehot_scan"
    query = query.float()
    _, m, cap = _packing(codes, m)
    flat = codes.reshape(cap, m)
    cb = codebook.to(torch.bfloat16)
    # the JAX sweep rounds the query to bf16 (onehot_adc.py:450)
    q_mm = query.to(torch.bfloat16)
    vals, idx = flat_sweep(
        q_mm, lambda c0, c1: decode_codes(flat[c0:c1], cb), cap,
        penalty, k=k, factor=2.0 if distance == "euclidean" else 1.0,
        max_elems=max_elems, precision=precision)
    return final_merge(vals, idx, query, k=k, distance=distance)

