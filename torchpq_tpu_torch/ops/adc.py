"""ADC scoring and the IVF scans (counterpart of torchpq_tpu/ops/adc.py).

The decoded-cache identity of the JAX package holds here too: the ADC
score of a code is the similarity of the query with the PQ reconstruction,
so the index keeps a bf16 decoded cache plus f32 norms and scores
candidates with products against it. `build_adc_table` and
`adc_lookup_scores` are the LUT-gather oracle the tests hold it to.

Two scans over the IVF cells:

* `scan_query_major` gathers each query's probed windows and scores them
  (the small-batch plan).
* `scan_cell_major` inverts the probe lists: probed (query, cell) pairs are
  grouped by cell into blocks of up to p_tile probers, each block is scored
  against its cell's window by the block scan (ops/block_scan.py), and the
  per-pair partial top-ks are unsorted and merged per query.

Both return (values [nq, k] f32, addresses [nq, k] int32, -1 padding).
"""

import torch

from .. import util
from ..metric import canonical_distance
from .block_scan import (BIG, block_scan, select_blocks, select_exact,
                         sortable_i32, sortable_i32_to_f32)

# resolved plan of the most recent scan_cell_major call: {"impl", "k_pair",
# "s_eff", "pack32", "blocks"} — lets a run record which select served it
LAST_GATE = {}

_INT32_MIN = -(1 << 31)


def _key_neg_big(slot_mask):
    """The pack32 key of a dead entry: sortable(-BIG) with no slot bits."""
    return int(sortable_i32(torch.tensor([-BIG]))[0]) & ~slot_mask


def build_adc_table(query, codebook, distance):
    """Per-subvector similarity table: query [nq, d], codebook
    [m, 256, dsub] -> LUT [nq, m, 256] f32."""
    distance = canonical_distance(distance)
    m, _, dsub = codebook.shape
    q = query.float().reshape(query.shape[0], m, dsub)
    ab = torch.einsum("qmd,mcd->qmc", q, codebook.float())
    if distance in ("inner", "cosine"):
        return ab
    if distance == "euclidean":
        return (2.0 * ab - torch.sum(q * q, dim=-1)[:, :, None]
                - torch.sum(codebook * codebook, dim=-1)[None])
    raise NotImplementedError(
        "manhattan distance is not ported yet (ROADMAP A12)")


def adc_lookup_scores(lut, codes):
    """Gather-oracle ADC: score[q, j] = sum_i lut[q, i, codes[j, i]].
    lut [nq, m, 256] f32, codes [n, m] uint8 -> [nq, n] f32."""
    m = lut.shape[1]
    sub = torch.arange(m, device=lut.device)
    return lut[:, sub[None, :], codes.long()].sum(-1)


def scan_query_major(query, cells, probe_mask, decoded, norms, is_empty,
                     cell_start, cell_capacity, *, k, distance, s_max):
    """Gather-and-score each query's probed windows.

    query [nq, d] f32; cells / probe_mask [nq, n_probe] (distinct cells per
    row); decoded [cap, d]; norms [cap] f32; is_empty [cap] bool; s_max
    bounds every cell's capacity."""
    distance = canonical_distance(distance)
    query = util.pad_cols(query.float(), decoded.shape[-1])
    nq, n_probe = cells.shape
    slot = torch.arange(s_max, device=decoded.device)
    # queries per chunk: bounds the gathered [chunk, n_probe * s_max, d]
    # candidates to 2^26 elements
    q_chunk = max(1, (1 << 26) // max(n_probe * s_max * query.shape[1], 1))
    vals_out, addr_out = [], []
    for i in range(0, nq, q_chunk):
        q = query[i:i + q_chunk]
        qc = cells[i:i + q_chunk].long()
        start = cell_start.long()[qc]
        capc = cell_capacity.long()[qc]
        addr = start[:, :, None] + slot[None, None, :]
        valid = (slot[None, None, :] < capc[:, :, None]) \
            & probe_mask[i:i + q_chunk, :, None]
        flat = torch.where(valid, addr, 0).reshape(q.shape[0], -1)
        valid = valid.reshape(q.shape[0], -1) & ~is_empty[flat]
        cand = decoded[flat].float()                       # [qc, np*s, d]
        qv = q.to(decoded.dtype).float() if decoded.dtype == torch.bfloat16 \
            else q
        ab = torch.bmm(cand, qv[:, :, None])[:, :, 0]
        if distance == "euclidean":
            sc = 2.0 * ab - norms[flat] - torch.sum(q * q, -1)[:, None]
        else:
            sc = ab
        sc = torch.where(valid, sc, -torch.inf)
        kc = min(k, sc.shape[-1])
        v, idx = torch.topk(sc, kc, dim=-1)
        a = torch.gather(flat, 1, idx)
        vals_out.append(v)
        addr_out.append(torch.where(torch.isfinite(v), a, -1).int())
    vals, addrs = torch.cat(vals_out), torch.cat(addr_out)
    if vals.shape[-1] < k:
        pad = k - vals.shape[-1]
        vals = torch.nn.functional.pad(vals, (0, pad), value=-torch.inf)
        addrs = torch.nn.functional.pad(addrs, (0, pad), value=-1)
    return vals, addrs


def _pack_pairs(cells, probe_mask, *, n_cells, p_tile):
    """Group probed (query, cell) pairs by cell into blocks of up to p_tile
    probers of one cell. A pair's rank within its cell is the number of
    lower-numbered queries that probe the cell (a stable sort by cell),
    so the blocks are the JAX package's.

    Returns (pair_block, pair_slot, block_cell, probers, n_blocks):
    pair_block / pair_slot [n_pairs] in original pair order (masked pairs
    get block n_blocks), block_cell [n_blocks], probers [n_blocks, p_tile]
    int32 query rows (-1 pads)."""
    nq, n_probe = cells.shape
    dev = cells.device
    flat_cells = torch.where(probe_mask.reshape(-1), cells.reshape(-1).long(),
                             n_cells)
    flat_q = torch.arange(nq, device=dev).repeat_interleave(n_probe)
    order = torch.argsort(flat_cells, stable=True)
    sorted_cells = flat_cells[order]
    count = torch.bincount(flat_cells, minlength=n_cells + 1)[:n_cells]
    first = util.exclusive_cumsum(count)
    safe = sorted_cells.clamp(max=n_cells - 1)
    rank = torch.arange(flat_cells.shape[0], device=dev) - first[safe]
    blocks_per_cell = util.cdiv(count, p_tile)
    block_offset = util.exclusive_cumsum(blocks_per_cell)
    n_blocks = int(blocks_per_cell.sum())  # host sync: sizes the launch
    live = sorted_cells < n_cells
    pb_sorted = torch.where(live, block_offset[safe] + rank // p_tile,
                            n_blocks)
    pair_block = torch.empty_like(pb_sorted)
    pair_block[order] = pb_sorted
    pair_slot = torch.empty_like(rank)
    pair_slot[order] = rank % p_tile
    ok = pair_block < n_blocks
    block_cell = torch.full((n_blocks,), -1, dtype=torch.long, device=dev)
    block_cell[pair_block[ok]] = flat_cells[ok]
    probers = torch.full((n_blocks, p_tile), -1, dtype=torch.int32,
                         device=dev)
    probers[pair_block[ok], pair_slot[ok]] = flat_q[ok].int()
    return pair_block, pair_slot, block_cell, probers, n_blocks


def _block_select(scores, start_c, *, k_pair, pack32, slot_mask):
    """Per-block exact top-k_pair, then the wire format: the JAX package's
    XLA select (adc.py:_block_select), serving the shapes outside the block
    scan's gate. Its approx_max_k is exact off the TPU, so this is exact.
    pack32 keeps (key & ~slot_mask) | slot; exact keeps (key, address)."""
    if not pack32:
        return select_exact(scores, start_c, k_pair)
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k_pair], idx[..., :k_pair]
    packed = (sortable_i32(vals) & ~slot_mask) | idx.int()
    return torch.where(vals > -BIG / 2, packed, _key_neg_big(slot_mask))


def _merge_pairs(combo, query, pair_block, pair_slot, start_c, *, n_blocks,
                 p_tile, k, k_pair, nq, n_probe, pack32, slot_mask,
                 distance):
    """Unsort per-pair partial top-ks to [nq, n_probe * k_pair] and take
    each query's top k (adc.py:_merge_pairs, without the taper). The JAX
    package's bitonic tree and top_k give the same exact set here."""
    live = pair_block < n_blocks
    bo = pair_block.clamp(max=max(n_blocks - 1, 0))
    rows = (bo * p_tile + pair_slot).reshape(nq, n_probe)
    live2 = live.reshape(nq, n_probe)
    kk = min(k, n_probe * k_pair)
    if n_blocks == 0:
        combo = torch.zeros((1, p_tile, combo.shape[-1]), dtype=torch.int32,
                            device=combo.device)
    if pack32:
        tbl = combo.reshape(-1, k_pair)
        keys = torch.where(live2[:, :, None], tbl[rows],
                           _key_neg_big(slot_mask)) \
            .reshape(nq, n_probe * k_pair)
        starts_q = torch.where(live, start_c.long()[bo] if n_blocks else 0,
                               0).reshape(nq, n_probe)
        packed_w, fi = torch.topk(keys, kk, dim=-1)
        start_w = torch.gather(starts_q, 1, fi // k_pair)
        alive = sortable_i32_to_f32(packed_w) > -BIG / 2
        slot = packed_w & slot_mask
        fv = sortable_i32_to_f32(packed_w & ~slot_mask)
        fa = torch.where(alive, start_w + slot, -1)
        fv = torch.where(alive, fv, -torch.inf)
    else:
        pc = combo.reshape(-1, 2 * k_pair)[rows]   # [nq, n_probe, 2k]
        keys = torch.where(live2[:, :, None], pc[..., :k_pair], _INT32_MIN)
        addrs = torch.where(live2[:, :, None], pc[..., k_pair:], -1)
        fk, fi = torch.topk(keys.reshape(nq, -1), kk, dim=-1)
        fa = torch.gather(addrs.reshape(nq, -1), 1, fi)
        fv = sortable_i32_to_f32(fk)
        fin = torch.isfinite(fv)
        fa = torch.where(fin, fa, -1)
        fv = torch.where(fin, fv, -torch.inf)
    if distance == "euclidean":
        # the per-query -|q|^2 term, deferred from the block scores
        fv = torch.where(torch.isfinite(fv),
                         fv - torch.sum(query * query, -1)[:, None], fv)
    fa = fa.int()
    if kk < k:
        fv = torch.nn.functional.pad(fv, (0, k - kk), value=-torch.inf)
        fa = torch.nn.functional.pad(fa, (0, k - kk), value=-1)
    return fv, fa


def scan_cell_major(query, cells, probe_mask, decoded, norms, is_empty,
                    cell_start, cell_capacity, *, k, distance, s_max, n_cells,
                    p_tile=128, approx=False):
    """Inverted-probe-list block scan (adc.py:scan_cell_major at group=1,
    no probe cap, no taper, k_pair chosen as there).

    The block scan (kernel on the card, plain version on the CPU) serves
    every shape its gate admits: k_pair <= 64, and for approx the pack32
    wire format with a window the 128 strided groups divide (s_eff % 128
    == 0, or a power of two below 128). Other shapes take `_block_select`,
    the JAX package's own XLA select at those shapes."""
    distance = canonical_distance(distance)
    if distance == "manhattan":
        raise NotImplementedError(
            "manhattan distance is not ported yet (ROADMAP A12)")
    query = util.pad_cols(query.float(), decoded.shape[-1])
    nq, n_probe = cells.shape
    cap_total = decoded.shape[0]
    k_pair = 64 if (approx and k > 64) else k
    k_pair = max(k_pair, min(k, util.cdiv(k, n_probe)))
    k_pair = min(k_pair, k, s_max, cap_total)
    s_eff = min(s_max, cap_total)
    s_pow2 = util.next_pow2(s_eff)
    pack32 = approx and s_pow2 <= 4096
    slot_mask = s_pow2 - 1
    euclidean = distance == "euclidean"

    pair_block, pair_slot, block_cell, probers, n_blocks = _pack_pairs(
        cells, probe_mask, n_cells=n_cells, p_tile=p_tile)
    start = cell_start[block_cell]
    cap_b = cell_capacity[block_cell]
    start_c = start.clamp(0, cap_total - s_eff)
    off = (start - start_c).int()
    start_c = start_c.int().contiguous()
    cap_b = cap_b.int()
    if euclidean:
        penalty = torch.where(is_empty, BIG, norms.float())
    else:
        penalty = torch.where(is_empty, BIG, 0.0)
    penalty = penalty.float().contiguous()
    qtable = query.to(decoded.dtype).contiguous()

    use_kernel = k_pair <= 64 and (not approx or (pack32 and (
        s_eff % 128 == 0 or (s_pow2 == s_eff and s_eff < 128))))
    LAST_GATE.clear()
    LAST_GATE.update(impl="block_scan" if use_kernel else "block_select",
                     k_pair=k_pair, s_eff=s_eff, pack32=pack32,
                     blocks=n_blocks)
    if use_kernel:
        combo = block_scan(qtable, probers, start_c, off, cap_b, penalty,
                           decoded.contiguous(), s_eff=s_eff, k_pair=k_pair,
                           euclidean=euclidean, pack32=pack32,
                           slot_mask=slot_mask)
    else:
        def select(sc, st):
            return _block_select(sc, st, k_pair=k_pair, pack32=pack32,
                                 slot_mask=slot_mask)
        combo = select_blocks(select, qtable, probers, start_c, off, cap_b,
                              penalty, decoded, s_eff=s_eff,
                              euclidean=euclidean,
                              width=k_pair if pack32 else 2 * k_pair)
    return _merge_pairs(
        combo, query, pair_block, pair_slot, start_c, n_blocks=n_blocks,
        p_tile=p_tile, k=k, k_pair=k_pair, nq=nq, n_probe=n_probe,
        pack32=pack32, slot_mask=slot_mask, distance=distance)
