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
  per-pair partial top-ks are unsorted and merged per query. It also serves
  the int8 cache tier (per-slot `scales`; the queries quantize per row),
  and the deep-k surface: supercells of `group` adjacent cells scanned as
  one window, a cap on each query's distinct supercells, an explicit
  per-pair width `k_pair`, and the rank-tapered merge.

Both return (values [nq, k] f32, addresses [nq, k] int32, -1 padding).
"""

import torch

from .. import config
from .. import util
from ..metric import canonical_distance
from .block_scan import (BIG, block_scan, select_blocks, select_chunks,
                         select_exact, sortable_i32, sortable_i32_to_f32)

# resolved plan of the most recent scan_cell_major call: {"impl", "k_pair",
# "s_eff", "pack32", "blocks", "cache", "group", "n_probe", "precision"}
# (scan_cell_major_codes: its own keys and "precision") — lets a run
# record which select served it. index/ivfpq.py:_search_full adds
# "super_probe" and "split" ((p0, kp_tail) or None), and after a split
# "head" and "tail", the records of its two scans.
LAST_GATE = {}

# scan_impl values (the JAX package's): "auto" runs the kernel where its
# gate admits; "pallas" demands it; "xla" and "pallas_flat" run the probed
# scans through the XLA select (_block_select)
IMPLS = ("auto", "pallas", "xla", "pallas_flat")

_INT32_MIN = -(1 << 31)


def _key_neg_big(slot_mask):
    """The pack32 key of a dead entry: sortable(-BIG) with no slot bits."""
    return int(sortable_i32(torch.tensor([-BIG]))[0]) & ~slot_mask


def subvector_products(q, codebook, precision):
    """<q_i, c> per subvector: q [nq, m, dsub], codebook [m, nc, dsub] ->
    [nq, m, nc] f32, one batched product over m at `precision`."""
    return util.matmul(q.transpose(0, 1), codebook, precision) \
        .transpose(0, 1)


def build_adc_table(query, codebook, distance, precision=None):
    """Per-subvector similarity table: query [nq, d], codebook
    [m, 256, dsub] -> LUT [nq, m, 256] f32 (manhattan: -|q_i - c|_1 by
    broadcast, nq x m x 256 x dsub); the products at `precision` (None:
    the search precision), the norm terms f32."""
    distance = canonical_distance(distance)
    m, _, dsub = codebook.shape
    q = query.float().reshape(query.shape[0], m, dsub)
    cb = codebook.float()
    if distance == "manhattan":
        return -torch.sum(torch.abs(q[:, :, None, :] - cb[None]), dim=-1)
    ab = subvector_products(q, cb, precision)
    if distance == "euclidean":
        return (2.0 * ab - torch.sum(q * q, dim=-1)[:, :, None]
                - torch.sum(cb * cb, dim=-1)[None])
    return ab


def adc_lookup_scores(lut, codes, chunk=4096):
    """Gather-oracle ADC: score[q, j] = sum_i lut[q, i, codes[j, i]].
    lut [nq, m, 256] f32, codes [n, m] uint8 -> [nq, n] f32. (`chunk`, the
    JAX package's gather tile, is accepted and ignored.)"""
    m = lut.shape[1]
    sub = torch.arange(m, device=lut.device)
    return lut[:, sub[None, :], codes.long()].sum(-1)


def scan_query_major(query, cells, probe_mask, decoded, norms, is_empty,
                     cell_start, cell_capacity, *, k, distance, s_max,
                     q_chunk=16, approx=False, precision=None):
    """Gather-and-score each query's probed windows.

    query [nq, d] f32; cells / probe_mask [nq, n_probe] (distinct cells per
    row); decoded [cap, d]; norms [cap] f32; is_empty [cap] bool; s_max
    bounds every cell's capacity. The products run at `precision` (None:
    the search precision), a bf16 cache against the bf16-rounded query.
    The JAX package's `q_chunk` tiling is accepted and ignored; its
    approx_max_k is exact off the TPU, so `approx` takes the exact
    top-k."""
    distance = canonical_distance(distance)
    if decoded.dtype == torch.int8:
        raise ValueError("an int8 cache needs per-slot scales: use "
                         "scan_cell_major (adc.py:182-183)")
    query = util.pad_cols(query.float(), decoded.shape[-1])
    nq, n_probe = cells.shape
    slot = torch.arange(s_max, device=decoded.device)
    # queries per chunk: bounds the gathered [chunk, n_probe * s_max, d]
    # candidates to 2^26 elements
    rows = max(1, (1 << 26) // max(n_probe * s_max * query.shape[1], 1))
    vals_out, addr_out = [], []
    for i in range(0, nq, rows):
        q = query[i:i + rows]
        qc = cells[i:i + rows].long()
        start = cell_start.long()[qc]
        capc = cell_capacity.long()[qc]
        addr = start[:, :, None] + slot[None, None, :]
        valid = (slot[None, None, :] < capc[:, :, None]) \
            & probe_mask[i:i + rows, :, None]
        flat = torch.where(valid, addr, 0).reshape(q.shape[0], -1)
        valid = valid.reshape(q.shape[0], -1) & ~is_empty[flat]
        cand = decoded[flat]                               # [qc, np*s, d]
        if distance == "manhattan":
            # the f32 query against the upcast rows (adc.py:138, :155)
            sc = -torch.sum(torch.abs(cand.float() - q[:, None, :]), dim=-1)
        else:
            qv = q.to(decoded.dtype) \
                if decoded.dtype == torch.bfloat16 else q
            ab = util.matmul(cand, qv[:, None, :], precision)[:, :, 0]
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
                 distance, merge_taper=None):
    """Unsort per-pair partial top-ks to [nq, n_probe * k_pair] and take
    each query's top k (adc.py:_merge_pairs). The JAX package merges with a
    bitonic tree, an approx_max_k (exact off the TPU) or a top_k by width;
    each picks the same exact set as the torch.topk here.

    merge_taper (p0, kp_tail), pack32 only: where it engages (k > 32,
    n_probe > p0, kp_tail < k_pair) the first p0 probes keep all k_pair
    columns and the rest their first kp_tail (raised so the columns still
    reach k), gathered at that width (the JAX package's split unsort)."""
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
        dead = _key_neg_big(slot_mask)
        starts_q = torch.where(live, start_c.long()[bo] if n_blocks else 0,
                               0).reshape(nq, n_probe)
        if (merge_taper is not None and kk > 32 and n_probe > merge_taper[0]
                and merge_taper[1] < k_pair):
            p0, kp_tail = merge_taper
            kp_tail = max(kp_tail, util.cdiv(max(kk - p0 * k_pair, 0),
                                             max(n_probe - p0, 1)))
            head = torch.where(live2[:, :p0, None], tbl[rows[:, :p0]], dead)
            tail = torch.where(live2[:, p0:, None],
                               tbl[:, :kp_tail][rows[:, p0:]], dead)
            keys = torch.cat([head.reshape(nq, p0 * k_pair),
                              tail.reshape(nq, -1)], dim=1)
            dev = keys.device
            col2probe = torch.cat([
                torch.arange(p0 * k_pair, device=dev) // k_pair,
                p0 + torch.arange((n_probe - p0) * kp_tail, device=dev)
                // kp_tail])
            kk = min(kk, keys.shape[-1])
            packed_w, fi = torch.topk(keys, kk, dim=-1)
            start_w = torch.gather(starts_q, 1, col2probe[fi])
        else:
            keys = torch.where(live2[:, :, None], tbl[rows], dead) \
                .reshape(nq, n_probe * k_pair)
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


def _l1_block_scores(query, probers, start_c, off, cap, penalty, decoded, *,
                     s_eff):
    """Manhattan block scores [B, P, s_eff]: -|q - y|_1 of the f32 query
    against the upcast window rows, minus the penalty (the JAX package's
    XLA select, adc.py:943-948)."""
    slot = torch.arange(s_eff, device=decoded.device)
    rows = start_c.long()[:, None] + slot[None, :]
    in_cell = (slot[None, :] >= off[:, None]) \
        & (slot[None, :] < (off + cap)[:, None])
    pen = penalty[rows] + torch.where(in_cell, 0.0, BIG)
    q = query[probers.clamp(min=0).long()]                  # [B, P, d]
    win = decoded[rows].float()                             # [B, s, d]
    l1 = torch.sum(torch.abs(q[:, :, None, :] - win[:, None, :, :]), dim=-1)
    return -l1 - pen[:, None, :]


def check_impl(impl):
    if impl not in IMPLS:
        raise ValueError(f"scan_impl must be one of {IMPLS}, got {impl!r}")


def gate_kernel(impl, gate, what):
    """Whether the kernel serves a scan: impl "auto" or "pallas" and its
    gate admits. Where the JAX package warns and falls back to its XLA
    select (impl="pallas" with the gate failing), the port raises."""
    check_impl(impl)
    if impl == "pallas" and not gate:
        raise ValueError(f"{what}: scan_impl='pallas' demands the kernel, "
                         "but its gate fails at this shape")
    return gate and impl in ("auto", "pallas")


def _group_cells(cells, probe_mask, cell_start, *, group, n_cells,
                 cap_total, probe_cap, pre_grouped):
    """Supercell windows for a grouped scan (adc.py:656-721): supercell c
    is cells [c*group, (c+1)*group), one contiguous window from
    cell_start[c*group] to the next supercell's start (the last to
    cap_total). Each query's probed cells become their supercells with a
    rank-preserving first-occurrence dedup (duplicates masked), then at
    most probe_cap of them by rank (None: all). pre_grouped: `cells`
    already holds distinct supercell ids (_coarse_probe_super).

    Returns (cells, probe_mask, super_start, super_cap, n_super)."""
    dev = cells.device
    n_super = util.cdiv(n_cells, group)
    super_start = cell_start[::group]
    super_cap = torch.diff(torch.cat([
        super_start, torch.tensor([cap_total], dtype=super_start.dtype,
                                  device=dev)]))
    nq, n_probe = cells.shape
    if pre_grouped:
        cells = torch.where(probe_mask, cells, n_super).int()
        return cells, cells < n_super, super_start, super_cap, n_super
    sup = torch.where(probe_mask, cells.long() // group, n_super)
    if n_probe <= 128:
        # [np, np] strict-lower compare per row
        prior = torch.tril(torch.ones((n_probe, n_probe), dtype=torch.bool,
                                      device=dev), diagonal=-1)
        dup = ((sup[:, :, None] == sup[:, None, :]) & prior[None]).any(-1)
    else:
        # a stable value sort: the first of each equal run is the first
        # occurrence by rank; unsort the run-start mask
        order = torch.argsort(sup, dim=1, stable=True)
        s_sorted = torch.gather(sup, 1, order)
        dup_sorted = torch.cat([
            torch.zeros((nq, 1), dtype=torch.bool, device=dev),
            s_sorted[:, 1:] == s_sorted[:, :-1]], dim=1)
        dup = torch.gather(dup_sorted, 1, torch.argsort(order, dim=1))
    cells = torch.where(dup, n_super, sup).int()
    probe_mask = cells < n_super
    if probe_cap is not None and probe_cap < n_probe:
        # each query's best-ranked probe_cap distinct supercells
        key = torch.where(probe_mask,
                          torch.arange(n_probe, device=dev)[None, :], n_probe)
        order = torch.argsort(key, dim=1, stable=True)[:, :probe_cap]
        cells = torch.gather(cells, 1, order)
        probe_mask = torch.gather(probe_mask, 1, order)
    return cells, probe_mask, super_start, super_cap, n_super


def resolve_k_pair(k_pair, *, k, n_probe, approx):
    """The per-pair width before the shape clip (adc.py:725-747): explicit
    k_pair as given; else k (approx k > 64: 64), raised by the completeness
    floor to min(k, ceil(k / n_probe)) so that n_probe * k_pair reaches
    k."""
    if k_pair is not None:
        return int(k_pair)
    k_pair = 64 if (approx and k > 64) else k
    return max(k_pair, min(k, util.cdiv(k, n_probe)))


def scan_cell_major(query, cells, probe_mask, decoded, norms, is_empty,
                    cell_start, cell_capacity, *, k, distance, s_max, n_cells,
                    p_tile=128, block_chunk=8, approx=False, impl="xla",
                    interpret=False, group=1, scales=None, precision=None,
                    k_pair=None, probe_cap=None, merge_taper=None,
                    pre_grouped=False):
    """Inverted-probe-list block scan (adc.py:scan_cell_major).

    group > 1 scans supercells of `group` adjacent cells as one window of
    min(s_max * group, capacity) slots (_group_cells: dedup, probe_cap,
    pre_grouped). k_pair: the per-pair width (resolve_k_pair; an explicit
    one bypasses the completeness floor), clipped to k, s_max and the
    capacity. merge_taper (p0, kp_tail): the rank-tapered merge of the
    pack32 lists (_merge_pairs); exact selects ignore it.

    The block scan (kernel on the card, plain version on the CPU) serves
    every shape its gate admits under impl "auto" or "pallas": k_pair <=
    64, and for approx the pack32 wire format with a window the 128 strided
    groups divide (s_eff % 128 == 0, or a power of two below 128); an int8
    cache (decoded int8 with per-slot `scales` [cap] f32) also needs d % 16
    == 0. Other shapes, manhattan, and impl "xla" (the default, as in the
    JAX package) / "pallas_flat", take `_block_select`, the JAX package's
    own XLA select at those shapes; manhattan scores there by the L1
    broadcast (_l1_block_scores). `precision` (None: the search
    precision) is the XLA select's products' (float caches); the kernels,
    like the Pallas ones, take none. `block_chunk` and `interpret` (the
    JAX package's tiling and interpret mode) are accepted and ignored."""
    distance = canonical_distance(distance)
    precision = config.resolve_precision(precision)
    int8 = decoded.dtype == torch.int8
    assert not (int8 and distance == "manhattan"), \
        "int8 caches cannot score manhattan (no dequant in the L1 path)"
    if int8 != (scales is not None):
        raise ValueError("an int8 cache needs per-slot scales, and only it")
    query = util.pad_cols(query.float(), decoded.shape[-1])
    cap_total = decoded.shape[0]
    if group > 1:
        cells, probe_mask, cell_start, cell_capacity, n_cells = _group_cells(
            cells, probe_mask, cell_start, group=group, n_cells=n_cells,
            cap_total=cap_total, probe_cap=probe_cap,
            pre_grouped=pre_grouped)
        s_max = min(s_max * group, cap_total)
    nq, n_probe = cells.shape
    k_pair = resolve_k_pair(k_pair, k=k, n_probe=n_probe, approx=approx)
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
    if int8:
        # per-query symmetric quantization (adc.py:776-778)
        qtable, q_scale = util.int8_quantize_rows(query)
        scales = scales.float().contiguous()
    else:
        qtable, q_scale = query.to(decoded.dtype).contiguous(), None

    gate = distance != "manhattan" and k_pair <= 64 and (
        not approx or (pack32 and (
            s_eff % 128 == 0 or (s_pow2 == s_eff and s_eff < 128)))) \
        and (not int8 or decoded.shape[1] % 16 == 0)
    use_kernel = gate_kernel(impl, gate, "scan_cell_major")
    LAST_GATE.clear()
    LAST_GATE.update(impl="block_scan" if use_kernel else "block_select",
                     k_pair=k_pair, s_eff=s_eff, pack32=pack32,
                     blocks=n_blocks, group=group, n_probe=n_probe,
                     cache=str(decoded.dtype).replace("torch.", ""),
                     precision=precision)
    if use_kernel:
        combo = block_scan(qtable, probers, start_c, off, cap_b, penalty,
                           decoded.contiguous(), s_eff=s_eff, k_pair=k_pair,
                           euclidean=euclidean, pack32=pack32,
                           slot_mask=slot_mask, scale=scales,
                           q_scale=q_scale)
    else:
        def select(sc, st):
            return _block_select(sc, st, k_pair=k_pair, pack32=pack32,
                                 slot_mask=slot_mask)
        width = k_pair if pack32 else 2 * k_pair
        if distance == "manhattan":
            def scores(sl):
                return _l1_block_scores(query, probers[sl], start_c[sl],
                                        off[sl], cap_b[sl], penalty, decoded,
                                        s_eff=s_eff)
            # the [B, P, s_eff, d] broadcast: d temporaries per score
            combo = select_chunks(scores, select, probers, start_c,
                                  s_eff=s_eff, width=width,
                                  cost=decoded.shape[1])
        else:
            combo = select_blocks(select, qtable, probers, start_c, off,
                                  cap_b, penalty, decoded, s_eff=s_eff,
                                  euclidean=euclidean, width=width,
                                  scale=scales, q_scale=q_scale,
                                  precision=precision)
    return _merge_pairs(
        combo, query, pair_block, pair_slot, start_c, n_blocks=n_blocks,
        p_tile=p_tile, k=k, k_pair=k_pair, nq=nq, n_probe=n_probe,
        pack32=pack32, slot_mask=slot_mask, distance=distance,
        merge_taper=merge_taper if pack32 else None)
