"""IVFPQ index — the main user-facing ANN index (counterpart of
torchpq_tpu/index/ivfpq.py).

Beside the canonical uint8 codes the index keeps a bf16 decoded cache (the
PQ reconstruction) and per-slot squared norms as aux row stores, so ADC
scoring is a product against the cache. Search runs one of three plans:
`cell_major` (coarse probe -> pack (query, cell) pairs into blocks -> block
scan -> merge), `query_major` (gather each query's windows) and `flat` (a
sweep over the compacted cache). The reference's [d_vector, n_data] layout
holds at every public method.

scan_cache_dtype="none" is the code-domain tier: no decoded cache, only the
codes (m B per slot) and the norms (4 B). Its probed plans run the codes
scan (ops/onehot_adc.py:scan_cell_major_codes) and its flat plan decodes
chunks of codes on the fly (flat_decode_scan).

scan_cache_dtype="int8" is the int8 tier: the decoded cache holds each row
quantized to int8 (d_cache B per slot) beside its f32 dequant scale (the
"scale" aux store) and norm. Every probed plan runs the cell-major scan in
the block scan's int8 mode, and the flat plan sweeps the integer products.

n_bits=4 keeps two 16-cluster codes per byte (m/2 bytes per slot). Every
reader of the stored bytes (the cache rebuild, the code-domain scans,
similarity_at_address) decodes or scores them against the byte-pair view
of the codebooks (`_scan_codebook`, codec/pq.py:paired_codebook), so
nothing unpacks them. pq_use_residual=True encodes each vector's residual
from its cell centroid: the cache rows are centroid + PQ reconstruction
(the code domain refuses it, as the JAX package does). anisotropic_eta
trains and encodes the PQ by the anisotropic loss (codec/pq.py).
Manhattan distance runs in plain torch: no kernel takes it, in either
package.

`scan_impl` picks the scan implementation as in the JAX package: "auto"
(the kernels wherever their gates admit), "pallas" (demand the kernel: the
port raises where the JAX package warns and falls back), "xla" (the
probed plans through the XLA select) and "pallas_flat" (the flat plan
through the fused flat-scan kernel, the probed plans as "xla").

The deep-k surface of the JAX package is here too: supercells
(`scan_group`), the probe cap, `scan_k_pair`, the rank-tapered merge and
its split into two scans, supercell-native probing, and both routes of
capacity-bounded (spill) assignment at add: on the device (ops/spill.py)
and on the host through the native C++ greedy (native.spill_assign), in
exact arrival order.
"""

import numpy as np
import torch

from .. import config
from .. import native
from .. import util
from ..metric import (canonical_distance, negative_manhattan_distance,
                      negative_squared_l2_distance)
from ..codec import PQCodec, VQCodec
from ..codec.pq import pack_nibbles, paired_codebook
from ..container import CellContainer
from ..fn.ivfpq_topk import IVFPQTopk, batch_threshold_for
from ..ops import adc
from ..ops.block_scan import BIG
from ..ops.codes_scan import codes_kernel_static_gate, decode_codes
from ..ops.flat_adc import flat_adc_auto
from ..ops.gather import gather_rows
from ..ops.max_sim import topk_sim
from ..ops.onehot_adc import (flat_decode_scan, flat_onehot_scan,
                              scan_cell_major_codes)
from ..ops.spill import spill_assign_device


def _coarse_probe(query, coarse_codebook, temperature, *, n_probe,
                  use_smart, precision=None):
    """Coarse scoring + cell selection + smart-probing mask (ivfpq.py:37-70).

    Scores are float32 negative squared L2 against the coarse codebook,
    the products at `precision` (None: the search precision).
    Smart probing keeps ceil(normalized_entropy * n_probe) cells per query,
    with p = softmax(-sqrt|sims| / T). The JAX package's approx_max_k is
    exact off the TPU, so cells are an exact top-k here."""
    sims = negative_squared_l2_distance(query, coarse_codebook,
                                        precision=precision)
    topk_sims, cells = torch.topk(sims, n_probe, dim=-1)
    if use_smart and n_probe > 1:
        p = torch.softmax(-torch.sqrt(torch.abs(topk_sims)) / temperature,
                          dim=-1)
        log2p = torch.log2(torch.clamp(p, min=1e-30))
        ent = -torch.sum(p * log2p / np.log2(np.float32(n_probe)), dim=-1)
        n_list = torch.clamp(torch.ceil(ent * n_probe).int(), 1, n_probe)
        mask = torch.arange(n_probe, device=cells.device)[None, :] \
            < n_list[:, None]
    else:
        mask = torch.ones(cells.shape, dtype=torch.bool, device=cells.device)
    return topk_sims, cells.int(), mask


def _coarse_probe_super(query, coarse_codebook, temperature, *, cap, group,
                        n_cells, use_smart, precision=None):
    """Supercell-native probing (ivfpq.py:76-119): rank the supercells of
    `group` adjacent cells by the largest coarse score of their cells
    (padded with -inf to n_super * group) and keep the top
    min(cap, n_super), each query's distinct supercells in rank order.
    Smart probing applies _coarse_probe's entropy rule to the supercell
    scores, normalized by log2(max(cap, 2))."""
    sims = negative_squared_l2_distance(query, coarse_codebook,
                                        precision=precision)
    n_super = util.cdiv(n_cells, group)
    pad = n_super * group - n_cells
    if pad:
        sims = torch.nn.functional.pad(sims, (0, pad), value=-torch.inf)
    sup_sims = sims.reshape(sims.shape[0], n_super, group).amax(-1)
    top_sims, sup = torch.topk(sup_sims, min(cap, n_super), dim=-1)
    if use_smart and cap > 1:
        p = torch.softmax(-torch.sqrt(torch.abs(top_sims)) / temperature,
                          dim=-1)
        log2p = torch.log2(torch.clamp(p, min=1e-30))
        ent = -torch.sum(p * log2p / np.log2(np.float32(max(cap, 2))),
                         dim=-1)
        n_list = torch.clamp(torch.ceil(ent * cap).int(), 1, cap)
        mask = torch.arange(sup.shape[1], device=sup.device)[None, :] \
            < n_list[:, None]
    else:
        mask = torch.ones(sup.shape, dtype=torch.bool, device=sup.device)
    return top_sims, sup.int(), mask


def _compact_cells_cache(decoded, norms, scales, is_empty, cell_start,
                         new_start, n_pad):
    """Pack each cell's live rows into a contiguous segment of a fresh
    [n_pad, d] cache starting at new_start[c] (ivfpq.py:122-155), with
    their norms and (int8 tier, else None) scales.
    addr_map[i] = storage address of compact row i (-1 on padding)."""
    dev = decoded.device
    cap = decoded.shape[0]
    aidx = torch.arange(cap, device=dev)
    cell_of = (torch.searchsorted(cell_start.long(), aidx, right=True) - 1) \
        .clamp(0, cell_start.shape[0] - 1)
    live = (~is_empty).long()
    prefix = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                        torch.cumsum(live, 0)])
    rank = prefix[aidx] - prefix[cell_start.long()[cell_of]]
    dest = torch.where(is_empty, n_pad, new_start.long()[cell_of] + rank)
    return _gather_compact(decoded, norms, scales, aidx, dest, n_pad)


def _compact_flat_cache(decoded, norms, is_empty, n_pad, scales=None):
    """Live rows in address order, padded to n_pad (ivfpq.py:158-174)."""
    aidx = torch.nonzero(~is_empty).flatten()
    dest = torch.arange(aidx.shape[0], device=aidx.device)
    return _gather_compact(decoded, norms, scales, aidx, dest, n_pad)


def _gather_compact(decoded, norms, scales, src, dest, n_pad):
    """Rows src -> positions dest (n_pad drops) of a fresh cache ->
    (decoded, norms, is_empty, addr_map, scales or None)."""
    addr_map = torch.full((n_pad + 1,), -1, dtype=torch.long,
                          device=decoded.device)
    addr_map[dest] = src
    addr_map = addr_map[:n_pad]
    valid = addr_map >= 0
    safe = addr_map.clamp(min=0)
    sc = None if scales is None else scales[safe].contiguous()
    # the row gather is the port's gather_rows kernel on the card
    return (gather_rows(decoded.contiguous(), safe), norms[safe].contiguous(),
            ~valid, addr_map.int(), sc)


def _translate(addr, addr_map, address2id):
    """Compact addresses -> storage addresses -> ids (-1 stays -1)."""
    if addr_map is not None:
        addr = torch.where(addr >= 0, addr_map[addr.long().clamp(min=0)], -1)
    ids = torch.where(addr >= 0, address2id[addr.long().clamp(min=0)], -1)
    return ids, addr.int()


def _search_flat(q, decoded, norms, is_empty, addr_map, address2id, *, k,
                 distance, approx, impl, scales=None, precision=None):
    """Flat plan: exhaustive sweep (or the fused flat-scan kernel) +
    address translation."""
    penalty = torch.where(is_empty, BIG,
                          norms.float() if distance == "euclidean" else 0.0)
    vals, addr = flat_adc_auto(q, decoded, penalty.float(), k=k,
                               distance=distance, approx=approx, impl=impl,
                               scales=scales, precision=precision)
    ids, addr = _translate(addr, addr_map, address2id)
    return vals, ids, addr


def _search_full(q, coarse_codebook, decoded, norms, is_empty, cell_start,
                 cell_capacity, address2id, temperature, *, k, n_probe,
                 use_smart, distance, s_max, n_cells, mode, approx, impl,
                 scales=None, addr_map=None, group=1, probe_cap=None,
                 k_pair=None, merge_taper=None, super_probe=False,
                 split_taper=True, precision=None):
    """Probed plans: coarse probe + scan + id translation (ivfpq.py:327-422),
    the coarse and scan products at `precision`.

    Supercell-native probing (_coarse_probe_super) serves the cell-major
    scan when grouping, an approx select and a probe cap below n_probe are
    all on. The split taper runs an engaged merge taper as two scans, the
    first p0 probes at the full width kp_res and the rest at kp_tail, then
    one [nq, 2k] top-k; it needs distinct probes per query (super-probe or
    group 1). Where k_pair is not given, kp_res keeps the scan's
    completeness floor (ops/adc.py:resolve_k_pair), which the JAX package
    leaves out here: with k > 64 * np_eff the port returns k live rows
    where the JAX package pads with -inf / -1.

    adc.LAST_GATE gains "super_probe" and "split" ((p0, kp_tail) or None);
    after a split the records of both scans, "head" and "tail"."""
    use_super = (super_probe and mode == "cell_major" and group > 1
                 and probe_cap is not None and probe_cap < n_probe
                 and approx)
    if use_super:
        _, cells, mask = _coarse_probe_super(
            q, coarse_codebook, temperature, cap=probe_cap, group=group,
            n_cells=n_cells, use_smart=use_smart, precision=precision)
    else:
        _, cells, mask = _coarse_probe(q, coarse_codebook, temperature,
                                       n_probe=n_probe, use_smart=use_smart,
                                       precision=precision)
    if mode == "query_major":
        vals, addr = adc.scan_query_major(
            q, cells, mask, decoded, norms, is_empty, cell_start,
            cell_capacity, k=k, distance=distance, s_max=s_max,
            precision=precision)
        ids, addr = _translate(addr, addr_map, address2id)
        return vals, ids, addr
    np_eff = probe_cap if (probe_cap is not None
                           and probe_cap < n_probe) else n_probe
    kp_res = k_pair if k_pair is not None \
        else (64 if (approx and k > 64) else k)
    use_split = (split_taper and merge_taper is not None and approx
                 and (use_super or group == 1)
                 and min(k, np_eff * kp_res) > 32
                 and np_eff > merge_taper[0]
                 and merge_taper[1] < kp_res)
    scan_kw = dict(k=k, distance=distance, s_max=s_max, n_cells=n_cells,
                   approx=approx, scales=scales, impl=impl, group=group,
                   pre_grouped=use_super, precision=precision)
    if use_split:
        # the completeness floor the JAX package omits here (ROADMAP C1)
        kp_res = adc.resolve_k_pair(k_pair, k=k, n_probe=np_eff,
                                    approx=approx)
        p0 = merge_taper[0]
        kp_tail = max(merge_taper[1], util.cdiv(
            max(min(k, np_eff * kp_res) - p0 * kp_res, 0),
            max(np_eff - p0, 1)))
        v_h, a_h = adc.scan_cell_major(
            q, cells[:, :p0], mask[:, :p0], decoded, norms, is_empty,
            cell_start, cell_capacity, k_pair=kp_res, **scan_kw)
        head = dict(adc.LAST_GATE)
        v_t, a_t = adc.scan_cell_major(
            q, cells[:, p0:], mask[:, p0:], decoded, norms, is_empty,
            cell_start, cell_capacity, k_pair=kp_tail, **scan_kw)
        adc.LAST_GATE.update(head=head, tail=dict(adc.LAST_GATE))
        vals, sel = torch.topk(torch.cat([v_h, v_t], dim=1), k, dim=-1)
        addr = torch.gather(torch.cat([a_h, a_t], dim=1), 1, sel)
        split = (p0, kp_tail)
    else:
        vals, addr = adc.scan_cell_major(
            q, cells, mask, decoded, norms, is_empty, cell_start,
            cell_capacity, probe_cap=None if use_super else probe_cap,
            k_pair=k_pair, merge_taper=merge_taper, **scan_kw)
        split = None
    adc.LAST_GATE.update(super_probe=use_super, split=split)
    ids, addr = _translate(addr, addr_map, address2id)
    return vals, ids, addr


def _search_flat_codes(q, codes, norms, is_empty, addr_map, address2id,
                       codebook, *, k, distance, m, precision=None):
    """Code-domain flat plan: decode-on-the-fly sweep (manhattan: the LUT
    sweep, as L1 does not factor through a product) + address
    translation."""
    penalty = torch.where(is_empty, BIG,
                          norms.float() if distance == "euclidean" else 0.0)
    sweep = flat_onehot_scan if distance == "manhattan" else flat_decode_scan
    vals, addr = sweep(q, codes, penalty.float(), codebook, k=k,
                       distance=distance, m=m, precision=precision)
    ids, addr = _translate(addr, addr_map, address2id)
    return vals, ids, addr


def _search_full_codes(q, coarse_codebook, codes, norms, is_empty,
                       cell_start, cell_capacity, address2id, pq_codebook,
                       temperature, *, k, n_probe, use_smart, distance, s_max,
                       n_cells, approx, m, impl, k_pair=None,
                       precision=None):
    """Code-domain probed plans: coarse probe + codes scan (k_pair: the
    index's scan_k_pair) + id translation."""
    _, cells, mask = _coarse_probe(q, coarse_codebook, temperature,
                                   n_probe=n_probe, use_smart=use_smart,
                                   precision=precision)
    vals, addr = scan_cell_major_codes(
        q, cells, mask, codes, norms, is_empty, cell_start, cell_capacity,
        pq_codebook, k=k, distance=distance, s_max=s_max, n_cells=n_cells,
        approx=approx, m=m, impl=impl, k_pair=k_pair, precision=precision)
    ids, addr = _translate(addr, None, address2id)
    return vals, ids, addr


# The planner's costs on an H100 (plan_scan_mode on a CUDA index): each
# plan's estimated ms, fitted by chip_smoke.py's fit_planner to the points
# of its planner sweep on an NVIDIA H100 80GB HBM3 at its 700.00 W power
# limit (torch 2.11.0+cu128). Terms, with r = d / 128 - 1 (each width a
# plan's cost growth per 128 more dimensions):
#   flat:        call + n_items * ((1 + pass_width r) pass_ps
#                                  + nq (1 + slot_width r) slot_ps)
#                by the sweep's precision class (flat_class): "f32", its
#                GEMMs in IEEE f32 ("highest"; "high" is not measured and
#                takes them), and "bf16", bf16 GEMMs on the tensor cores
#                ("default", the shipped search precision)
#   cell_major:  call + nq query_us + nq n_probe pair_ns
#                + nq n_probe s (1 + width r) slot_ps
#   query_major: call + nq n_probe s (1 + width r) slot_ps
# with s = max(next_pow2(max cell capacity), 128), the probed scans'
# narrowest window. The cell-major terms are per tier and per select:
# "fast" (the tensor-core selects) or "slow" (an exact k_pair above 16 on
# the CUDA cores, or a k_pair above 64 on the plain select). The flat
# "bf16" terms, cell_major and query_major are one sweep's whole fit (the
# bf16 scans on block_scan_wg.cu: its narrow instances at d <= 128, k-chunked
# ones above); the flat "f32" terms are the fit of the sweep at "highest"
# before it (the sweep runs at the shipped default).
CARD_PLAN_COSTS = {
    "flat": {
        "f32": dict(
            call_ms=0.675, pass_width=2.66, slot_width=0.209,
            pass_ps={"bf16": 227.0, "int8": 564.0, "codes": 1740.0},
            slot_ps={"bf16": 24.2, "int8": 29.3, "codes": 23.4}),
        "bf16": dict(
            call_ms=0.605, pass_width=0.716, slot_width=0.00732,
            pass_ps={"bf16": 98.9, "int8": 382.0, "codes": 1110.0},
            slot_ps={"bf16": 18.3, "int8": 29.3, "codes": 17.8})},
    "cell_major": dict(
        call_ms=2.98, width={"fast": 5.02, "slow": 0.479},
        query_us={"bf16": {"fast": 0.0748, "slow": 0.0619},
                  "int8": {"fast": 0.0274, "slow": 6.36},
                  "codes": {"fast": 0.134, "slow": 147.0}},
        pair_ns={"bf16": {"fast": 1.76, "slow": 0.0},
                  "int8": {"fast": 0.0, "slow": 0.0},
                  "codes": {"fast": 0.0, "slow": 0.0}},
        slot_ps={"bf16": {"fast": 0.566, "slow": 56.6},
                  "int8": {"fast": 3.07, "slow": 112.0},
                  "codes": {"fast": 4.37, "slow": 0.0}}),
    "query_major": dict(call_ms=1.24, width=2.07, slot_ps=682.0),
}


def _select_class(k, n_probe, approx):
    """The probed scan's select as ops/adc.py resolves it: "slow" where the
    k_pair is above 64 (k above 64 * n_probe with approx on: the plain
    select) or an exact one above 16 (the CUDA-core scans), else "fast"
    (the tensor cores)."""
    if approx:
        return "slow" if k > 64 * n_probe else "fast"
    return "slow" if k > 16 else "fast"


def flat_class(precision=None):
    """The flat terms' precision class of a search precision (None: the
    search precision): "bf16" at "default", else "f32"."""
    return "bf16" if config.resolve_precision(precision) == "default" \
        else "f32"


def card_plan_ms(nq, k, *, n_probe, s_pow2, n_items, d_vector, tier,
                 approx, precision=None):
    """Estimated ms of each plan on the card (CARD_PLAN_COSTS' model) ->
    {"flat", "cell_major", "query_major": ms}; the flat terms of the
    search precision's class (flat_class). An f32 cache takes the bf16
    terms (not measured)."""
    c = CARD_PLAN_COSTS
    t = "bf16" if tier == "float32" else tier
    r = d_vector / 128.0 - 1.0
    pairs = nq * n_probe
    slots = pairs * max(s_pow2, 128) * 1e-9
    f, cm, qm = (c["flat"][flat_class(precision)], c["cell_major"],
                 c["query_major"])
    sel = _select_class(k, n_probe, approx)
    return {
        "flat": f["call_ms"] + max(n_items, 1) * 1e-9 * (
            (1.0 + f["pass_width"] * r) * f["pass_ps"][t]
            + nq * (1.0 + f["slot_width"] * r) * f["slot_ps"][t]),
        "cell_major": cm["call_ms"] + nq * cm["query_us"][t][sel] * 1e-3
        + pairs * cm["pair_ns"][t][sel] * 1e-6
        + slots * (1.0 + cm["width"][sel] * r) * cm["slot_ps"][t][sel],
        "query_major": qm["call_ms"]
        + slots * (1.0 + qm["width"] * r) * qm["slot_ps"]}


def card_probed_plan(nq, k, *, n_probe, s_pow2, d_vector, tier, approx,
                     batch_threshold=None):
    """The card's probed plan: query_major where the cache is bf16 / f32,
    the batch is below the threshold and its estimate is below
    cell_major's; else cell_major (the int8 and code tiers run every
    probed plan cell-major)."""
    if tier in ("int8", "codes") \
            or nq >= batch_threshold_for("cuda", batch_threshold):
        return "cell_major"
    est = card_plan_ms(nq, k, n_probe=n_probe, s_pow2=s_pow2, n_items=1,
                       d_vector=d_vector, tier=tier, approx=approx)
    return "query_major" if est["query_major"] < est["cell_major"] \
        else "cell_major"


def plan_for(nq, k, *, n_probe, s_pow2, n_items, d_vector, tier, approx,
             codes_kernel=True, device="cpu", batch_threshold=None,
             precision=None):
    """The plan of an "auto" search from the index's host shadows: tier is
    "bf16", "float32", "int8" or "codes" (codes_kernel: whether the codes
    kernel's static gate admits the index). On the CPU, the JAX package's
    rule and TPU v5e crossovers (ivfpq.py:1140-1197), so the CPU parity
    tests compare the same plan. On a CUDA device, the card's costs:
    card_probed_plan, then flat where its estimate (at the search
    `precision`'s flat terms) is no higher."""
    if getattr(device, "type", str(device)) == "cuda":
        mode = card_probed_plan(nq, k, n_probe=n_probe, s_pow2=s_pow2,
                                d_vector=d_vector, tier=tier, approx=approx,
                                batch_threshold=batch_threshold)
        est = card_plan_ms(nq, k, n_probe=n_probe, s_pow2=s_pow2,
                           n_items=n_items, d_vector=d_vector, tier=tier,
                           approx=approx, precision=precision)
        return "flat" if est["flat"] <= est[mode] else mode
    mode = ("query_major" if nq < batch_threshold_for("cpu", batch_threshold)
            else "cell_major")
    touched = n_probe * s_pow2
    n_live = max(int(n_items), 1)
    if tier == "codes":
        # probed codes scan against the decode-on-the-fly flat sweep
        mult = 12 if codes_kernel else 512
        if touched * mult >= n_live:
            mode = "flat"
    elif int(k) <= 32 or d_vector >= 512:
        if approx and touched * 128 >= n_live:
            mode = "flat"
    elif touched * 512 >= n_live:
        mode = "flat"
    return mode


class IVFPQIndex(CellContainer):
    def __init__(self, d_vector, n_subvectors=8, n_cells=128,
                 initial_size=None, expand_step_size=128,
                 expand_mode="double", distance="euclidean", device=None,
                 pq_use_residual=False, verbose=0, scan_cache_dtype=None,
                 scan_mode="auto", n_bits=8, seed=0, anisotropic_eta=None,
                 anisotropic_iters=8, pack_ingest=None):
        assert d_vector % n_subvectors == 0
        assert n_bits in (4, 8), "n_bits must be 4 or 8"
        if n_bits == 4:
            assert n_subvectors % 2 == 0, "4-bit PQ needs even n_subvectors"
        cache_dtype = str(scan_cache_dtype or config.SCAN_CACHE_DTYPE)
        # scan_cache_dtype="none": no decoded cache; scans read the codes
        self._code_domain = cache_dtype == "none"
        # scan_cache_dtype="int8": int8 cache rows with per-slot scales
        self._int8_cache = cache_dtype == "int8"
        self.n_bits = int(n_bits)
        if initial_size is None:
            initial_size = expand_step_size
        code_bytes = n_subvectors // 2 if n_bits == 4 else n_subvectors
        # packed [cap/g, g*m] storage at ingest (g = 128 // code bytes):
        # every eligible 8-bit index, and a 4-bit one only in the code
        # domain (ivfpq.py:444-470), so each tier's stored layout and .npz
        # state are the JAX package's
        eligible = 8 <= code_bytes < 128 and 128 % code_bytes == 0
        if pack_ingest is None:
            pack_ingest = eligible and (n_bits == 8 or self._code_domain)
        elif pack_ingest and not eligible:
            raise ValueError(
                "pack_ingest requires 8 <= code bytes < 128 dividing 128")
        super().__init__(
            code_size=code_bytes, n_cells=n_cells, dtype="uint8",
            device=device, initial_size=initial_size,
            expand_step_size=expand_step_size, expand_mode=expand_mode,
            use_inverse_id_mapping=True, contiguous_size=4, verbose=verbose,
            pack_group=128 // code_bytes if pack_ingest else 1)
        self.d_vector = d_vector
        self.n_subvectors = n_subvectors
        self.d_subvector = d_vector // n_subvectors
        self.distance = canonical_distance(distance)
        self.pq_use_residual = pq_use_residual
        assert not (self._code_domain and pq_use_residual), \
            "scan_cache_dtype='none' does not support pq_use_residual yet " \
            "(the per-cell centroid term is not in the code LUT)"
        assert not (self._int8_cache and self.distance == "manhattan"), \
            "int8 scan cache does not support manhattan distance"
        self.n_probe = 1
        self._use_smart_probing = True
        self._smart_probing_temperature = 30.0
        self._use_approx_topk = False
        # the reference's CUDA tunables (ivfpq.py:483-488), validated and
        # kept; use_tensor_core picks the search products' precision
        # (_search_precision), the others have no effect on the scans
        self._use_precomputed = pq_use_residual
        self._use_cublas = True
        self._use_tensor_core = True
        self._fp16_scale_mode = "a"
        self.scan_mode = scan_mode
        # "auto", "pallas", "xla" or "pallas_flat" (ops/adc.py:IMPLS)
        self.scan_impl = "auto"
        # spill (off by default; see _assign_cells): up to spill_cells
        # best cells per item, each held to spill_capacity items. "device"
        # routes on the device (ops/spill.py), any other value ("host") on
        # the host through the native C++ greedy
        self.spill_cells = 1
        self.spill_capacity = None
        self.spill_impl = "device"
        # the deep-k surface (ivfpq.py:497-539): supercells of scan_group
        # adjacent cells per scanned window; a cap on each query's distinct
        # supercells (None, "auto" or an int; approx only); the per-pair
        # width (None: the scan's rule); the rank-tapered merge (None or
        # (p0, kp_tail)); supercell-native probing and the split taper,
        # both on by default, engage as in the JAX package (_search_full)
        self.scan_group = 1
        self.scan_probe_cap = None
        self.scan_k_pair = None
        self.scan_merge_taper = None
        self.scan_super_probe = True
        self.scan_split_taper = True
        self.register_state("_frozen_codes", False)
        # cache width: lane-padded to a multiple of 128 above d=128, as in
        # the JAX package's state format (zero columns score nothing)
        self._d_cache = (util.round_up(d_vector, 128) if d_vector > 128
                         else d_vector)
        if not self._code_domain:
            self.add_aux_store("decoded", self._d_cache, cache_dtype)
        self.add_aux_store("norm", 1, "float32")
        if self._int8_cache:
            # per-slot symmetric dequant scale of the int8 cache rows
            self.add_aux_store("scale", 1, "float32")
        # the codec hyperparameters of the reference (IVFPQIndex.py:63-79)
        self.register_module("vq_codec", VQCodec(
            n_clusters=n_cells, n_redo=1, max_iter=15, tol=1e-4,
            distance="euclidean", init_mode="random", verbose=verbose,
            seed=seed, device=device))
        self.register_module("pq_codec", PQCodec(
            d_vector=d_vector, n_subvectors=n_subvectors,
            n_clusters=16 if n_bits == 4 else 256, distance=distance,
            verbose=verbose, seed=seed, anisotropic_eta=anisotropic_eta,
            anisotropic_iters=anisotropic_iters, device=device))
        self._ivfpq_topk = IVFPQTopk(n_cells=n_cells, mode=scan_mode)
        # (mutation counter, layout) caches of the compacted scan layouts
        self._flat_cache = None
        self._compact_cache = None
        self.scan_compact = "auto"
        self.set_aux_rebuilder(
            ("norm",) if self._code_domain else
            ("decoded", "norm") + (("scale",) if self._int8_cache else ()),
            self._rebuild_scan_cache)

    # ---- tunables ----
    @property
    def use_smart_probing(self):
        return self._use_smart_probing

    @use_smart_probing.setter
    def use_smart_probing(self, value):
        self._use_smart_probing = bool(value)

    @property
    def smart_probing_temperature(self):
        return self._smart_probing_temperature

    @smart_probing_temperature.setter
    def smart_probing_temperature(self, value):
        assert value > 0
        self._smart_probing_temperature = float(value)

    @property
    def use_approx_topk(self):
        """Approximate in-scan selection (the pack32 block select)."""
        return self._use_approx_topk

    @use_approx_topk.setter
    def use_approx_topk(self, value):
        self._use_approx_topk = bool(value)
        self._ivfpq_topk.approx = bool(value)

    @property
    def use_cublas(self):
        return self._use_cublas

    @use_cublas.setter
    def use_cublas(self, value):
        self._use_cublas = bool(value)

    @property
    def use_tensor_core(self):
        """Search at config.SEARCH_PRECISION (True, the default) or at
        "highest" (False), as in the JAX package."""
        return self._use_tensor_core

    @use_tensor_core.setter
    def use_tensor_core(self, value):
        self._use_tensor_core = bool(value)

    @property
    def fp16_scale_mode(self):
        return self._fp16_scale_mode

    @fp16_scale_mode.setter
    def fp16_scale_mode(self, value):
        assert value in ("a", "b", "both", "none")
        self._fp16_scale_mode = value

    @property
    def use_precomputed(self):
        return self._use_precomputed

    @use_precomputed.setter
    def use_precomputed(self, value):
        self._use_precomputed = bool(value)

    # codec hyperparameter pass-throughs (the reference's IVFPQIndex.py)
    @property
    def pq_max_iter(self):
        return self.pq_codec.kmeans.max_iter

    @pq_max_iter.setter
    def pq_max_iter(self, v):
        self.pq_codec.kmeans.max_iter = int(v)

    @property
    def vq_max_iter(self):
        return self.vq_codec.kmeans.max_iter

    @vq_max_iter.setter
    def vq_max_iter(self, v):
        self.vq_codec.kmeans.max_iter = int(v)

    @property
    def is_trained(self):
        return self.vq_codec.is_trained and self.pq_codec.is_trained

    def _prep(self, x):
        x = util.as_tensor(x, self.device, torch.float32)
        assert x.shape[0] == self.d_vector
        if self.distance == "cosine":
            x = util.normalize(x, dim=0)
        return x

    # ---- training ----
    def train(self, x, force_retrain=False):
        """x: [d_vector, n]. VQ k-means, the locality relabel of the cells
        (util.locality_order, as in the JAX package), then PQ k-means (on
        the residuals from the cell centroids with pq_use_residual)."""
        if self.is_trained and not force_retrain:
            self.print_message("index is already trained", 1)
            return
        x = self._prep(x)
        self.vq_codec.train(x)
        km = self.vq_codec.kmeans
        order = util.locality_order(km._centroids[0].cpu().numpy())
        km.register_state("_centroids", km._centroids[
            :, torch.as_tensor(order, device=self.device)].contiguous())
        if self.pq_use_residual:
            x = x - self.vq_codec.decode(self.vq_codec.encode(x))
        self.pq_codec.train(x)

    # ---- codec exposure ----
    def encode(self, x):
        """x: [d_vector, n] -> PQ codes [n_subvectors, n] uint8 (cosine
        inputs normalized first); with pq_use_residual (pq_code, vq_code),
        the PQ codes of the residuals from the cells' centroids."""
        x = self._prep(x)
        if self.pq_use_residual:
            vq_code = self.vq_codec.encode(x)
            pq_code = self.pq_codec.encode(x - self.vq_codec.decode(vq_code))
            return pq_code, vq_code
        return self.pq_codec.encode(x)

    def decode(self, x):
        """PQ codes [n_subvectors, n] -> [d_vector, n] f32; with
        pq_use_residual a (pq_code, vq_code) pair, the sum of both parts."""
        if self.pq_use_residual:
            pq_code, vq_code = x
            return self.vq_codec.decode(vq_code) + self.pq_codec.decode(
                pq_code)
        return self.pq_codec.decode(x)

    def _rerank_cache_parts(self):
        """(rerank codes [cap, m_r], rerank codebook) whose decode each
        cache row adds: (None, None) here; IVFPQRIndex's cached tiers hold
        the full two-stage reconstruction."""
        return None, None

    def _rebuild_scan_cache(self):
        """Recompute decoded/norm(/scale) (norm only in the code domain)
        from the canonical codes in chunks; with pq_use_residual each row
        adds its cell's centroid, the cell found from the address by the
        cell starts, and with rerank parts (_rerank_cache_parts) the decode
        of the row's rerank codes, before the norm and the int8
        quantization of each chunk (ivfpq.py:177-210). Never-written slots
        decode to garbage; every reader masks them."""
        cap, d = self._capacity, self._d_cache
        rr_store, rr_cb = self._rerank_cache_parts()
        chunk = min(cap, util.next_pow2(max(16384, (1 << 27) // max(d, 1))))
        dec = None if self._code_domain else torch.zeros(
            (cap, d), dtype=self._aux["decoded"][1], device=self.device)
        nrm = torch.zeros((cap, 1), dtype=torch.float32, device=self.device)
        sc = torch.zeros((cap, 1), dtype=torch.float32, device=self.device) \
            if self._int8_cache else None
        codes = self._codes_view()
        starts = self._cell_start.long()
        for c0 in range(0, cap, chunk):
            db = self._decode_stored(codes[c0:c0 + chunk])
            if self.pq_use_residual:
                idx = torch.arange(c0, c0 + db.shape[0], device=self.device)
                cell = (torch.searchsorted(starts, idx, right=True) - 1) \
                    .clamp(0, starts.shape[0] - 1)
                db = db + self._coarse_cb()[cell]
            if rr_store is not None:
                db = db + decode_codes(rr_store[c0:c0 + chunk],
                                       rr_cb).float()
            nrm[c0:c0 + chunk, 0] = torch.sum(db * db, dim=-1)
            if sc is not None:
                db, sc[c0:c0 + chunk, 0] = util.int8_quantize_rows(db)
            if dec is not None:
                dec[c0:c0 + chunk] = util.pad_cols(db, d).to(dec.dtype)
        if dec is None:
            return {"norm": nrm}
        out = {"decoded": dec, "norm": nrm}
        if sc is not None:
            out["scale"] = sc
        return out

    def _pack_codes(self, codes_nm):
        """Codec codes [n, m] -> the stored bytes [n, code_size]: at 4 bits
        two codes per byte (codec/pq.py:pack_nibbles)."""
        if self.n_bits == 8:
            return codes_nm
        return pack_nibbles(codes_nm.T).T

    @property
    def _scan_codebook(self):
        """The codebook of the stored bytes: at 8 bits the PQ codebook
        itself, at 4 bits its byte-pair view (codec/pq.py:paired_codebook),
        built once per codebook: the cache is keyed on the tensor and its
        version counter, so a load (a new tensor) and an in-place change
        both rebuild it."""
        cb = self.pq_codec.codebook_internal
        if self.n_bits == 8:
            return cb
        cached = getattr(self, "_paired_cb", None)
        if cached is None or cached[0] is not cb or cached[1] != cb._version:
            cached = (cb, cb._version, paired_codebook(cb))
            self._paired_cb = cached
        return cached[2]

    @property
    def _m_packed(self):
        """Per-slot code width to hand the code-domain scans when the
        storage is the packed [cap/g, g*m] layout, else None."""
        return self.code_size if self.pack_group > 1 else None

    def _decode_stored(self, codes):
        """Stored bytes [n, code_size] -> [n, d] f32 PQ reconstruction,
        against the codebook of the stored bytes."""
        return decode_codes(util.as_tensor(codes, self.device),
                            self._scan_codebook).float()

    # ---- frozen code-domain storage ----
    def freeze_codes(self):
        """Block mutation of a code-domain index (ivfpq.py:847-882). Packed
        storage makes this a flag flip; a pack_ingest=False index is first
        re-viewed as [cap/g, g*m] rows (the same bytes: no copy). A no-op
        when the code width cannot pack (g = 128 // m must divide 16)."""
        if not self._code_domain:
            raise ValueError("freeze_codes is for scan_cache_dtype='none'")
        if self._frozen_codes:
            return
        m = self.code_size
        g = 128 // m if (8 <= m < 128 and 128 % m == 0) else 1
        if g == 1 or self._capacity % g:
            return
        if self.pack_group == 1:
            self.register_state("_storage", self._storage.view(
                self._capacity // g, g * m))
            self.pack_group = g
            self._mutations += 1  # invalidate layout-derived caches
        self._frozen_codes = True

    def unfreeze_codes(self):
        """Re-enable mutation; the storage stays packed."""
        self._frozen_codes = False

    def _assert_unfrozen(self, what):
        if self._frozen_codes:
            raise RuntimeError(
                f"{what} on a frozen code-domain index: call "
                "unfreeze_codes() first")

    # ---- ingestion ----
    def add(self, x, ids=None, return_address=False):
        """x: [d_vector, n]. Coarse assignment, PQ encode, container write
        of the codes with their decoded rows and norms."""
        self._assert_unfrozen("add")
        assert self.is_trained, "train the index first"
        cells, codes_nm, decoded = self._encode_rows(self._prep(x))
        norms = torch.sum(decoded * decoded, dim=-1, keepdim=True)
        aux_rows = {"norm": norms}
        if self._int8_cache:
            q, scale = util.int8_quantize_rows(decoded)
            aux_rows["decoded"] = util.pad_cols(q, self._d_cache)
            aux_rows["scale"] = scale[:, None]
        elif not self._code_domain:
            aux_rows["decoded"] = util.pad_cols(decoded, self._d_cache)
        return super().add(self._pack_codes(codes_nm).T, cells, ids=ids,
                           return_address=return_address, aux_rows=aux_rows)

    def _encode_rows(self, x):
        """Prepared x [d_vector, n] -> (cells [n], PQ codes [n, m], the
        rows' reconstruction [n, d] f32). With pq_use_residual the codes
        are the residual's from the assigned cell's centroid, and the row
        is centroid + PQ reconstruction, summed in the JAX package's
        order."""
        cells = self._assign_cells(x)
        if self.pq_use_residual:
            recon = self.vq_codec.decode(cells).T
            codes_nm = self.pq_codec.encode_nd(x.T - recon)
            return cells, codes_nm, recon + self.pq_codec.decode_nd(codes_nm)
        codes_nm = self.pq_codec.encode_nd(x.T)
        return cells, codes_nm, self.pq_codec.decode_nd(codes_nm)

    def _assign_cells(self, x):
        """Coarse cells of x [d_vector, n] (ivfpq.py:810-846): the argmax
        cell, or with spill (spill_cells > 1 and a spill_capacity) each
        item's best cell below the capacity among its spill_cells best. The
        top cells are an exact top-k, as approx_max_k is off the TPU.

        spill_impl "device" routes on the device (ops/spill.py); any other
        value on the host: the [n, l] top cells cross as int16 where the
        cell ids fit, then the native greedy (native.spill_assign) walks the
        items in arrival order against a copy of the host cell sizes, which
        the container keeps in step with every add and remove."""
        if self.spill_cells <= 1 or self.spill_capacity is None:
            return self.vq_codec.encode(x)
        _, top = topk_sim(x.T, self._coarse_cb(), self.spill_cells,
                          "euclidean")
        cap = int(self.spill_capacity)
        if self.spill_impl == "device":
            cells, _ = spill_assign_device(top, self._cell_size, cap=cap,
                                           n_cells=self.n_cells)
            return cells
        if self.n_cells <= 32767:
            top = top.to(torch.int16)
        cells, _ = native.spill_assign(top.cpu().numpy(),
                                       self._cell_size_np.copy(), cap)
        return torch.as_tensor(cells, device=self.device)

    def remove(self, ids=None, address=None):
        self._assert_unfrozen("remove")
        return super().remove(ids=ids, address=address)

    # ---- search ----
    def _aux_col0(self, name):
        return self.aux(name)[:, 0]

    def _coarse_cb(self):
        return self.vq_codec.kmeans._centroids[0]

    def _scales(self):
        """The int8 tier's per-slot scales [cap] (None in other tiers)."""
        return self._aux_col0("scale") if self._int8_cache else None

    def _cell_compacted(self):
        """Cell-aware compacted layout, rebuilt lazily per mutation:
        (decoded, norms, is_empty, addr_map, scales, cell_start_live,
        cell_size_live, s_live). Live rows packed per cell into 16-aligned
        segments, so the probed scans run with s_max = the largest live cell
        (rounded up to 128) instead of the largest capacity. scales is None
        outside the int8 tier."""
        ver = self._mutations
        if self._compact_cache is not None and self._compact_cache[0] == ver:
            return self._compact_cache[1]
        sizes = np.asarray(self._cell_size_np, dtype=np.int64)
        caps16 = ((sizes + 15) // 16) * 16
        new_start = np.zeros_like(caps16)
        np.cumsum(caps16[:-1], out=new_start[1:])
        total = int(caps16.sum())
        unit = 131072 if total > 131072 else 2048
        n_pad = util.round_up(max(total, 16), unit)
        s_live = min(util.round_up(max(int(caps16.max()), 16), 128), n_pad)
        new_start_t = torch.as_tensor(new_start, dtype=torch.int32,
                                      device=self.device)
        res = _compact_cells_cache(
            self.aux("decoded"), self._aux_col0("norm"), self._scales(),
            self._is_empty, self._cell_start, new_start_t, n_pad) + (
            new_start_t,
            torch.as_tensor(sizes, dtype=torch.int32, device=self.device),
            s_live)
        self._compact_cache = (ver, res)
        return res

    def _use_compact_scan(self):
        """Route probed scans through the compacted layout when it shrinks
        the window by >= 1.25x and the copy stays under 4 GiB."""
        if self.scan_compact is True:
            return True
        if self.scan_compact is False or self._code_domain:
            return False
        sizes = self._cell_size_np
        if sizes.max() == 0:
            return False
        caps16 = ((int(sizes.max()) + 15) // 16) * 16
        s_live = min(((caps16 + 127) // 128) * 128, self.capacity)
        itemsize = self.aux("decoded").element_size()  # 1 B in the int8 tier
        copy_bytes = int(sizes.sum()) * 1.1 * (self.d_vector * itemsize + 8)
        return s_live * 1.25 <= self.max_cell_capacity \
            and copy_bytes <= 4 * (1 << 30)

    def _flat_compacted(self):
        """(decoded, norms, is_empty, addr_map, scales) for the flat sweep,
        with dead slots squeezed out unless capacity is already tight."""
        ver = self._mutations
        if self._flat_cache is not None and self._flat_cache[0] == ver:
            return self._flat_cache[1]
        n = max(int(self.n_items), 1)
        unit = 131072 if n > 131072 else 2048
        n_pad = util.round_up(n, unit)
        if n_pad * 8 >= self.capacity * 7:
            res = (self.aux("decoded"), self._aux_col0("norm"),
                   self._is_empty, None, self._scales())
        elif self._use_compact_scan():
            res = self._cell_compacted()[:5]
        else:
            res = _compact_flat_cache(self.aux("decoded"),
                                      self._aux_col0("norm"),
                                      self._is_empty, n_pad, self._scales())
        self._flat_cache = (ver, res)
        return res

    def _flat_compacted_codes(self):
        """(codes, norms, is_empty, addr_map, m_packed) for the code-domain
        flat sweep (ivfpq.py:1006-1034): live rows compacted into unpacked
        [n_pad, m] codes, unless capacity is already tight or the storage is
        packed and over 1 GiB (then dead slots ride the penalty). m_packed
        is the per-slot code width when the packed storage is returned."""
        ver = self._mutations
        if self._flat_cache is not None and self._flat_cache[0] == ver:
            return self._flat_cache[1]
        g = self.pack_group
        n = max(int(self.n_items), 1)
        unit = 131072 if n > 131072 else 2048
        n_pad = util.round_up(n, unit)
        big = self._storage.numel() > (1 << 30)
        if n_pad >= self.capacity or (g > 1 and big):
            res = (self._storage, self._aux_col0("norm"), self._is_empty,
                   None, self._m_packed)
        else:
            res = _compact_flat_cache(self._codes_view(),
                                      self._aux_col0("norm"),
                                      self._is_empty, n_pad)[:4] + (None,)
        self._flat_cache = (ver, res)
        return res

    def _codes_kernel_eligible(self):
        """The planner's mirror of the codes-kernel gate: the same shape
        predicate the scan dispatch uses (ops/codes_scan.py)."""
        if self.pack_group <= 1:
            return False
        return codes_kernel_static_gate(self.code_size, self.pack_group,
                                        self.d_vector, self.distance)

    def _resolved_probe_cap(self, n_probe):
        """The probe cap of a search at n_probe (ivfpq.py:1130-1138): None
        unless grouping and an approx select are on; "auto" is 2x the
        supercells n_probe cells span, at least 8; a cap >= n_probe is
        None."""
        cap = self.scan_probe_cap
        if cap is None or self.scan_group <= 1 or not self._use_approx_topk:
            return None
        if cap == "auto":
            cap = max(2 * util.cdiv(n_probe, self.scan_group), 8)
        cap = int(cap)
        return cap if cap < n_probe else None

    def _plan_tier(self):
        """The planner's tier: "codes", "int8", or the cache's dtype."""
        if self._code_domain:
            return "codes"
        if self._int8_cache:
            return "int8"
        return "float32" if self.aux("decoded").dtype == torch.float32 \
            else "bf16"

    def plan_scan_mode(self, nq, k):
        """The plan `search` runs for nq queries at this k: 'flat',
        'cell_major' or 'query_major'; scan_mode != 'auto' pins it.

        "auto" decides from the host shadows by plan_for: on a CPU index
        the JAX package's rule and TPU v5e crossovers (ivfpq.py:1140-1197);
        on a CUDA index the card's measured costs (CARD_PLAN_COSTS)."""
        mode = self.scan_mode
        if mode != "auto":
            return mode
        return plan_for(int(nq), int(k), **self._plan_shadows())

    def _search_precision(self):
        """The search products' precision (ivfpq.py:945-946): the search
        precision with use_tensor_core, else "highest"."""
        return config.resolve_precision(
            None if self._use_tensor_core else "highest")

    def _plan_shadows(self):
        """plan_for's keyword arguments from this index's host shadows."""
        return dict(
            n_probe=min(self.n_probe, self.n_cells),
            s_pow2=util.next_pow2(self.max_cell_capacity),
            n_items=int(self.n_items), d_vector=self.d_vector,
            tier=self._plan_tier(), approx=self._use_approx_topk,
            codes_kernel=self._code_domain and self._codes_kernel_eligible(),
            device=self.device,
            batch_threshold=self._ivfpq_topk.batch_threshold,
            precision=self._search_precision())

    def search(self, x, k=1, return_address=False):
        """x: [d_vector, nq] -> (values [nq, k] f32, ids [nq, k]); with
        return_address also the storage addresses."""
        adc.check_impl(self.scan_impl)
        q = self._prep(x).T.contiguous()
        nq = q.shape[0]
        k = int(k)
        n_probe = min(self.n_probe, self.n_cells)
        precision = self._search_precision()
        mode = self.plan_scan_mode(nq, k)
        if self._code_domain:
            # every non-flat plan, query_major included, runs the codes
            # cell-major scan, as in the JAX package
            if mode == "flat":
                codes, nrm, emp, amap, m_c = self._flat_compacted_codes()
                out = _search_flat_codes(
                    q, codes, nrm, emp, amap, self._address2id,
                    self._scan_codebook, k=k, distance=self.distance, m=m_c,
                    precision=precision)
            else:
                out = _search_full_codes(
                    q, self._coarse_cb(), self._storage,
                    self._aux_col0("norm"), self._is_empty, self._cell_start,
                    self._cell_capacity, self._address2id,
                    self._scan_codebook, self._smart_probing_temperature,
                    k=k, n_probe=n_probe, use_smart=self._use_smart_probing,
                    distance=self.distance, s_max=self.max_cell_capacity,
                    n_cells=self.n_cells, approx=self._use_approx_topk,
                    m=self._m_packed, impl=self.scan_impl,
                    k_pair=self.scan_k_pair, precision=precision)
        elif mode == "flat":
            dec, nrm, emp, amap, sc = self._flat_compacted()
            out = _search_flat(q, dec, nrm, emp, amap, self._address2id,
                               k=k, distance=self.distance,
                               approx=self._use_approx_topk,
                               impl=self.scan_impl, scales=sc,
                               precision=precision)
        else:
            # the int8 tier's probed plans live in the cell-major scan
            kw = dict(k=k, n_probe=n_probe,
                      use_smart=self._use_smart_probing,
                      distance=self.distance, n_cells=self.n_cells,
                      mode="cell_major" if self._int8_cache else mode,
                      approx=self._use_approx_topk, impl=self.scan_impl,
                      group=self.scan_group,
                      probe_cap=self._resolved_probe_cap(n_probe),
                      k_pair=self.scan_k_pair,
                      merge_taper=self.scan_merge_taper,
                      super_probe=self.scan_super_probe,
                      split_taper=self.scan_split_taper, precision=precision)
            if self._use_compact_scan():
                dec, nrm, emp, amap, sc, cs, sz, s_live = \
                    self._cell_compacted()
                out = _search_full(
                    q, self._coarse_cb(), dec, nrm, emp, cs, sz,
                    self._address2id, self._smart_probing_temperature,
                    s_max=s_live, scales=sc, addr_map=amap, **kw)
            else:
                out = _search_full(
                    q, self._coarse_cb(), self.aux("decoded"),
                    self._aux_col0("norm"), self._is_empty, self._cell_start,
                    self._cell_capacity, self._address2id,
                    self._smart_probing_temperature,
                    s_max=self.max_cell_capacity, scales=self._scales(),
                    **kw)
        vals, ids, addr = out
        if return_address:
            return vals, ids, addr
        return vals, ids

    def search_cells(self, x, cells, probe_mask=None, k=1,
                     return_address=False):
        """Scan explicit cells per query: x [d_vector, nq], cells
        [nq, n_probe] (distinct per row), through the IVFPQTopk facade,
        with the index's scan_group and probe cap; as in the JAX package
        (ivfpq.py:932-965), no merge taper, split or supercell-native
        probing."""
        adc.check_impl(self.scan_impl)
        q = self._prep(x).T.contiguous()
        cells = util.as_tensor(cells, self.device).int()
        if probe_mask is None:
            probe_mask = torch.ones(cells.shape, dtype=torch.bool,
                                    device=self.device)
        code = self._code_domain
        vals, addr = self._ivfpq_topk.topk(
            q, cells, util.as_tensor(probe_mask, self.device).bool(),
            self._storage if code else self.aux("decoded"),
            self._aux_col0("norm"), self._is_empty,
            self._cell_start, self._cell_capacity, k=int(k),
            distance=self.distance, s_max=self.max_cell_capacity,
            mode=self.scan_mode, scales=self._scales(), impl=self.scan_impl,
            group=self.scan_group,
            probe_cap=self._resolved_probe_cap(cells.shape[1]),
            pq_codebook=self._scan_codebook if code else None,
            m=self._m_packed if code else None,
            precision=self._search_precision())
        ids, addr = _translate(addr, None, self._address2id)
        if return_address:
            return vals, ids, addr
        return vals, ids

    # ---- rescoring ----
    def similarity_at_address(self, x, address):
        """Similarity of each query with the stored vector at each address
        [n] -> [nq, n], scored as search scores it; -inf where empty."""
        q = self._prep(x).T
        address = util.as_tensor(address, self.device).long()
        valid = (address >= 0) & (address < self._capacity)
        safe = torch.where(valid, address, 0)
        valid = valid & ~self._is_empty[safe]
        if self._code_domain:
            # no cache: decode the requested rows from their codes (f32)
            y = self._decode_stored(self.storage_rows(safe))
        else:
            y = self.aux("decoded")[safe]
        if self._int8_cache:
            # dequantized: the int8 row times its scale (ivfpq.py:1317-1318)
            y = y.float() * self.aux("scale")[safe]
        q = util.pad_cols(q, y.shape[-1])
        if self.distance == "manhattan":
            sims = negative_manhattan_distance(q, y.float())
            return torch.where(valid[None, :], sims, -torch.inf)
        # the f32 query at the search precision, as the JAX package
        sims = util.matmul(q, y)
        if self.distance == "euclidean":
            sims = 2.0 * sims - self.aux("norm")[safe, 0][None, :] \
                - torch.sum(q * q, -1)[:, None]
        return torch.where(valid[None, :], sims, -torch.inf)

    def similarity_at_id(self, x, ids):
        """similarity_at_address at the addresses of `ids` [n]."""
        return self.similarity_at_address(x, self.get_address_by_id(ids))
