"""IVFPQ index — the main user-facing ANN index (counterpart of
torchpq_tpu/index/ivfpq.py).

Beside the canonical uint8 codes the index keeps a bf16 decoded cache (the
PQ reconstruction) and per-slot squared norms as aux row stores, so ADC
scoring is a product against the cache. Search runs one of three plans:
`cell_major` (coarse probe -> pack (query, cell) pairs into blocks -> block
scan -> merge), `query_major` (gather each query's windows) and `flat` (a
sweep over the compacted cache). The reference's [d_vector, n_data] layout
holds at every public method.

Settings the JAX package supports but this port does not yet raise
NotImplementedError naming their ROADMAP item; none silently takes another
path.
"""

import numpy as np
import torch

from .. import config
from .. import util
from ..metric import canonical_distance, negative_squared_l2_distance
from ..codec import PQCodec, VQCodec
from ..container import CellContainer
from ..fn.ivfpq_topk import IVFPQTopk
from ..ops import adc
from ..ops.block_scan import BIG
from ..ops.flat_adc import flat_adc_scan


def _coarse_probe(query, coarse_codebook, temperature, *, n_probe,
                  use_smart):
    """Coarse scoring + cell selection + smart-probing mask (ivfpq.py:37-70).

    Scores are float32 negative squared L2 against the coarse codebook.
    Smart probing keeps ceil(normalized_entropy * n_probe) cells per query,
    with p = softmax(-sqrt|sims| / T). The JAX package's approx_max_k is
    exact off the TPU, so cells are an exact top-k here."""
    sims = negative_squared_l2_distance(query, coarse_codebook)
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


def _compact_cells_cache(decoded, norms, is_empty, cell_start, new_start,
                         n_pad):
    """Pack each cell's live rows into a contiguous segment of a fresh
    [n_pad, d] cache starting at new_start[c] (ivfpq.py:122-155).
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
    return _gather_compact(decoded, norms, aidx, dest, n_pad)


def _compact_flat_cache(decoded, norms, is_empty, n_pad):
    """Live rows in address order, padded to n_pad (ivfpq.py:158-174)."""
    aidx = torch.nonzero(~is_empty).flatten()
    dest = torch.arange(aidx.shape[0], device=aidx.device)
    return _gather_compact(decoded, norms, aidx, dest, n_pad)


def _gather_compact(decoded, norms, src, dest, n_pad):
    """Rows src -> positions dest (n_pad drops) of a fresh cache."""
    addr_map = torch.full((n_pad + 1,), -1, dtype=torch.long,
                          device=decoded.device)
    addr_map[dest] = src
    addr_map = addr_map[:n_pad]
    valid = addr_map >= 0
    safe = addr_map.clamp(min=0)
    return (decoded[safe].contiguous(), norms[safe].contiguous(), ~valid,
            addr_map.int())


def _translate(addr, addr_map, address2id):
    """Compact addresses -> storage addresses -> ids (-1 stays -1)."""
    if addr_map is not None:
        addr = torch.where(addr >= 0, addr_map[addr.long().clamp(min=0)], -1)
    ids = torch.where(addr >= 0, address2id[addr.long().clamp(min=0)], -1)
    return ids, addr.int()


def _search_flat(q, decoded, norms, is_empty, addr_map, address2id, *, k,
                 distance):
    """Flat plan: exhaustive sweep + address translation."""
    penalty = torch.where(is_empty, BIG,
                          norms.float() if distance == "euclidean" else 0.0)
    vals, addr = flat_adc_scan(q, decoded, penalty.float(), k=k,
                               distance=distance)
    ids, addr = _translate(addr, addr_map, address2id)
    return vals, ids, addr


def _search_full(q, coarse_codebook, decoded, norms, is_empty, cell_start,
                 cell_capacity, address2id, temperature, *, k, n_probe,
                 use_smart, distance, s_max, n_cells, mode, approx,
                 addr_map=None):
    """Probed plans: coarse probe + scan + id translation."""
    _, cells, mask = _coarse_probe(q, coarse_codebook, temperature,
                                   n_probe=n_probe, use_smart=use_smart)
    if mode == "query_major":
        vals, addr = adc.scan_query_major(
            q, cells, mask, decoded, norms, is_empty, cell_start,
            cell_capacity, k=k, distance=distance, s_max=s_max)
    else:
        vals, addr = adc.scan_cell_major(
            q, cells, mask, decoded, norms, is_empty, cell_start,
            cell_capacity, k=k, distance=distance, s_max=s_max,
            n_cells=n_cells, approx=approx)
    ids, addr = _translate(addr, addr_map, address2id)
    return vals, ids, addr


class IVFPQIndex(CellContainer):
    def __init__(self, d_vector, n_subvectors=8, n_cells=128,
                 initial_size=None, expand_step_size=128,
                 expand_mode="double", distance="euclidean", device=None,
                 pq_use_residual=False, verbose=0, scan_cache_dtype=None,
                 scan_mode="auto", n_bits=8, seed=0, anisotropic_eta=None,
                 pack_ingest=None):
        assert d_vector % n_subvectors == 0
        cache_dtype = str(scan_cache_dtype or config.SCAN_CACHE_DTYPE)
        if cache_dtype in ("int8", "none"):
            raise NotImplementedError(
                f"scan_cache_dtype={cache_dtype!r} is not ported yet "
                f"(ROADMAP {'A9' if cache_dtype == 'int8' else 'A11'})")
        if n_bits != 8:
            raise NotImplementedError("n_bits=4 is not ported yet "
                                      "(ROADMAP A12)")
        if pq_use_residual:
            raise NotImplementedError("pq_use_residual is not ported yet "
                                      "(ROADMAP A12)")
        if anisotropic_eta is not None:
            raise NotImplementedError("anisotropic PQ is not ported yet "
                                      "(ROADMAP A12)")
        if canonical_distance(distance) == "manhattan":
            raise NotImplementedError(
                "manhattan distance is not ported yet (ROADMAP A12)")
        self.n_bits = 8
        if initial_size is None:
            initial_size = expand_step_size
        eligible = 8 <= n_subvectors < 128 and 128 % n_subvectors == 0
        if pack_ingest is None:
            pack_ingest = eligible
        elif pack_ingest and not eligible:
            raise ValueError(
                "pack_ingest requires 8 <= code bytes < 128 dividing 128")
        super().__init__(
            code_size=n_subvectors, n_cells=n_cells, dtype="uint8",
            device=device, initial_size=initial_size,
            expand_step_size=expand_step_size, expand_mode=expand_mode,
            use_inverse_id_mapping=True, verbose=verbose,
            pack_group=128 // n_subvectors if pack_ingest else 1)
        self.d_vector = d_vector
        self.n_subvectors = n_subvectors
        self.d_subvector = d_vector // n_subvectors
        self.distance = canonical_distance(distance)
        self.pq_use_residual = False
        self.n_probe = 1
        self._use_smart_probing = True
        self._smart_probing_temperature = 30.0
        self._use_approx_topk = False
        self.scan_mode = scan_mode
        # deep-k / grouping / spill settings of the JAX package; only their
        # off values are ported (checked at add / search)
        self.spill_cells = 1
        self.scan_group = 1
        self.scan_probe_cap = None
        self.scan_k_pair = None
        self.scan_merge_taper = None
        self.register_state("_frozen_codes", False)
        # cache width: lane-padded to a multiple of 128 above d=128, as in
        # the JAX package's state format (zero columns score nothing)
        self._d_cache = (util.round_up(d_vector, 128) if d_vector > 128
                         else d_vector)
        self.add_aux_store("decoded", self._d_cache, cache_dtype)
        self.add_aux_store("norm", 1, "float32")
        # the codec hyperparameters of the reference (IVFPQIndex.py:63-79)
        self.register_module("vq_codec", VQCodec(
            n_clusters=n_cells, n_redo=1, max_iter=15, tol=1e-4,
            distance="euclidean", init_mode="random", verbose=verbose,
            seed=seed, device=device))
        self.register_module("pq_codec", PQCodec(
            d_vector=d_vector, n_subvectors=n_subvectors, n_clusters=256,
            distance=distance, verbose=verbose, seed=seed, device=device))
        self._ivfpq_topk = IVFPQTopk(n_cells=n_cells, mode=scan_mode)
        # (mutation counter, layout) caches of the compacted scan layouts
        self._flat_cache = None
        self._compact_cache = None
        self.scan_compact = "auto"
        self.set_aux_rebuilder(("decoded", "norm"), self._rebuild_scan_cache)

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
    def is_trained(self):
        return self.vq_codec.is_trained and self.pq_codec.is_trained

    def _check_ported(self, what):
        unported = [
            ("spill_cells > 1", self.spill_cells > 1, "A15"),
            ("scan_group > 1", self.scan_group != 1, "A10"),
            ("scan_probe_cap", self.scan_probe_cap is not None, "A10"),
            ("scan_k_pair", self.scan_k_pair is not None, "A10"),
            ("scan_merge_taper", self.scan_merge_taper is not None, "A10"),
        ]
        for name, on, item in unported:
            if on:
                raise NotImplementedError(
                    f"{what} with {name} is not ported yet (ROADMAP {item})")

    def _prep(self, x):
        x = util.as_tensor(x, self.device, torch.float32)
        assert x.shape[0] == self.d_vector
        if self.distance == "cosine":
            x = util.normalize(x, dim=0)
        return x

    # ---- training ----
    def train(self, x, force_retrain=False):
        """x: [d_vector, n]. VQ k-means, the locality relabel of the cells
        (util.locality_order, as in the JAX package), then PQ k-means."""
        if self.is_trained and not force_retrain:
            self.print_message("index is already trained", 1)
            return
        x = self._prep(x)
        self.vq_codec.train(x)
        km = self.vq_codec.kmeans
        order = util.locality_order(km._centroids[0].cpu().numpy())
        km.register_state("_centroids", km._centroids[
            :, torch.as_tensor(order, device=self.device)].contiguous())
        self.pq_codec.train(x)

    def _rebuild_scan_cache(self):
        """Recompute decoded/norm from the canonical codes in chunks.
        Never-written slots decode to garbage; every reader masks them."""
        cap, d = self._capacity, self._d_cache
        chunk = min(cap, util.next_pow2(max(16384, (1 << 27) // max(d, 1))))
        dec = torch.zeros((cap, d), dtype=self._aux["decoded"][1],
                          device=self.device)
        nrm = torch.zeros((cap, 1), dtype=torch.float32, device=self.device)
        codes = self._codes_view()
        for c0 in range(0, cap, chunk):
            db = self.pq_codec.decode_nd(codes[c0:c0 + chunk])
            nrm[c0:c0 + chunk, 0] = torch.sum(db * db, dim=-1)
            dec[c0:c0 + chunk] = util.pad_cols(db, d).to(dec.dtype)
        return {"decoded": dec, "norm": nrm}

    # ---- ingestion ----
    def add(self, x, ids=None, return_address=False):
        """x: [d_vector, n]. Coarse assignment, PQ encode, container write
        of the codes with their decoded rows and norms."""
        self._check_ported("add")
        if self._frozen_codes:
            raise RuntimeError("add on a frozen index")
        assert self.is_trained, "train the index first"
        x = self._prep(x)
        cells = self.vq_codec.encode(x)
        codes_nm = self.pq_codec.encode_nd(x.T)
        decoded = self.pq_codec.decode_nd(codes_nm)
        norms = torch.sum(decoded * decoded, dim=-1, keepdim=True)
        aux_rows = {"norm": norms,
                    "decoded": util.pad_cols(decoded, self._d_cache)}
        return super().add(codes_nm.T, cells, ids=ids,
                           return_address=return_address, aux_rows=aux_rows)

    def remove(self, ids=None, address=None):
        if self._frozen_codes:
            raise RuntimeError("remove on a frozen index")
        return super().remove(ids=ids, address=address)

    # ---- search ----
    def _aux_col0(self, name):
        return self.aux(name)[:, 0]

    def _coarse_cb(self):
        return self.vq_codec.kmeans._centroids[0]

    def _cell_compacted(self):
        """Cell-aware compacted layout, rebuilt lazily per mutation:
        (decoded, norms, is_empty, addr_map, cell_start_live, cell_size_live,
        s_live). Live rows packed per cell into 16-aligned segments, so the
        probed scans run with s_max = the largest live cell (rounded up to
        128) instead of the largest capacity."""
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
        dec, nrm, emp, amap = _compact_cells_cache(
            self.aux("decoded"), self._aux_col0("norm"), self._is_empty,
            self._cell_start, new_start_t, n_pad)
        res = (dec, nrm, emp, amap, new_start_t,
               torch.as_tensor(sizes, dtype=torch.int32, device=self.device),
               s_live)
        self._compact_cache = (ver, res)
        return res

    def _use_compact_scan(self):
        """Route probed scans through the compacted layout when it shrinks
        the window by >= 1.25x and the copy stays under 4 GiB."""
        if self.scan_compact is True:
            return True
        if self.scan_compact is False:
            return False
        sizes = self._cell_size_np
        if sizes.max() == 0:
            return False
        caps16 = ((int(sizes.max()) + 15) // 16) * 16
        s_live = min(((caps16 + 127) // 128) * 128, self.capacity)
        itemsize = self.aux("decoded").element_size()
        copy_bytes = int(sizes.sum()) * 1.1 * (self.d_vector * itemsize + 8)
        return s_live * 1.25 <= self.max_cell_capacity \
            and copy_bytes <= 4 * (1 << 30)

    def _flat_compacted(self):
        """(decoded, norms, is_empty, addr_map) for the flat sweep, with
        dead slots squeezed out unless capacity is already tight."""
        ver = self._mutations
        if self._flat_cache is not None and self._flat_cache[0] == ver:
            return self._flat_cache[1]
        n = max(int(self.n_items), 1)
        unit = 131072 if n > 131072 else 2048
        n_pad = util.round_up(n, unit)
        if n_pad * 8 >= self.capacity * 7:
            res = (self.aux("decoded"), self._aux_col0("norm"),
                   self._is_empty, None)
        elif self._use_compact_scan():
            res = self._cell_compacted()[:4]
        else:
            res = _compact_flat_cache(self.aux("decoded"),
                                      self._aux_col0("norm"),
                                      self._is_empty, n_pad)
        self._flat_cache = (ver, res)
        return res

    def plan_scan_mode(self, nq, k):
        """The plan `search` runs for nq queries at this k: 'flat',
        'cell_major' or 'query_major'; scan_mode != 'auto' pins it.

        The structure is the JAX package's (ivfpq.py:1140-1197). Its
        crossover multipliers (128x, 512x) were measured on a TPU v5e and
        are not yet re-derived for the H100: pin scan_mode to choose."""
        mode = self.scan_mode
        if mode != "auto":
            return mode
        n_probe = min(self.n_probe, self.n_cells)
        mode = ("query_major" if nq < self._ivfpq_topk.batch_threshold
                else "cell_major")
        touched = n_probe * util.next_pow2(self.max_cell_capacity)
        n_live = max(int(self.n_items), 1)
        if int(k) <= 32 or self.d_vector >= 512:
            if self._use_approx_topk and touched * 128 >= n_live:
                mode = "flat"
        elif touched * 512 >= n_live:
            mode = "flat"
        return mode

    def search(self, x, k=1, return_address=False):
        """x: [d_vector, nq] -> (values [nq, k] f32, ids [nq, k]); with
        return_address also the storage addresses."""
        self._check_ported("search")
        q = self._prep(x).T.contiguous()
        nq = q.shape[0]
        k = int(k)
        n_probe = min(self.n_probe, self.n_cells)
        mode = self.plan_scan_mode(nq, k)
        if mode == "flat":
            dec, nrm, emp, amap = self._flat_compacted()
            out = _search_flat(q, dec, nrm, emp, amap, self._address2id,
                               k=k, distance=self.distance)
        else:
            kw = dict(k=k, n_probe=n_probe,
                      use_smart=self._use_smart_probing,
                      distance=self.distance, n_cells=self.n_cells,
                      mode=mode, approx=self._use_approx_topk)
            if self._use_compact_scan():
                dec, nrm, emp, amap, cs, sz, s_live = self._cell_compacted()
                out = _search_full(
                    q, self._coarse_cb(), dec, nrm, emp, cs, sz,
                    self._address2id, self._smart_probing_temperature,
                    s_max=s_live, addr_map=amap, **kw)
            else:
                out = _search_full(
                    q, self._coarse_cb(), self.aux("decoded"),
                    self._aux_col0("norm"), self._is_empty, self._cell_start,
                    self._cell_capacity, self._address2id,
                    self._smart_probing_temperature,
                    s_max=self.max_cell_capacity, **kw)
        vals, ids, addr = out
        if return_address:
            return vals, ids, addr
        return vals, ids

    def search_cells(self, x, cells, probe_mask=None, k=1,
                     return_address=False):
        """Scan explicit cells per query: x [d_vector, nq], cells
        [nq, n_probe] (distinct per row), through the IVFPQTopk facade."""
        self._check_ported("search_cells")
        q = self._prep(x).T.contiguous()
        cells = util.as_tensor(cells, self.device).int()
        if probe_mask is None:
            probe_mask = torch.ones(cells.shape, dtype=torch.bool,
                                    device=self.device)
        vals, addr = self._ivfpq_topk.topk(
            q, cells, util.as_tensor(probe_mask, self.device).bool(),
            self.aux("decoded"), self._aux_col0("norm"), self._is_empty,
            self._cell_start, self._cell_capacity, k=int(k),
            distance=self.distance, s_max=self.max_cell_capacity,
            mode=self.scan_mode)
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
        y = self.aux("decoded")[safe]
        q = util.pad_cols(q, y.shape[-1])
        sims = util.matmul_f32(q, y)  # the f32 query, as the JAX package
        if self.distance == "euclidean":
            sims = 2.0 * sims - self.aux("norm")[safe, 0][None, :] \
                - torch.sum(q * q, -1)[:, None]
        return torch.where(valid[None, :], sims, -torch.inf)
