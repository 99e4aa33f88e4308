"""Sharded IVFPQ search, add and remove over the ranks of a mesh, and
data-parallel k-means and search (counterpart of
torchpq_tpu/parallel/sharded_ivfpq.py).

The JAX package runs one controller and a `shard_map` over the mesh; here
each rank is its own process and runs what the `local` body runs for its
mesh index. Every public call is collective: every rank of the mesh makes
it, with the same arguments, and gets the same replicated result (JAX's
out_specs=P()).

* IVF cells are assigned round-robin to shards (cell c -> shard c % D, local
  index c // D), so a query's probes spread evenly;
* the coarse codebook and the queries are replicated; each rank probes
  every cell, masks out the other ranks' cells, and scans its own through
  the port's scans (on the card: the block scan and codes scan kernels);
* the per-rank [nq, k] candidates merge through one all_gather and a local
  top-k over [nq, D * k].

Each rank keeps only its shard's stores, re-laid out on its own device from
a trained and filled IVFPQIndex that every rank passes (loaded from the
same .npz, for example). Adds compute their routing on the host from
shadows that every rank keeps identical: the coarse assignment is the same
computation on the same inputs in every rank. All three cache tiers shard:
bf16/f32 decoded, int8 (with per-slot scales), and the code domain
(`scan_cache_dtype='none'`: shards hold the uint8 codes, packed as the
index packs them, so the codes kernel serves them).
"""

import numpy as np
import torch
import torch.distributed as dist

from .. import util
from ..metric import canonical_distance
from ..ops import adc
from ..ops.block_scan import BIG
from ..ops.flat_adc import flat_adc_scan
from ..ops.max_sim import max_sim
from ..ops.onehot_adc import (flat_decode_scan, flat_onehot_scan,
                              scan_cell_major_codes)
from ..ops.segment_ops import compute_centroids
from .mesh import get_mesh, mesh_rank


def _all_gather_cat(x, group, d_count, dim):
    """x on every rank -> the ranks' x concatenated along `dim`, in rank
    order, on every rank."""
    parts = [torch.empty_like(x) for _ in range(d_count)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _merge(vals, lids, k, group, d_count):
    """Per-rank top-k candidates -> the mesh's top-k (replicated): one
    all_gather of values and ids ([nq, D * k], rank-major columns), then a
    top-k; dead entries get id -1."""
    gv = _all_gather_cat(vals.float(), group, d_count, 1)
    gi = _all_gather_cat(lids, group, d_count, 1)
    fv, fi = torch.topk(gv, k, dim=1)
    fids = torch.gather(gi, 1, fi)
    return fv, torch.where(torch.isfinite(fv), fids, -1)


class ShardedIVFPQSearcher:
    def __init__(self, index, mesh=None, scan_mode="cell_major", p_tile=128,
                 scan_group=1):
        self._int8 = bool(getattr(index, "_int8_cache", False))
        self._codes = bool(getattr(index, "_code_domain", False))
        assert not ((self._int8 or self._codes)
                    and scan_mode == "query_major"), \
            "int8/code-domain tiers have no query_major path: use " \
            "cell_major or flat"
        self.index = index
        self.mesh = mesh if mesh is not None else get_mesh()
        self.axis = self.mesh.mesh_dim_names[0]
        self.n_shards = self.mesh.size()
        self.rank = mesh_rank(self.mesh)
        self.group = self.mesh.get_group()
        self.device = index.device
        self.distance = index.distance
        self.scan_mode = scan_mode
        self.p_tile = p_tile
        self.scan_group = scan_group
        self._flat_sh = None  # compacted shard for flat mode
        self._build_state()

    # ---- state ----
    def _build_state(self):
        """Gather this rank's cells contiguously on its device; every rank
        computes the host shadows of every shard (sharded_ivfpq.py:207-299)."""
        idx, d_count, my, dev = self.index, self.n_shards, self.rank, \
            self.device
        n_cells = idx.n_cells
        caps = idx._cell_capacity_np.astype(np.int64)
        starts = idx._cell_start.cpu().numpy().astype(np.int64)
        self.cells_per_shard = c_loc = util.cdiv(n_cells, d_count)
        lstart = np.zeros((d_count, c_loc), np.int64)
        lcap = np.zeros((d_count, c_loc), np.int64)
        for s in range(d_count):
            reps = caps[s::d_count]
            lcap[s, :len(reps)] = reps
            lstart[s, :len(reps)] = np.cumsum(reps) - reps
        cap_sh = util.next_pow2(int(lcap.sum(axis=1).max()))

        # this shard's packed region reads source rows
        # repeat(starts - packed_prefix) + arange: one gather per store
        reps = lcap[my, :len(caps[my::d_count])]
        total = int(reps.sum())
        src = torch.repeat_interleave(
            torch.as_tensor(starts[my::d_count] - lstart[my, :len(reps)],
                            device=dev),
            torch.as_tensor(reps, device=dev)) \
            + torch.arange(total, device=dev)
        # the code domain shards the raw codes ([cap, m] rows of the packed
        # storage; `decoded` names the scan payload in every tier)
        payload = idx._codes_view() if self._codes else idx.aux("decoded")
        self.decoded = self._fresh(payload, cap_sh, 0)
        self.decoded[:total] = payload[src]
        self.norms = torch.zeros(cap_sh, dtype=torch.float32, device=dev)
        self.norms[:total] = idx.aux("norm")[src, 0]
        self.is_empty = torch.ones(cap_sh, dtype=torch.bool, device=dev)
        self.is_empty[:total] = idx._is_empty[src]
        self.ids = torch.full((cap_sh,), -1, dtype=util.ID_DTYPE, device=dev)
        self.ids[:total] = idx._address2id[src]
        self.scales = None
        if self._int8:
            self.scales = torch.zeros(cap_sh, dtype=torch.float32, device=dev)
            self.scales[:total] = idx.aux("scale")[src, 0]
        self.cell_start = torch.as_tensor(lstart[my], dtype=torch.int32,
                                          device=dev)
        self.cell_capacity = torch.as_tensor(lcap[my], dtype=torch.int32,
                                             device=dev)
        self.s_max = int(caps.max()) if n_cells else 1
        self.codebook = idx._coarse_cb()
        self.pq_cb = idx._scan_codebook if self._codes else None

        # host shadows for the sharded add's routing: the next free slot of
        # each local cell is one past its LAST live slot (holes left by
        # removals are not reused: they stay masked empty; an occupancy
        # count would point at a live slot and overwrite it)
        self._lstart_np = lstart
        self._lcap_np = lcap
        live = torch.nonzero(~idx._is_empty).flatten()
        starts_t = idx._cell_start.long()
        cell = torch.searchsorted(starts_t, live, right=True) - 1
        last = torch.zeros(n_cells, dtype=torch.long, device=dev)
        last.scatter_reduce_(0, cell, live - starts_t[cell] + 1, "amax")
        last = last.cpu().numpy()
        self._next_free = np.zeros((d_count, c_loc), np.int64)
        c = np.arange(n_cells)
        self._next_free[c % d_count, c // d_count] = last
        a2i = idx._address2id
        self._max_id = int(a2i.max()) + 1 if bool((a2i >= 0).any()) else 0

    def _fresh(self, like, rows, fill):
        return torch.full((rows,) + tuple(like.shape[1:]), fill,
                          dtype=like.dtype, device=self.device)

    def _stores(self):
        names = ["decoded", "norms", "is_empty", "ids"]
        return names + ["scales"] if self._int8 else names

    def _grow_local(self, need):
        """Re-lay out the shard stores with grown capacities for the local
        cells in `need` {(shard, local_cell): required}: pow2 growth, one
        re-layout for all (sharded_ivfpq.py:301-346; the counterpart of
        CellContainer._relayout). Every rank updates every shard's shadows
        and moves its own rows."""
        new_caps = self._lcap_np.copy()
        for (s, lc), req in need.items():
            new_caps[s, lc] = max(util.next_pow2(req), new_caps[s, lc])
        new_start = np.zeros_like(new_caps)
        new_start[:, 1:] = np.cumsum(new_caps[:, :-1], axis=1)
        cap_sh = util.next_pow2(int(new_caps.sum(axis=1).max()))
        my, dev = self.rank, self.device
        # the old layout is packed (cells back to back): old rows
        # [0, old_total) land at repeat(new_start - old_prefix) + arange
        old_caps = self._lcap_np[my]
        old_total = int(old_caps.sum())
        dst = torch.repeat_interleave(
            torch.as_tensor(new_start[my] - self._lstart_np[my], device=dev),
            torch.as_tensor(old_caps, device=dev)) \
            + torch.arange(old_total, device=dev)
        fills = {"decoded": 0, "norms": 0, "is_empty": True, "ids": -1,
                 "scales": 0}
        for name in self._stores():
            old = getattr(self, name)
            new = self._fresh(old, cap_sh, fills[name])
            new[dst] = old[:old_total]
            setattr(self, name, new)
        self.cell_start = torch.as_tensor(new_start[my], dtype=torch.int32,
                                          device=dev)
        self.cell_capacity = torch.as_tensor(new_caps[my], dtype=torch.int32,
                                             device=dev)
        self._lstart_np = new_start
        self._lcap_np = new_caps
        self.s_max = int(new_caps.max())
        self._flat_sh = None

    def _route_slots(self, cells):
        """(shard, slot) per item from its coarse cell, by vectorized
        run-length arithmetic (the sort + run-start trick of
        ops/spill.rank_in_group), never a Python iteration per distinct
        cell. Advances the next-free shadows; grows overflowing local cells
        first (one re-layout for all)."""
        n = cells.shape[0]
        shard_of = cells % self.n_shards
        order = np.argsort(cells, kind="stable")
        sorted_cells = cells[order]
        runs = np.flatnonzero(np.r_[True, sorted_cells[1:]
                                    != sorted_cells[:-1]])
        run_len = np.diff(np.r_[runs, n])
        run_cells = sorted_cells[runs]
        s_arr = run_cells % self.n_shards
        lc_arr = run_cells // self.n_shards
        req = self._next_free[s_arr, lc_arr] + run_len
        over = req > self._lcap_np[s_arr, lc_arr]
        if over.any():
            self._grow_local({(int(s), int(lc)): int(r) for s, lc, r in
                              zip(s_arr[over], lc_arr[over], req[over])})
        rank = np.arange(n) - np.repeat(runs, run_len)
        base = self._lstart_np[s_arr, lc_arr] + self._next_free[s_arr, lc_arr]
        slots = np.empty(n, np.int64)
        slots[order] = np.repeat(base, run_len) + rank
        # distinct (s, lc) per run makes the fancy-index add exact
        self._next_free[s_arr, lc_arr] += run_len
        return shard_of, slots

    def _prep(self, x):
        x = util.as_tensor(x, self.device, torch.float32)
        if self.distance == "cosine":
            x = util.normalize(x, dim=0)
        return x

    # ---- mutation ----
    def add(self, x, ids=None):
        """Route new vectors [d_vector, n] to their owning shards and append
        them (sharded_ivfpq.py:378-433): coarse assignment and PQ encode on
        the replicated codecs in every rank, every item's (shard, slot) on
        the host from the shadows, then each rank writes only its own
        items. Returns the ids [n]."""
        idx = self.index
        x = self._prep(x)
        n = int(x.shape[1])
        if n == 0:
            return torch.zeros((0,), dtype=util.ID_DTYPE, device=self.device)
        cells_t = idx.vq_codec.encode(x).long()
        if idx.pq_use_residual:
            recon = idx.vq_codec.decode(cells_t).T
            codes_nm = idx.pq_codec.encode_nd(x.T - recon)
            rows = recon + idx.pq_codec.decode_nd(codes_nm)
        else:
            codes_nm = idx.pq_codec.encode_nd(x.T)
            rows = idx.pq_codec.decode_nd(codes_nm)
        norms = torch.sum(rows * rows, dim=-1)
        scales = None
        if self._codes:
            rows = idx._pack_codes(codes_nm)  # [n, code_size] uint8
        elif self._int8:
            rows, scales = util.int8_quantize_rows(rows)
            rows = util.pad_cols(rows, self.decoded.shape[1])
        else:
            rows = util.pad_cols(rows, self.decoded.shape[1])
        if ids is None:
            # the host _max_id shadow: reading the device id store per add
            # would put a device-to-host sync on the ingest path
            ids = np.arange(self._max_id, self._max_id + n, dtype=np.int64)
        else:
            ids = np.asarray(util.to_numpy(ids), dtype=np.int64).reshape(-1)
        self._max_id = max(self._max_id, int(ids.max()) + 1)

        shard_of, slots = self._route_slots(cells_t.cpu().numpy())
        mine = np.flatnonzero(shard_of == self.rank)
        sel = torch.as_tensor(mine, device=self.device)
        tgt = torch.as_tensor(slots[mine], device=self.device)
        self.decoded[tgt] = rows[sel].to(self.decoded.dtype)
        self.norms[tgt] = norms[sel]
        self.is_empty[tgt] = False
        ids_t = torch.as_tensor(ids, device=self.device).to(util.ID_DTYPE)
        self.ids[tgt] = ids_t[sel]
        if self._int8:
            self.scales[tgt] = scales[sel]
        self._flat_sh = None
        return ids_t

    def remove(self, ids):
        """Mask the given ids out of every shard (holes stay empty: adds
        append past them). Returns the count removed over the mesh."""
        rm = util.as_tensor(ids, self.device).reshape(-1).long()
        if rm.numel() == 0:
            return 0
        hit = ~self.is_empty & torch.isin(self.ids.long(), rm)
        self.is_empty |= hit
        self.ids[hit] = -1
        n = hit.sum().to(torch.int64).reshape(1)
        dist.all_reduce(n, group=self.group)
        self._flat_sh = None
        return int(n[0])

    # ---- search ----
    def _flat_compacted(self):
        """(decoded, norms, is_empty, ids, scales) of this shard with its
        dead slots squeezed out, for flat mode (sharded_ivfpq.py:128-152,
        :448-463); rebuilt lazily after adds, removes and growth. The pad
        width is the same on every rank: the largest shard's next-free sum
        (a bound on its live count) rounded up."""
        if self._flat_sh is not None:
            return self._flat_sh
        n_live = int(self._next_free.sum(axis=1).max())
        unit = 131072 if n_live > 131072 else 2048
        n_pad = min(util.round_up(max(n_live, 1), unit),
                    int(self.decoded.shape[0]))
        amap = torch.nonzero(~self.is_empty).flatten()[:n_pad]
        amap = torch.cat([amap, amap.new_full((n_pad - amap.shape[0],), -1)])
        valid = amap >= 0
        safe = amap.clamp(min=0)
        self._flat_sh = (
            self.decoded[safe], torch.where(valid, self.norms[safe], 0.0),
            ~valid, torch.where(valid, self.ids[safe], -1),
            None if self.scales is None else self.scales[safe])
        return self._flat_sh

    def _scan_payload(self, dec):
        """The shard payload as the scans take it: code-domain shards in
        the index's packed [cap/g, g*m] layout (so the codes kernel serves
        them), with the per-slot width; otherwise as stored."""
        g = self.index.pack_group
        if self._codes and g > 1:
            return dec.view(dec.shape[0] // g, g * dec.shape[1]), \
                dec.shape[1]
        return dec, None

    def _local_search(self, q, k):
        """This rank's top-k (values, ids) over its own cells, the products
        at the index's search precision (sharded_ivfpq.py:490-491)."""
        idx, d_count = self.index, self.n_shards
        impl = idx.scan_impl
        precision = idx._search_precision()
        if self.scan_mode == "flat":
            # an exhaustive sweep of the compacted shard: no probing
            dec, nrm, emp, ids, sc = self._flat_compacted()
            penalty = torch.where(
                emp, BIG, nrm if self.distance == "euclidean" else 0.0)
            if self._codes:
                sweep = flat_onehot_scan if self.distance == "manhattan" \
                    else flat_decode_scan
                vals, addr = sweep(q, dec, penalty, self.pq_cb, k=k,
                                   distance=self.distance,
                                   precision=precision)
            else:
                vals, addr = flat_adc_scan(q, dec, penalty, k=k,
                                           distance=self.distance,
                                           approx=True, scales=sc,
                                           precision=precision)
        else:
            from ..index.ivfpq import _coarse_probe
            n_probe = min(idx.n_probe, idx.n_cells)
            _, cells, mask = _coarse_probe(
                q, self.codebook, idx.smart_probing_temperature,
                n_probe=n_probe, use_smart=idx.use_smart_probing,
                precision=precision)
            local_mask = mask & (cells % d_count == self.rank)
            local_cells = torch.clamp(cells // d_count,
                                      max=self.cells_per_shard - 1)
            ids = self.ids
            kw = dict(k=k, distance=self.distance,
                      s_max=util.next_pow2(self.s_max),
                      approx=idx.use_approx_topk, precision=precision)
            args = (q, local_cells, local_mask)
            tables = (self.norms, self.is_empty, self.cell_start,
                      self.cell_capacity)
            if self._codes:
                dec, m = self._scan_payload(self.decoded)
                vals, addr = scan_cell_major_codes(
                    *args, dec, *tables, self.pq_cb,
                    n_cells=self.cells_per_shard, p_tile=self.p_tile, m=m,
                    impl=impl, **kw)
            elif self.scan_mode == "cell_major":
                vals, addr = adc.scan_cell_major(
                    *args, self.decoded, *tables,
                    n_cells=self.cells_per_shard, p_tile=self.p_tile,
                    group=self.scan_group, scales=self.scales, impl=impl,
                    **kw)
            else:
                vals, addr = adc.scan_query_major(*args, self.decoded,
                                                  *tables, **kw)
        lids = torch.where(addr >= 0, ids[addr.long().clamp(min=0)], -1)
        return vals, lids

    def search(self, x, k=1):
        """x: [d_vector, nq] -> (values [nq, k], ids [nq, k]), the same on
        every rank: each rank scans its own cells, then one all_gather and a
        top-k merge (sharded_ivfpq.py:45-125, :465-492)."""
        q = self._prep(x).T.contiguous()
        k = int(k)
        vals, lids = self._local_search(q, k)
        return _merge(vals, lids, k, self.group, self.n_shards)


def _compute_device(device, *xs):
    """Where the data-parallel k-means computes: `device` when given, else
    the device of the first tensor among xs, else the card (the port's
    default). The mesh's collective backend does not choose it: gloo
    carries CUDA tensors too."""
    if device is not None:
        return torch.device(device)
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cuda")


def data_parallel_lloyd_step(mesh, data_sharded, centroids, distance,
                             axis_name=None, device=None):
    """One data-parallel k-means iteration over the mesh: local assignment
    and partial sums, then an all_reduce (sharded_ivfpq.py:494-523).

    data_sharded: the JAX layout [D, n_local, d], of which each rank takes
    its own row (or this rank's [n_local, d] rows); centroids [k, d],
    replicated. device: where it computes (default: the data's or the
    centroids' device when either is a tensor, else "cuda"). Returns the
    new centroids, replicated."""
    del axis_name  # 1-D meshes: the mesh's one axis
    data = util.as_tensor(data_sharded,
                          _compute_device(device, data_sharded, centroids),
                          torch.float32)
    if data.ndim == 3:
        data = data[mesh_rank(mesh)]
    cents = util.as_tensor(centroids, data.device, torch.float32)
    return _lloyd_update(data, cents, canonical_distance(distance),
                         mesh.get_group())


def _lloyd_update(data, cents, distance, group):
    """One Lloyd update over the mesh: local assignment, sums and counts,
    all-reduced; a cluster no row took keeps its centroid."""
    _, labels = max_sim(data, cents, distance)
    sums, counts = compute_centroids(data, labels, cents.shape[0])
    dist.all_reduce(sums, group=group)
    dist.all_reduce(counts, group=group)
    return torch.where((counts > 0)[:, None],
                       sums / torch.clamp(counts, min=1.0)[:, None], cents)


def data_parallel_kmeans_fit(data, n_clusters, *, mesh=None, max_iter=15,
                             tol=1e-4, distance="euclidean", seed=0,
                             axis_name=None, verbose=0, device=None):
    """Data-parallel Lloyd over the mesh (sharded_ivfpq.py:545-610): rows
    split across ranks, one all_reduce of the sums and counts per iteration.

    data: [n, d], the same on every rank (numpy, or a tensor on this rank's
    device); device: where it computes (default: the data's device when it
    is a tensor, else "cuda"); each rank keeps its own ceil(n / D) rows (the last rank's are
    fewer: the JAX package's padding rows, dropped). The initial centroids
    are the rows np.random.default_rng(seed).choice(n, k, replace=False)
    picks, as in the JAX package. Cosine renormalizes the centroids each
    iteration; the loop stops once the squared centroid shift is <= tol.
    Returns (centroids [k, d] replicated, iterations run)."""
    del axis_name
    mesh = mesh if mesh is not None else get_mesh()
    d_count, my = mesh.size(), mesh_rank(mesh)
    distance = canonical_distance(distance)
    dev = _compute_device(device, data)
    data = util.as_tensor(data, dev, torch.float32)
    n = data.shape[0]
    n_loc = util.cdiv(n, d_count)
    local = data[my * n_loc:(my + 1) * n_loc]
    rng = np.random.default_rng(seed)
    pick = torch.as_tensor(rng.choice(n, n_clusters, replace=False),
                           device=dev)
    cents = data[pick].clone()
    group = mesh.get_group()
    it = 0
    for it in range(1, max_iter + 1):
        new_c = _lloyd_update(local, cents, distance, group)
        if distance == "cosine":
            new_c = util.normalize(new_c)
        err = float(torch.sum(torch.square(new_c - cents)))
        cents = new_c
        if verbose:
            print(f"[data_parallel_kmeans_fit] iteration {it}: shift {err}")
        if err <= tol:
            break
    return cents, it


def data_parallel_search(index, x, k=1, mesh=None):
    """Query-data-parallel search (sharded_ivfpq.py:613-667): the other
    scaling axis. Every rank holds the whole index (its own replica) and
    searches its own slice of the queries, padded to a multiple of D; one
    all_gather brings every slice to every rank. Right where the index fits
    one card and query volume is the bottleneck.

    x: [d_vector, nq] -> (values [nq, k], ids [nq, k]). The caller's index
    is only searched: nothing of it is re-placed or rebound."""
    mesh = mesh if mesh is not None else get_mesh()
    d_count, my = mesh.size(), mesh_rank(mesh)
    x = util.as_tensor(x, index.device, torch.float32)
    nq = int(x.shape[1])
    nq_loc = util.cdiv(max(nq, 1), d_count)
    x = util.pad_cols(x, nq_loc * d_count)
    vals, ids = index.search(x[:, my * nq_loc:(my + 1) * nq_loc], k=k)
    group = mesh.get_group()
    return tuple(_all_gather_cat(part, group, d_count, 0)[:nq]
                 for part in (vals, ids))
