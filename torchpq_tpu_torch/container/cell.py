"""Cell (inverted-list) store (counterpart of torchpq_tpu/container/cell.py).

One flat buffer split into contiguous per-cell segments (`_cell_start`,
`_cell_size`, `_cell_capacity`, `_is_empty`). Per-cell capacities are
powers of two (after an exact presize, multiples of 16, or of 128 from 128
up) and at least 16, so every cell start is a multiple of 16.
Adds follow the JAX package: rank within the cell (ioa,
ops/spill.py:rank_in_group) -> grow cells that would overflow -> the
ioa-th empty slot of the cell -> scatter. Growth is one relayout over the
whole store; aux row stores (the decoded scan cache, the norms) share the
slot address space, and stores marked derived are rebuilt from the codes
instead of moved.

`pack_group` g > 1 keeps the JAX package's packed code layout
[cap/g, g*code_size] (part of the npz state format). A contiguous
[cap/g, g*m] uint8 tensor *is* [cap, m], so every write and read here goes
through `storage.view(cap, m)`.
"""

import numpy as np
import torch

from .. import util
from ..ops.spill import rank_in_group
from .base import BaseContainer


def _find_write_addresses(is_empty, cell_start, cells, ioa):
    """Address of the (ioa+1)-th empty slot at/after each cell's start: a
    prefix sum over the empty bitmap plus a searchsorted."""
    empty = is_empty.long()
    inc = torch.cumsum(empty, 0)        # empties in [0, i]
    excl = inc - empty                  # empties in [0, i)
    target = excl[cell_start.long()[cells]] + ioa + 1
    return torch.searchsorted(inc, target)


def _relayout_gather(old_rows, old_start, old_cap, new_start, new_total,
                     fill):
    """Move every old slot to its position under new per-cell starts: new
    slot j of cell c at offset o comes from old_start[c] + o, or is `fill`
    past the old capacity."""
    dev = old_rows.device
    j = torch.arange(new_total, device=dev)
    c = torch.searchsorted(new_start, j, right=True) - 1
    o = j - new_start[c]
    in_old = o < old_cap[c]
    rows = old_rows[torch.where(in_old, old_start[c] + o, 0)]
    if rows.ndim > 1:
        in_old = in_old[:, None]
    return torch.where(in_old, rows, torch.as_tensor(fill, dtype=rows.dtype,
                                                     device=dev))


class CellContainer(BaseContainer):
    def __init__(self, code_size, n_cells, dtype="float32", device=None,
                 initial_size=None, expand_step_size=1024,
                 expand_mode="double", use_inverse_id_mapping=True,
                 contiguous_size=1, verbose=0, pack_group=1):
        del contiguous_size  # the reference's vector-load width; no effect
        if initial_size is None:
            initial_size = max(expand_step_size // max(n_cells, 1), 16)
        per_cell = max(util.next_pow2(initial_size), 16)
        super().__init__(initial_size=per_cell * n_cells,
                         expand_step_size=expand_step_size,
                         expand_mode=expand_mode,
                         use_inverse_id_mapping=use_inverse_id_mapping,
                         verbose=verbose, device=device)
        self.code_size = int(code_size)
        self.n_cells = int(n_cells)
        self.dtype = util.str2dtype(dtype)
        assert pack_group in (1, 2, 4, 8, 16), pack_group
        self.pack_group = int(pack_group)
        cap = per_cell * n_cells
        self._capacity = cap
        dev = self.device
        self.register_state("_address2id", torch.full(
            (cap,), -1, dtype=util.ID_DTYPE, device=dev))
        self.register_state("_storage", torch.zeros(
            (cap // self.pack_group, self.pack_group * self.code_size),
            dtype=self.dtype, device=dev))
        self.register_state("_cell_start", torch.arange(
            n_cells, dtype=torch.int32, device=dev) * per_cell)
        self.register_state("_cell_size", torch.zeros(
            n_cells, dtype=torch.int32, device=dev))
        self.register_state("_cell_capacity", torch.full(
            (n_cells,), per_cell, dtype=torch.int32, device=dev))
        self.register_state("_is_empty", torch.ones(
            cap, dtype=torch.bool, device=dev))
        self._aux = {}
        # host shadows for shape decisions (scan window, compaction)
        self._cell_size_np = np.zeros(n_cells, np.int64)
        self._cell_capacity_np = np.full(n_cells, per_cell, np.int64)

    @property
    def n_items(self):
        return self._n_items

    @property
    def max_cell_capacity(self):
        """Bound on any cell's capacity — the scan window S_max."""
        return int(self._cell_capacity_np.max())

    # -- aux stores --
    def add_aux_store(self, name, n_cols, dtype):
        dt = util.str2dtype(dtype)
        self._aux[name] = (int(n_cols), dt)
        self.register_state("_aux_" + name, torch.zeros(
            (self._capacity, int(n_cols)), dtype=dt, device=self.device))

    def aux(self, name):
        return getattr(self, "_aux_" + name)

    def set_aux_rebuilder(self, names, fn):
        """Mark aux stores as derived: on relayout they are freed before the
        storage moves and recreated by fn(), which returns
        {name: [new_capacity, cols] tensor} read from the moved codes."""
        self._aux_rebuild_names = tuple(names)
        self._aux_rebuilder = fn

    # -- address helpers --
    def _codes_view(self):
        """[capacity, code_size] view of the (possibly packed) storage."""
        return self._storage.view(self._capacity, self.code_size)

    def get_cell_by_address(self, address):
        """address [n] -> owning cell [n] (-1 if out of range)."""
        address = util.as_tensor(address, self.device).long()
        valid = (address >= 0) & (address < self._capacity)
        c = torch.searchsorted(self._cell_start.long(),
                               torch.where(valid, address, 0),
                               right=True) - 1
        return torch.where(valid, c, -1).int()

    def get_ioa(self, cells, unique_cells=None):
        """Rank of each item within its own cell among the batch's items,
        stable -> [n] (the reference's get_ioa)."""
        del unique_cells
        cells = util.as_tensor(cells, self.device).long()
        return rank_in_group(cells, torch.ones_like(cells, dtype=torch.bool),
                             self.n_cells)

    def get_write_address(self, cells, empty_adr=None, ioa=None):
        """Address each new item would be written at: the ioa-th empty slot
        of its cell -> int32 [n]."""
        del empty_adr
        cells = util.as_tensor(cells, self.device).long()
        ioa = self.get_ioa(cells) if ioa is None \
            else util.as_tensor(ioa, self.device).long()
        return _find_write_addresses(self._is_empty, self._cell_start, cells,
                                     ioa).int()

    def storage_rows(self, address):
        """Code rows [n, code_size] at in-range addresses."""
        return self._codes_view()[util.as_tensor(address, self.device).long()]

    def get_data_by_address(self, address):
        """[n] -> [code_size, n]; zeros for empty/invalid slots."""
        address = util.as_tensor(address, self.device).long()
        valid = (address >= 0) & (address < self._capacity)
        safe = torch.where(valid, address, 0)
        valid = valid & ~self._is_empty[safe]
        rows = self.storage_rows(safe)
        return torch.where(valid[:, None], rows, 0).T

    def set_data_by_address(self, data, address):
        """Overwrite the code rows at `address` [n] with data
        [code_size, n]; out-of-range addresses are dropped."""
        address = util.as_tensor(address, self.device).long()
        valid = (address >= 0) & (address < self._capacity)
        rows = util.as_tensor(data, self.device, self.dtype).T
        self._codes_view()[address[valid]] = rows[valid]
        self._mutations += 1

    def get_data_by_id(self, ids):
        """ids [n] -> [code_size, n]; zeros where an id holds nothing."""
        return self.get_data_by_address(self.get_address_by_id(ids))

    # -- growth --
    def expand(self, cells=None, required=None, exact=False):
        """Relayout with grown capacities: `required` {cell: min size}
        rounds each to the next power of two; `cells` doubles those cells;
        neither doubles every cell.

        `exact` (with `required`, cell.py:376-408): round to multiples of 16
        instead, or of 128 once at or above 128, so capacities track the
        true counts while every cell start stays 16-aligned and the largest
        capacity (the scan window) a multiple of 128. Meant for the
        presize-before-ingest path: one relayout while the store is empty,
        which allocates fresh stores instead of moving zeros (_relayout)."""
        new_caps = self._cell_capacity_np.copy()
        if required is not None:
            for c, req in required.items():
                if exact:
                    r = max(int(req), 16)
                    rounded = util.round_up(r, 16 if r < 128 else 128)
                else:
                    rounded = util.next_pow2(int(req))
                new_caps[c] = max(rounded, new_caps[c])
        elif cells is not None:
            for c in np.unique(np.asarray(cells)):
                new_caps[c] = new_caps[c] * 2
        else:
            new_caps = new_caps * 2
        self._relayout(new_caps)

    def _relayout(self, new_caps):
        new_caps = np.asarray(new_caps, np.int64)
        new_start_np = np.zeros_like(new_caps)
        np.cumsum(new_caps[:-1], out=new_start_np[1:])
        new_total = int(new_caps.sum())
        dev = self.device
        old_start = self._cell_start.long()
        old_caps = self._cell_capacity.long()
        new_start = torch.as_tensor(new_start_np, device=dev)
        rebuild = (set(getattr(self, "_aux_rebuild_names", ()))
                   if getattr(self, "_aux_rebuilder", None) else set())
        for name in rebuild:
            setattr(self, "_aux_" + name, None)  # free before the moves
        if self._n_items == 0:
            # an empty store (the presize-before-ingest path): fresh stores,
            # not a gather of zeros, which would cost a pass over the store
            # and a transient of twice its size (cell.py:424-445)
            def build(old, fill):
                return torch.full((new_total,) + tuple(old.shape[1:]), fill,
                                  dtype=old.dtype, device=dev)
        else:
            def build(old, fill):
                return _relayout_gather(old, old_start, old_caps, new_start,
                                        new_total, fill)
        self.register_state("_storage", build(self._codes_view(), 0).view(
            new_total // self.pack_group, self.pack_group * self.code_size))
        self.register_state("_address2id", build(self._address2id, -1))
        self.register_state("_is_empty", build(self._is_empty, True))
        for name in self._aux:
            if name not in rebuild:
                self.register_state("_aux_" + name, build(self.aux(name), 0))
        self.register_state("_cell_start", new_start.int())
        self.register_state("_cell_capacity", torch.as_tensor(
            new_caps, dtype=torch.int32, device=dev))
        self._cell_capacity_np = new_caps
        self._capacity = new_total
        if rebuild:
            rebuilt = self._aux_rebuilder()
            for name in rebuild:
                assert rebuilt[name].shape[0] == new_total
                self.register_state("_aux_" + name, rebuilt[name])
        self._mutations += 1
        self.create_inverse_id_mapping()
        self.print_message(
            f"relayout: capacity {new_total} "
            f"(max cell {int(new_caps.max())})", 1)

    # -- add / remove --
    def add(self, data, cells, ids=None, return_address=False, aux_rows=None):
        """data: [code_size, n]; cells: [n] cell labels; aux_rows:
        {name: [n, cols]} rows written at the same addresses."""
        dev = self.device
        data = util.as_tensor(data, dev, self.dtype)
        assert data.shape[0] == self.code_size
        n = int(data.shape[1])
        ids_np = self._prepare_ids(ids, n)
        self._grow_id_map()
        cells = util.as_tensor(cells, dev).long()
        counts = torch.bincount(cells, minlength=self.n_cells).cpu().numpy()
        if counts.shape[0] != self.n_cells or (n and int(cells.min()) < 0):
            raise ValueError("cell labels out of range")
        need = self._cell_size_np + counts
        over = need > self._cell_capacity_np
        if over.any():
            self.expand(required={
                int(c): int(need[c]) for c in np.nonzero(over)[0]})
        ids_t = torch.as_tensor(ids_np, device=dev)
        # rank of each item among the batch's items of its cell (ioa)
        ioa = rank_in_group(cells, torch.ones_like(cells, dtype=torch.bool),
                            self.n_cells)
        addr = _find_write_addresses(self._is_empty, self._cell_start,
                                     cells, ioa)
        self._codes_view()[addr] = data.T
        self._address2id[addr] = ids_t.to(util.ID_DTYPE)
        self._is_empty[addr] = False
        self._id2address[ids_t] = addr.int()
        self._cell_size += torch.as_tensor(counts, dtype=torch.int32,
                                           device=dev)
        for name, arr in (aux_rows or {}).items():
            store = self.aux(name)
            store[addr] = util.as_tensor(arr, dev, store.dtype).reshape(
                n, store.shape[1])
        self._n_items += n
        self._mutations += 1
        self._cell_size_np += counts
        ids_out = torch.as_tensor(ids_np, dtype=util.ID_DTYPE, device=dev)
        if return_address:
            return ids_out, addr.int()
        return ids_out

    def remove(self, ids=None, address=None):
        """Remove by ids or addresses; returns the count actually removed."""
        if (ids is None) == (address is None):
            raise ValueError("provide exactly one of ids / address")
        if address is None:
            address = self.get_address_by_id(ids)
        address = torch.unique(util.as_tensor(address, self.device).long())
        address = address[(address >= 0) & (address < self._capacity)]
        address = address[~self._is_empty[address]]
        if address.numel() == 0:
            return 0
        rm_ids = self._address2id[address].long()
        self._address2id[address] = -1
        self._is_empty[address] = True
        self._id2address[rm_ids] = -1
        cell_of = torch.searchsorted(self._cell_start.long(), address,
                                     right=True) - 1
        counts = torch.bincount(cell_of, minlength=self.n_cells)
        self._cell_size -= counts.int()
        self._cell_size_np -= counts.cpu().numpy()
        removed = int(address.numel())
        self._n_items -= removed
        self._mutations += 1
        return removed

    def empty(self):
        """Drop every item and keep the layout."""
        self._address2id.fill_(-1)
        self._id2address.fill_(-1)
        self._is_empty.fill_(True)
        self._cell_size.zero_()
        self._n_items = 0
        self._max_id = 0
        self._mutations += 1
        self._cell_size_np[:] = 0

    def _after_load(self):
        super()._after_load()
        self._mutations += 1
        self._cell_size_np = self._cell_size.cpu().numpy().astype(np.int64)
        self._cell_capacity_np = \
            self._cell_capacity.cpu().numpy().astype(np.int64)
        # the packed layout is read off the stored row width
        self.pack_group = int(self._storage.shape[1]) // self.code_size
