"""Flat (dense-prefix) store (counterpart of torchpq_tpu/container/flat.py).

Live rows always form the dense prefix [0, n_items): an add appends at
n_items + rank, and a remove moves the surviving rows of the tail window
into the holes below the new end (swap-from-tail compaction), so the
addresses of both packages agree after any sequence of adds and removes.
Storage is row-major [capacity, code_size]. Aux row stores (the group's
member storages) share the address space and are written and compacted
in lockstep. Stores are updated in place.
"""

import torch

from .. import util
from .base import BaseContainer


class FlatContainer(BaseContainer):
    def __init__(self, code_size, contiguous_size=1, dtype="float32",
                 device=None, initial_size=None, expand_step_size=1024,
                 expand_mode="double", use_inverse_id_mapping=True,
                 verbose=0):
        del contiguous_size  # the reference's vector-load width; no effect
        super().__init__(initial_size=initial_size,
                         expand_step_size=expand_step_size,
                         expand_mode=expand_mode,
                         use_inverse_id_mapping=use_inverse_id_mapping,
                         verbose=verbose, device=device)
        self.code_size = int(code_size)
        self.dtype = util.str2dtype(dtype)
        self.register_state("_storage", torch.zeros(
            (self._capacity, self.code_size), dtype=self.dtype,
            device=self.device))
        self._aux = {}  # name -> (n_cols, dtype); tensors live as states

    # -- aux row stores sharing the address space --
    def add_aux_store(self, name, n_cols, dtype):
        dt = util.str2dtype(dtype)
        self._aux[name] = (int(n_cols), dt)
        self.register_state("_aux_" + name, torch.zeros(
            (self._capacity, int(n_cols)), dtype=dt, device=self.device))

    def aux(self, name):
        return getattr(self, "_aux_" + name)

    # -- data access --
    def _rows_at(self, store, address):
        """Rows of `store` at `address` [n] as [cols, n]; zeros outside the
        live prefix."""
        address = util.as_tensor(address, self.device).long()
        valid = (address >= 0) & (address < self._n_items)
        rows = store[torch.where(valid, address, 0)]
        return torch.where(valid[:, None], rows, 0).T

    def get_data_by_address(self, address):
        """address [n] -> data [code_size, n]; zeros for invalid addresses."""
        return self._rows_at(self._storage, address)

    def _set_rows(self, store, data, address):
        address = util.as_tensor(address, self.device).long()
        valid = (address >= 0) & (address < self._capacity)
        rows = util.as_tensor(data, self.device, store.dtype).T
        store[address[valid]] = rows[valid]
        self._mutations += 1

    def set_data_by_address(self, data, address):
        """data [code_size, n] written at address [n]; out-of-range
        addresses are dropped."""
        self._set_rows(self._storage, data, address)

    def get_data_by_id(self, ids):
        return self.get_data_by_address(self.get_address_by_id(ids))

    # -- growth --
    def _grow_to(self, new_cap):
        if new_cap <= self._capacity:
            return
        pad = new_cap - self._capacity
        dev = self.device

        def grown(t, fill=0):
            return torch.cat([t, torch.full((pad,) + tuple(t.shape[1:]),
                                            fill, dtype=t.dtype, device=dev)])

        self.register_state("_storage", grown(self._storage))
        for name in self._aux:
            self.register_state("_aux_" + name, grown(self.aux(name)))
        self.register_state("_address2id", grown(self._address2id, -1))
        self._capacity = new_cap
        self._mutations += 1
        self.print_message(f"expanded to capacity {new_cap}", 1)

    def expand(self):
        """One growth step of the expand policy."""
        self._grow_to(self._next_capacity(self._capacity + 1))

    # -- add / remove --
    def add(self, data, ids=None, return_address=False, aux_rows=None):
        """data: [code_size, n]; appended at n_items + rank. aux_rows:
        {name: [n, cols]} rows written at the same addresses. Returns ids
        (and addresses)."""
        dev = self.device
        data = util.as_tensor(data, dev, self.dtype)
        assert data.shape[0] == self.code_size
        n = int(data.shape[1])
        ids_np = self._prepare_ids(ids, n)
        self._grow_id_map()
        if self._n_items + n > self._capacity:
            self._grow_to(self._next_capacity(self._n_items + n))
        n0 = self._n_items
        ids_t = torch.as_tensor(ids_np, device=dev)
        addr = torch.arange(n0, n0 + n, dtype=torch.int32, device=dev)
        self._storage[n0:n0 + n] = data.T
        self._address2id[n0:n0 + n] = ids_t.to(util.ID_DTYPE)
        self._id2address[ids_t] = addr
        for name, arr in (aux_rows or {}).items():
            store = self.aux(name)
            store[n0:n0 + n] = util.as_tensor(arr, dev, store.dtype).reshape(
                n, store.shape[1])
        self._n_items += n
        self._mutations += 1
        ids_out = ids_t.to(util.ID_DTYPE)
        if return_address:
            return ids_out, addr
        return ids_out

    def remove(self, ids=None, address=None):
        """Remove by ids or addresses; the survivors of the tail window move
        into the holes below the new prefix end, ascending onto ascending
        (the JAX package's _flat_remove). Returns the count removed."""
        if (ids is None) == (address is None):
            raise ValueError("provide exactly one of ids / address")
        if address is None:
            address = self.get_address_by_id(ids)
        address = torch.unique(util.as_tensor(address, self.device).long())
        address = address[(address >= 0) & (address < self._n_items)]
        r = int(address.numel())
        if r == 0:
            return 0
        n_items = self._n_items
        new_n = n_items - r
        rm_ids = self._address2id[address].long()
        self._id2address[rm_ids[rm_ids >= 0]] = -1
        removed = torch.zeros(n_items, dtype=torch.bool, device=self.device)
        removed[address] = True
        win = torch.arange(new_n, n_items, device=self.device)
        src = win[~removed[new_n:]]              # live tail rows, ascending
        dst = address[address < new_n]           # holes, ascending (unique)
        moved_ids = self._address2id[src]
        self._storage[dst] = self._storage[src]
        self._address2id[dst] = moved_ids
        live = moved_ids >= 0
        self._id2address[moved_ids[live].long()] = dst[live].int()
        for name in self._aux:
            store = self.aux(name)
            store[dst] = store[src]
        self._address2id[new_n:n_items] = -1
        self._n_items = new_n
        self._mutations += 1
        return r

    def empty(self):
        """Drop every item."""
        self._address2id.fill_(-1)
        self._id2address.fill_(-1)
        self._n_items = 0
        self._max_id = 0
        self._mutations += 1
