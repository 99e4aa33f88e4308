"""Container base: id <-> address machinery (counterpart of
torchpq_tpu/container/base.py).

`_address2id` maps a slot to its id (-1 when empty) and the dense inverse
map `_id2address` is kept up to date on every add/remove. Host shadows of
the scalar bookkeeping (n_items, max_id, capacities) live in python.
Mutations update the state tensors in place where the JAX package returns
new arrays: that keeps one copy of each store on the device.
"""

import numpy as np
import torch

from ..module import StateModule
from .. import util


class BaseContainer(StateModule):
    def __init__(self, initial_size=None, expand_step_size=1024,
                 expand_mode="double", use_inverse_id_mapping=True,
                 verbose=0, device=None):
        super().__init__(verbose=verbose, device=device)
        assert expand_mode in ("step", "double")
        self.expand_step_size = int(expand_step_size)
        self.expand_mode = expand_mode
        self.use_inverse_id_mapping = use_inverse_id_mapping
        # bumped on every storage mutation (add/remove/relayout/load); lets
        # caches derived from storage invalidate without content hashing
        self._mutations = 0
        cap = util.next_pow2(initial_size or expand_step_size)
        self._capacity = cap
        self._n_items = 0
        self._max_id = 0
        self._id_capacity = util.next_pow2(max(cap, 1))
        self.register_state("_address2id", torch.full(
            (cap,), -1, dtype=util.ID_DTYPE, device=self.device))
        self.register_state("_id2address", torch.full(
            (self._id_capacity,), -1, dtype=torch.int32, device=self.device))

    @property
    def capacity(self):
        return self._capacity

    @property
    def n_items(self):
        return self._n_items

    @property
    def max_id(self):
        return self._max_id

    def _prepare_ids(self, ids, n):
        """Host int64 ids (default: consecutive from max_id)."""
        if ids is None:
            ids = np.arange(self._max_id, self._max_id + n, dtype=np.int64)
        else:
            ids = np.asarray(
                ids.cpu() if isinstance(ids, torch.Tensor) else ids,
                dtype=np.int64)
            if ids.shape != (n,):
                raise ValueError(f"ids shape {ids.shape} != ({n},)")
            if n and ids.min() < 0:
                raise ValueError("ids must be non-negative")
        if n:
            self._max_id = max(self._max_id, int(ids.max()) + 1)
        return ids

    def _grow_id_map(self):
        need = util.next_pow2(max(self._max_id, 1))
        if need > self._id_capacity:
            pad = torch.full((need - self._id_capacity,), -1,
                             dtype=torch.int32, device=self.device)
            self.register_state("_id2address",
                                torch.cat([self._id2address, pad]))
            self._id_capacity = need

    def create_inverse_id_mapping(self):
        """Rebuild the dense inverse map from _address2id."""
        self._grow_id_map()
        a2i = self._address2id
        live = torch.nonzero(a2i >= 0).flatten()
        inv = torch.full((self._id_capacity,), -1, dtype=torch.int32,
                         device=self.device)
        inv[a2i[live].long()] = live.int()
        self.register_state("_id2address", inv)

    def get_id_by_address(self, address):
        """address [n] -> ids [n]; -1 for empty/out-of-range."""
        address = util.as_tensor(address, self.device).long()
        valid = (address >= 0) & (address < self._capacity)
        out = self._address2id[torch.where(valid, address, 0)]
        return torch.where(valid, out, -1)

    def get_address_by_id(self, ids):
        """ids [n] -> addresses [n] int32; -1 if absent."""
        ids = util.as_tensor(ids, self.device).long()
        valid = (ids >= 0) & (ids < self._id_capacity)
        out = self._id2address[torch.where(valid, ids, 0)]
        return torch.where(valid, out, -1)

    def _after_load(self):
        self._capacity = int(self._address2id.shape[0])
        self._id_capacity = int(self._id2address.shape[0])
        a2i = self._address2id
        live = a2i >= 0
        self._n_items = int(live.sum())
        self._max_id = int(a2i.max()) + 1 if self._n_items else 0
