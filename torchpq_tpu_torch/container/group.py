"""Group of parallel flat stores sharing one id / address space
(counterpart of torchpq_tpu/container/group.py).

Storage 0 is the FlatContainer's own; storages 1..N-1 are its aux row
stores ("storage<i>"), written and compacted in lockstep. `group[i]` is a
read-only view of one member.
"""

from .. import util
from .flat import FlatContainer


class _StorageView:
    """Read-only view of one member storage."""

    def __init__(self, group, i):
        self._group = group
        self._i = i

    @property
    def code_size(self):
        return self._group.code_sizes[self._i]

    @property
    def dtype(self):
        return self._group.dtypes[self._i]

    @property
    def n_items(self):
        return self._group.n_items

    def get_data_by_address(self, address):
        return self._group.get_data_by_address(address, self._i)

    def get_data_by_id(self, ids):
        return self._group.get_data_by_address(
            self._group.get_address_by_id(ids), self._i)


class FlatContainerGroup(FlatContainer):
    def __init__(self, code_sizes, dtypes=None, contiguous_sizes=None,
                 device=None, initial_size=None, expand_step_size=1024,
                 expand_mode="double", use_inverse_id_mapping=True,
                 verbose=0):
        del contiguous_sizes
        code_sizes = [int(c) for c in code_sizes]
        if dtypes is None:
            dtypes = ["float32"] * len(code_sizes)
        assert len(dtypes) == len(code_sizes)
        super().__init__(
            code_size=code_sizes[0], dtype=dtypes[0], device=device,
            initial_size=initial_size, expand_step_size=expand_step_size,
            expand_mode=expand_mode,
            use_inverse_id_mapping=use_inverse_id_mapping, verbose=verbose)
        self.n_storages = len(code_sizes)
        self.code_sizes = code_sizes
        self.dtypes = dtypes
        for i in range(1, self.n_storages):
            self.add_aux_store(f"storage{i}", code_sizes[i], dtypes[i])

    def __getitem__(self, i):
        assert 0 <= i < self.n_storages
        return _StorageView(self, i)

    def add(self, data_list, ids=None, return_address=False):
        """data_list: one [code_size_i, n] array per storage."""
        assert len(data_list) == self.n_storages
        aux_rows = {f"storage{i}": util.as_tensor(data_list[i],
                                                  self.device).T
                    for i in range(1, self.n_storages)}
        return super().add(data_list[0], ids=ids,
                           return_address=return_address, aux_rows=aux_rows)

    def get_data_by_address(self, address, storage_index=0):
        if storage_index == 0:
            return super().get_data_by_address(address)
        return self._rows_at(self.aux(f"storage{storage_index}"), address)

    def set_data_by_address(self, data, address, storage_index=0):
        if storage_index == 0:
            return super().set_data_by_address(data, address)
        self._set_rows(self.aux(f"storage{storage_index}"), data, address)
