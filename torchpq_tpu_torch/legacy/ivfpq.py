"""v1 IVFPQ / IVFPQR adapters (reference legacy/IVFPQ.py, legacy/IVFPQR.py;
counterpart of torchpq_tpu/legacy/ivfpq.py)."""

import numpy as np

from .. import util
from ..index import IVFPQIndex, IVFPQRIndex


class IVFPQ:
    """v1 facade: n_cq_clusters -> n_cells, blocksize -> initial per-cell
    capacity, topk() -> search(). An optional `cpu_quantizer` (an SQCodec)
    enables the CPU-RAM tier: SQ-compressed originals are kept on the host
    and can be reconstructed by id (reference legacy/IVFPQBase.py:55-58,
    :520-526). The index lives on `device` (the card unless named)."""

    index_cls = IVFPQIndex

    def __init__(self, d_vector, n_subvectors=8, n_cq_clusters=128,
                 n_pq_clusters=256, blocksize=64, verbose=0,
                 distance="euclidean", cpu_quantizer=None, device=None,
                 **kwargs):
        assert n_pq_clusters == 256, \
            "only 256 PQ clusters are supported (like the reference)"
        self._index = self.index_cls(
            d_vector=d_vector, n_subvectors=n_subvectors,
            n_cells=n_cq_clusters, initial_size=blocksize,
            distance=distance, verbose=verbose, device=device, **kwargs)
        self.cpu_quantizer = cpu_quantizer
        self._cpu_store = {}  # id -> the host copy of its SQ code column

    # -- v1 names --
    def train(self, input, force_retrain=False):
        if self.cpu_quantizer is not None and not self.cpu_quantizer.is_trained:
            self.cpu_quantizer.train(
                util.as_tensor(input, self.cpu_quantizer.device))
        return self._index.train(input, force_retrain=force_retrain)

    def add(self, input, input_ids=None, return_address=False):
        out = self._index.add(input, ids=input_ids,
                              return_address=return_address)
        ids = out[0] if return_address else out
        if self.cpu_quantizer is not None:
            codes = util.to_numpy(self.cpu_quantizer.encode(
                util.as_tensor(input, self.cpu_quantizer.device)))
            for j, i in enumerate(util.to_numpy(ids)):
                self._cpu_store[int(i)] = codes[:, j]
        return out

    def remove(self, remove_ids):
        for i in np.asarray(util.to_numpy(remove_ids)).reshape(-1):
            self._cpu_store.pop(int(i), None)
        return self._index.remove(ids=remove_ids)

    def remove_address(self, address):
        return self._index.remove(address=address)

    def encode(self, input):
        return self._index.encode(input)

    def decode(self, code):
        return self._index.decode(code)

    def topk(self, query, k, mode=2, return_address=False):
        """v1 search entry (reference legacy/IVFPQ.py:315-349); `mode` chose
        among scan strategies there, and both map to the index's search."""
        del mode
        return self._index.search(query, k=k, return_address=return_address)

    def similarity_at_address(self, query, address):
        return self._index.similarity_at_address(query, address)

    def similarity_at_id(self, query, ids):
        return self._index.similarity_at_id(query, ids)

    def reconstruct_from_cpu_ram(self, ids):
        """Reconstruct originals from the CPU-RAM SQ tier -> [d, n]."""
        assert self.cpu_quantizer is not None, "no cpu_quantizer configured"
        codes = np.stack([self._cpu_store[int(i)]
                          for i in np.asarray(util.to_numpy(ids))], axis=1)
        return self.cpu_quantizer.decode(
            util.as_tensor(codes, self.cpu_quantizer.device))

    # pass-throughs
    @property
    def n_probe(self):
        return self._index.n_probe

    @n_probe.setter
    def n_probe(self, v):
        self._index.n_probe = v

    def __getattr__(self, name):
        # during pickling and copying (and before __init__ has run) `_index`
        # may be missing: looking it up through getattr would recurse
        try:
            index = self.__dict__["_index"]
        except KeyError:
            raise AttributeError(name) from None
        return getattr(index, name)


class IVFPQR(IVFPQ):
    """v1 IVFPQR facade over IVFPQRIndex (n_subq: the rerank PQ's
    subvectors)."""

    index_cls = IVFPQRIndex

    def __init__(self, d_vector, n_subvectors=8, n_subq=8, n_cq_clusters=128,
                 n_pq_clusters=256, blocksize=64, verbose=0,
                 distance="euclidean", cpu_quantizer=None, device=None,
                 **kwargs):
        super().__init__(
            d_vector, n_subvectors=n_subvectors, n_cq_clusters=n_cq_clusters,
            n_pq_clusters=n_pq_clusters, blocksize=blocksize, verbose=verbose,
            distance=distance, cpu_quantizer=cpu_quantizer, device=device,
            n_subvectors_rerank=n_subq, **kwargs)
