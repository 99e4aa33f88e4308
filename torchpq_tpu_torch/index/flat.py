"""Exact (brute-force) index (counterpart of torchpq_tpu/index/flat.py).

Rows live in a FlatContainer as float32; a search scores the queries
against the live prefix at the search precision, as the JAX package does
(config.py): on the card "highest" is IEEE float32, the exact index, and
the default "default" scores bf16-rounded operands on the tensor cores, as
the TPU does; the CPU computes float32 at every precision. It keeps the
top k per query. Queries go in chunks whose
[chunk, n_items] score tile stays within FLAT_TILE_ELEMS, so memory is
bounded while the GEMM stays wide on the card. Cosine rows are normalized
at add and scored as inner products against the normalized queries.
Manhattan runs through the chunked broadcast of metric.py.
"""

import torch

from .. import config
from .. import util
from ..container import FlatContainer
from ..metric import canonical_distance, preprocess_query, similarity

# elements of one [chunk, n_items] f32 score tile: 2 GiB, 512 queries per
# chunk against 1M rows
FLAT_TILE_ELEMS = 1 << 29

# the resolved precision of the most recent FlatIndex search: {"precision"}
LAST_SEARCH = {}


def _flat_search(query, storage, address2id, n_items, *, k, distance,
                 q_chunk=None, precision=None):
    """query [nq, d] f32 -> (vals [nq, min(k, n_items)], ids, addr); columns
    whose row holds no id score -inf, and -inf entries carry id and
    address -1. The rows are cast for the products once (at "default" on
    the card, one bf16 copy), not per query chunk; |row|^2 is an f32 sum."""
    rows = storage[:n_items].float()
    valid = address2id[:n_items] >= 0
    b_sq = torch.sum(rows * rows, dim=-1) if distance == "euclidean" \
        else None
    eff = "inner" if distance == "cosine" else distance
    if eff != "manhattan":
        rows = util.matmul_operand(rows, precision)
    k_eff = min(k, n_items)
    if q_chunk is None:
        q_chunk = max(1, FLAT_TILE_ELEMS // max(n_items, 1))
    vals, idx = [], []
    for i in range(0, query.shape[0], q_chunk):
        sims = similarity(query[i:i + q_chunk], rows, eff,
                          precision=precision, b_sq=b_sq)
        sims = torch.where(valid[None, :], sims, -torch.inf)
        v, a = torch.topk(sims, k_eff, dim=-1)
        vals.append(v)
        idx.append(a)
    vals = torch.cat(vals)
    idx = torch.cat(idx)
    live = torch.isfinite(vals)
    ids = torch.where(live, address2id[idx], -1)
    addr = torch.where(live, idx, -1).int()
    return vals, ids, addr


class FlatIndex(FlatContainer):
    def __init__(self, d_vector, initial_size=None, expand_step_size=1024,
                 expand_mode="double", distance="euclidean", device=None,
                 verbose=0):
        super().__init__(
            code_size=d_vector, dtype="float32", device=device,
            initial_size=initial_size, expand_step_size=expand_step_size,
            expand_mode=expand_mode, use_inverse_id_mapping=True,
            verbose=verbose)
        self.d_vector = d_vector
        self.distance = canonical_distance(distance)

    def add(self, data, ids=None, return_address=False):
        """data: [d_vector, n]; cosine rows are stored normalized."""
        data = util.as_tensor(data, self.device, torch.float32)
        if self.distance == "cosine":
            data = util.normalize(data, dim=0)
        return super().add(data, ids=ids, return_address=return_address)

    def search(self, x, k=1, return_address=False):
        """x: [d_vector, nq] -> (values [nq, k], ids [nq, k]) at the
        search precision (config.SEARCH_PRECISION); past the live rows the
        values pad with -inf and the ids (and addresses) with -1."""
        x = util.as_tensor(x, self.device, torch.float32)
        assert x.shape[0] == self.d_vector
        q = preprocess_query(x.T.contiguous(), self.distance)
        k = max(int(k), 1)
        precision = config.resolve_precision(None)
        LAST_SEARCH.clear()
        LAST_SEARCH.update(precision=precision)
        vals, ids, addr = _flat_search(
            q, self._storage, self._address2id, self._n_items, k=k,
            distance=self.distance, precision=precision)
        pad = k - vals.shape[1]
        if pad:
            vals = torch.nn.functional.pad(vals, (0, pad), value=-torch.inf)
            ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
            addr = torch.nn.functional.pad(addr, (0, pad), value=-1)
        if return_address:
            return vals, ids, addr
        return vals, ids
