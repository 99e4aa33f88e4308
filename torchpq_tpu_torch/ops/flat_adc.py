"""Flat (exhaustive) ADC scan over the decoded cache (counterpart of
torchpq_tpu/ops/flat_adc.py:flat_adc_scan).

The JAX package runs this outside any Pallas kernel, so here it is plain
torch: the cache is swept in slot chunks, each chunk one float32 product
[nq, d] x [d, chunk] and a per-query top-k, and the chunk winners merge with
one exact top-k. The JAX package's approx_max_k is exact off the TPU, so
both `approx` settings take the exact top-k here. `flat_sweep` and
`final_merge` also serve the code-domain sweep (ops/onehot_adc.py), whose
chunks are decoded from PQ codes.
"""

import torch

from .. import util
from ..metric import canonical_distance
from .block_scan import BIG


def flat_sweep(q_mm, rows, n, penalty, *, k, factor, max_elems=1 << 28):
    """Per chunk of slots [c0, c1): s = factor * q_mm @ rows(c0, c1).T -
    penalty[c0:c1], and its top k. q_mm [nq, d] f32; rows(c0, c1) -> f32
    [c1 - c0, d]; `max_elems` bounds the [nq, chunk] score tile. Returns
    the chunk winners (values [nq, n_chunks * k_c], slots alike)."""
    nq = q_mm.shape[0]
    chunk = min(n, max(1024, max_elems // max(nq, 1)))
    k_c = min(k, chunk)
    vals, idx = [], []
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        # factor * <q, y> - penalty as one GEMM with its bias epilogue
        s = torch.addmm(-penalty[c0:c1][None, :], q_mm, rows(c0, c1).T,
                        alpha=factor)
        v, i = torch.topk(s, min(k_c, s.shape[1]), dim=-1)
        vals.append(v)
        idx.append(i + c0)
    return torch.cat(vals, dim=1), torch.cat(idx, dim=1)


def final_merge(vals, idx, query, *, k, distance):
    """Exact merge of the chunk winners (onehot_adc.py:_flat_final_merge):
    top k, dead entries (<= -BIG/2) to -inf / -1, the euclidean -|q|^2 term
    added after the merge. Returns (values [nq, k] f32, addresses int32)."""
    kk = min(k, vals.shape[1])
    fv, fi = torch.topk(vals, kk, dim=-1)
    fa = torch.gather(idx, 1, fi)
    alive = fv > -BIG / 2
    fa = torch.where(alive, fa, -1).int()
    if distance == "euclidean":
        fv = fv - torch.sum(query * query, -1)[:, None]
    fv = torch.where(alive, fv, -torch.inf)
    if kk < k:
        fv = torch.nn.functional.pad(fv, (0, k - kk), value=-torch.inf)
        fa = torch.nn.functional.pad(fa, (0, k - kk), value=-1)
    return fv, fa


def flat_adc_scan(query, decoded, penalty, *, k, distance, max_elems=1 << 28):
    """query [nq, d] f32 (preprocessed); decoded [cap, d] bf16/f32; penalty
    [cap] f32 = norms (euclidean) or 0, with BIG at empty slots.

    Returns (values [nq, k] f32, addresses [nq, k] int32, -1 padding); the
    euclidean -|q|^2 term is added after the merge. `max_elems` bounds the
    [nq, chunk] score tile."""
    distance = canonical_distance(distance)
    if distance == "manhattan":
        raise NotImplementedError(
            "manhattan distance is not ported yet (ROADMAP A12)")
    query = util.pad_cols(query.float(), decoded.shape[-1])
    # bf16 cache: the query rounds to bf16 too, then both operands go up to
    # f32, where bf16 products are exact (the JAX package's bf16 x bf16 ->
    # f32 product)
    q_mm = query.to(decoded.dtype).float() \
        if decoded.dtype == torch.bfloat16 else query
    vals, idx = flat_sweep(
        q_mm, lambda c0, c1: decoded[c0:c1].float(), decoded.shape[0],
        penalty, k=k, factor=2.0 if distance == "euclidean" else 1.0,
        max_elems=max_elems)
    return final_merge(vals, idx, query, k=k, distance=distance)
