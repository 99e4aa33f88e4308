"""Flat (exhaustive) ADC scan over the decoded cache (counterpart of
torchpq_tpu/ops/flat_adc.py:flat_adc_scan).

The JAX package runs this outside any Pallas kernel, so here it is plain
torch: the cache is swept in slot chunks, each chunk one float32 product
[nq, d] x [d, chunk] and a per-query top-k, and the chunk winners merge with
one exact top-k. The JAX package's approx_max_k is exact off the TPU, so
both `approx` settings take the exact top-k here.
"""

import torch

from .. import util
from ..metric import canonical_distance
from .block_scan import BIG


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
    nq = query.shape[0]
    cap = decoded.shape[0]
    chunk = min(cap, max(1024, max_elems // max(nq, 1)))
    k_c = min(k, chunk)
    # bf16 cache: the query rounds to bf16 too, then both operands go up to
    # f32, where bf16 products are exact (the JAX package's bf16 x bf16 ->
    # f32 product)
    q_mm = query.to(decoded.dtype).float() \
        if decoded.dtype == torch.bfloat16 else query
    factor = 2.0 if distance == "euclidean" else 1.0
    vals, idx = [], []
    for c0 in range(0, cap, chunk):
        block = decoded[c0:c0 + chunk].float()
        # factor * <q, y> - penalty as one GEMM with its bias epilogue
        s = torch.addmm(-penalty[c0:c0 + chunk][None, :], q_mm, block.T,
                        alpha=factor)
        v, i = torch.topk(s, min(k_c, s.shape[1]), dim=-1)
        vals.append(v)
        idx.append(i + c0)
    vals = torch.cat(vals, dim=1)
    idx = torch.cat(idx, dim=1)
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
