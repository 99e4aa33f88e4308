"""Batched similarity matrices with distance epilogues (counterpart of
torchpq_tpu/ops/bmm.py, the reference's BMM kernel family). Operands are
batched row-major: a [l, m, d], b [l, n, d] -> [l, m, n] f32 similarities
(larger is better). Plain torch: batched products (util.matmul) and the
reductions; the JAX package runs no Pallas kernel here. `precision` is the
products' matmul precision (config.py; None: the search precision)."""

import torch

from .. import config
from .. import util
from ..metric import canonical_distance


def bmm(a, b, distance="inner", precision=None):
    """[l, m, d] x [l, n, d] -> [l, m, n]: inner products, negative squared
    L2 (2 ab - |a|^2 - |b|^2), cosine, or negative L1 over chunks of a's
    rows that bound the [l, chunk, n, d] broadcast."""
    distance = canonical_distance(distance)
    a, b = torch.as_tensor(a).float(), torch.as_tensor(b).float()
    if distance == "manhattan":
        l, m, _ = a.shape
        n = b.shape[1]
        chunk = max(8, min(m, config.MAX_SIM_CHUNK_ELEMS // max(l * n, 1)))
        out = torch.empty((l, m, n), device=a.device)
        for i in range(0, m, chunk):
            out[:, i:i + chunk] = -torch.sum(torch.abs(
                a[:, i:i + chunk, None, :] - b[:, None, :, :]), dim=-1)
        return out
    if distance == "cosine":
        a, b = util.normalize(a), util.normalize(b)
    ab = util.matmul(a, b, precision)
    if distance == "euclidean":
        ab = (2.0 * ab - torch.sum(a * a, -1)[:, :, None]
              - torch.sum(b * b, -1)[:, None, :])
    return ab


def min_bmm(a, b, distance="euclidean", dim=2, precision=None):
    """The best match along `dim` (1 or 2) -> (values, int32 indices, the
    first index among equal values)."""
    assert dim in (1, 2)
    sims = bmm(a, b, distance=distance, precision=precision)
    return sims.amax(dim=dim), torch.argmax(sims, dim=dim).int()


def topk_bmm(a, b, k=128, distance="inner", dim=2, precision=None):
    """Per-row top-k along `dim` (1 or 2) -> (values, int32 indices)."""
    assert dim in (1, 2)
    sims = bmm(a, b, distance=distance, precision=precision)
    if dim == 1:
        sims = sims.transpose(1, 2)
    vals, idx = torch.topk(sims, min(k, sims.shape[-1]), dim=-1)
    return vals, idx.int()


def masked_bmm(a, b, mask, distance="inner", precision=None):
    """bmm with -inf where `mask` (broadcastable to [l, m, n]) is False."""
    sims = bmm(a, b, distance=distance, precision=precision)
    return torch.where(torch.as_tensor(mask, device=sims.device), sims,
                       -torch.inf)
