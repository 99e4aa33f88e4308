"""Chunked similarity + argmax / top-k (counterpart of
torchpq_tpu/ops/max_sim.py): one GEMM per row chunk, so the [n, k] score
matrix is never held whole."""

import torch

from .. import config
from .. import util
from ..metric import similarity, canonical_distance


def _chunk_rows(total_free_elems, inner):
    c = max(8, total_free_elems // max(inner, 1))
    return util.next_pow2(min(c, 65536))


def max_sim(data, centroids, distance, chunk=None):
    """data [n, d], centroids [k, d] -> (maxsims [n] f32, labels [n] i32).
    Ties go to the lowest centroid index, as in the JAX package."""
    distance = canonical_distance(distance)
    if chunk is None:
        chunk = _chunk_rows(config.MAX_SIM_CHUNK_ELEMS, centroids.shape[0])
    maxs, labels = [], []
    for i in range(0, data.shape[0], chunk):
        sim = similarity(data[i:i + chunk], centroids, distance)
        v, a = torch.max(sim, dim=-1)
        maxs.append(v)
        labels.append(a.int())
    return torch.cat(maxs), torch.cat(labels)


def topk_sim(data, centroids, k_top, distance, chunk=None):
    """Per-row top-k over centroids -> (values [n, k], indices [n, k])."""
    distance = canonical_distance(distance)
    k_top = min(int(k_top), centroids.shape[0])
    if chunk is None:
        chunk = _chunk_rows(config.MAX_SIM_CHUNK_ELEMS, centroids.shape[0])
    vals, idx = [], []
    for i in range(0, data.shape[0], chunk):
        sim = similarity(data[i:i + chunk], centroids, distance)
        v, a = torch.topk(sim, k_top, dim=-1)
        vals.append(v)
        idx.append(a.int())
    return torch.cat(vals), torch.cat(idx)


def _scores_batched(b, centroids, distance):
    """b [m, c, d], centroids [m, k, d] -> [m, c, k]."""
    ab = torch.bmm(b, centroids.transpose(1, 2))
    if distance in ("inner", "cosine"):
        return ab
    if distance == "euclidean":
        return (2.0 * ab
                - torch.sum(b * b, dim=-1)[:, :, None]
                - torch.sum(centroids * centroids, dim=-1)[:, None, :])
    raise NotImplementedError(
        "manhattan distance is not ported yet (ROADMAP A12)")


def batched_max_sim(data, centroids, distance, layout="nd"):
    """Multi-problem assignment for MultiKMeans.

    data: [m, n, d] (layout="nd") or [m, d, n] (layout="dn"),
    centroids: [m, k, d] -> (maxsims [m, n], labels [m, n] i32)."""
    distance = canonical_distance(distance)
    if layout == "dn":
        data = data.transpose(1, 2)
    m, n, _ = data.shape
    centroids = centroids.float()
    chunk = _chunk_rows(config.MAX_SIM_CHUNK_ELEMS,
                        max(m * centroids.shape[1], 1))
    maxs, labels = [], []
    for i in range(0, n, chunk):
        sim = _scores_batched(data[:, i:i + chunk].float(), centroids,
                              distance)
        v, a = torch.max(sim, dim=-1)
        maxs.append(v)
        labels.append(a.int())
    return torch.cat(maxs, dim=1), torch.cat(labels, dim=1)
