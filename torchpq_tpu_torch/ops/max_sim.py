"""Chunked similarity + argmax / top-k (counterpart of
torchpq_tpu/ops/max_sim.py): one GEMM per row chunk, so the [n, k] score
matrix is never held whole. Manhattan has no GEMM form: its chunks also
bound the [chunk, k, d] broadcast. `precision` is the products' matmul
precision (config.py): None is the search precision in max_sim / topk_sim
(through metric.similarity) and the train precision in the batched ones,
which serve k-means and codebook training, as in the JAX package."""

import torch

from .. import config
from .. import util
from ..metric import similarity, canonical_distance


def _chunk_rows(total_free_elems, inner):
    c = max(8, total_free_elems // max(inner, 1))
    return util.next_pow2(min(c, 65536))


def _inner(distance, d):
    """Elements per (row, centroid) pair a score chunk holds: the
    manhattan broadcast keeps all d, the products one."""
    return d if distance == "manhattan" else 1


def max_sim(data, centroids, distance, precision=None, chunk=None):
    """data [n, d], centroids [k, d] -> (maxsims [n] f32, labels [n] i32).
    Ties go to the lowest centroid index, as in the JAX package."""
    distance = canonical_distance(distance)
    if chunk is None:
        chunk = _chunk_rows(config.MAX_SIM_CHUNK_ELEMS, centroids.shape[0]
                            * _inner(distance, centroids.shape[1]))
    maxs, labels = [], []
    for i in range(0, data.shape[0], chunk):
        sim = similarity(data[i:i + chunk], centroids, distance,
                         precision=precision)
        v, a = torch.max(sim, dim=-1)
        maxs.append(v)
        labels.append(a.int())
    return torch.cat(maxs), torch.cat(labels)


def topk_sim(data, centroids, k_top, distance, precision=None, chunk=None,
             approx=False):
    """Per-row top-k over centroids -> (values [n, k], indices [n, k]).
    The JAX package's approx_max_k is exact off the TPU, so `approx` takes
    the exact top-k here too."""
    distance = canonical_distance(distance)
    k_top = min(int(k_top), centroids.shape[0])
    if chunk is None:
        chunk = _chunk_rows(config.MAX_SIM_CHUNK_ELEMS, centroids.shape[0]
                            * _inner(distance, centroids.shape[1]))
    vals, idx = [], []
    for i in range(0, data.shape[0], chunk):
        sim = similarity(data[i:i + chunk], centroids, distance,
                         precision=precision)
        v, a = torch.topk(sim, k_top, dim=-1)
        vals.append(v)
        idx.append(a.int())
    return torch.cat(vals), torch.cat(idx)


def _scores_batched(b, centroids, distance, precision):
    """b [m, c, d], centroids [m, k, d] -> [m, c, k], the products at
    `precision` (None: config.TRAIN_PRECISION)."""
    if distance == "manhattan":
        return -torch.sum(torch.abs(b[:, :, None, :]
                                    - centroids[:, None, :, :]), dim=-1)
    ab = util.matmul(b, centroids,
                     config.resolve_precision(precision, train=True))
    if distance == "euclidean":
        return (2.0 * ab
                - torch.sum(b * b, dim=-1)[:, :, None]
                - torch.sum(centroids * centroids, dim=-1)[:, None, :])
    return ab


def batched_max_sim(data, centroids, distance, precision=None, layout="nd"):
    """Multi-problem assignment for MultiKMeans.

    data: [m, n, d] (layout="nd") or [m, d, n] (layout="dn"),
    centroids: [m, k, d] -> (maxsims [m, n], labels [m, n] i32)."""
    distance = canonical_distance(distance)
    if layout == "dn":
        data = data.transpose(1, 2)
    m, n, _ = data.shape
    centroids = centroids.float()
    chunk = _chunk_rows(config.MAX_SIM_CHUNK_ELEMS, max(
        m * centroids.shape[1] * _inner(distance, centroids.shape[2]), 1))
    maxs, labels = [], []
    for i in range(0, n, chunk):
        sim = _scores_batched(data[:, i:i + chunk].float(), centroids,
                              distance, precision)
        v, a = torch.max(sim, dim=-1)
        maxs.append(v)
        labels.append(a.int())
    return torch.cat(maxs, dim=1), torch.cat(labels, dim=1)


def batched_topk_sim(data, centroids, k_top, distance, precision=None):
    """Per-problem top-k over centroids for MultiKMeans.topk.

    data: [m, n, d], centroids: [m, k, d] -> (vals [m, n, k_top] f32,
    idx [m, n, k_top] i32)."""
    distance = canonical_distance(distance)
    n = data.shape[1]
    k_top = min(int(k_top), centroids.shape[1])
    centroids = centroids.float()
    chunk = _chunk_rows(config.MAX_SIM_CHUNK_ELEMS, max(
        data.shape[0] * centroids.shape[1]
        * _inner(distance, centroids.shape[2]), 1))
    vals, idx = [], []
    for i in range(0, n, chunk):
        sim = _scores_batched(data[:, i:i + chunk].float(), centroids,
                              distance, precision)
        v, a = torch.topk(sim, k_top, dim=-1)
        vals.append(v)
        idx.append(a.int())
    return torch.cat(vals, dim=1), torch.cat(idx, dim=1)
