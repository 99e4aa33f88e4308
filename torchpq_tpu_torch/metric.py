"""Similarity metrics (counterpart of torchpq_tpu/metric.py).

Every score is a similarity — larger is better. Euclidean is the negative
squared L2 distance, manhattan the negative L1 distance. Functions take
row-major [n, d] tensors and return [n_a, n_b] score matrices in float32.
`precision` is the products' matmul precision (config.py; None: the search
precision); the norm terms are float32 sums at every precision.
"""

import torch

from . import config
from . import util

CANONICAL = {
    "euclidean": "euclidean", "l2": "euclidean",
    "cosine": "cosine", "angular": "cosine",
    "inner": "inner", "dot": "inner", "ip": "inner",
    "manhattan": "manhattan", "l1": "manhattan",
}


def canonical_distance(name):
    key = str(name).lower()
    if key not in CANONICAL:
        raise ValueError(f"unknown distance {name!r}")
    return CANONICAL[key]


def inner_similarity(a, b, precision=None):
    """<a_i, b_j> for all pairs. a: [na, d], b: [nb, d] -> [na, nb]; b
    may be util.matmul_operand's."""
    return util.matmul(a, b, precision)


def cosine_similarity(a, b, precision=None):
    return inner_similarity(util.normalize(a.float()),
                            util.normalize(b.float()), precision=precision)


def negative_squared_l2_distance(a, b, precision=None, b_sq=None):
    """-||a_i - b_j||^2 expanded as 2<a,b> - ||a||^2 - ||b||^2 (the same
    expansion as the JAX package, so near-ties round alike). b may be
    util.matmul_operand's where b_sq is given."""
    a = a.float()
    ab = inner_similarity(a, b, precision=precision)
    a_sq = torch.sum(a * a, dim=-1, keepdim=True)
    if b_sq is None:
        b = b.float()
        b_sq = torch.sum(b * b, dim=-1)
    return 2.0 * ab - a_sq - b_sq[None, :]


def negative_manhattan_distance(a, b, chunk=None):
    """-sum_k |a_ik - b_jk| in float32, over chunks of `a`'s rows that bound
    the [chunk, nb, d] broadcast to config.MAX_SIM_CHUNK_ELEMS elements."""
    a, b = a.float(), b.float()
    if chunk is None:
        chunk = max(1, config.MAX_SIM_CHUNK_ELEMS
                    // max(b.shape[0] * b.shape[1], 1))
    out = torch.empty((a.shape[0], b.shape[0]), device=a.device)
    for i in range(0, a.shape[0], chunk):
        out[i:i + chunk] = -torch.sum(
            torch.abs(a[i:i + chunk, None, :] - b[None]), dim=-1)
    return out


def similarity(a, b, distance, precision=None, b_sq=None):
    """Dispatch by canonical distance name; [na, d] x [nb, d] -> [na, nb]."""
    distance = canonical_distance(distance)
    if distance == "euclidean":
        return negative_squared_l2_distance(a, b, precision=precision,
                                            b_sq=b_sq)
    if distance == "cosine":
        return cosine_similarity(a, b, precision=precision)
    if distance == "inner":
        return inner_similarity(a, b, precision=precision)
    return negative_manhattan_distance(a, b)


def preprocess_query(q, distance):
    """Queries are L2-normalized for cosine, row-wise ([nq, d])."""
    if canonical_distance(distance) == "cosine":
        return util.normalize(q)
    return q
