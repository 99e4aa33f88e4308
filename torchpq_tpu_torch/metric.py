"""Similarity metrics (counterpart of torchpq_tpu/metric.py).

Every score is a similarity — larger is better. Euclidean is the negative
squared L2 distance. Functions take row-major [n, d] tensors and return
[n_a, n_b] score matrices in float32.
"""

import torch

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


def inner_similarity(a, b):
    """<a_i, b_j> for all pairs. a: [na, d], b: [nb, d] -> [na, nb]."""
    return util.matmul_f32(a, b)


def cosine_similarity(a, b):
    return inner_similarity(util.normalize(a.float()), util.normalize(b.float()))


def negative_squared_l2_distance(a, b, b_sq=None):
    """-||a_i - b_j||^2 expanded as 2<a,b> - ||a||^2 - ||b||^2 (the same
    expansion as the JAX package, so near-ties round alike)."""
    a = a.float()
    b = b.float()
    ab = inner_similarity(a, b)
    a_sq = torch.sum(a * a, dim=-1, keepdim=True)
    if b_sq is None:
        b_sq = torch.sum(b * b, dim=-1)
    return 2.0 * ab - a_sq - b_sq[None, :]


def similarity(a, b, distance, b_sq=None):
    """Dispatch by canonical distance name; [na, d] x [nb, d] -> [na, nb]."""
    distance = canonical_distance(distance)
    if distance == "euclidean":
        return negative_squared_l2_distance(a, b, b_sq=b_sq)
    if distance == "cosine":
        return cosine_similarity(a, b)
    if distance == "inner":
        return inner_similarity(a, b)
    raise NotImplementedError(
        "manhattan distance is not ported yet (ROADMAP A12)")
