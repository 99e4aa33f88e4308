"""Functional core of the k-means family (counterpart of
torchpq_tpu/clustering/lloyd.py).

Every function here works on a batch of `m` independent problems at once
(`m == 1` for KMeans, `m == n_subvectors` for PQ codebooks): data
[m, n, d] f32 ("nd") or [m, d, n] ("dn"), centroids [m, k, d] f32.
Randomness comes from an explicit torch.Generator; it will not draw the
JAX package's numbers, so parity is held by feeding both the same initial
centroids.
"""

import torch

from .. import util
from ..metric import canonical_distance
from ..ops.max_sim import batched_max_sim
from ..ops.segment_ops import batched_compute_centroids


def _rows(data, dn):
    """[m, n, d] view of the data, whatever its layout."""
    return data.transpose(1, 2) if dn else data


def _init_random(x, gen, n_clusters):
    """k distinct data points per problem (with replacement when n < k)."""
    m, n, _ = x.shape
    out = []
    for i in range(m):
        if n < n_clusters:
            idx = torch.randint(n, (n_clusters,), generator=gen)
        else:
            idx = torch.randperm(n, generator=gen)[:n_clusters]
        out.append(x[i, idx.to(x.device)])
    return torch.stack(out)


def _init_kmeanspp(x, gen, n_clusters, distance):
    """k-means++ seeding by Gumbel-max sampling on log D, with D the
    squared L2 distance to the nearest seed (the L1 distance for
    manhattan)."""
    l1 = canonical_distance(distance) == "manhattan"

    def dist_to(xi, c):
        diff = xi - c
        return torch.sum(diff.abs() if l1 else diff * diff, dim=-1)

    m, n, d = x.shape
    out = []
    for i in range(m):
        xi = x[i]
        first = int(torch.randint(n, (1,), generator=gen))
        cents = torch.zeros((n_clusters, d), dtype=xi.dtype, device=xi.device)
        cents[0] = xi[first]
        best_d = dist_to(xi, xi[first])
        for j in range(1, n_clusters):
            u = torch.rand(n, generator=gen).clamp_(1e-20, 1.0)
            g = -torch.log(-torch.log(u)).to(xi.device)
            idx = int(torch.argmax(torch.log(best_d.clamp(min=1e-30)) + g))
            cents[j] = xi[idx]
            best_d = torch.minimum(best_d, dist_to(xi, xi[idx]))
        out.append(cents)
    return torch.stack(out)


def lloyd_fit(data, gen, *, n_clusters, max_iter, tol, distance, init_mode,
              init_centroids=None, layout="nd"):
    """One full Lloyd run per problem. Returns (centroids [m, k, d],
    labels [m, n], inertia [m], n_iters). Stops after `max_iter` updates or
    once the summed squared centroid shift is at most `tol`."""
    distance = canonical_distance(distance)
    dn = layout == "dn"
    data = data.float()
    if distance == "cosine":
        data = util.normalize(data, dim=1 if dn else -1)
    x = _rows(data, dn)

    if init_centroids is not None:
        cents = init_centroids.float().to(data.device)
    elif init_mode == "kmeans++":
        cents = _init_kmeanspp(x, gen, n_clusters, distance)
    else:
        cents = _init_random(x, gen, n_clusters)
    if distance == "cosine":
        cents = util.normalize(cents)

    err = float("inf")
    it = 0
    while it < max_iter and err > tol:
        _, labels = batched_max_sim(data, cents, distance, layout=layout)
        sums, counts = batched_compute_centroids(x, labels, n_clusters)
        new_c = torch.where((counts > 0)[..., None],
                            sums / torch.clamp(counts, min=1.0)[..., None],
                            cents)
        if distance == "cosine":
            new_c = util.normalize(new_c)
        err = float(torch.sum((new_c - cents) ** 2))
        cents = new_c
        it += 1
    maxs, labels = batched_max_sim(data, cents, distance, layout=layout)
    inertia = -torch.mean(maxs, dim=-1)
    return cents, labels, inertia, it


def fit_redo(data, gen, *, n_clusters, n_redo, max_iter, tol, distance,
             init_mode, init_centroids=None, layout="nd"):
    """n_redo restarts, keeping the lowest-inertia run per problem.
    Explicit init_centroids make Lloyd deterministic: run once."""
    if init_centroids is not None:
        n_redo = 1
    best = None
    for _ in range(max(n_redo, 1)):
        out = lloyd_fit(
            data, gen, n_clusters=n_clusters, max_iter=max_iter, tol=tol,
            distance=distance, init_mode=init_mode,
            init_centroids=init_centroids, layout=layout)
        if best is None:
            best = out
            continue
        c0, l0, i0, _ = best
        c1, l1, i1, it = out
        take = i1 < i0  # [m]
        best = (torch.where(take[:, None, None], c1, c0),
                torch.where(take[:, None], l1, l0),
                torch.minimum(i1, i0), it)
    return best
