"""Online (mini-batch) k-means (counterpart of
torchpq_tpu/clustering/minibatch_kmeans.py): persistent per-cluster
counts, one assignment per batch and a centroid step towards the batch
mean at the per-cluster rate batch_count / total_count."""

import torch

from .. import util
from ..metric import canonical_distance
from ..module import StateModule
from ..ops.max_sim import max_sim, topk_sim
from ..ops.segment_ops import compute_centroids
from . import lloyd


def _minibatch_step(data, centroids, counts, *, n_clusters, distance):
    """data [n, d] -> (new centroids [k, d], new counts [k], inertia,
    error) as 0-d tensors."""
    maxs, labels = max_sim(data, centroids, distance)
    sums, batch_counts = compute_centroids(data, labels, n_clusters)
    new_counts = counts + batch_counts
    lr = torch.where(new_counts > 0,
                     batch_counts / torch.clamp(new_counts, min=1.0), 0.0)
    batch_mean = sums / torch.clamp(batch_counts, min=1.0)[:, None]
    new_c = centroids + lr[:, None] * (batch_mean - centroids)
    new_c = torch.where((batch_counts > 0)[:, None], new_c, centroids)
    if distance == "cosine":
        new_c = util.normalize(new_c)
    error = torch.sum((new_c - centroids) ** 2)
    return new_c, new_counts, -torch.mean(maxs), error


class MinibatchKMeans(StateModule):
    def __init__(self, n_clusters, distance="euclidean", init_mode="random",
                 verbose=0, sm_size=None, seed=0, device=None):
        super().__init__(verbose=verbose, device=device)
        del sm_size  # the reference's shared-memory size; no effect
        self.n_clusters = n_clusters
        self.distance = canonical_distance(distance)
        self.init_mode = init_mode
        self.seed = seed
        self.register_state("_centroids", None)  # [k, d]
        self.register_state("_n_points_in_clusters", None)  # [k] f32
        self.register_state("_inertia", float("nan"))
        self.register_state("_error", float("nan"))

    @property
    def centroids(self):
        return None if self._centroids is None else self._centroids.T

    @property
    def n_points_in_clusters(self):
        return self._n_points_in_clusters

    @property
    def inertia(self):
        return self._inertia

    @property
    def error(self):
        return self._error

    @property
    def is_trained(self):
        return self._centroids is not None

    def _to_internal(self, data):
        x = util.as_tensor(data, self.device, torch.float32)
        assert x.ndim == 2, f"expected [d_vector, n_data], got {x.shape}"
        x = x.T
        return util.normalize(x) if self.distance == "cosine" else x

    def _reset(self, cents):
        self.register_state("_centroids", cents.contiguous())
        self.register_state("_n_points_in_clusters", torch.zeros(
            self.n_clusters, dtype=torch.float32, device=self.device))

    def fit_minibatch(self, data, centroids=None):
        """One online update with a batch [d_vector, n]; `centroids`
        ([d_vector, k]) restart from those. Returns labels [n]."""
        x = self._to_internal(data)
        if centroids is not None:
            self._reset(util.as_tensor(centroids, self.device,
                                       torch.float32).T)
        if self._centroids is None:
            gen = torch.Generator().manual_seed(int(self.seed))
            if self.init_mode == "kmeans++":
                cents = lloyd._init_kmeanspp(x[None], gen, self.n_clusters,
                                             self.distance)[0]
            else:
                cents = lloyd._init_random(x[None], gen, self.n_clusters)[0]
            self._reset(cents)
        new_c, new_counts, inertia, error = _minibatch_step(
            x, self._centroids, self._n_points_in_clusters,
            n_clusters=self.n_clusters, distance=self.distance)
        self.register_state("_centroids", new_c)
        self.register_state("_n_points_in_clusters", new_counts)
        self.register_state("_inertia", float(inertia))
        self.register_state("_error", float(error))
        return max_sim(x, new_c, self.distance)[1]

    def predict(self, query):
        assert self.is_trained, "not trained"
        return max_sim(self._to_internal(query), self._centroids,
                       self.distance)[1]

    def topk(self, query, k=128):
        assert self.is_trained
        return topk_sim(self._to_internal(query), self._centroids, k,
                        self.distance)
