"""KMeans / MultiKMeans (counterpart of torchpq_tpu/clustering/kmeans.py).

Data layout is the reference's feature-major one: KMeans.fit takes
[d_vector, n_data], MultiKMeans.fit takes [m, d_subvector, n_data]. The
`centroids` property exposes the reference layout ([d, k] resp. [m, d, k]);
the registered state `_centroids` is row-major [m, k, d], as in the JAX
package's state dict.
"""

import torch

from .. import util
from ..metric import canonical_distance
from ..module import StateModule
from ..ops.max_sim import max_sim
from . import lloyd


class MultiKMeans(StateModule):
    """`m` independent k-means problems solved together (PQ training)."""

    def __init__(self, n_clusters, n_redo=1, max_iter=100, tol=1e-4,
                 distance="euclidean", init_mode="random", verbose=0,
                 seed=0, device=None):
        super().__init__(verbose=verbose, device=device)
        self.n_clusters = n_clusters
        self.n_redo = n_redo
        self.max_iter = max_iter
        self.tol = tol
        self.distance = canonical_distance(distance)
        self.init_mode = init_mode
        self.seed = seed
        self.register_state("_centroids", None)  # internal [m, k, d]

    @property
    def centroids(self):
        """[m, d_subvector, n_clusters] like the reference's buffer."""
        if self._centroids is None:
            return None
        return self._centroids.transpose(1, 2)

    @property
    def is_trained(self):
        return self._centroids is not None

    def _generator(self):
        return torch.Generator().manual_seed(int(self.seed))

    def fit(self, data, centroids=None):
        """data: [m, d_subvector, n_data]; centroids ([m, d, k], optional)
        seed Lloyd instead of the random init. Returns labels [m, n]."""
        data = util.as_tensor(data, self.device, torch.float32)
        if data.ndim != 3:
            raise ValueError(f"expected [m, d, n], got {tuple(data.shape)}")
        init = None if centroids is None else util.as_tensor(
            centroids, self.device, torch.float32).transpose(1, 2)
        cents, labels, inertia, iters = lloyd.fit_redo(
            data, self._generator(), n_clusters=self.n_clusters,
            n_redo=self.n_redo, max_iter=self.max_iter, tol=self.tol,
            distance=self.distance, init_mode=self.init_mode,
            init_centroids=init, layout="dn")
        self.register_state("_centroids", cents.contiguous())
        self.print_message(f"fit done: {iters} iters", 1)
        return labels


class KMeans(MultiKMeans):
    """Single k-means problem."""

    @property
    def centroids(self):
        """[d_vector, n_clusters] like the reference buffer."""
        if self._centroids is None:
            return None
        return self._centroids[0].T

    def fit(self, data, centroids=None):
        """data: [d_vector, n_data]; centroids [d_vector, k] optional.
        Returns labels [n]."""
        data = util.as_tensor(data, self.device, torch.float32)
        if data.ndim != 2:
            raise ValueError(
                f"expected [d_vector, n_data], got {tuple(data.shape)}")
        init = None if centroids is None else util.as_tensor(
            centroids, self.device, torch.float32).T[None]
        cents, labels, inertia, iters = lloyd.fit_redo(
            data.T[None], self._generator(), n_clusters=self.n_clusters,
            n_redo=self.n_redo, max_iter=self.max_iter, tol=self.tol,
            distance=self.distance, init_mode=self.init_mode,
            init_centroids=init)
        self.register_state("_centroids", cents.contiguous())
        self.print_message(
            f"fit done: {iters} iters, inertia={float(inertia[0]):.6g}", 1)
        return labels[0]

    def predict(self, query):
        """query: [d_vector, n] -> labels [n] i32."""
        assert self.is_trained, "kmeans is not trained"
        x = util.as_tensor(query, self.device, torch.float32).T
        if self.distance == "cosine":
            x = util.normalize(x)
        _, labels = max_sim(x, self._centroids[0], self.distance)
        return labels
