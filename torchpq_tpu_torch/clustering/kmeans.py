"""KMeans / MultiKMeans (counterpart of torchpq_tpu/clustering/kmeans.py).

Data layout is the reference's feature-major one: KMeans.fit takes
[d_vector, n_data], MultiKMeans.fit takes [m, d_subvector, n_data]. The
`centroids` property exposes the reference layout ([d, k] resp. [m, d, k]);
the registered state `_centroids` is row-major [m, k, d], as in the JAX
package's state dict.
"""

import torch

from .. import util
from ..metric import (canonical_distance, cosine_similarity,
                      negative_squared_l2_distance, similarity)
from ..module import StateModule
from ..ops.max_sim import batched_max_sim, batched_topk_sim, max_sim, \
    topk_sim
from . import lloyd


class MultiKMeans(StateModule):
    """`m` independent k-means problems solved together (PQ training)."""

    def __init__(self, n_clusters, n_redo=1, max_iter=100, tol=1e-4,
                 distance="euclidean", init_mode="random", verbose=0,
                 sm_size=None, seed=0, device=None):
        super().__init__(verbose=verbose, device=device)
        del sm_size  # the reference's shared-memory knob; no effect here
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

    @centroids.setter
    def centroids(self, value):
        self._centroids = None if value is None else util.as_tensor(
            value, self.device, torch.float32).transpose(1, 2).contiguous()

    @property
    def is_trained(self):
        return self._centroids is not None

    # -- memory probing and similarity helpers (kmeans.py:60-95) --
    @staticmethod
    def remaining_memory(device=None):
        """Free device memory in bytes: the CUDA allocator's free bytes on
        a card, else the JAX package's assumption of 8 GiB."""
        dev = torch.device(device if device is not None else (
            "cuda" if torch.cuda.is_available() else "cpu"))
        if dev.type == "cuda":
            return int(torch.cuda.mem_get_info(dev)[0])
        return 1 << 33

    @staticmethod
    def does_it_fit(size, device=None, dtype=torch.float32):
        itemsize = torch.empty((), dtype=util.str2dtype(dtype)).element_size()
        return size * itemsize < MultiKMeans.remaining_memory(device)

    @staticmethod
    def cos_sim(a, b):
        """[d, na] x [d, nb] -> [na, nb] cosine similarity."""
        return cosine_similarity(a.T, b.T)

    @staticmethod
    def euc_sim(a, b):
        """[d, na] x [d, nb] -> [na, nb] negative squared L2."""
        return negative_squared_l2_distance(a.T, b.T)

    def sim(self, a, b):
        """[d, na] x [d, nb] -> [na, nb] by the instance's distance."""
        return similarity(a.T, b.T, self.distance)

    @staticmethod
    def calculate_error(a, b):
        return torch.sum((a - b) ** 2)

    @staticmethod
    def calculate_inertia(maxsims):
        return torch.mean(-maxsims)

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

    def _query(self, query):
        """query [m, d_subvector, n] -> f32 on the device, normalized along
        d for cosine."""
        assert self.is_trained, "kmeans is not trained"
        x = util.as_tensor(query, self.device, torch.float32)
        if x.ndim != 3:
            raise ValueError(f"expected [m, d, n], got {tuple(x.shape)}")
        return util.normalize(x, dim=1) if self.distance == "cosine" else x

    def predict(self, query):
        """query: [m, d_subvector, n] -> labels [m, n] i32."""
        _, labels = batched_max_sim(self._query(query), self._centroids,
                                    self.distance, layout="dn")
        return labels

    def topk(self, query, k=128):
        """query: [m, d_subvector, n] -> (values, indices) [m, n, k] of the
        k best centroids of each problem."""
        x = self._query(query).transpose(1, 2)
        return batched_topk_sim(x, self._centroids, k, self.distance)


class KMeans(MultiKMeans):
    """Single k-means problem."""

    @property
    def centroids(self):
        """[d_vector, n_clusters] like the reference buffer."""
        if self._centroids is None:
            return None
        return self._centroids[0].T

    @centroids.setter
    def centroids(self, value):
        self._centroids = None if value is None else util.as_tensor(
            value, self.device, torch.float32).T[None].contiguous()

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

    def _query(self, query):
        """query [d_vector, n] -> [n, d_vector] f32 on the device,
        normalized for cosine."""
        assert self.is_trained, "kmeans is not trained"
        x = util.as_tensor(query, self.device, torch.float32).T
        return util.normalize(x) if self.distance == "cosine" else x

    def predict(self, query):
        """query: [d_vector, n] -> labels [n] i32."""
        _, labels = max_sim(self._query(query), self._centroids[0],
                            self.distance)
        return labels

    def topk(self, query, k=128):
        """query: [d_vector, n] -> (values, indices) [n, k] of the k best
        centroids per query."""
        return topk_sim(self._query(query), self._centroids[0], k,
                        self.distance)
