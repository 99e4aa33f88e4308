"""OPQ, optimized product quantization (counterpart of
torchpq_tpu/transform/opq.py): the non-parametric OPQ of Ge et al. (CVPR
2013). Each round fits the PQ codebooks on the rotated data, warm-started
from the previous round's, then solves the orthogonal Procrustes problem
R = U V^T from SVD(Y X^T), Y the PQ reconstruction."""

import torch

from .. import util
from ..codec import PQCodec
from ..codec.base import BaseCodec


class OPQ(BaseCodec):
    def __init__(self, d_vector, n_subvectors=8, n_clusters=256,
                 distance="euclidean", n_iter=8, pq_max_iter=10, verbose=0,
                 seed=0, device=None):
        super().__init__(verbose=verbose, device=device)
        self.d_vector = d_vector
        self.n_subvectors = n_subvectors
        self.n_iter = int(n_iter)
        self.register_state("_rotation", torch.eye(d_vector,
                                                   device=self.device))
        self.register_module("pq", PQCodec(
            d_vector=d_vector, n_subvectors=n_subvectors,
            n_clusters=n_clusters, distance=distance, verbose=verbose,
            max_iter=pq_max_iter, seed=seed, device=device))

    @property
    def rotation(self):
        return self._rotation

    @property
    def codebook(self):
        return self.pq.codebook

    def train(self, x):
        """x: [d_vector, n]; n_iter rounds from the current rotation."""
        x = util.as_tensor(x, self.device, torch.float32)
        assert x.shape[0] == self.d_vector
        r = self._rotation
        warm = None
        for it in range(self.n_iter):
            xr = r @ x
            self.pq.train(xr, centroids=warm)
            self.pq._set_trained(True)
            recon = self.pq.decode(self.pq.encode(xr))  # Y: [d, n]
            u, _, vt = torch.linalg.svd(recon @ x.T, full_matrices=False)
            r = u @ vt
            if self.verbose:
                err = float(torch.mean((r @ x - recon) ** 2))
                self.print_message(f"OPQ iter {it}: distortion {err:.6g}", 1)
            warm = self.pq.codebook
            self.pq._set_trained(False)
        self.register_state("_rotation", r)
        self.pq.train(r @ x, centroids=warm)
        self._set_trained(True)

    def rotate(self, x):
        """The learned rotation alone: [d, n] -> [d, n]."""
        assert self.is_trained
        return self._rotation @ util.as_tensor(x, self.device, torch.float32)

    def encode(self, x):
        assert self.is_trained
        return self.pq.encode(self.rotate(x))

    def decode(self, code):
        assert self.is_trained
        return self._rotation.T @ self.pq.decode(code)
