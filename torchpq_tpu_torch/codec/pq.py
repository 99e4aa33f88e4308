"""Product-quantizer codec (counterpart of torchpq_tpu/codec/pq.py), 8-bit
codes only: 256-centroid codebooks per subvector trained with MultiKMeans,
uint8 codes, decode by codebook gather.

The JAX package decodes large batches with a block-diagonal one-hot matmul
(a TPU layout workaround); at HIGHEST precision that is bit-identical to the
gather used here.
"""

import torch

from .base import BaseCodec
from ..clustering import MultiKMeans
from ..ops.max_sim import batched_max_sim
from .. import util
from ..metric import canonical_distance


def _decode_nd(codes_nm, codebook):
    """codes [n, m] uint8, codebook [m, n_clusters, dsub] -> [n, m*dsub] f32."""
    n, m = codes_nm.shape
    sub = torch.arange(m, device=codebook.device)
    g = codebook[sub[None, :], codes_nm.long()]  # [n, m, dsub]
    return g.reshape(n, -1).float()


class PQCodec(BaseCodec):
    def __init__(self, d_vector, n_subvectors=8, n_clusters=256,
                 distance="euclidean", verbose=0, max_iter=25, n_redo=1,
                 tol=1e-4, seed=0, device=None):
        super().__init__(verbose=verbose, device=device)
        assert d_vector % n_subvectors == 0
        self.d_vector = d_vector
        self.n_subvectors = n_subvectors
        self.n_clusters = n_clusters
        self.d_subvector = d_vector // n_subvectors
        self.distance = canonical_distance(distance)
        self.register_module("kmeans", MultiKMeans(
            n_clusters=n_clusters, distance=distance, max_iter=max_iter,
            n_redo=n_redo, tol=tol, verbose=verbose, seed=seed,
            device=device))

    @property
    def codebook(self):
        """[n_subvectors, d_subvector, n_clusters]."""
        return self.kmeans.centroids if self.is_trained else None

    @property
    def codebook_internal(self):
        """[m, n_clusters, d_subvector] row-major, for the ops layer."""
        return self.kmeans._centroids

    def train(self, x, centroids=None):
        """x: [d_vector, n]; `centroids` ([m, d_subvector, n_clusters])
        seed the codebooks."""
        x = util.as_tensor(x, self.device, torch.float32)
        assert x.shape[0] == self.d_vector
        sub = x.reshape(self.n_subvectors, self.d_subvector, -1)
        self.kmeans.fit(sub, centroids=centroids)
        self._set_trained()

    def encode(self, x):
        """x: [d_vector, n] -> codes [n_subvectors, n] uint8."""
        return self.encode_nd(util.as_tensor(x, self.device).T).T

    def decode(self, code):
        """codes [n_subvectors, n] uint8 -> [d_vector, n] f32."""
        return self.decode_nd(util.as_tensor(code, self.device).T).T

    def encode_nd(self, x_nd):
        """[n, d] -> [n, m] uint8 codes."""
        assert self.is_trained, "codec is not trained"
        x_nd = util.as_tensor(x_nd, self.device, torch.float32)
        n = x_nd.shape[0]
        sub = x_nd.T.reshape(self.n_subvectors, self.d_subvector, n)
        if self.distance == "cosine":
            sub = util.normalize(sub, dim=1)
        _, labels = batched_max_sim(sub, self.codebook_internal,
                                    self.distance, layout="dn")
        return labels.T.to(torch.uint8).contiguous()

    def decode_nd(self, codes_nm):
        """[n, m] uint8 -> [n, d] f32 reconstruction."""
        assert self.is_trained, "codec is not trained"
        return _decode_nd(util.as_tensor(codes_nm, self.device),
                          self.codebook_internal)
