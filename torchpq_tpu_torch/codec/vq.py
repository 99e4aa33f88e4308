"""Vector-quantizer codec (counterpart of torchpq_tpu/codec/vq.py), the IVF
coarse quantizer of IVFPQIndex."""

import torch

from .base import BaseCodec
from ..clustering import KMeans


class VQCodec(BaseCodec):
    def __init__(self, *args, verbose=0, device=None, **kwargs):
        super().__init__(verbose=verbose, device=device)
        self.register_module("kmeans", KMeans(
            *args, verbose=verbose, device=device, **kwargs))

    @property
    def codebook(self):
        """[d_vector, n_clusters]."""
        return self.kmeans.centroids if self.is_trained else None

    def train(self, data):
        """data: [d_vector, n]."""
        self.kmeans.fit(data)
        self._set_trained()

    def encode(self, x):
        """x: [d_vector, n] -> cell labels [n] int32."""
        assert self.is_trained, "codec is not trained"
        return self.kmeans.predict(x)

    def decode(self, code):
        """labels [n] -> centroid columns [d_vector, n]."""
        assert self.is_trained, "codec is not trained"
        return self.kmeans.centroids[:, torch.as_tensor(code).long()]
