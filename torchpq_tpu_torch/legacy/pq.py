"""v1 PQ adapter (reference legacy/PQ.py: the v1 name for PQCodec)."""

from ..codec import PQCodec


class PQ(PQCodec):
    def __init__(self, d_vector, n_subvectors=8, n_clusters=256,
                 distance="euclidean", verbose=0, device=None, **kwargs):
        super().__init__(d_vector=d_vector, n_subvectors=n_subvectors,
                         n_clusters=n_clusters, distance=distance,
                         verbose=verbose, device=device, **kwargs)
