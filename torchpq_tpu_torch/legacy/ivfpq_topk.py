"""v1 IVFPQTopk adapter (reference legacy/IVFPQTopk.py).

The v1 scan strategy computed the full similarity list of all probed codes
and sorted it externally. Here `topk` is a brute ADC top-k over an explicit
code list (ops/adc.py: build_adc_table + adc_lookup_scores), and `scores`
returns the full list for callers that used the raw lists.
"""

import torch

from .. import util
from ..ops import adc


class IVFPQTopk:
    def __init__(self, n_subvectors=8, n_clusters=256, n_cs=4, **kwargs):
        del n_cs  # the v1 kernel's uchar4 interleave factor
        self.n_subvectors = n_subvectors
        self.n_clusters = n_clusters

    @staticmethod
    def topk(query, codebook_internal, codes, k, distance="euclidean"):
        """query [nq, d] rows; codebook_internal [m, 256, dsub]; codes
        [n, m] uint8 -> (values [nq, k], indices [nq, k])."""
        scores = IVFPQTopk.scores(query, codebook_internal, codes, distance)
        return torch.topk(scores, min(int(k), scores.shape[-1]), dim=-1)

    @staticmethod
    def scores(query, codebook_internal, codes, distance="euclidean"):
        """The full similarity list [nq, n], like the v1 compute_product
        path, on the codebook's device (numpy or tensor inputs)."""
        cb = util.as_tensor(codebook_internal, None)
        query = util.as_tensor(query, cb.device, torch.float32)
        if distance == "cosine":  # build_adc_table's precondition
            query = util.normalize(query, dim=-1)
        lut = adc.build_adc_table(query, cb, distance)
        return adc.adc_lookup_scores(lut, util.as_tensor(codes, cb.device))
