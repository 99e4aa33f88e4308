"""Legacy (v1) API adapters (counterpart of torchpq_tpu/legacy).

Reference counterpart: torchpq/legacy/, the library's first-generation API
(IVFPQ, IVFPQR, PQ, SQ, IVFPQTopk) kept for backwards compatibility. Thin
adapters over the current components, so v1 call sites keep working: the
v1 names (n_cq_clusters, blocksize, topk, input_ids, remove_ids) map onto
IVFPQIndex / PQCodec / SQCodec. The v1 extras are kept: rescoring by
address or id lives on IVFPQIndex itself, and the optional CPU-RAM tier
keeps SQ-compressed originals on the host through a `cpu_quantizer`.
"""

from .ivfpq import IVFPQ, IVFPQR
from .pq import PQ
from .sq import SQ
from .ivfpq_topk import IVFPQTopk

# previous-generation clustering names the reference keeps "for reference"
# (torchpq/clustering/KMeansOld.py, MultiKMeansOld.py): aliases here
from ..clustering import KMeans as KMeansOld
from ..clustering import MultiKMeans as MultiKMeansOld
