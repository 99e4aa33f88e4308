from .ivfpq_topk import IVFPQTopk
