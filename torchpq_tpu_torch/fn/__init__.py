from .topk import Topk, topk
from .ivfpq_topk import IVFPQTopk
