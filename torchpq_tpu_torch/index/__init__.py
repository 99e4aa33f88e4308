from .ivfpq import IVFPQIndex
