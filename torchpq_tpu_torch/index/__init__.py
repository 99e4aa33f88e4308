from .flat import FlatIndex
from .ivfpq import IVFPQIndex
from .ivfpqr import IVFPQRIndex
