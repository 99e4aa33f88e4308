from .pca import PCA
from .opq import OPQ
