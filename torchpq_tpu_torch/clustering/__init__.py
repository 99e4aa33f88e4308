from .kmeans import KMeans, MultiKMeans
from . import lloyd
