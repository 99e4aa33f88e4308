from .kmeans import KMeans, MultiKMeans
from .minibatch_kmeans import MinibatchKMeans
from . import lloyd
