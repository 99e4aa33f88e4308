"""Multi-device execution over torch.distributed (counterpart of
torchpq_tpu/parallel).

IVF cells shard over the ranks of a mesh, codebooks replicate, and each
rank's scan merges with one all_gather and a top-k (ShardedIVFPQSearcher);
k-means and search also run data-parallel. One process per rank: NCCL
between cards, gloo between CPU processes.
"""

from .mesh import get_mesh, device_count
from .sharded_ivfpq import (ShardedIVFPQSearcher, data_parallel_lloyd_step,
                            data_parallel_kmeans_fit, data_parallel_search)
