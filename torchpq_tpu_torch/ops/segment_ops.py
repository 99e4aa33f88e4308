"""Label-indexed reductions for k-means updates (counterpart of
torchpq_tpu/ops/segment_ops.py): per-cluster sums and counts by
`index_add_`."""

import torch


def compute_centroids(data, labels, n_clusters):
    """data [n, d], labels [n] -> (sums [n_clusters, d], counts [n_clusters])."""
    sums = torch.zeros((n_clusters, data.shape[1]), dtype=torch.float32,
                       device=data.device)
    sums.index_add_(0, labels.long(), data.float())
    counts = torch.zeros(n_clusters, dtype=torch.float32, device=data.device)
    counts.index_add_(0, labels.long(),
                      torch.ones(labels.shape[0], device=data.device))
    return sums, counts


def batched_compute_centroids(data, labels, n_clusters):
    """Multi-problem variant: data [m, n, d], labels [m, n] ->
    (sums [m, n_clusters, d], counts [m, n_clusters]); one flat index_add_
    with per-problem label offsets."""
    m, n, d = data.shape
    offset = (torch.arange(m, device=data.device) * n_clusters)[:, None]
    sums, counts = compute_centroids(
        data.reshape(m * n, d), (labels.long() + offset).reshape(-1),
        m * n_clusters)
    return sums.reshape(m, n_clusters, d), counts.reshape(m, n_clusters)

