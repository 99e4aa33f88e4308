"""Label-indexed reductions for k-means updates (counterpart of
torchpq_tpu/ops/segment_ops.py): per-cluster sums and counts by
`index_add_`.

On a CUDA tensor `index_add_` of floats adds atomically, in an order that
changes between runs, so two trainings from one seed would end at other
centroids. The sums there sort the rows by label (a stable sort) and sum
each cluster's run of rows with `torch.segment_reduce`, in a fixed order.
(PyTorch's deterministic `index_add_` does the same, but its first call in
a process took 7.8 s on an H100.) The counts add exact integers (below
2^24 per cluster), equal in any order."""

import torch


def _sum_rows(out, labels, rows):
    """out.index_add_(0, labels, rows), in a fixed order on a CUDA
    tensor."""
    if not out.is_cuda:
        out.index_add_(0, labels, rows)
        return
    order = torch.sort(labels, stable=True).indices
    lengths = torch.bincount(labels, minlength=out.shape[0])
    out += torch.segment_reduce(rows[order], "sum", lengths=lengths, axis=0)


def compute_centroids(data, labels, n_clusters):
    """data [n, d], labels [n] -> (sums [n_clusters, d], counts [n_clusters])."""
    sums = torch.zeros((n_clusters, data.shape[1]), dtype=torch.float32,
                       device=data.device)
    _sum_rows(sums, labels.long(), data.float())
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
