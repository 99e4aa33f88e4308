"""Row-wise top-k facade (counterpart of torchpq_tpu/fn/topk.py), with the
reference's `dim` semantics. The JAX package's approx=True takes
approx_max_k, which is exact off the TPU: here both take torch.topk.
`recall_target` is accepted for that path and has no effect."""

import torch


def topk(x, k, dim=-1, approx=False, recall_target=0.95):
    """Top-k along `dim` -> (values, int32 indices), largest first; past
    the length of `dim` the values pad with -inf and the indices with 0."""
    del approx, recall_target
    x = torch.as_tensor(x)
    ndim = x.ndim
    dim = dim % ndim
    if dim != ndim - 1:
        x = x.movedim(dim, -1)
    k = int(k)
    k_eff = min(k, x.shape[-1])
    values, indices = torch.topk(x, k_eff, dim=-1)
    indices = indices.int()
    if k_eff < k:
        pad = (0, k - k_eff)
        values = torch.nn.functional.pad(values, pad, value=-torch.inf)
        indices = torch.nn.functional.pad(indices, pad, value=0)
    if dim != ndim - 1:
        values = values.movedim(-1, dim)
        indices = indices.movedim(-1, dim)
    return values, indices


class Topk:
    """Callable facade, the reference's `torchpq.fn.Topk` object."""

    def __call__(self, x, k, dim=-1, approx=False, recall_target=0.95):
        return topk(x, k, dim=dim, approx=approx, recall_target=recall_target)
