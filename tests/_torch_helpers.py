"""Shared helpers of the parity tests between torchpq_tpu (JAX) and its
PyTorch port torchpq_tpu_torch. Arrays cross between the two as numpy."""

import numpy as np
import torch


def to_np(x):
    """JAX array / torch tensor -> numpy (bf16 as float32)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.detach().cpu().numpy()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return a


def to_t(x, dtype=None):
    """JAX array / numpy -> CPU torch tensor (bf16 kept as bf16)."""
    a = np.array(x)  # a writable copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t if dtype is None else t.to(dtype)


def assert_topk_match(v_ref, i_ref, v, i, atol=1e-4, rtol=1e-5):
    """Top-k results agree: values within tolerance, position by position,
    and ids equal except among tied values. Two values tie when they are
    within twice the tolerance; a tie with the k-th value may reach past
    the k shown, so there the ids may differ outright."""
    v_ref, i_ref, v, i = map(to_np, (v_ref, i_ref, v, i))
    assert v_ref.shape == v.shape and i_ref.shape == i.shape
    np.testing.assert_allclose(v, v_ref, atol=atol, rtol=rtol)
    tol = 2 * (atol + rtol * np.abs(v_ref))
    for r in range(v_ref.shape[0]):
        row = v_ref[r]
        for c in range(row.shape[0]):
            if not np.isfinite(row[c]):
                assert i[r, c] == -1 and i_ref[r, c] == -1, (r, c)
            elif i[r, c] != i_ref[r, c]:
                near = np.abs(row - row[c]) <= tol[r, c]
                tail_tie = abs(row[c] - row[-1]) <= tol[r, c]
                assert tail_tie or i[r, c] in i_ref[r][near], \
                    (r, c, i[r], i_ref[r], row)


def overlap(a, b):
    """Mean per-row share of b's (non -1) entries that a holds too."""
    a, b = to_np(a), to_np(b)
    shares = []
    for ra, rb in zip(a, b):
        ref = set(rb.tolist()) - {-1}
        if ref:
            shares.append(len(set(ra.tolist()) & ref) / len(ref))
    return float(np.mean(shares))
