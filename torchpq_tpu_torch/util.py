"""Shape/dtype utilities (counterpart of torchpq_tpu/util.py)."""

import numpy as np
import torch

# user-visible id arrays are int32, matching the JAX package's default x32
# mode (torchpq_tpu/util.py:id_dtype) so saved states carry across
ID_DTYPE = torch.int32


def cdiv(a, b):
    return -(-a // b)


def round_up(x, m):
    return cdiv(x, m) * m


def next_pow2(x):
    x = int(x)
    if x <= 1:
        return 1
    return 1 << (x - 1).bit_length()


def locality_order(centroids):
    """Recursive balanced PCA-bisection order over [n, d] centroid rows
    (a verbatim numpy copy of torchpq_tpu/util.py:locality_order, which
    relabels the coarse cells at train time — the two packages must agree
    on the cell ids). Returns an int64 permutation: new id i holds old
    centroid order[i]."""
    c = np.asarray(centroids, np.float64)
    n = c.shape[0]
    order = np.empty(n, np.int64)
    pos = 0

    def rec(idx):
        nonlocal pos
        if len(idx) <= 2:
            order[pos:pos + len(idx)] = idx
            pos += len(idx)
            return
        x = c[idx] - c[idx].mean(0)
        v = x[0] + 1e-9  # top principal axis by power iteration
        for _ in range(8):
            v = x.T @ (x @ v)
            nv = np.linalg.norm(v)
            if nv < 1e-30:
                break
            v = v / nv
        t = x @ v
        srt = np.argsort(t, kind="stable")
        h = len(idx) // 2
        rec(idx[srt[:h]])
        rec(idx[srt[h:]])

    rec(np.arange(n))
    return order


def str2dtype(dtype):
    """Parse a dtype name (or pass a torch dtype through)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    aliases = {
        "float": "float32", "double": "float64", "half": "float16",
        "long": "int64", "int": "int32",
    }
    name = aliases.get(str(dtype), str(dtype))
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return out


def pad_cols(x, w):
    """Zero-pad the trailing axis to width `w` (no-op when already there)."""
    if x.shape[-1] == w:
        return x
    return torch.nn.functional.pad(x, (0, w - x.shape[-1]))


def normalize(x, dim=-1, eps=1e-12):
    """L2-normalize along `dim`."""
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(n, min=eps)


def as_tensor(x, device, dtype=None):
    """numpy / torch input -> tensor on `device` (no copy when it is there)."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=device, dtype=dtype)


def matmul_f32(a, b_t):
    """a [n, d] @ b_t[m, d].T with float32 products and accumulation.

    bf16 operands are upcast first: a bf16 product is exact in float32, so
    this is the bf16 x bf16 -> f32 product the JAX package asks XLA for
    (torch's own bf16 matmul would round the result to bf16)."""
    return a.float() @ b_t.float().T


def exclusive_cumsum(x):
    out = torch.zeros_like(x)
    if x.numel() > 1:
        torch.cumsum(x[:-1], 0, out=out[1:])
    return out
