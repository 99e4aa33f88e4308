"""Shape/dtype utilities (counterpart of torchpq_tpu/util.py)."""

import time

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


def int8_quantize_rows(rows):
    """Per-row symmetric int8 quantization of the int8 scan cache
    (torchpq_tpu/util.py:int8_quantize_rows): rows [n, d] f32 -> (q [n, d]
    int8, scale [n] f32) with rows ~= q * scale[:, None]. torch.round
    rounds half to even, as jnp.round does. The divisor 127 is a tensor on
    the rows' device: by a Python scalar, CUDA tensors are multiplied by
    its reciprocal, one ulp off the quotient on some rows."""
    absmax = torch.clamp(rows.abs().amax(dim=-1), min=1e-12)
    scale = absmax / torch.tensor(127.0, device=rows.device)
    return torch.round(rows / scale[:, None]).to(torch.int8), scale


def exclusive_cumsum(x):
    out = torch.zeros_like(x)
    if x.numel() > 1:
        torch.cumsum(x[:-1], 0, out=out[1:])
    return out


def id_dtype():
    """Dtype of user-visible id arrays (torchpq_tpu/util.py:id_dtype):
    ID_DTYPE, int32, which is the JAX package's answer in its default x32
    mode and what every entry point of the port returns."""
    return ID_DTYPE


def as_n_d(x, d_vector=None):
    """Accept the reference's [d_vector, n_data] layout and return
    row-major [n, d] (a view). Public entry points take [d, n]; internal
    compute is [n, d]."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    if x.ndim != 2:
        raise ValueError(
            f"expected 2-D [d_vector, n_data] input, got {tuple(x.shape)}")
    if d_vector is not None and x.shape[0] != d_vector:
        raise ValueError(f"expected [d_vector={d_vector}, n_data], got "
                         f"{tuple(x.shape)}")
    return x.T


def as_d_n(x):
    """Return to the reference's [d, n] layout at the boundary."""
    return x.T


def pad_rows(x, multiple, value=0):
    """Pad dim 0 of `x` up to a multiple; returns (padded, n_valid)."""
    n = x.shape[0]
    target = round_up(max(n, 1), multiple)
    if target == n:
        return x, n
    pad = x.new_full((target - n,) + tuple(x.shape[1:]), value)
    return torch.cat([x, pad]), n


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_tree_map(fn, v) for v in tree]
        return type(tree)(out) if isinstance(tree, list) else tuple(out)
    return fn(tree)


def block_until_ready(tree):
    """Wait for the devices of every CUDA tensor in `tree` (dicts, lists
    and tuples of tensors) to finish their queued work; returns `tree`.
    Kernel launches return before the card is done, so a host clock read
    without this measures the enqueue."""
    devices = set()

    def note(a):
        if isinstance(a, torch.Tensor) and a.is_cuda:
            devices.add(a.device)
        return a

    _tree_map(note, tree)
    for dev in devices:
        torch.cuda.synchronize(dev)
    return tree


def to_numpy(tree):
    """Tensors of `tree` -> numpy copies on the host (bf16 as float32, which
    numpy lacks); other leaves as np.asarray gives them."""
    def conv(a):
        if isinstance(a, torch.Tensor):
            a = a.detach()
            if a.dtype == torch.bfloat16:
                a = a.float()
            return a.cpu().numpy()
        return np.asarray(a)
    return _tree_map(conv, tree)


class Timer:
    """Wall-clock probe with device sync (reference torchpq/util.py:86
    tick())."""

    def __init__(self):
        self.t = time.perf_counter()

    def tick(self, label="", sync=None):
        """Seconds since the last tick. `sync`: the tensors being timed,
        whose devices are waited for; without it the current CUDA device
        (where one is in use) is."""
        if sync is not None:
            block_until_ready(sync)
        elif torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        now = time.perf_counter()
        dt = now - self.t
        self.t = now
        if label:
            print(f"[tick] {label}: {dt * 1e3:.3f} ms")
        return dt
