"""Shape/dtype utilities (counterpart of torchpq_tpu/util.py)."""

import math
import time

import numpy as np
import torch

from . import config

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


def normalize(x, axis=-1, eps=1e-12, dim=None):
    """L2-normalize along `axis` (the reference's name); `dim`, where
    given, takes its place."""
    n = torch.linalg.vector_norm(x, dim=axis if dim is None else dim,
                                 keepdim=True)
    return x / torch.clamp(n, min=eps)


def as_tensor(x, device, dtype=None):
    """numpy / torch input -> tensor on `device` (no copy when it is there)."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=device, dtype=dtype)


def _mm_f32(a, b_t, alpha, bias):
    """alpha * a @ b_t.T + bias in IEEE float32 (bias only for 2-D
    operands, where it rides the GEMM's epilogue)."""
    a, b_t = a.float(), b_t.float()
    if bias is not None:
        return torch.addmm(bias, a, b_t.T, alpha=alpha)
    out = a @ b_t.mT
    return out if alpha == 1.0 else out.mul_(alpha)


def _mm_bf16(a, b_t):
    """bf16 a @ b_t.T with an f32 result: the products exact, summed in
    f32 on the tensor cores (torch.mm's out_dtype; the plain bf16 matmul
    would round the result to bf16)."""
    if a.ndim == 2:
        return torch.mm(a, b_t.T, out_dtype=torch.float32)
    return torch.bmm(a, b_t.mT, out_dtype=torch.float32)


def _on_card(x):
    """Whether a product of x runs at its precision: on a CUDA tensor. The
    CPU computes f32 at every precision, as XLA:CPU does."""
    return x.is_cuda


def bf16_parts(x, precision):
    """x's bf16 high part and, at "high" for a non-bf16 x, its bf16 low
    part (x - hi rounded; else None): the operands one product reads."""
    hi = x.to(torch.bfloat16)
    if precision != "high" or x.dtype == torch.bfloat16:
        return hi, None
    return hi, (x.float() - hi.float()).to(torch.bfloat16)


def matmul_operand(x, precision=None):
    """`x` prepared once for many products at one precision (matmul
    accepts it in place of x): its bf16 parts on a CUDA tensor below
    "highest", else x as f32. FlatIndex casts its storage so, once per
    search instead of once per query chunk."""
    p = config.resolve_precision(precision)
    if _on_card(x) and p != "highest":
        return bf16_parts(x, p)
    return x.float()


def matmul(a, b_t, precision=None, *, alpha=1.0, bias=None):
    """alpha * a @ b_t.T (+ bias) with a float32 result, at a precision
    (config.resolve_precision; None: SEARCH_PRECISION). a [..., n, d],
    b_t [..., m, d] with equal leading dims (at most one); bias [m] or
    [n, m], 2-D operands only; either operand may be matmul_operand's.

    On a CUDA tensor it computes what the TPU computes at the precision:
    "default", one GEMM of the bf16-rounded operands (exact products, f32
    sums on the tensor cores); "high", bf16_3x, a_hi b_lo + a_lo b_hi +
    a_hi b_hi with x = x_hi + x_lo in bf16 each, every term as "default",
    summed in f32 (bf16 operands have no low part: one GEMM); "highest",
    IEEE float32. On the CPU every precision computes float32, as XLA:CPU
    does. matmul_plain is the plain version of each mode. A power-of-two
    alpha scales a's bf16 parts (exactly), and the bias is added after the
    GEMM: on an H100 that beat addmm's bias for bf16 operands
    (chip_matmul.py)."""
    p = config.resolve_precision(precision)
    if not _on_card(a[0] if isinstance(a, tuple) else a) or p == "highest":
        return _mm_f32(a, b_t, alpha, bias)
    (a_hi, a_lo), (b_hi, b_lo) = (
        x if isinstance(x, tuple) else bf16_parts(x, p) for x in (a, b_t))
    scale = alpha if alpha > 0 and math.frexp(alpha)[0] == 0.5 else 1.0
    if scale != 1.0:
        a_hi = a_hi * scale
        a_lo = None if a_lo is None else a_lo * scale
    out = None
    if p == "high":
        for x, y in ((a_hi, b_lo), (a_lo, b_hi)):
            if x is not None and y is not None:
                t = _mm_bf16(x, y)
                out = t if out is None else out.add_(t)
    hh = _mm_bf16(a_hi, b_hi)
    out = hh if out is None else out.add_(hh)
    if alpha != scale:
        out.mul_(alpha)
    return out if bias is None else out.add_(bias)


def matmul_plain(a, b_t, precision=None):
    """Plain version of matmul's mode at a precision, on any device:
    the operands rounded to bf16 explicitly ("default"), or split into
    bf16 high and low parts with the three products summed in f32
    ("high"), then f32 products; "highest" an f32 product."""
    p = config.resolve_precision(precision)
    if p == "highest":
        return a.float() @ b_t.float().mT
    (a_hi, a_lo), (b_hi, b_lo) = (bf16_parts(x, p) for x in (a, b_t))

    def mm(x, y):
        return x.float() @ y.float().mT
    small = [mm(x, y) for x, y in ((a_hi, b_lo), (a_lo, b_hi))
             if x is not None and y is not None]
    out = mm(a_hi, b_hi)
    return sum(small[1:], small[0]) + out if small else out


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
