"""Flat (exhaustive) ADC scan over the decoded cache (counterpart of
torchpq_tpu/ops/flat_adc.py:flat_adc_scan).

The JAX package runs this outside any Pallas kernel, so here it is plain
torch: the cache is swept in slot chunks, each chunk one product
[nq, d] x [d, chunk] at the search precision (util.matmul: on the card a
bf16 GEMM with f32 sums at "default", IEEE f32 at "highest") and a
per-query top-k, and the chunk winners merge with one exact top-k. The JAX
package's approx_max_k is exact off the TPU, so both `approx` settings
take the exact top-k here. `flat_sweep` and
`final_merge` also serve the code-domain sweep (ops/onehot_adc.py), whose
chunks are decoded from PQ codes. An int8 cache sweeps the exact integer
products of the int8-quantized queries, dequantized per column.

`flat_adc_auto` is the flat plan's dispatch: under impl="pallas_flat", and
inside that kernel's gate, the fused flat-scan kernel (ops/flat_scan.py)
runs instead of the sweep.
"""

import torch

from .. import config
from .. import util
from ..metric import canonical_distance, negative_manhattan_distance
from .block_scan import BIG, int8_products
from .flat_scan import flat_scan

# resolved route of the most recent flat_adc_auto call: {"impl", "k",
# "approx", "cache", "precision"}
LAST_FLAT = {}


def flat_sweep(q_mm, rows, n, penalty, *, k, factor, max_elems=1 << 28,
               q_scale=None, scales=None, manhattan=False, precision=None):
    """Per chunk of slots [c0, c1): s = factor * q_mm @ rows(c0, c1).T -
    penalty[c0:c1], and its top k. q_mm [nq, d] f32 or bf16; rows(c0, c1)
    -> [c1 - c0, d] f32 or bf16, the product at `precision` (util.matmul);
    `max_elems` bounds the [nq, chunk] score tile. int8 (q_mm
    and rows int8, q_scale [nq] and scales [n] f32 given): s = ab *
    ((factor * q_scale)[:, None] * scales[None, c0:c1]) - penalty, with ab
    the exact integer products (flat_adc.py:85-91). manhattan: s =
    -|q_mm - row|_1 - penalty (flat_adc.py:80-84), the broadcast chunked by
    metric.negative_manhattan_distance. Returns the chunk winners (values
    [nq, n_chunks * k_c], slots alike)."""
    nq = q_mm.shape[0]
    # whole 128-column chunks: the score tile's rows stay 16-byte aligned,
    # which cuBLAS's Hopper kernels need (on an H100 a bf16 GEMM with f32
    # output of an odd width ran a slower CUTLASS sm75 kernel;
    # chip_matmul.py)
    chunk = min(n, max(1024, max_elems // max(nq, 1) // 128 * 128))
    k_c = min(k, chunk)
    vals, idx = [], []
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        if manhattan:
            s = negative_manhattan_distance(q_mm, rows(c0, c1))
            s.sub_(penalty[c0:c1][None, :])
        elif scales is None:
            # factor * <q, y> - penalty as one GEMM with its bias epilogue
            s = util.matmul(q_mm, rows(c0, c1), precision, alpha=factor,
                            bias=-penalty[c0:c1][None, :])
        else:
            s = int8_products(q_mm[None], rows(c0, c1)[None])[0]
            s.mul_((factor * q_scale)[:, None] * scales[None, c0:c1])
            s.sub_(penalty[c0:c1][None, :])
        v, i = torch.topk(s, min(k_c, s.shape[1]), dim=-1)
        vals.append(v)
        idx.append(i + c0)
    return torch.cat(vals, dim=1), torch.cat(idx, dim=1)


def final_merge(vals, idx, query, *, k, distance):
    """Exact merge of the chunk winners (onehot_adc.py:_flat_final_merge):
    top k, dead entries (<= -BIG/2) to -inf / -1, the euclidean -|q|^2 term
    added after the merge. Returns (values [nq, k] f32, addresses int32)."""
    kk = min(k, vals.shape[1])
    fv, fi = torch.topk(vals, kk, dim=-1)
    fa = torch.gather(idx, 1, fi)
    alive = fv > -BIG / 2
    fa = torch.where(alive, fa, -1).int()
    if distance == "euclidean":
        fv = fv - torch.sum(query * query, -1)[:, None]
    fv = torch.where(alive, fv, -torch.inf)
    if kk < k:
        fv = torch.nn.functional.pad(fv, (0, k - kk), value=-torch.inf)
        fa = torch.nn.functional.pad(fa, (0, k - kk), value=-1)
    return fv, fa


def flat_adc_scan(query, decoded, penalty, *, k, distance, chunk=None,
                  approx=True, scales=None, precision=None,
                  max_elems=1 << 28):
    """query [nq, d] f32 (preprocessed); decoded [cap, d] bf16/f32/int8;
    penalty [cap] f32 = norms (euclidean) or 0, with BIG at empty slots;
    scales [cap] f32 per-slot dequant scales (int8 cache only).

    Returns (values [nq, k] f32, addresses [nq, k] int32, -1 padding); the
    euclidean -|q|^2 term (f32) is added after the merge. The products run
    at `precision` (None: the search precision); an int8 cache's are exact
    integers at any. `max_elems` bounds the [nq, chunk] score tile; the JAX
    package's `chunk` is accepted and ignored, and its approx_max_k is
    exact off the TPU, so `approx` takes the exact top-k. Manhattan scores
    the f32 query against the upcast rows by the L1 broadcast."""
    distance = canonical_distance(distance)
    int8 = decoded.dtype == torch.int8
    if int8 != (scales is not None):
        raise ValueError("an int8 cache needs per-slot scales, and only it")
    query = util.pad_cols(query.float(), decoded.shape[-1])
    factor = 2.0 if distance == "euclidean" else 1.0
    if int8:
        q_mm, q_scale = util.int8_quantize_rows(query)
        vals, idx = flat_sweep(
            q_mm, lambda c0, c1: decoded[c0:c1], decoded.shape[0], penalty,
            k=k, factor=factor, max_elems=max_elems, q_scale=q_scale,
            scales=scales.float())
        return final_merge(vals, idx, query, k=k, distance=distance)
    # bf16 cache: the query rounds to bf16 too, and the products are exact
    # at any precision (the JAX package's bf16 x bf16 -> f32 product);
    # manhattan keeps the f32 query against the upcast rows
    manhattan = distance == "manhattan"
    q_mm = query.to(decoded.dtype) \
        if decoded.dtype == torch.bfloat16 and not manhattan else query
    vals, idx = flat_sweep(
        q_mm, (lambda c0, c1: decoded[c0:c1].float()) if manhattan
        else (lambda c0, c1: decoded[c0:c1]), decoded.shape[0],
        penalty, k=k, factor=factor, max_elems=max_elems,
        manhattan=manhattan, precision=precision)
    return final_merge(vals, idx, query, k=k, distance=distance)


def flat_scan_glue(query, decoded, penalty, *, k, distance):
    """The fused flat-scan kernel's glue (flat_adc.py:_flat_pallas_glue):
    r_keep = min(32, max(8, ceil(k / 8) * 8)); the kernel's top r_keep is
    sorted, so its head is the answer; then the deferred -|q|^2 term and
    dead masking. (The JAX glue pads queries to its tile and the cache to
    the window; the kernel takes any query count and pads the cache
    itself.)"""
    r_keep = min(32, max(8, util.cdiv(k, 8) * 8))
    vals, addrs = flat_scan(query, decoded.contiguous(), penalty.contiguous(),
                            r_keep=r_keep, euclidean=distance == "euclidean")
    vals, addrs = vals[:, :k], addrs[:, :k]
    alive = vals > -BIG / 2
    if distance == "euclidean":
        vals = vals - torch.sum(query * query, -1)[:, None]
    return torch.where(alive, vals, -torch.inf), torch.where(alive, addrs, -1)


def flat_adc_auto(query, decoded, penalty, *, k, distance, approx=True,
                  impl="xla", scales=None, interpret=False, precision=None):
    """The flat plan's dispatch (flat_adc.py:flat_adc_auto): the fused
    flat-scan kernel under impl="pallas_flat" inside its gate (not
    manhattan, not int8, k <= 32, cap >= 2048, approx), else the sweep,
    which is the JAX package's own routing. `precision` (None: the search
    precision) is the sweep's; the kernel, like the Pallas one, takes none.
    `interpret` is accepted and ignored."""
    distance = canonical_distance(distance)
    precision = config.resolve_precision(precision)
    query = util.pad_cols(query.float(), decoded.shape[-1])
    use_kernel = (impl == "pallas_flat" and distance != "manhattan"
                  and decoded.dtype != torch.int8 and k <= 32
                  and decoded.shape[0] >= 2048 and approx)
    LAST_FLAT.clear()
    LAST_FLAT.update(impl="flat_scan" if use_kernel else "sweep", k=k,
                     approx=approx,
                     cache=str(decoded.dtype).replace("torch.", ""),
                     precision=precision)
    if use_kernel:
        return flat_scan_glue(query, decoded, penalty, k=k,
                              distance=distance)
    return flat_adc_scan(query, decoded, penalty, k=k, distance=distance,
                         scales=scales, precision=precision)
