"""Shared helpers of the parity tests between torchpq_tpu (JAX) and its
PyTorch port torchpq_tpu_torch. Arrays cross between the two as numpy."""

import numpy as np
import torch

# The port's objects live on the card unless built with a device: the CPU
# parity tests build theirs here.
CPU = "cpu"


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


def seed_fits(index, max_iter=6):
    """Every k-means fit of an index's codecs (VQ, PQ and, where there is
    one, the rerank PQ) starts from the first k columns of the data it is
    given, in either package: equal initial centroids, not the packages'
    own random draws."""
    for name in ("vq_codec", "pq_codec", "rerank_codec"):
        km = getattr(index, name).kmeans
        km.max_iter = max_iter

        def seeded(data, centroids=None, fit=km.fit, k=km.n_clusters):
            return fit(data, centroids=data[..., :k])

        km.fit = seeded


def overlap(a, b):
    """Mean per-row share of b's (non -1) entries that a holds too."""
    a, b = to_np(a), to_np(b)
    shares = []
    for ra, rb in zip(a, b):
        ref = set(rb.tolist()) - {-1}
        if ref:
            shares.append(len(set(ra.tolist()) & ref) / len(ref))
    return float(np.mean(shares))


def pallas_codes(qt, pr, sc, off, cap, penalty, codes, cb, *, m, s_eff,
                 k_pair, distance, pack32, slot_mask):
    """The JAX package's Pallas codes kernel (interpret mode) on its own
    staged inputs: query tiles, penalty rows in the deinterleaved column
    order, packed codes, bf16 block diagonal. Inputs are numpy: qt [nq, d],
    pr [B, 128], sc / off / cap [B], penalty [capacity] f32, codes
    [capacity, m] uint8, cb [m, 256, dsub]."""
    import jax.numpy as jnp
    from torchpq_tpu.ops import onehot_adc as jonehot
    from torchpq_tpu.ops.pallas_codes_scan import scan_blocks_pallas_codes
    from torchpq_tpu_torch.ops.block_scan import BIG
    g = 128 // m
    b = sc.shape[0]
    j = np.arange(s_eff)
    in_cell = (j[None] >= off[:, None]) & (j[None] < (off + cap)[:, None])
    pen = (penalty[sc[:, None] + j[None]]
           + np.where(in_cell, 0.0, BIG)).astype(np.float32)
    pen = pen.reshape(b, s_eff // g, g).transpose(0, 2, 1).reshape(b, s_eff)
    bdiag = jonehot.blockdiag_codebook(jnp.asarray(cb, jnp.float32)) \
        .astype(jnp.bfloat16)
    return np.asarray(scan_blocks_pallas_codes(
        jnp.asarray(qt, jnp.bfloat16)[jnp.asarray(np.maximum(pr, 0))],
        jnp.asarray(sc), jnp.asarray(pen),
        jnp.asarray(codes.reshape(-1, 128)), bdiag, s_eff=s_eff,
        k_pair=k_pair, p_tile=128, m=m, distance=distance, approx=pack32,
        slot_mask=slot_mask, bps=1, interpret=True))
