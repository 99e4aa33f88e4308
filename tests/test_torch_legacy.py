"""Parity of the port's v1 adapters (torchpq_tpu_torch.legacy) with the
JAX package's (torchpq_tpu.legacy), mirroring tests/test_legacy.py: each of
its checks runs in both packages, and where both hold the same trained
state (carried as the JAX package's state_dict) their outputs agree.
Tolerances: exact searches as assert_topk_match (values 1e-4 + 1e-5
relative, ids equal outside ties); SQ and ADC scores 1e-5 relative and
1e-4 absolute; codes and reconstructions from carried state equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import torchpq_tpu.legacy as jleg
from torchpq_tpu.codec import PQCodec as JaxPQ
import torchpq_tpu_torch as tp
from torchpq_tpu_torch import legacy as leg

from _torch_helpers import CPU, assert_topk_match


def _pair(cls_j, cls_t, x, **kw):
    """The facade in both packages, the JAX one trained on x and its index
    state carried into the port's."""
    j = cls_j(**kw)
    j.train(jnp.asarray(x))
    t = cls_t(**kw, device=CPU)
    t._index.load_state_dict(j._index.state_dict())
    return j, t


def test_legacy_ivfpq_end_to_end(rng):
    d, n = 16, 600
    x = rng.normal(size=(d, n)).astype(np.float32)
    j, t = _pair(jleg.IVFPQ, leg.IVFPQ, x, d_vector=d, n_subvectors=4,
                 n_cq_clusters=8, blocksize=128, scan_cache_dtype="float32")
    assert t.n_cells == 8 and t.max_cell_capacity == 128
    j_ids = np.asarray(j.add(jnp.asarray(x)))
    ids = t.add(x).numpy()
    np.testing.assert_array_equal(ids, j_ids)
    for f in (j, t):
        f.n_probe = 8
    vals, got = t.topk(x[:, :30], k=1)
    assert (got.numpy()[:, 0] == ids[:30]).mean() > 0.9
    v_ref, i_ref = j.topk(jnp.asarray(x[:, :30]), k=5)
    assert_topk_match(v_ref, i_ref, *t.topk(x[:, :30], k=5, mode=1))
    sims = t.similarity_at_id(x[:, :5], ids[:5])
    assert tuple(sims.shape) == (5, 5)
    np.testing.assert_allclose(
        sims.numpy(), np.asarray(j.similarity_at_id(jnp.asarray(x[:, :5]),
                                                    j_ids[:5])),
        rtol=1e-5, atol=1e-4)
    addr = t.get_address_by_id(ids[:3])
    np.testing.assert_array_equal(
        t.similarity_at_address(x[:, :5], addr).numpy(),
        t.similarity_at_id(x[:, :5], ids[:3]).numpy())
    assert t.remove(ids[:10]) == j.remove(jnp.asarray(j_ids[:10])) == 10
    assert t.n_items == j.n_items == n - 10
    assert t.remove_address(t.get_address_by_id(ids[10:12])) == 2


def test_legacy_cpu_ram_tier(rng):
    """The CPU-RAM SQ tier: reconstructions within the JAX test's bound,
    and equal to the JAX package's from the same SQ state."""
    d, n = 8, 200
    x = rng.normal(size=(d, n)).astype(np.float32)
    kw = dict(d_vector=d, n_subvectors=4, n_cq_clusters=4, blocksize=128,
              scan_cache_dtype="float32")
    j = jleg.IVFPQ(**kw, cpu_quantizer=jleg.SQ(bits=8))
    j.train(jnp.asarray(x))
    sq = leg.SQ(bits=8, device=CPU)
    sq.load_state_dict(j.cpu_quantizer.state_dict())
    t = leg.IVFPQ(**kw, cpu_quantizer=sq, device=CPU)
    t._index.load_state_dict(j._index.state_dict())
    j_ids = np.asarray(j.add(jnp.asarray(x)))
    ids = t.add(x).numpy()
    rec = t.reconstruct_from_cpu_ram(ids[:7]).numpy()
    assert rec.shape == (d, 7)
    assert np.abs(rec - x[:, :7]).mean() < 0.05
    np.testing.assert_allclose(
        rec, np.asarray(j.reconstruct_from_cpu_ram(j_ids[:7])),
        rtol=1e-5, atol=1e-5)
    t.remove(ids[:2])
    assert set(t._cpu_store) == set(ids[2:].tolist())
    # a fresh quantizer trains on the facade's first train() call
    t2 = leg.IVFPQ(**kw, cpu_quantizer=leg.SQ(bits=8, device=CPU),
                   device=CPU)
    t2.train(x)
    assert t2.cpu_quantizer.is_trained


def test_legacy_pq_sq(rng):
    x = rng.normal(size=(16, 300)).astype(np.float32)
    pq = leg.PQ(d_vector=16, n_subvectors=4, device=CPU)
    jpq = jleg.PQ(d_vector=16, n_subvectors=4)
    jpq.train(jnp.asarray(x))
    pq.load_state_dict(jpq.state_dict())
    code = pq.encode(x)
    assert tuple(code.shape) == (4, 300)
    np.testing.assert_array_equal(code.numpy(),
                                  np.asarray(jpq.encode(jnp.asarray(x))))
    sq = leg.SQ(bits=8, device=CPU)
    sq.train(x)
    assert np.abs(sq.decode(sq.encode(x)).numpy() - x).mean() < 0.05
    jsq = jleg.SQ(bits=8)
    jsq.train(jnp.asarray(x))
    np.testing.assert_array_equal(sq.encode(x).numpy(),
                                  np.asarray(jsq.encode(jnp.asarray(x))))
    assert isinstance(pq, tp.codec.PQCodec) and isinstance(sq,
                                                           tp.codec.SQCodec)


@pytest.mark.parametrize("distance", ["euclidean", "inner", "cosine"])
def test_legacy_ivfpq_topk_scores(rng, distance):
    d, n, nq = 16, 200, 5
    x = rng.normal(size=(d, n)).astype(np.float32)
    jpq = JaxPQ(d_vector=d, n_subvectors=4)
    jpq.train(jnp.asarray(x))
    codes = np.array(jpq.encode_nd(jnp.asarray(x.T)))
    cb = np.array(jpq.codebook_internal)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    s = leg.IVFPQTopk.scores(q, torch.from_numpy(cb), codes,
                             distance=distance)
    assert tuple(s.shape) == (nq, n)
    s_ref = jleg.IVFPQTopk.scores(jnp.asarray(q), jnp.asarray(cb),
                                  jnp.asarray(codes), distance=distance)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-5,
                               atol=1e-4)
    vals, idx = leg.IVFPQTopk(n_subvectors=4, n_cs=4).topk(
        q, cb, torch.from_numpy(codes), k=3, distance=distance)
    assert tuple(vals.shape) == (nq, 3)
    v_ref, i_ref = jleg.IVFPQTopk.topk(jnp.asarray(q), jnp.asarray(cb),
                                       jnp.asarray(codes), k=3,
                                       distance=distance)
    assert_topk_match(v_ref, i_ref, vals, idx)


def test_legacy_ivfpqr(rng):
    d, n = 16, 500
    x = rng.normal(size=(d, n)).astype(np.float32)
    j, t = _pair(jleg.IVFPQR, leg.IVFPQR, x, d_vector=d, n_subvectors=2,
                 n_subq=8, n_cq_clusters=4, blocksize=256,
                 scan_cache_dtype="float32")
    assert t.n_subvectors_rerank == 8
    j_ids = np.asarray(j.add(jnp.asarray(x)))
    ids = t.add(x).numpy()
    np.testing.assert_array_equal(ids, j_ids)
    for f in (j, t):
        f.n_probe = 4
    vals, got = t.topk(x[:, :20], k=1)
    assert (got.numpy()[:, 0] == ids[:20]).mean() > 0.85
    v_ref, i_ref = j.topk(jnp.asarray(x[:, :20]), k=4)
    assert_topk_match(v_ref, i_ref, *t.topk(x[:, :20], k=4))


def test_legacy_aliases():
    assert leg.KMeansOld is tp.clustering.KMeans
    assert leg.MultiKMeansOld is tp.clustering.MultiKMeans
    with pytest.raises(AssertionError, match="256"):
        leg.IVFPQ(d_vector=8, n_subvectors=4, n_pq_clusters=16, device=CPU)
    f = leg.IVFPQ(d_vector=8, n_subvectors=4, n_cq_clusters=4, device=CPU)
    assert f.n_probe == 1 and f.d_vector == 8
    with pytest.raises(AttributeError):
        object.__new__(leg.IVFPQ).anything
    with pytest.raises(AssertionError, match="cpu_quantizer"):
        f.reconstruct_from_cpu_ram([0])
