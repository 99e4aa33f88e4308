"""Port parity of the training path: max_sim, centroid updates, k-means fed
identical initial centroids, and PQ codes from the same codebooks."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torchpq_tpu.clustering import KMeans as JaxKMeans
from torchpq_tpu.clustering import MultiKMeans as JaxMultiKMeans
from torchpq_tpu.codec import PQCodec as JaxPQ
from torchpq_tpu.ops import max_sim as jms
from torchpq_tpu.ops import segment_ops as jseg
import torchpq_tpu_torch as tp
from torchpq_tpu_torch.ops import max_sim as tms
from torchpq_tpu_torch.ops import segment_ops as tseg

from _torch_helpers import CPU


@pytest.mark.parametrize("distance", ["euclidean", "inner", "cosine"])
def test_max_sim_matches(rng, distance):
    x = rng.normal(size=(500, 16)).astype(np.float32)
    c = rng.normal(size=(37, 16)).astype(np.float32)
    v_ref, l_ref = jms.max_sim(jnp.asarray(x), jnp.asarray(c), distance)
    v, lab = tms.max_sim(torch.from_numpy(x), torch.from_numpy(c), distance)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(l_ref))


def test_topk_sim_matches(rng):
    x = rng.normal(size=(300, 16)).astype(np.float32)
    c = rng.normal(size=(50, 16)).astype(np.float32)
    v_ref, i_ref = jms.topk_sim(jnp.asarray(x), jnp.asarray(c), 5,
                                "euclidean")
    v, i = tms.topk_sim(torch.from_numpy(x), torch.from_numpy(c), 5,
                        "euclidean")
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))


@pytest.mark.parametrize("layout", ["nd", "dn"])
def test_batched_max_sim_matches(rng, layout):
    x = rng.normal(size=(4, 300, 8)).astype(np.float32)
    c = rng.normal(size=(4, 32, 8)).astype(np.float32)
    if layout == "dn":
        x = np.ascontiguousarray(x.transpose(0, 2, 1))
    v_ref, l_ref = jms.batched_max_sim(jnp.asarray(x), jnp.asarray(c),
                                       "euclidean", layout=layout)
    v, lab = tms.batched_max_sim(torch.from_numpy(x), torch.from_numpy(c),
                                 "euclidean", layout=layout)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(l_ref))


def test_batched_compute_centroids_matches(rng):
    x = rng.normal(size=(3, 400, 6)).astype(np.float32)
    lab = rng.integers(0, 20, size=(3, 400)).astype(np.int32)
    s_ref, c_ref = jseg.batched_compute_centroids(
        jnp.asarray(x), jnp.asarray(lab), 20)
    s, c = tseg.batched_compute_centroids(torch.from_numpy(x),
                                          torch.from_numpy(lab), 20)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))


@pytest.mark.parametrize("distance", ["euclidean", "cosine"])
def test_kmeans_same_init_matches(rng, distance):
    x = rng.normal(size=(24, 1200)).astype(np.float32)
    init = x[:, rng.choice(1200, 16, replace=False)].copy()
    kw = dict(n_clusters=16, max_iter=20, tol=1e-4, distance=distance)
    ref = JaxKMeans(**kw)
    l_ref = ref.fit(jnp.asarray(x), centroids=jnp.asarray(init))
    port = tp.clustering.KMeans(**kw, device=CPU)
    lab = port.fit(x, centroids=init)
    np.testing.assert_allclose(port._centroids.numpy(),
                               np.asarray(ref._centroids), atol=1e-5)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(l_ref))
    np.testing.assert_array_equal(port.predict(x).numpy(),
                                  np.asarray(ref.predict(jnp.asarray(x))))


def test_multikmeans_same_init_matches(rng):
    x = rng.normal(size=(4, 2, 3000)).astype(np.float32)
    init = x[:, :, :64].copy()
    kw = dict(n_clusters=64, max_iter=10, tol=1e-4)
    ref = JaxMultiKMeans(**kw)
    l_ref = ref.fit(jnp.asarray(x), centroids=jnp.asarray(init))
    port = tp.clustering.MultiKMeans(**kw, device=CPU)
    lab = port.fit(x, centroids=init)
    np.testing.assert_allclose(port._centroids.numpy(),
                               np.asarray(ref._centroids), atol=1e-5)
    assert np.mean(lab.numpy() == np.asarray(l_ref)) >= 0.999


def test_kmeans_own_init_trains(rng):
    """The port's own inits (its own generator): k-means++ finds separated
    clusters, and a seed fixes the random-init fit."""
    centers = rng.normal(size=(8, 16)).astype(np.float32) * 10
    x = (centers[rng.integers(0, 8, 2000)]
         + rng.normal(size=(2000, 16)).astype(np.float32)).T
    km = tp.clustering.KMeans(n_clusters=8, max_iter=50, init_mode="kmeans++",
                              device=CPU)
    km.fit(x)
    d2 = ((x.T[:, None, :] - km._centroids[0].numpy()[None]) ** 2) \
        .sum(-1).min(1)
    assert d2.mean() < 16 * 4, d2.mean()
    fits = [tp.clustering.KMeans(n_clusters=8, n_redo=2, seed=3,
                                 device=CPU).fit(x)
            for _ in range(2)]
    np.testing.assert_array_equal(fits[0].numpy(), fits[1].numpy())


def test_pq_codes_match(rng):
    x = rng.normal(size=(32, 3000)).astype(np.float32)
    ref = JaxPQ(d_vector=32, n_subvectors=8, max_iter=5)
    ref.train(jnp.asarray(x))
    port = tp.codec.PQCodec(d_vector=32, n_subvectors=8, device=CPU)
    port.load_state_dict(ref.state_dict())
    assert port.is_trained
    xs = rng.normal(size=(32, 2000)).astype(np.float32)
    c_ref = np.asarray(ref.encode(jnp.asarray(xs)))
    codes = port.encode(xs).numpy()
    assert codes.dtype == np.uint8
    assert np.mean(codes == c_ref) >= 0.999
    np.testing.assert_allclose(port.decode(codes).numpy(),
                               np.asarray(ref.decode(jnp.asarray(codes))),
                               rtol=0, atol=0)


def test_pq_train_same_init_matches(rng):
    x = rng.normal(size=(16, 2000)).astype(np.float32)
    init = x.reshape(4, 4, -1)[:, :, :256].copy()
    ref = JaxPQ(d_vector=16, n_subvectors=4, max_iter=4)
    ref.train(jnp.asarray(x), centroids=jnp.asarray(init))
    port = tp.codec.PQCodec(d_vector=16, n_subvectors=4, max_iter=4,
                            device=CPU)
    port.train(x, centroids=init)
    np.testing.assert_allclose(port.codebook_internal.numpy(),
                               np.asarray(ref.codebook_internal), atol=1e-5)
