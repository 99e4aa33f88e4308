"""Port parity of the remaining public ops: the SQ codec, PCA, OPQ,
mini-batch k-means and the bmm family, and the twins of
tests/test_transform_pipeline.py. The same seeded numpy inputs go through
the JAX package and the port at toy sizes. Trained state is carried across
(the .npz state path, or a state_dict); OPQ's rounds and the mini-batch
steps start from equal centroids in both packages, never from two fresh
random fits. Each test states its tolerance."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torchpq_tpu.clustering import MinibatchKMeans as JaxMBK
from torchpq_tpu.codec import SQCodec as JaxSQ
from torchpq_tpu.index import FlatIndex as JaxFlatIndex
from torchpq_tpu.index import IVFPQIndex as JaxIndex
from torchpq_tpu.ops import bmm as jbmm
from torchpq_tpu.transform import OPQ as JaxOPQ
from torchpq_tpu.transform import PCA as JaxPCA
import torchpq_tpu_torch as tp
from torchpq_tpu_torch.ops import bmm as tbmm

from _torch_helpers import CPU, assert_topk_match, to_np

DISTANCES = ["euclidean", "inner", "cosine", "manhattan"]


def _carry(src, dst, tmp_path, name):
    """src saved as .npz, loaded into dst."""
    path = str(tmp_path / f"{name}.npz")
    src.save(path)
    dst.load(path)
    return dst


# -- SQ -----------------------------------------------------------------------

@pytest.mark.parametrize("bits,mode", [(8, "minmax"), (8, "meanstd"),
                                       (4, "minmax"), (4, "meanstd"),
                                       (16, "minmax"), (32, "minmax")])
def test_sq_matches(rng, bits, mode):
    """train's window (rel 1e-6), encode (codes equal on >= 0.999: a value
    on a bin edge may round either way after a one-ulp window change) and
    decode of the same codes (equal within 1e-6) against the JAX codec."""
    x = (rng.normal(size=(16, 700)) * 3 + 1).astype(np.float32)
    ref = JaxSQ(bits=bits, alpha=1.5, mode=mode)
    port = tp.codec.SQCodec(bits=bits, alpha=1.5, mode=mode, device=CPU)
    ref.train(jnp.asarray(x))
    port.train(x)
    assert port.is_trained
    for key in ("lower", "upper") + (("binsize",) if bits <= 8 else ()):
        np.testing.assert_allclose(getattr(port, key).numpy(),
                                   np.asarray(getattr(ref, key)),
                                   rtol=1e-6, atol=1e-6, err_msg=key)
    c_ref = np.asarray(ref.encode(jnp.asarray(x)))
    codes = port.encode(x)
    assert codes.dtype == {4: torch.uint8, 8: torch.uint8,
                           16: torch.float16, 32: torch.float32}[bits]
    assert tuple(codes.shape) == c_ref.shape
    assert np.mean(to_np(codes) == c_ref) >= 0.999
    np.testing.assert_allclose(
        port.decode(c_ref).numpy(), np.asarray(ref.decode(jnp.asarray(c_ref))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_sq_state_carries_across(rng, tmp_path, direction):
    """A trained 4-bit codec saved by one package encodes and decodes alike
    in the other (codes equal, decodes within 1e-6)."""
    x = rng.normal(size=(8, 300)).astype(np.float32)
    jsq, tsq = JaxSQ(bits=4, mode="meanstd"), tp.codec.SQCodec(
        bits=4, mode="meanstd", device=CPU)
    if direction == "jax_to_port":
        jsq.train(jnp.asarray(x))
        _carry(jsq, tsq, tmp_path, "sq")
    else:
        tsq.train(x)
        _carry(tsq, jsq, tmp_path, "sq")
    assert tsq.is_trained and jsq.is_trained
    codes = tsq.encode(x).numpy()
    np.testing.assert_array_equal(codes, np.asarray(jsq.encode(
        jnp.asarray(x))))
    np.testing.assert_allclose(tsq.decode(codes).numpy(),
                               np.asarray(jsq.decode(jnp.asarray(codes))),
                               rtol=1e-6, atol=1e-6)


# -- PCA ----------------------------------------------------------------------

def _pca_data(rng, d=24, n=900):
    x = rng.normal(size=(d, n)).astype(np.float32)
    x *= np.linspace(4.0, 0.5, d, dtype=np.float32)[:, None]
    return x + 2.0


def test_pca_train_matches_up_to_sign(rng):
    """The port's fit against the JAX fit: mean within 1e-5, components
    equal within 1e-3 up to each row's sign (eigh fixes no sign), and the
    reconstruction of the data within 1e-3."""
    x = _pca_data(rng)
    ref, port = JaxPCA(n_components=10), tp.transform.PCA(n_components=10,
                                                           device=CPU)
    ref.train(jnp.asarray(x))
    port.train(x)
    np.testing.assert_allclose(port._mean.numpy(), np.asarray(ref._mean),
                               rtol=1e-5, atol=1e-5)
    c_ref = np.asarray(ref._components)
    comps = port._components.numpy()
    sign = np.sign(np.sum(comps * c_ref, axis=1, keepdims=True))
    np.testing.assert_allclose(comps * sign, c_ref, atol=1e-3)
    np.testing.assert_allclose(
        port.decode(port.encode(x)).numpy(),
        np.asarray(ref.decode(ref.encode(jnp.asarray(x)))), atol=1e-3)
    np.testing.assert_allclose(
        tp.transform.PCA.covar(x, meaned=False).numpy(),
        np.asarray(JaxPCA.covar(jnp.asarray(x), meaned=False)),
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_pca_state_carries_across(rng, tmp_path, direction):
    """From carried state, encode and decode agree within 1e-5."""
    x = _pca_data(rng)
    jp, tpc = JaxPCA(n_components=6), tp.transform.PCA(n_components=6,
                                                        device=CPU)
    if direction == "jax_to_port":
        jp.train(jnp.asarray(x))
        _carry(jp, tpc, tmp_path, "pca")
    else:
        tpc.train(x)
        _carry(tpc, jp, tmp_path, "pca")
    assert tpc.is_trained and jp.is_trained
    z = tpc.encode(x)
    np.testing.assert_allclose(z.numpy(), np.asarray(jp.encode(
        jnp.asarray(x))), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tpc.decode(z).numpy(),
                               np.asarray(jp.decode(jnp.asarray(z.numpy()))),
                               rtol=1e-5, atol=1e-4)


# -- OPQ ----------------------------------------------------------------------

def _opq_pair(n_iter):
    kw = dict(d_vector=16, n_subvectors=4, n_clusters=32, n_iter=n_iter,
              pq_max_iter=4)
    return JaxOPQ(**kw), tp.transform.OPQ(**kw, device=CPU)


def _warm_start(opq, init):
    """Seed the first round's codebooks (the JAX package draws them from
    jax.random, the port from a torch.Generator) with `init`
    ([m, dsub, k]); later rounds pass their own warm codebooks."""
    train = opq.pq.train

    def seeded(x, centroids=None):
        return train(x, centroids=init if centroids is None else centroids)

    opq.pq.train = seeded


def test_opq_train_from_warm_start_matches(rng):
    """Two rounds from the same rotation and the same first codebooks: the
    rotations within 1e-3, the codebooks within 1e-2 and the codes of the
    training data equal on >= 0.98 (k-means labels flip on near-ties as
    the f32 sums drift)."""
    x = rng.normal(size=(16, 1200)).astype(np.float32)
    x[:4] *= 3.0
    jo, to = _opq_pair(n_iter=2)
    init = x[:, :32].reshape(4, 4, 32)
    _warm_start(jo, jnp.asarray(init))
    _warm_start(to, init)
    jo.train(jnp.asarray(x))
    to.train(x)
    assert to.is_trained
    np.testing.assert_allclose(to.rotation.numpy(), np.asarray(jo.rotation),
                               atol=1e-3)
    r = to.rotation.numpy()
    np.testing.assert_allclose(r @ r.T, np.eye(16), atol=1e-5)
    np.testing.assert_allclose(to.codebook.numpy(), np.asarray(jo.codebook),
                               atol=1e-2)
    assert np.mean(to.encode(x).numpy()
                   == np.asarray(jo.encode(jnp.asarray(x)))) >= 0.98


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_opq_state_carries_across(rng, tmp_path, direction):
    """rotate within 1e-5, encode equal on >= 0.999 and decode of the same
    codes within 1e-5, from carried state."""
    x = rng.normal(size=(16, 800)).astype(np.float32)
    jo, to = _opq_pair(n_iter=1)
    if direction == "jax_to_port":
        jo.train(jnp.asarray(x))
        _carry(jo, to, tmp_path, "opq")
    else:
        to.train(x)
        _carry(to, jo, tmp_path, "opq")
    assert to.is_trained and jo.is_trained
    np.testing.assert_allclose(to.rotate(x).numpy(),
                               np.asarray(jo.rotate(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    codes = to.encode(x).numpy()
    assert np.mean(codes == np.asarray(jo.encode(jnp.asarray(x)))) >= 0.999
    np.testing.assert_allclose(to.decode(codes).numpy(),
                               np.asarray(jo.decode(jnp.asarray(codes))),
                               rtol=1e-5, atol=1e-5)


# -- mini-batch k-means -------------------------------------------------------

@pytest.mark.parametrize("distance", ["euclidean", "cosine", "inner"])
def test_minibatch_kmeans_matches(rng, distance):
    """Four batches from equal initial centroids: labels equal, centroids
    and counts within 1e-5, inertia and error within rel 1e-4; then
    predict and topk; sm_size accepted and ignored."""
    d, k = 12, 16
    init = rng.normal(size=(d, k)).astype(np.float32)
    ref = JaxMBK(n_clusters=k, distance=distance, sm_size=48 * 1024)
    port = tp.clustering.MinibatchKMeans(n_clusters=k, distance=distance,
                                         sm_size=48 * 1024, device=CPU)
    for step in range(4):
        b = rng.normal(size=(d, 300)).astype(np.float32)
        kw = dict(centroids=init) if step == 0 else {}
        l_ref = ref.fit_minibatch(
            jnp.asarray(b), **{n: jnp.asarray(v) for n, v in kw.items()})
        lab = port.fit_minibatch(b, **kw)
        np.testing.assert_array_equal(lab.numpy(), np.asarray(l_ref))
        np.testing.assert_allclose(port.centroids.numpy(),
                                   np.asarray(ref.centroids), atol=1e-5)
        np.testing.assert_allclose(port.n_points_in_clusters.numpy(),
                                   np.asarray(ref.n_points_in_clusters))
        np.testing.assert_allclose([port.inertia, port.error],
                                   [ref.inertia, ref.error], rtol=1e-4,
                                   atol=1e-6)
    q = rng.normal(size=(d, 50)).astype(np.float32)
    np.testing.assert_array_equal(port.predict(q).numpy(),
                                  np.asarray(ref.predict(jnp.asarray(q))))
    v_ref, i_ref = ref.topk(jnp.asarray(q), k=5)
    v, i = port.topk(q, k=5)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))


@pytest.mark.parametrize("init_mode", ["random", "kmeans++"])
def test_minibatch_kmeans_own_init_and_state(rng, tmp_path, init_mode):
    """A fit from the port's own seeded init (a torch.Generator: other
    draws than jax.random) trains; its state carries into the JAX
    package, which then predicts the same labels and takes the same next
    step (centroids within 1e-5)."""
    d, k = 8, 10
    b = rng.normal(size=(d, 400)).astype(np.float32)
    port = tp.clustering.MinibatchKMeans(n_clusters=k, init_mode=init_mode,
                                         seed=3, device=CPU)
    assert not port.is_trained
    port.fit_minibatch(b)
    assert port.is_trained and np.isfinite(port.inertia)
    ref = _carry(port, JaxMBK(n_clusters=k), tmp_path, "mbk")
    np.testing.assert_array_equal(port.predict(b).numpy(),
                                  np.asarray(ref.predict(jnp.asarray(b))))
    b2 = rng.normal(size=(d, 400)).astype(np.float32)
    port.fit_minibatch(b2)
    ref.fit_minibatch(jnp.asarray(b2))
    np.testing.assert_allclose(port.centroids.numpy(),
                               np.asarray(ref.centroids), atol=1e-5)


# -- bmm family ---------------------------------------------------------------

def _ab(rng, l=3, m=20, n=30, d=8):
    return (rng.normal(size=(l, m, d)).astype(np.float32),
            rng.normal(size=(l, n, d)).astype(np.float32))


@pytest.mark.parametrize("distance", DISTANCES)
def test_bmm_matches(rng, distance):
    a, b = _ab(rng)
    np.testing.assert_allclose(
        tbmm.bmm(torch.from_numpy(a), torch.from_numpy(b),
                 distance=distance).numpy(),
        np.asarray(jbmm.bmm(jnp.asarray(a), jnp.asarray(b),
                            distance=distance)), rtol=1e-5, atol=1e-4)


def test_bmm_manhattan_chunks(rng, monkeypatch):
    """The manhattan broadcast cut into row chunks equals one chunk."""
    a, b = _ab(rng, m=50)
    whole = tbmm.bmm(torch.from_numpy(a), torch.from_numpy(b), "manhattan")
    monkeypatch.setattr(tp.config, "MAX_SIM_CHUNK_ELEMS", 3 * 30 * 9)
    cut = tbmm.bmm(torch.from_numpy(a), torch.from_numpy(b), "manhattan")
    assert torch.equal(whole, cut)


@pytest.mark.parametrize("distance,dim", [("euclidean", 2), ("inner", 1),
                                          ("manhattan", 2)])
def test_min_bmm_matches(rng, distance, dim):
    a, b = _ab(rng)
    v_ref, i_ref = jbmm.min_bmm(jnp.asarray(a), jnp.asarray(b),
                                distance=distance, dim=dim)
    v, i = tbmm.min_bmm(torch.from_numpy(a), torch.from_numpy(b),
                        distance=distance, dim=dim)
    assert i.dtype == torch.int32
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))


@pytest.mark.parametrize("distance,dim,k", [("inner", 2, 7), ("cosine", 1, 4),
                                            ("euclidean", 2, 128)])
def test_topk_bmm_matches(rng, distance, dim, k):
    """Values within 1e-4, indices equal outside ties; k above the row
    length keeps the whole row."""
    a, b = _ab(rng)
    v_ref, i_ref = jbmm.topk_bmm(jnp.asarray(a), jnp.asarray(b), k=k,
                                 distance=distance, dim=dim)
    v, i = tbmm.topk_bmm(torch.from_numpy(a), torch.from_numpy(b), k=k,
                         distance=distance, dim=dim)
    assert tuple(v.shape) == tuple(np.asarray(v_ref).shape)
    for r in range(v.shape[0]):
        assert_topk_match(v_ref[r], i_ref[r], v[r], i[r])


def test_masked_bmm_matches(rng):
    a, b = _ab(rng)
    mask = rng.random(size=(3, 20, 30)) > 0.3
    got = tbmm.masked_bmm(torch.from_numpy(a), torch.from_numpy(b),
                          torch.from_numpy(mask), distance="euclidean")
    ref = np.asarray(jbmm.masked_bmm(jnp.asarray(a), jnp.asarray(b),
                                     jnp.asarray(mask), distance="euclidean"))
    assert np.array_equal(np.isneginf(got.numpy()), ~mask)
    np.testing.assert_allclose(got.numpy()[mask], ref[mask], rtol=1e-5,
                               atol=1e-4)


# -- transform pipelines (twins of tests/test_transform_pipeline.py) ---------

def test_pca_into_ivfpq(rng, tmp_path):
    """PCA 64 -> 32 from carried state feeding an IVFPQ index carried from
    the JAX package: the reduced vectors within 1e-4, the same adds, and
    the self-query finds the inserted row (>= 0.9, as the JAX test) with
    ids equal to the JAX index's outside ties."""
    d, d_red, n = 64, 32, 3000
    x = rng.standard_normal((d, n)).astype(np.float32)
    x[:d_red] *= 4.0
    jp = JaxPCA(n_components=d_red)
    jp.train(jnp.asarray(x))
    port_pca = _carry(jp, tp.transform.PCA(n_components=d_red, device=CPU),
                      tmp_path, "pca")
    z_ref = jp.encode(jnp.asarray(x))
    z = port_pca.encode(x)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), rtol=1e-4,
                               atol=1e-4)
    kw = dict(d_vector=d_red, n_subvectors=8, n_cells=16, initial_size=512)
    jidx = JaxIndex(**kw)
    jidx.vq_codec.kmeans.max_iter = jidx.pq_codec.kmeans.max_iter = 6
    jidx.train(z_ref)
    port = tp.IVFPQIndex(**kw, device=CPU)
    port.load_state_dict(jidx.state_dict())
    ids = np.asarray(jidx.add(z_ref))
    port.add(z_ref.__array__())
    for idx in (jidx, port):
        idx.n_probe = 16
    v_ref, i_ref = jidx.search(z_ref[:, :32], k=1)
    v, got = port.search(np.asarray(z_ref)[:, :32], k=1)
    assert (got.numpy()[:, 0] == ids[:32]).mean() >= 0.9
    assert_topk_match(v_ref, i_ref, v, got)


def test_opq_rotation_into_flat(rng, tmp_path):
    """OPQ carried from the JAX package rotates into a FlatIndex: every
    self-query finds its row, the rotation keeps inner products (within
    1e-2), and the search equals the JAX FlatIndex's on the same rotated
    rows."""
    d, n = 32, 1500
    x = rng.standard_normal((d, n)).astype(np.float32)
    jo = JaxOPQ(d_vector=d, n_subvectors=8, n_iter=3, pq_max_iter=5)
    jo.train(jnp.asarray(x[:, :1000]))
    to = _carry(jo, tp.transform.OPQ(d_vector=d, n_subvectors=8, n_iter=3,
                                     pq_max_iter=5, device=CPU),
                tmp_path, "opq")
    z = to.rotate(x)
    assert tuple(z.shape) == (d, n)
    flat = tp.FlatIndex(d_vector=d, initial_size=2048, device=CPU)
    ids = flat.add(z).numpy()
    v, got = flat.search(z[:, :64], k=1)
    assert (got.numpy()[:, 0] == ids[:64]).all()
    zz = z.numpy()
    np.testing.assert_allclose(zz[:, :8].T @ zz[:, :8], x[:, :8].T @ x[:, :8],
                               rtol=1e-3, atol=1e-2)
    jflat = JaxFlatIndex(d_vector=d, initial_size=2048)
    jflat.add(jnp.asarray(zz))
    v_ref, i_ref = jflat.search(jnp.asarray(zz[:, :64]), k=3)
    v, got = flat.search(zz[:, :64], k=3)
    assert_topk_match(v_ref, i_ref, v, got)
