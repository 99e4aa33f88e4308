"""Port parity of the PQ variants: 4-bit PQ (packed nibbles scored through
the byte-pair codebook), residual PQ, anisotropic PQ and manhattan
distance. The same seeded numpy inputs (or the JAX package's trained
state, carried into the port) go through both packages at toy sizes
(d 32, m 8, 8-16 cells, n <= 1,500); each test states its tolerance.

Mirrors tests/test_pq4.py (but the IVFPQR case, which needs the port's
IVFPQR index), tests/test_codecs.py::test_pq4bit_codec and
::test_anisotropic_recall_gain, tests/test_ivfpq.py::test_residual_mode
and the manhattan cases of tests/test_code_domain.py, tests/test_metric.py,
tests/test_kmeans.py and tests/test_flat_adc.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torchpq_tpu import metric as jmetric
from torchpq_tpu.clustering import KMeans as JaxKMeans
from torchpq_tpu.codec import pq as jpq
from torchpq_tpu.index import IVFPQIndex as JaxIndex
from torchpq_tpu.index.ivfpq import _coarse_probe as jcoarse
from torchpq_tpu.ops import adc as jadc
from torchpq_tpu.ops import flat_adc as jflat
from torchpq_tpu.ops import max_sim as jms
from torchpq_tpu.ops import onehot_adc as jonehot
import torchpq_tpu_torch as tp
from torchpq_tpu_torch.codec import pq as tpq
from torchpq_tpu_torch.ops import adc as tadc
from torchpq_tpu_torch.ops import flat_adc as tflat
from torchpq_tpu_torch.ops import max_sim as tms
from torchpq_tpu_torch.ops import onehot_adc as tonehot

from _torch_helpers import CPU, assert_topk_match, overlap, to_np, to_t

D, M = 32, 8


def _clustered(seed, n, d=D, n_centers=20, scale=3.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_centers, d)).astype(np.float32) * scale
    x = centers[rng.integers(0, n_centers, n)] \
        + rng.normal(size=(n, d)).astype(np.float32)
    return x.astype(np.float32)


def _pair(x_train, x_add, *, n_cells=16, max_iter=8, **kw):
    """A JAX-trained index, its state carried into the port, the same add
    in both (ids 0..n-1)."""
    kw = dict(d_vector=D, n_subvectors=M, n_cells=n_cells, initial_size=32,
              **kw)
    jidx = JaxIndex(**kw)
    jidx.vq_codec.kmeans.max_iter = jidx.pq_codec.kmeans.max_iter = max_iter
    jidx.train(jnp.asarray(x_train.T))
    port = tp.IVFPQIndex(**kw, device=CPU)
    port.load_state_dict(jidx.state_dict())
    _, a_ref = jidx.add(jnp.asarray(x_add.T), return_address=True)
    _, a = port.add(x_add.T, return_address=True)
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    return jidx, port


def _search_both(jidx, port, q, k, **settings):
    for idx in (jidx, port):
        for name, value in settings.items():
            setattr(idx, name, value)
    v_ref, i_ref = jidx.search(jnp.asarray(q.T), k=k)
    v, i = port.search(q.T, k=k)
    return v_ref, i_ref, v, i


def _recall(ids, gt):
    ids = to_np(ids)
    return float(np.mean([len(set(ids[r]) & set(gt[r])) / gt.shape[1]
                          for r in range(gt.shape[0])]))


_CASES = {}


def _case(name):
    """Indexes built once per setting: (jidx, port, x, q)."""
    if name not in _CASES:
        x = _clustered(31, 1400)
        kw = {"pq4": dict(n_bits=4, scan_cache_dtype="float32"),
              "pq4_bf16": dict(n_bits=4),
              "pq4_code": dict(n_bits=4, scan_cache_dtype="none"),
              "residual": dict(pq_use_residual=True),
              "manhattan": dict(distance="manhattan"),
              "manhattan_code": dict(distance="manhattan",
                                     scan_cache_dtype="none")}[name]
        jidx, port = _pair(x[:900], x, **kw)
        _CASES[name] = (jidx, port, x, _clustered(32, 24))
    return _CASES[name]


# ---- the 4-bit codec pieces ----

def test_nibbles_and_paired_codebook_match(rng):
    """pack / unpack and the byte-pair codebook equal the JAX package's bit
    for bit; packed bytes against the byte-pair codebook decode exactly as
    the unpacked codes against the 16-entry one (test_pq4.py:28-42)."""
    m, nc, dsub, n = 6, 16, 5, 257
    cb = rng.normal(size=(m, nc, dsub)).astype(np.float32)
    codes = rng.integers(0, nc, size=(m, n)).astype(np.uint8)
    packed = tpq.pack_nibbles(codes)
    assert packed.dtype == torch.uint8 and tuple(packed.shape) == (m // 2, n)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(
        jpq.pack_nibbles(jnp.asarray(codes))))
    np.testing.assert_array_equal(tpq.unpack_nibbles(packed).numpy(), codes)
    pcb = tpq.paired_codebook(torch.from_numpy(cb))
    np.testing.assert_array_equal(pcb.numpy(), np.asarray(
        jpq.paired_codebook(jnp.asarray(cb))))
    want = tp.ops.codes_scan.decode_codes(torch.from_numpy(codes.T),
                                          torch.from_numpy(cb))
    got = tp.ops.codes_scan.decode_codes(packed.T, pcb)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_pq4bit_codec_matches(rng):
    """PQCodec(n_clusters=16) from the same initial codebooks: the same
    codebooks (1e-5), codes and decode; codes below 16 and the nibble round
    trip (test_codecs.py::test_pq4bit_codec)."""
    d, n, m = 32, 500, 8
    x = rng.normal(size=(d, n)).astype(np.float32)
    init = np.ascontiguousarray(
        x.reshape(m, d // m, n)[:, :, :16])            # [m, dsub, 16]
    ref = jpq.PQCodec(d_vector=d, n_subvectors=m, n_clusters=16,
                      max_iter=10)
    ref.train(jnp.asarray(x), centroids=jnp.asarray(init))
    port = tpq.PQCodec(d_vector=d, n_subvectors=m, n_clusters=16,
                       max_iter=10, device=CPU)
    port.train(x, centroids=init)
    np.testing.assert_allclose(port.codebook.numpy(),
                               np.asarray(ref.codebook), rtol=1e-5,
                               atol=1e-5)
    code = port.encode(x)
    assert int(code.max()) < 16 and tuple(code.shape) == (m, n)
    assert np.mean(code.numpy() == np.asarray(ref.encode(jnp.asarray(x)))) \
        >= 0.999
    rec = port.decode(code).numpy()
    assert ((rec - x) ** 2).mean() < (x ** 2).mean()
    np.testing.assert_allclose(
        rec, np.asarray(ref.decode(jnp.asarray(code.numpy()))), rtol=1e-5,
        atol=1e-5)
    packed = tpq.pack_nibbles(code)
    assert tuple(packed.shape) == (m // 2, n)
    np.testing.assert_array_equal(tpq.unpack_nibbles(packed).numpy(),
                                  code.numpy())


# ---- anisotropic PQ ----

def _aniso_inputs(seed, n=3000, d=D, m=M, k=32):
    """MIPS-shaped data (clustered directions with a norm spread) as
    feature-major subvectors [m, dsub, n], and a warm start: k-means
    centroids [m, k, dsub] from the data itself."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((24, d)).astype(np.float32)
    x = centers[rng.integers(0, 24, size=n)] \
        + 0.35 * rng.standard_normal((n, d)).astype(np.float32)
    x *= (0.5 + rng.random((n, 1))).astype(np.float32) ** 2
    sub = np.ascontiguousarray(x.T.reshape(m, d // m, n))
    cents = np.ascontiguousarray(sub[:, :, :k].transpose(0, 2, 1))
    return x, sub, cents


def test_aniso_assign_matches():
    """_aniso_assign against the JAX function on the same subvectors and
    codebook, over several column blocks (chunk 512): labels agree on >=
    0.999 (the cost's last bits follow the summation order)."""
    _, sub, cents = _aniso_inputs(41)
    kw = dict(eta=4.0, k=cents.shape[1], chunk=512)
    ref = np.asarray(jpq._aniso_assign(jnp.asarray(sub), jnp.asarray(cents),
                                       **kw))
    got = tpq._aniso_assign(torch.from_numpy(sub), torch.from_numpy(cents),
                            **kw)
    assert got.dtype == torch.int32 and got.shape == ref.shape
    assert np.mean(got.numpy() == ref) >= 0.999


def test_aniso_refine_matches():
    """_aniso_refine (eta 4, 8 iterations) from the same warm start as the
    JAX function: centroids within 1e-3 (the [dsub, dsub] solves and the
    one-hot sums differ in their last bits), and the labels they give agree
    on >= 0.999."""
    _, sub, cents = _aniso_inputs(42)
    kw = dict(eta=4.0, iters=8, k=cents.shape[1], chunk=1024)
    ref = np.asarray(jpq._aniso_refine(jnp.asarray(sub), jnp.asarray(cents),
                                       **kw))
    got = tpq._aniso_refine(torch.from_numpy(sub), torch.from_numpy(cents),
                            **kw)
    assert not np.allclose(ref, cents), "the refinement must move"
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-3)
    lab_ref = np.asarray(jpq._aniso_assign(
        jnp.asarray(sub), jnp.asarray(ref), eta=4.0, k=cents.shape[1],
        chunk=1024))
    lab = tpq._aniso_assign(torch.from_numpy(sub), got, eta=4.0,
                            k=cents.shape[1], chunk=1024).numpy()
    assert np.mean(lab == lab_ref) >= 0.999


def test_anisotropic_recall_gain():
    """Score-aware PQ from the same warm start in both packages: >= 0.99
    of the codebook entries within 1e-3 (a label that flips on a near-tie
    in one package moves its clusters; the refinement alone is held from
    equal inputs above), and in the port eta = 4 changes the codes and
    raises inner-product recall@10 over plain PQ
    (test_codecs.py::test_anisotropic_recall_gain)."""
    x, _, _ = _aniso_inputs(43, n=6000)
    rng = np.random.default_rng(44)
    centers = rng.standard_normal((24, D)).astype(np.float32)
    q = centers[rng.integers(0, 24, size=128)] \
        + 0.35 * rng.standard_normal((128, D)).astype(np.float32)
    gt = np.argsort(-(q @ x.T), axis=1)[:, :10]
    init = np.ascontiguousarray(x[:256].T.reshape(M, D // M, 256))
    with pytest.raises(AssertionError, match="must be >= 1"):
        tpq.PQCodec(d_vector=D, n_subvectors=M, anisotropic_eta=0.5,
                    device=CPU)

    def recall(eta):
        kw = dict(d_vector=D, n_subvectors=M, distance="inner",
                  anisotropic_eta=eta, max_iter=10)
        ref = jpq.PQCodec(**kw)
        ref.train(jnp.asarray(x.T), centroids=jnp.asarray(init))
        port = tpq.PQCodec(**kw, device=CPU)
        port.train(x.T, centroids=init)
        got = port.codebook_internal.numpy()
        want = np.asarray(ref.codebook_internal)
        assert np.mean(np.abs(got - want) <= 1e-3 + 1e-3 * np.abs(want)) \
            >= 0.99
        codes = port.encode_nd(x)
        dec = port.decode_nd(codes).numpy()
        pred = np.argsort(-(q @ dec.T), axis=1)[:, :10]
        return _recall(pred, gt), codes.numpy()

    r_plain, codes_plain = recall(None)
    r_aniso, codes_aniso = recall(4.0)
    assert (codes_plain != codes_aniso).any(), "eta must change assignments"
    assert r_aniso > r_plain, (r_aniso, r_plain)


def test_anisotropic_index_matches():
    """An IVFPQ index with anisotropic_eta / anisotropic_iters: the
    settings reach the PQ codec, the JAX-trained codebooks encode alike
    (the anisotropic assignment: >= 0.995 of the stored codes; the cost
    cancels, so near-ties follow the summation order) and every plan
    finds the same neighbours (id overlap >= 0.95, values within 1e-3 where
    the ids agree)."""
    x = _clustered(31, 1400)
    jidx, port = _pair(x[:900], x, distance="inner", anisotropic_eta=3.0,
                       anisotropic_iters=4)
    assert (port.pq_codec.anisotropic_eta, port.pq_codec.anisotropic_iters) \
        == (3.0, 4)
    assert np.mean(port._storage.numpy() == np.asarray(jidx._storage)) \
        >= 0.995
    q = _clustered(46, 16)
    for mode in ("cell_major", "flat"):
        v_ref, i_ref, v, i = _search_both(
            jidx, port, q, 10, n_probe=6, scan_mode=mode, scan_impl="xla")
        assert overlap(i, i_ref) >= 0.95
        same = i.numpy() == np.asarray(i_ref)
        np.testing.assert_allclose(v.numpy()[same], np.asarray(v_ref)[same],
                                   rtol=1e-4, atol=1e-3)


# ---- 4-bit IVFPQ ----

def test_pq4_storage_is_packed():
    """m/2 bytes per slot, 16-cluster codebooks, unpacked rows in the
    decoded-cache tiers (no pack at ingest, as in the JAX package), the
    stored bytes equal the JAX package's and decode to what the codec
    reconstructs (test_pq4.py:45-54)."""
    jidx, port, x, _ = _case("pq4")
    assert tuple(port._storage.shape) == tuple(jidx._storage.shape)
    assert port._storage.shape[1] == M // 2 and port.pack_group == 1
    assert port.pq_codec.n_clusters == 16
    np.testing.assert_array_equal(port._storage.numpy(),
                                  np.asarray(jidx._storage))
    want = port.pq_codec.decode_nd(port.pq_codec.encode_nd(x)).numpy()
    addr = port.get_address_by_id(np.arange(len(x)))
    got = port._decode_stored(port._storage[addr.long()]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(port.aux("decoded").numpy(),
                                  np.asarray(jidx.aux("decoded")))


def test_pq4_scan_codebook_cache():
    """The byte-pair view is built once per codebook tensor and rebuilt
    after an in-place change and after a load (a new tensor)."""
    _, port, _, _ = _case("pq4")
    first = port._scan_codebook
    assert port._scan_codebook is first
    assert tuple(first.shape) == (M // 2, 256, 2 * D // M)
    cb = port.pq_codec.kmeans._centroids
    saved = cb.clone()
    try:
        cb.mul_(2.0)
        assert torch.equal(port._scan_codebook, 2.0 * first)
    finally:
        cb.copy_(saved)
    fresh = tp.IVFPQIndex(d_vector=D, n_subvectors=M, n_cells=16, n_bits=4,
                          scan_cache_dtype="float32", device=CPU)
    fresh.load_state_dict(port.state_dict())
    fresh._scan_codebook
    fresh.load_state_dict({"pq_codec.kmeans._centroids":
                           2.0 * saved.numpy()})
    assert torch.equal(fresh._scan_codebook, 2.0 * first)


@pytest.mark.parametrize("name", ["pq4", "pq4_bf16", "pq4_code"])
@pytest.mark.parametrize("mode,approx", [("cell_major", False),
                                         ("cell_major", True),
                                         ("flat", False)])
def test_pq4_search_matches(name, mode, approx):
    """Every plan of the f32, bf16 and code-domain 4-bit tiers: the JAX
    package's values (1e-4) and ids outside ties; pack32 plans by id
    overlap (>= 0.99)."""
    jidx, port, _, q = _case(name)
    v_ref, i_ref, v, i = _search_both(
        jidx, port, q, 10, n_probe=5, use_smart_probing=False,
        scan_mode=mode, use_approx_topk=approx)
    if approx and mode == "cell_major":
        assert overlap(i, i_ref) >= 0.99
        np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=2e-3,
                                   atol=1e-2)
    else:
        assert_topk_match(v_ref, i_ref, v, i, atol=1e-4, rtol=1e-5)


def test_pq4_code_domain_packs_at_ingest():
    """A 4-bit code-domain index of 32 codes (16 bytes per slot) packs at
    ingest with g = 128 / 16 = 8, as the JAX package does, and its probed
    plan runs the codes scan over the byte-pair codebook (16 byte pairs,
    dsub 4): the JAX package's stored bytes, and its neighbours from its
    XLA select, which scores with a bf16 LUT (values within 5e-3 relative:
    each LUT entry rounds by up to 2^-8; ids overlap >= 0.9); the
    kernel's own parity at these shapes is tests/test_torch_codes_scan.py's
    (m 32, dsub 4)."""
    x = _clustered(47, 600)
    kw = dict(d_vector=D, n_subvectors=32, n_cells=8, initial_size=32,
              n_bits=4, scan_cache_dtype="none")
    jidx = JaxIndex(**kw)
    jidx.vq_codec.kmeans.max_iter = jidx.pq_codec.kmeans.max_iter = 6
    jidx.train(jnp.asarray(x.T))
    port = tp.IVFPQIndex(**kw, device=CPU)
    port.load_state_dict(jidx.state_dict())
    jidx.add(jnp.asarray(x.T))
    port.add(x.T)
    assert port.pack_group == jidx.pack_group == 8
    assert tuple(port._storage.shape) == tuple(jidx._storage.shape)
    np.testing.assert_array_equal(port._storage.numpy(),
                                  np.asarray(jidx._storage))
    q = _clustered(48, 6)
    v_ref, i_ref, _, _ = _search_both(jidx, port, q, 8, n_probe=3,
                                      use_smart_probing=False,
                                      scan_mode="cell_major", scan_impl="xla")
    port.scan_impl = "auto"
    v, i = port.search(q.T, k=8)
    assert tadc.LAST_GATE["impl"] == "codes_scan"
    assert (tadc.LAST_GATE["m"], tadc.LAST_GATE["g"]) == (16, 8)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=5e-3,
                               atol=2e-3)
    assert overlap(i, i_ref) >= 0.9


def test_pq4_full_probe_equals_pq_bruteforce():
    """Probing every cell (exact select) finds the brute-force top-k over
    the 4-bit decoded rows: its values (1e-4) and ids outside ties (16-way
    codes leave many rows decoding alike; test_pq4.py:57-76)."""
    _, port, _, q = _case("pq4")
    port.n_probe, port.use_smart_probing = port.n_cells, False
    port.scan_mode, port.use_approx_topk = "cell_major", False
    vals, got = port.search(q.T, k=10)
    decoded = port.aux("decoded").numpy()
    a2i = port._address2id.numpy()
    s = -((q[:, None] - decoded[None]) ** 2).sum(-1)
    s[:, a2i < 0] = -np.inf
    order = np.argsort(-s, axis=1, kind="stable")[:, :10]
    assert_topk_match(np.take_along_axis(s, order, 1), a2i[order], vals,
                      got, atol=1e-3, rtol=1e-4)


def test_pq4_recall_between_random_and_8bit():
    """4-bit recall@10 on clustered data: far above chance, at most the
    8-bit tier's (+0.02) at the same m, both in the port on JAX-trained
    codecs, and equal to the JAX package's (test_pq4.py:109-138)."""
    x = _case("pq4_bf16")[2]
    q = x[:32] + 0.05 * np.random.default_rng(50).normal(
        size=(32, D)).astype(np.float32)
    gt = np.argsort(((q[:, None] - x[None]) ** 2).sum(-1), axis=1)[:, :10]
    rec = {}
    for n_bits in (4, 8):
        jidx, port = _case("pq4_bf16")[:2] if n_bits == 4 \
            else _pair(x[:900], x)
        v_ref, i_ref, v, i = _search_both(jidx, port, q, 10, n_probe=16,
                                          scan_mode="cell_major",
                                          use_approx_topk=False,
                                          scan_impl="xla")
        rec[n_bits] = _recall(i, gt)
        assert abs(rec[n_bits] - _recall(i_ref, gt)) <= 0.01
        jidx.scan_impl = port.scan_impl = "auto"
    assert rec[4] > 0.05, rec
    assert rec[8] >= rec[4] - 0.02, rec


def test_pq4_similarity_at_address_code_domain():
    """similarity_at_address on a 4-bit code-domain index decodes the
    packed bytes through the byte-pair codebook: the JAX package's values
    (1e-4) and the brute force over those rows (test_pq4.py:141-148)."""
    jidx, port, x, q = _case("pq4_code")
    addr = port.get_address_by_id(np.arange(32)).numpy()
    sims = port.similarity_at_address(q.T, addr).numpy()
    ref = np.asarray(jidx.similarity_at_address(jnp.asarray(q.T),
                                                jnp.asarray(addr)))
    np.testing.assert_allclose(sims, ref, rtol=1e-4, atol=1e-3)
    dec = port._decode_stored(port.storage_rows(torch.from_numpy(addr)))
    want = -((q[:, None] - dec.numpy()[None]) ** 2).sum(-1)
    np.testing.assert_allclose(sims, want, rtol=2e-3, atol=2e-3)


def test_pq4_remove_and_relayout_rebuild():
    """A remove, then adds that force a relayout: the rebuilt 4-bit cache
    equals the packed codes' decode and the JAX package's cache bit for
    bit (test_pq4.py:151-162)."""
    x = _clustered(31, 1400)
    jidx, port = _pair(x[:900], x, n_bits=4, scan_cache_dtype="float32")
    cap0 = port.max_cell_capacity
    rm = np.arange(100, 300)
    assert port.remove(rm) == jidx.remove(jnp.asarray(rm))
    more = _clustered(52, 1400)
    jidx.add(jnp.asarray(more.T))
    port.add(more.T)
    assert port.max_cell_capacity > cap0, "the adds must relayout"
    addr = port.get_address_by_id(np.arange(50)).long()
    np.testing.assert_allclose(
        port.aux("decoded")[addr].numpy(),
        port._decode_stored(port._storage[addr]).numpy(), rtol=1e-5,
        atol=1e-5)
    np.testing.assert_array_equal(port.aux("decoded").numpy(),
                                  np.asarray(jidx.aux("decoded")))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pq4_save_load_across(tmp_path, writer):
    """A 4-bit index saved by one package loads into the other and
    searches alike (values 1e-5, ids outside ties; test_pq4.py:196-210)."""
    jidx, port, _, q = _case("pq4_bf16")
    for idx in (jidx, port):
        idx.n_probe, idx.scan_mode = 8, "cell_major"
        idx.use_approx_topk = False
    path = str(tmp_path / "pq4.npz")
    kw = dict(d_vector=D, n_subvectors=M, n_cells=16, n_bits=4)
    if writer == "jax":
        jidx.save(path)
        fresh = tp.IVFPQIndex(**kw, device=CPU)
    else:
        port.save(path)
        fresh = JaxIndex(**kw)
    fresh.load(path)
    fresh.n_probe, fresh.scan_mode = 8, "cell_major"
    want_v, want_i = (jidx.search(jnp.asarray(q.T), k=5) if writer == "jax"
                      else port.search(q.T, k=5))
    got_v, got_i = fresh.search(q.T if writer == "jax"
                                else jnp.asarray(q.T), k=5)
    assert_topk_match(want_v, want_i, got_v, got_i, atol=1e-5, rtol=1e-5)


def test_pq4_int8_cache_matches():
    """4-bit codes under the int8 cache: unpacked rows, the JAX package's
    dequantized rows (up to its one-ulp quantizer divergence, ROADMAP's
    deliberate divergences), and its neighbours: the exact select's
    values (1e-2) and ids outside ties, the pack32 select's values and
    ids (overlap >= 0.95: 16-way codes tie often)."""
    x = _clustered(31, 1400)
    jidx, port = _pair(x[:900], x, n_bits=4, scan_cache_dtype="int8")
    assert port.pack_group == 1 and port._storage.shape[1] == M // 2
    dq = port.aux("decoded").float() * port.aux("scale")
    dq_ref = np.asarray(jidx.aux("decoded")).astype(np.float32) \
        * np.asarray(jidx.aux("scale"))
    np.testing.assert_allclose(dq.numpy(), dq_ref, rtol=1e-2, atol=2e-2)
    q = _clustered(54, 8)
    for approx in (False, True):
        v_ref, i_ref, v, i = _search_both(
            jidx, port, q, 10, n_probe=6, scan_mode="cell_major",
            use_approx_topk=approx)
        np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-3,
                                   atol=1e-2)
        if approx:
            assert overlap(i, i_ref) >= 0.95
        else:
            assert_topk_match(v_ref, i_ref, v, i, atol=1e-2, rtol=1e-3)


# ---- residual PQ ----

def test_residual_mode_matches():
    """Residual PQ: the JAX package's search results (values within 1e-3:
    at a self-hit 2<q, y> - |y|^2 - |q|^2 cancels) and self-hits
    (test_ivfpq.py:100-116); cache rows equal bf16(centroid[cell] +
    PQ decode) bit for bit and the JAX package's cache; encode returns
    (pq_code, vq_code), decode sums both parts."""
    jidx, port, x, q = _case("residual")
    assert port.pq_use_residual and port.use_precomputed
    v_ref, i_ref, v, i = _search_both(jidx, port, x[:50], 5, n_probe=16,
                                      use_smart_probing=False,
                                      scan_mode="cell_major",
                                      use_approx_topk=False)
    assert_topk_match(v_ref, i_ref, v, i, atol=1e-3, rtol=1e-5)
    assert (i.numpy() == np.arange(50)[:, None]).any(1).mean() > 0.9
    np.testing.assert_array_equal(to_np(port.aux("decoded")),
                                  to_np(jidx.aux("decoded")))
    addr = port.get_address_by_id(np.arange(len(x))).long()
    cells = port.get_cell_by_address(addr).long()
    rows = (port._coarse_cb()[cells]
            + port._decode_stored(port.storage_rows(addr)))
    assert torch.equal(port.aux("decoded")[addr], rows.to(torch.bfloat16))
    pq_code, vq_code = port.encode(x[:40].T)
    pq_ref, vq_ref = jidx.encode(jnp.asarray(x[:40].T))
    np.testing.assert_array_equal(vq_code.numpy(), np.asarray(vq_ref))
    assert np.mean(pq_code.numpy() == np.asarray(pq_ref)) >= 0.999
    np.testing.assert_allclose(
        port.decode((pq_code, vq_code)).numpy(),
        np.asarray(jidx.decode((jnp.asarray(pq_code.numpy()),
                                jnp.asarray(vq_code.numpy())))),
        rtol=1e-5, atol=1e-5)
    for mode, approx in (("cell_major", True), ("flat", False)):
        v_ref, i_ref, v, i = _search_both(jidx, port, q, 10, n_probe=5,
                                          scan_mode=mode,
                                          use_approx_topk=approx)
        assert overlap(i, i_ref) >= 0.99


def test_residual_train_reconstructs_better():
    """The port's own training: residual PQ fits the residuals of the
    cells' centroids, and its reconstruction error on the training data is
    below the plain index's (the claim of test_ivfpq.py:100-116)."""
    x = _clustered(55, 1500, n_centers=8, scale=4.0)
    err = {}
    for residual in (False, True):
        idx = tp.IVFPQIndex(d_vector=D, n_subvectors=M, n_cells=8,
                            initial_size=64, pq_use_residual=residual,
                            device=CPU)
        idx.vq_max_iter = idx.pq_max_iter = 8
        idx.train(x.T)
        idx.add(x.T)
        addr = idx.get_address_by_id(np.arange(len(x))).long()
        err[residual] = float(((idx.aux("decoded")[addr].float().numpy()
                                - x) ** 2).mean())
    assert err[True] < err[False], err


def test_residual_cache_after_remove_and_relayout():
    """A remove, then adds that grow the cells: the rebuilt residual cache
    keeps the centroid term (each row bf16(centroid[cell] + decode)), it
    equals the JAX package's, and a relayouted copy searches alike."""
    x = _clustered(31, 1400)
    jidx, port = _pair(x[:900], x, pq_use_residual=True)
    cap0 = port.max_cell_capacity
    rm = np.arange(0, 1400, 3)
    assert port.remove(rm) == jidx.remove(jnp.asarray(rm))
    more = _clustered(57, 1400)
    jidx.add(jnp.asarray(more.T))
    port.add(more.T)
    assert port.max_cell_capacity > cap0, "the adds must relayout"
    live = ~port._is_empty
    addr = torch.nonzero(live).flatten()
    cells = port.get_cell_by_address(addr).long()
    rows = (port._coarse_cb()[cells]
            + port._decode_stored(port.storage_rows(addr)))
    assert torch.equal(port.aux("decoded")[addr], rows.to(torch.bfloat16))
    np.testing.assert_array_equal(
        to_np(port.aux("decoded"))[live.numpy()],
        to_np(jidx.aux("decoded"))[live.numpy()])
    q = _clustered(58, 16)
    port.scan_compact = True
    v_ref, i_ref, v, i = _search_both(jidx, port, q, 10, n_probe=6,
                                      scan_mode="cell_major",
                                      use_approx_topk=False, scan_impl="xla")
    assert_topk_match(v_ref, i_ref, v, i, atol=1e-3, rtol=1e-5)


def test_residual_save_load_across(tmp_path):
    """A JAX-saved residual index (the same keys as an 8-bit one) loads
    into the port and searches alike; the port's save loads into the JAX
    package."""
    jidx, port, _, q = _case("residual")
    path = str(tmp_path / "res.npz")
    jidx.save(path)
    kw = dict(d_vector=D, n_subvectors=M, n_cells=16, pq_use_residual=True)
    fresh = tp.IVFPQIndex(**kw, device=CPU)
    fresh.load(path)
    assert sorted(fresh.state_dict()) == sorted(port.state_dict())
    for idx in (jidx, fresh):
        idx.n_probe, idx.scan_mode, idx.use_approx_topk = 8, "flat", False
    v_ref, i_ref = jidx.search(jnp.asarray(q.T), k=5)
    v, i = fresh.search(q.T, k=5)
    assert_topk_match(v_ref, i_ref, v, i, atol=1e-5, rtol=1e-5)
    path2 = str(tmp_path / "res_port.npz")
    fresh.save(path2)
    back = JaxIndex(**kw)
    back.load(path2)
    back.n_probe, back.scan_mode, back.use_approx_topk = 8, "flat", False
    v2, i2 = back.search(jnp.asarray(q.T), k=5)
    np.testing.assert_array_equal(np.asarray(i2), np.asarray(i_ref))


# ---- manhattan ----

def test_manhattan_metric_matches(rng):
    """similarity / negative_manhattan_distance (chunked, chunk 16) against
    the JAX package and numpy (test_metric.py)."""
    a = rng.normal(size=(100, 16)).astype(np.float32)
    b = rng.normal(size=(40, 16)).astype(np.float32)
    want = -np.abs(a[:, None] - b[None]).sum(-1)
    for got in (tp.metric.similarity(torch.from_numpy(a),
                                     torch.from_numpy(b), "l1"),
                tp.metric.negative_manhattan_distance(
                    torch.from_numpy(a), torch.from_numpy(b), chunk=16)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jmetric.similarity(
                jnp.asarray(a), jnp.asarray(b), "manhattan")), rtol=1e-5,
            atol=1e-4)


def test_manhattan_max_sim_and_adc_table_match(rng):
    """max_sim / topk_sim / the batched forms and the ADC table by L1
    against the JAX package."""
    x = rng.normal(size=(300, 8)).astype(np.float32)
    c = rng.normal(size=(20, 8)).astype(np.float32)
    v, i = tms.max_sim(torch.from_numpy(x), torch.from_numpy(c), "manhattan")
    v_ref, i_ref = jms.max_sim(jnp.asarray(x), jnp.asarray(c), "manhattan")
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-5,
                               atol=1e-5)
    v, i = tms.topk_sim(torch.from_numpy(x), torch.from_numpy(c), 4, "l1")
    v_ref, i_ref = jms.topk_sim(jnp.asarray(x), jnp.asarray(c), 4, "l1")
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    xb = rng.normal(size=(3, 200, 4)).astype(np.float32)
    cb = rng.normal(size=(3, 16, 4)).astype(np.float32)
    for fn, extra in ((tms.batched_max_sim, ()), (tms.batched_topk_sim, (5,))):
        jfn = getattr(jms, fn.__name__)
        got = fn(torch.from_numpy(xb), torch.from_numpy(cb), *extra,
                 "manhattan")
        ref = jfn(jnp.asarray(xb), jnp.asarray(cb), *extra, "manhattan")
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                                   rtol=1e-5, atol=1e-5)
    q = rng.normal(size=(5, 32)).astype(np.float32)
    book = rng.normal(size=(8, 256, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tadc.build_adc_table(torch.from_numpy(q), torch.from_numpy(book),
                             "manhattan").numpy(),
        np.asarray(jadc.build_adc_table(jnp.asarray(q), jnp.asarray(book),
                                        "manhattan")), rtol=1e-5, atol=1e-5)


def test_manhattan_kmeans_matches(rng):
    """KMeans by L1 from the same initial centroids (the mean update, L1
    assignment): the JAX package's centroids (1e-5) and labels; k-means++
    seeding by L1 runs."""
    x = rng.normal(size=(16, 512)).astype(np.float32)
    init = x[:, :6].copy()
    ref = JaxKMeans(n_clusters=6, max_iter=10, distance="manhattan")
    lab_ref = ref.fit(jnp.asarray(x), centroids=jnp.asarray(init))
    port = tp.clustering.KMeans(n_clusters=6, max_iter=10,
                                distance="manhattan", device=CPU)
    lab = port.fit(x, centroids=init)
    np.testing.assert_array_equal(lab.numpy(), np.asarray(lab_ref))
    np.testing.assert_allclose(port.centroids.numpy(),
                               np.asarray(ref.centroids), rtol=1e-5,
                               atol=1e-5)
    pp = tp.clustering.KMeans(n_clusters=6, max_iter=3, distance="l1",
                              init_mode="kmeans++", device=CPU)
    assert tuple(pp.fit(x).shape) == (512,)


def test_manhattan_flat_scans_match(rng):
    """The L1 sweep (flat_adc_scan, f32 and bf16 rows) and the code-domain
    LUT sweep (flat_onehot_scan) against the JAX package's on the same
    inputs (test_flat_adc.py, test_code_domain.py)."""
    n, d, k = 700, 16, 9
    decoded = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(5, d)).astype(np.float32)
    empty = np.zeros(n, bool)
    empty[rng.integers(0, n, 60)] = True
    big = np.float32(np.finfo(np.float32).max / 4)
    pen = np.where(empty, big, 0.0).astype(np.float32)
    for dt in (np.float32, "bfloat16"):
        dec_j = jnp.asarray(decoded).astype(dt)
        v_ref, a_ref = jflat.flat_adc_scan(
            jnp.asarray(q), dec_j, jnp.asarray(pen), k=k,
            distance="manhattan", chunk=256, approx=False)
        v, a = tflat.flat_adc_scan(torch.from_numpy(q), to_t(dec_j),
                                   torch.from_numpy(pen), k=k,
                                   distance="manhattan", max_elems=2048)
        assert_topk_match(v_ref, a_ref, v, a, atol=1e-4, rtol=1e-5)
    codes = rng.integers(0, 256, size=(n, 4)).astype(np.uint8)
    book = rng.normal(size=(4, 256, 4)).astype(np.float32)
    v_ref, a_ref = jonehot.flat_onehot_scan(
        jnp.asarray(q), jnp.asarray(codes), jnp.asarray(pen),
        jnp.asarray(book), k=k, distance="manhattan", chunk=128,
        approx=False)
    v, a = tonehot.flat_onehot_scan(
        torch.from_numpy(q), torch.from_numpy(codes), torch.from_numpy(pen),
        torch.from_numpy(book), k=k, distance="manhattan", max_elems=4096)
    assert_topk_match(v_ref, a_ref, v, a, atol=1e-4, rtol=1e-5)
    with pytest.raises(AssertionError, match="flat_onehot_scan"):
        tonehot.flat_decode_scan(
            torch.from_numpy(q), torch.from_numpy(codes),
            torch.from_numpy(pen), torch.from_numpy(book), k=k,
            distance="manhattan")


def test_manhattan_code_scan_matches_decoded_scan(rng):
    """The code-domain cell-major scan by L1 (the LUT path: no kernel takes
    manhattan) against the decoded-cache scan by L1 and against the JAX
    package's code scan on the same probes (test_code_domain.py:37-62)."""
    jidx, port, _, _ = _case("manhattan_code")
    dec_j, dec_p = _case("manhattan")[:2]
    q = rng.normal(size=(16, D)).astype(np.float32)
    _, cells, mask = jcoarse(
        jnp.asarray(q), jidx.vq_codec.kmeans._centroids[0],
        jnp.float32(30.0), n_probe=4, use_smart=False, precision=None)
    tail = (port.aux("norm")[:, 0], port._is_empty, port._cell_start,
            port._cell_capacity)
    kw = dict(k=8, distance="manhattan", s_max=port.max_cell_capacity,
              n_cells=16, approx=False)
    m = port.code_size if port.pack_group > 1 else None
    v_c, a_c = tonehot.scan_cell_major_codes(
        torch.from_numpy(q), to_t(cells), to_t(mask), port._storage, *tail,
        port._scan_codebook, m=m, impl="auto", **kw)
    assert tadc.LAST_GATE["impl"] == "onehot"
    v_ref, a_ref = jonehot.scan_cell_major_codes(
        jnp.asarray(q), cells, mask, jidx._storage,
        jidx.aux("norm")[:, 0], jidx._is_empty, jidx._cell_start,
        jidx._cell_capacity, jidx._scan_codebook, m=m, **kw)
    assert_topk_match(v_ref, a_ref, v_c, a_c, atol=1e-4, rtol=1e-5)
    v_d, a_d = tadc.scan_cell_major(
        torch.from_numpy(q), to_t(cells), to_t(mask), dec_p.aux("decoded"),
        dec_p.aux("norm")[:, 0], dec_p._is_empty, dec_p._cell_start,
        dec_p._cell_capacity, impl="auto", **kw)
    assert tadc.LAST_GATE["impl"] == "block_select"
    assert overlap(a_c, a_d) >= 0.95
    scale = max(1.0, float(v_d[torch.isfinite(v_d)].abs().max()))
    assert float((v_c - v_d)[torch.isfinite(v_d)].abs().max()) \
        <= 3e-2 * scale


@pytest.mark.parametrize("name", ["manhattan", "manhattan_code"])
@pytest.mark.parametrize("mode,approx", [("cell_major", False),
                                         ("cell_major", True),
                                         ("flat", False),
                                         ("query_major", False)])
def test_manhattan_search_matches(name, mode, approx):
    """Every plan of a manhattan index (bf16 cache and code domain): the
    JAX package's values and ids (pack32 by overlap >= 0.99); no block or
    codes scan kernel route (each gate excludes manhattan); similarity by
    id equal too."""
    jidx, port, _, q = _case(name)
    v_ref, i_ref, v, i = _search_both(
        jidx, port, q, 10, n_probe=5, use_smart_probing=False,
        scan_mode=mode, use_approx_topk=approx)
    if mode != "flat":
        assert tadc.LAST_GATE["impl"] in ("block_select", "onehot")
    if approx:
        assert overlap(i, i_ref) >= 0.99
    else:
        assert_topk_match(v_ref, i_ref, v, i, atol=1e-4, rtol=1e-5)
    ids = np.array([0, 5, 77, -1, 5000])
    np.testing.assert_allclose(
        port.similarity_at_id(q.T, ids).numpy(),
        np.asarray(jidx.similarity_at_id(jnp.asarray(q.T),
                                         jnp.asarray(ids))),
        rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kw", [
    dict(distance="inner", anisotropic_eta=3.0, anisotropic_iters=4),
    dict(distance="manhattan"),
], ids=["anisotropic", "manhattan"])
def test_variant_remove_relayout_save_load(tmp_path, kw):
    """Anisotropic and manhattan indexes through a remove and adds that
    relayout the cells: the stores stay the JAX package's (anisotropic
    codes on >= 0.995: the cost's near-ties follow the summation order),
    and a save by either package loads into the other and finds the same
    neighbours (values within 1e-4, ids outside ties; anisotropic by id
    overlap >= 0.95 where codes differ)."""
    x = _clustered(31, 1400)
    jidx, port = _pair(x[:900], x, **kw)
    cap0 = port.max_cell_capacity
    rm = np.arange(0, 1400, 5)
    assert port.remove(rm) == jidx.remove(jnp.asarray(rm))
    more = _clustered(59, 1400)
    jidx.add(jnp.asarray(more.T))
    port.add(more.T)
    assert port.max_cell_capacity > cap0, "the adds must relayout"
    np.testing.assert_array_equal(port._address2id.numpy(),
                                  np.asarray(jidx._address2id))
    same = np.mean(port._storage.numpy() == np.asarray(jidx._storage))
    assert same >= (0.995 if "anisotropic_eta" in kw else 1.0), same
    q = _clustered(60, 16)

    def search(idx):
        idx.n_probe, idx.scan_mode, idx.use_approx_topk = \
            6, "cell_major", False
        on_port = isinstance(idx, tp.IVFPQIndex)
        return idx.search(q.T if on_port else jnp.asarray(q.T), k=10)

    ctor = dict(d_vector=D, n_subvectors=M, n_cells=16, **kw)
    for saved, fresh in ((jidx, tp.IVFPQIndex(**ctor, device=CPU)),
                         (port, JaxIndex(**ctor))):
        path = str(tmp_path / f"{type(saved).__module__}.npz")
        saved.save(path)
        fresh.load(path)
        assert_topk_match(*search(saved), *search(fresh), atol=1e-4,
                          rtol=1e-5)
    v_ref, i_ref, v, i = _search_both(jidx, port, q, 10, n_probe=6,
                                      scan_mode="cell_major",
                                      use_approx_topk=False)
    if "anisotropic_eta" in kw:
        assert overlap(i, i_ref) >= 0.95
    else:
        assert_topk_match(v_ref, i_ref, v, i, atol=1e-4, rtol=1e-5)
