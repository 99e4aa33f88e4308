"""Port parity of IVFPQRIndex, the IVFPQ index with a re-ranking PQ over
the first stage's residual: the cached tiers (bf16, int8: the cache
rows are the full two-stage reconstruction) and the code domain (the base
codes scan at k * rerank_multiplier, then the rescore of the shortlist),
under euclidean, inner, cosine and manhattan distance, with a 4-bit base
and with residual PQ. Each index is trained by the JAX package and carried
into the port; both then take the same adds (two halves, the second of
which relayouts the cells), searches, removes and saves. Toy sizes (d 32,
m 8, m_rerank 8, 16 cells, 1,400 rows); each test states its tolerance.

Mirrors tests/test_ivfpq.py::test_ivfpqr_reranks,
tests/test_pq4.py::test_pq4_ivfpqr_rerank and
tests/test_relayout_rebuild.py::test_expand_preserves_rerank_codes."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torchpq_tpu.index import IVFPQIndex as JaxBase
from torchpq_tpu.index import IVFPQRIndex as JaxIndex
from torchpq_tpu.index import ivfpqr as jr
import torchpq_tpu_torch as tp
from torchpq_tpu_torch.index import ivfpqr as tr

from _torch_helpers import CPU, assert_topk_match, overlap, seed_fits, to_np

D, M, MR, CELLS = 32, 8, 8, 16

CASES = {
    "bf16": {},
    "int8": dict(scan_cache_dtype="int8"),
    "manhattan": dict(distance="manhattan"),
    "residual": dict(pq_use_residual=True),
    "code": dict(scan_cache_dtype="none"),
    "code_inner": dict(scan_cache_dtype="none", distance="inner"),
    "code_cosine": dict(scan_cache_dtype="none", distance="cosine"),
    "code_manhattan": dict(scan_cache_dtype="none", distance="manhattan"),
    "pq4_code": dict(n_bits=4, scan_cache_dtype="none"),
}
_BUILT = {}


def _clustered(seed, n, d=D, n_centers=20, scale=3.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_centers, d)).astype(np.float32) * scale
    x = centers[rng.integers(0, n_centers, n)] \
        + rng.normal(size=(n, d)).astype(np.float32)
    return x.astype(np.float32)


def _ctor(**kw):
    return dict(d_vector=D, n_subvectors=M, n_subvectors_rerank=MR,
                n_cells=CELLS, initial_size=32, **kw)


def _jax_trained(x_train, **kw):
    jidx = JaxIndex(**_ctor(**kw))
    for codec in (jidx.vq_codec, jidx.pq_codec, jidx.rerank_codec):
        codec.kmeans.max_iter = 6
    jidx.train(jnp.asarray(x_train.T))
    return jidx


def _add_both(jidx, port, x):
    """The same add in both packages: equal addresses."""
    _, a_ref = jidx.add(jnp.asarray(x.T), return_address=True)
    _, a = port.add(x.T, return_address=True)
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))


# the case whose probed plans run the block scan's routes (the JAX
# package's Pallas kernel in interpret mode, the port's plain version of
# its CUDA kernel); the others run both packages' XLA select
# (scan_impl="xla", which keeps the pack32 keys), compiled in a fraction of
# the time. The kernels themselves are held in test_torch_block_scan*.py
# and test_torch_codes_scan.py
KERNEL_CASES = ("bf16",)


def _pair(kind):
    """(jidx, port, x, q) for a case, built once: JAX-trained, carried into
    the port, then two adds of 700 rows, the second of which relayouts."""
    if kind not in _BUILT:
        x = _clustered(31, 1400)
        jidx = _jax_trained(x[:900], **CASES[kind])
        port = tp.IVFPQRIndex(**_ctor(**CASES[kind]), device=CPU)
        port.load_state_dict(jidx.state_dict())
        if kind not in KERNEL_CASES:
            jidx.scan_impl = port.scan_impl = "xla"
        assert port.is_trained
        _add_both(jidx, port, x[:700])
        cap0 = port.max_cell_capacity
        _add_both(jidx, port, x[700:])
        assert port.max_cell_capacity > cap0, "the second add must relayout"
        _BUILT[kind] = (jidx, port, x, _clustered(32, 24))
    return _BUILT[kind]


def _search(idx, q, k, **settings):
    for name, value in settings.items():
        setattr(idx, name, value)
    on_port = isinstance(idx, tp.IVFPQIndex)
    return idx.search(q.T if on_port else jnp.asarray(q.T), k=k,
                      return_address=True)


def _held(ref, got, approx):
    """Exact plans: values within 1e-3 (rel 1e-5) position by position (the
    products of these rows reach |q| |y| ~ 400, and an f32 sum in another
    order moves a score by up to ~5e-4), ids and addresses equal outside
    ties. Pack32 plans: values within 1e-2 (rel 2e-3: a key keeps 31 -
    log2(s_eff) bits of its score) and ids by overlap >= 0.95: the select
    keeps each strided group's best slots, and rows of equal codes (common
    at 4 bits) tie across groups, so the tied slots that survive differ."""
    (v_ref, i_ref, a_ref), (v, i, a) = (tuple(map(to_np, r))
                                        for r in (ref, got))
    if approx:
        np.testing.assert_allclose(v, v_ref, rtol=2e-3, atol=1e-2)
        assert overlap(i, i_ref) >= 0.95 and overlap(a, a_ref) >= 0.95
    else:
        assert_topk_match(v_ref, i_ref, v, i, atol=1e-3, rtol=1e-5)
        assert_topk_match(v_ref, a_ref, v, a, atol=1e-3, rtol=1e-5)


def _held_search(jidx, port, q, k, **settings):
    """A search of both indexes held by _held. The code domain rescores the
    base scan's k * rerank_multiplier shortlist, whose last place may hold
    a tie (rows of equal codes, or pack32 keys of equal value) that each
    package breaks its own way and the rescore may lift into the top k.
    There the base scans are held first; the rescored rows where both
    shortlists hold the same addresses are held; and on every row the
    port's rescore of the JAX package's own shortlist is held to the JAX
    result."""
    approx = settings["use_approx_topk"] \
        and settings["scan_mode"] == "cell_major"
    ref, got = _search(jidx, q, k, **settings), _search(port, q, k, **settings)
    assert tuple(got[0].shape) == (q.shape[0], k)
    if not port._code_domain:
        return _held(ref, got, approx)
    kb = k * port.rerank_multiplier
    base_ref = JaxBase.search(jidx, jnp.asarray(q.T), k=kb,
                              return_address=True)
    base = tp.IVFPQIndex.search(port, q.T, k=kb, return_address=True)
    _held(base_ref, base, approx)
    same = np.array([set(r.tolist()) == set(g.tolist()) for r, g in
                     zip(to_np(base_ref[2]), to_np(base[2]))])
    _held(tuple(to_np(r)[same] for r in ref),
          tuple(to_np(g)[same] for g in got), approx)
    vals, addr = port._rescore(port._prep(q.T).T, torch.tensor(
        to_np(base_ref[0])), torch.tensor(to_np(base_ref[2])), k)
    ids = torch.where(addr >= 0, port.get_id_by_address(addr), -1)
    pad = k - vals.shape[1]
    _held(ref, (torch.nn.functional.pad(vals, (0, pad), value=-torch.inf),
                torch.nn.functional.pad(ids, (0, pad), value=-1),
                torch.nn.functional.pad(addr, (0, pad), value=-1)), approx)


def _copies(kind):
    """Fresh JAX and port indexes holding the state of a case's pair (the
    adds included), for tests that change them."""
    jidx, port, x, q = _pair(kind)
    jc = JaxIndex(**_ctor(**CASES[kind]))
    jc.load_state_dict(jidx.state_dict())
    pc = tp.IVFPQRIndex(**_ctor(**CASES[kind]), device=CPU)
    pc.load_state_dict(port.state_dict())
    jc.scan_impl, pc.scan_impl = jidx.scan_impl, port.scan_impl
    return jc, pc, x, q


@pytest.mark.parametrize("kind", sorted(CASES))
def test_ivfpqr_stores_match(kind):
    """After the adds and their relayout: the base and rerank codes equal
    the JAX index's (>= 0.999: a near-tie may round either way), the same
    ids at the same addresses, and the derived stores within tolerance:
    the cached tiers' rows (the full reconstruction; int8: the quantized
    rows and scales) and norms, the code domain's base norms and norm
    deltas, both rebuilt by the relayout."""
    jidx, port, _, _ = _pair(kind)
    np.testing.assert_array_equal(port._address2id.numpy(),
                                  np.asarray(jidx._address2id))
    assert np.mean(port._storage.numpy() == np.asarray(jidx._storage)) \
        >= 0.999
    assert np.mean(port.aux("rerank_codes").numpy()
                   == np.asarray(jidx.aux("rerank_codes"))) >= 0.999
    live = ~port._is_empty.numpy()
    stores = ["norm"] + (["dnorm2"] if port._code_domain else ["decoded"]) \
        + (["scale"] if port._int8_cache else [])
    for name in stores:
        got = to_np(port.aux(name))[live].astype(np.float32)
        ref = to_np(jidx.aux(name))[live].astype(np.float32)
        if name == "decoded" and port._int8_cache:
            assert np.mean(np.abs(got - ref) <= 1) >= 0.999, name
        else:
            close = np.isclose(got, ref, rtol=1e-2, atol=2e-2)
            assert close.mean() >= 0.999, name


@pytest.mark.parametrize("kind", sorted(CASES))
@pytest.mark.parametrize("mode,approx", [("cell_major", False),
                                         ("cell_major", True),
                                         ("flat", False)])
def test_ivfpqr_search_matches(kind, mode, approx):
    """Every plan of every case against the JAX index (k = 10, n_probe 5:
    the code domain rescores its k * 4 = 40 shortlist)."""
    jidx, port, _, q = _pair(kind)
    settings = dict(n_probe=5, use_smart_probing=False, scan_mode=mode,
                    use_approx_topk=approx)
    _held_search(jidx, port, q, 10, **settings)


@pytest.mark.parametrize("kind", ["bf16", "code_inner", "code_manhattan"])
@pytest.mark.parametrize("k", [5, 12])
def test_ivfpqr_shortlist_beyond_items(kind, k):
    """An index of 40 rows: k * rerank_multiplier below (20) and above (48)
    the rows held. Values and ids as the JAX index's; the code domain pads
    past its shortlist with -inf / -1, in both packages."""
    small_j, small, x, q = _copies(kind)
    small_j.empty()
    small.empty()
    _add_both(small_j, small, x[:40])
    _held_search(small_j, small, q, k, n_probe=CELLS, use_smart_probing=False,
                 scan_mode="cell_major", use_approx_topk=False)


def test_ivfpqr_relayout_rebuilds_refined_cache():
    """Twin of test_expand_preserves_rerank_codes. The bf16 pair's second
    add relayouted the cells that held the first add's rows: every live
    cache row equals bf16 of the full two-stage reconstruction read from
    the moved codes (a rebuild that ignored the rerank parts leaves the
    base reconstruction), the rerank codes moved with their rows
    (re-encoding the originals reproduces them), and the cache equals the
    JAX index's. Then a forced relayout (expand) of a copy keeps every
    id's cache row, and the same search."""
    jidx, port, x, q = _pair("bf16")
    live = torch.nonzero(~port._is_empty).flatten()
    base = port.pq_codec.decode_nd(port.storage_rows(live))
    full = base + port.rerank_codec.decode_nd(port.aux("rerank_codes")[live])
    cache = port.aux("decoded")[live]
    assert torch.equal(cache, full.to(torch.bfloat16))
    assert not torch.equal(cache, base.to(torch.bfloat16))
    torch.testing.assert_close(port.aux("norm")[live, 0],
                               (full * full).sum(-1), rtol=1e-5, atol=1e-4)
    ids = port.get_id_by_address(live).numpy()
    want = port.rerank_codec.encode_nd(torch.from_numpy(x[ids]) - base)
    assert np.mean((port.aux("rerank_codes")[live] == want).numpy()) \
        >= 0.999
    np.testing.assert_array_equal(port.aux("decoded").float().numpy(),
                                  to_np(jidx.aux("decoded")))
    _, copy, _, _ = _copies("bf16")
    copy.expand()
    assert copy.max_cell_capacity == 2 * port.max_cell_capacity
    by_id = torch.from_numpy(np.sort(ids))
    assert torch.equal(copy.aux("decoded")[copy.get_address_by_id(by_id)],
                       port.aux("decoded")[port.get_address_by_id(by_id)])
    settings = dict(n_probe=5, use_smart_probing=False,
                    scan_mode="cell_major", use_approx_topk=False)
    v, i = _search(port, q, 10, **settings)[:2]
    v_c, i_c = _search(copy, q, 10, **settings)[:2]
    assert torch.equal(v, v_c) and torch.equal(i, i_c)


def test_ivfpqr_code_domain_rebuilder():
    """The code domain marks ("norm", "dnorm2") as derived, replacing the
    parent's ("norm",): a relayout rebuilds the norm deltas, and they
    equal |base + rerank|^2 - |base|^2 recomputed from the moved codes."""
    _, port, _, _ = _pair("code")
    assert port._aux_rebuild_names == ("norm", "dnorm2")
    assert "dnorm2" in port._aux and "decoded" not in port._aux
    rebuilt = port._rebuild_scan_cache()
    assert set(rebuilt) == {"norm", "dnorm2"}
    live = torch.nonzero(~port._is_empty).flatten()
    base = port._decode_stored(port.storage_rows(live))
    full = base + port.rerank_codec.decode_nd(port.aux("rerank_codes")[live])
    for name, want in (("norm", (base * base).sum(-1)),
                       ("dnorm2", (full * full).sum(-1)
                        - (base * base).sum(-1))):
        torch.testing.assert_close(rebuilt[name][live, 0], want, rtol=1e-5,
                                   atol=1e-4)
        torch.testing.assert_close(port.aux(name)[live, 0], want, rtol=1e-5,
                                   atol=1e-4)


@pytest.mark.parametrize("kind", ["bf16", "code"])
def test_ivfpqr_remove_matches(kind):
    """A remove of every 7th id from copies of a case's pair in both
    packages, then the exact probed and flat plans: values and ids as the
    JAX index's, removed ids never returned."""
    jidx, port, x, q = _copies(kind)
    rm = np.arange(0, 1400, 7)
    assert port.remove(rm) == jidx.remove(jnp.asarray(rm)) == rm.size
    for mode in ("cell_major", "flat"):
        settings = dict(n_probe=5, use_smart_probing=False, scan_mode=mode,
                        use_approx_topk=False)
        _held_search(jidx, port, q, 10, **settings)
        assert not np.isin(port.search(q.T, k=10)[1].numpy(), rm).any()


@pytest.mark.parametrize("kind", ["int8", "code_cosine", "pq4_code"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ivfpqr_npz_carries_across(tmp_path, kind, writer):
    """An index saved by one package (rerank_codec, rerank_codes and, in
    the code domain, dnorm2 included) loads into the other and searches
    alike (values 1e-4, ids outside ties); the rerank stores equal."""
    jidx, port, _, q = _pair(kind)
    path = str(tmp_path / f"{kind}.npz")
    if writer == "jax":
        jidx.save(path)
        fresh, src = tp.IVFPQRIndex(**_ctor(**CASES[kind]), device=CPU), jidx
    else:
        port.save(path)
        fresh, src = JaxIndex(**_ctor(**CASES[kind])), port
    fresh.load(path)
    fresh.scan_impl = src.scan_impl
    assert fresh.is_trained and fresh.n_items == src.n_items
    names = ["rerank_codes"] + (["dnorm2"] if port._code_domain else [])
    for name in names:
        np.testing.assert_array_equal(to_np(fresh.aux(name)),
                                      to_np(src.aux(name)), err_msg=name)
    np.testing.assert_array_equal(
        to_np(fresh.rerank_codec.codebook_internal),
        to_np(src.rerank_codec.codebook_internal))
    settings = dict(n_probe=5, use_smart_probing=False,
                    scan_mode="cell_major", use_approx_topk=False)
    on_jax, on_port = (src, fresh) if writer == "jax" else (fresh, src)
    _held_search(on_jax, on_port, q, 10, **settings)


@pytest.mark.parametrize("kind", ["bf16", "code_cosine", "residual"])
def test_ivfpqr_train_from_equal_init_matches(kind):
    """train in both packages, every fit from equal initial centroids: the
    coarse centroids (relabelled by the locality order) within 1e-3, the
    PQ and rerank codebooks within 1e-2, and the codes of the train rows
    equal on >= 0.98 (labels flip on near-ties as the f32 sums drift)."""
    x = _clustered(33, 900)
    jidx = JaxIndex(**_ctor(**CASES[kind]))
    port = tp.IVFPQRIndex(**_ctor(**CASES[kind]), device=CPU)
    for idx in (jidx, port):
        seed_fits(idx)
    jidx.train(jnp.asarray(x.T))
    port.train(x.T)
    assert port.is_trained
    for codec, atol in (("vq_codec", 1e-3), ("pq_codec", 1e-2),
                        ("rerank_codec", 1e-2)):
        np.testing.assert_allclose(
            to_np(getattr(port, codec).kmeans._centroids),
            np.asarray(getattr(jidx, codec).kmeans._centroids), atol=atol,
            err_msg=codec)
    xs = port._prep(x.T)
    first = port.encode(xs)
    resid = (xs - port.decode(first)).T
    codes = port.rerank_codec.encode_nd(resid).numpy()
    ref = np.asarray(jidx.rerank_codec.encode_nd(jnp.asarray(resid.numpy())))
    assert np.mean(codes == ref) >= 0.98


def test_rerank_correct_matches(rng):
    """The shortlist correction alone, on shared random inputs (shortlist
    entries -1, -inf values and emptied slots among them), euclidean and
    inner: values within 1e-4, addresses outside ties."""
    nq, kp, cap, d, mr = 9, 24, 200, D, MR
    q = rng.normal(size=(nq, d)).astype(np.float32)
    vals_b = rng.normal(size=(nq, kp)).astype(np.float32) * 10
    cand = rng.integers(0, cap, size=(nq, kp)).astype(np.int32)
    cand[:, -3:] = -1
    vals_b[:, -5:-3] = -np.inf
    rcodes = rng.integers(0, 256, size=(cap, mr)).astype(np.uint8)
    dn = rng.normal(size=(cap,)).astype(np.float32)
    cb = rng.normal(size=(mr, 256, d // mr)).astype(np.float32)
    empty = rng.random(cap) < 0.1
    for distance in ("euclidean", "inner"):
        v_ref, a_ref = jr._rerank_correct(
            jnp.asarray(q), jnp.asarray(vals_b), jnp.asarray(cand),
            jnp.asarray(rcodes), jnp.asarray(dn), jnp.asarray(cb),
            jnp.asarray(empty), k=10, distance=distance, mr=mr,
            dsubr=d // mr)
        v, a = tr._rerank_correct(
            *(torch.from_numpy(t) for t in (q, vals_b, cand, rcodes, dn, cb,
                                            empty)), k=10, distance=distance)
        assert_topk_match(v_ref, a_ref, v, a, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("pack_g", [1, 4])
@pytest.mark.parametrize("residual", [False, True])
def test_rerank_from_codes_matches(rng, pack_g, residual):
    """The manhattan rescore alone, on shared random inputs: the packed
    [cap / g, g * m] storage the JAX function reads is the port's [cap, m]
    view of the same bytes; with residual each row adds its cell's
    centroid. Values within 1e-4, addresses outside ties."""
    nq, kp, cap, d, m, cells = 7, 20, 256, D, M, 8
    q = rng.normal(size=(nq, d)).astype(np.float32)
    cand = rng.integers(0, cap, size=(nq, kp)).astype(np.int32)
    cand[:, -2:] = -1
    codes = rng.integers(0, 256, size=(cap, m)).astype(np.uint8)
    rcodes = rng.integers(0, 256, size=(cap, MR)).astype(np.uint8)
    starts = (np.arange(cells) * (cap // cells)).astype(np.int32)
    pcb = rng.normal(size=(m, 256, d // m)).astype(np.float32)
    rcb = rng.normal(size=(MR, 256, d // MR)).astype(np.float32) * 0.3
    vq = rng.normal(size=(cells, d)).astype(np.float32)
    empty = rng.random(cap) < 0.1
    v_ref, a_ref = jr._rerank_from_codes(
        jnp.asarray(q), jnp.asarray(cand),
        jnp.asarray(codes.reshape(cap // pack_g, pack_g * m)),
        jnp.asarray(rcodes), jnp.asarray(starts), jnp.asarray(pcb),
        jnp.asarray(rcb), jnp.asarray(vq) if residual else None,
        jnp.asarray(empty), k=8, distance="manhattan", residual=residual,
        m=m, dsub=d // m, mr=MR, dsubr=d // MR, pack_g=pack_g)
    v, a = tr._rerank_from_codes(
        torch.from_numpy(q), torch.from_numpy(cand), torch.from_numpy(codes),
        torch.from_numpy(rcodes), torch.from_numpy(starts),
        torch.from_numpy(pcb), torch.from_numpy(rcb),
        torch.from_numpy(vq) if residual else None,
        torch.from_numpy(empty), k=8)
    assert_topk_match(v_ref, a_ref, v, a, atol=1e-4, rtol=1e-5)


def test_ivfpqr_reranks():
    """The port's own training (its seeded draws, not the JAX package's):
    the refined index finds a perturbed row's source at least as often as
    the base IVFPQ index of the same base codecs, and above 0.8 (the twin
    of test_ivfpq.py::test_ivfpqr_reranks)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1500, D)).astype(np.float32)
    q = x[:100] + 0.01 * rng.normal(size=(100, D)).astype(np.float32)
    kw = dict(d_vector=D, n_subvectors=4, n_cells=8,
              scan_cache_dtype="float32", initial_size=64)
    r = tp.IVFPQRIndex(**kw, n_subvectors_rerank=16, device=CPU)
    for codec in (r.vq_codec, r.pq_codec, r.rerank_codec):
        codec.kmeans.max_iter = 8
    r.train(x.T)
    b = tp.IVFPQIndex(**kw, device=CPU)
    b.load_state_dict({k: v for k, v in r.state_dict().items()
                       if k.startswith(("vq_codec.", "pq_codec."))})
    hits = {}
    for name, idx in (("rerank", r), ("base", b)):
        ids = idx.add(x.T).numpy()
        idx.n_probe, idx.use_smart_probing = 8, False
        _, got = idx.search(q.T, k=1)
        hits[name] = float((got[:, 0].numpy() == ids[:100]).mean())
    assert hits["rerank"] >= hits["base"] and hits["rerank"] > 0.8, hits


def test_pq4_ivfpqr_lifts_recall():
    """Over a 4-bit base from carried state, the code-domain rerank
    decodes the packed base bytes and lifts recall@10 by >= 0.1 over the
    base-only search of the same codes (the twin of
    test_pq4.py::test_pq4_ivfpqr_rerank)."""
    jidx, port, x, _ = _pair("pq4_code")
    rng = np.random.default_rng(7)
    q = x[rng.choice(x.shape[0], 24, replace=False)] \
        + 0.05 * rng.normal(size=(24, D)).astype(np.float32)
    gt = np.argsort(((q[:, None] - x[None]) ** 2).sum(-1), axis=1)[:, :10]
    base = tp.IVFPQIndex(d_vector=D, n_subvectors=M, n_cells=CELLS, n_bits=4,
                         scan_cache_dtype="none", device=CPU)
    base.load_state_dict({k: v for k, v in port.state_dict().items()
                          if k.startswith(("vq_codec.", "pq_codec."))})
    base.add(x.T)
    recalls = {}
    for name, idx in (("base", base), ("rerank", port)):
        idx.n_probe, idx.scan_mode, idx.use_approx_topk = \
            CELLS, "cell_major", False
        _, got = idx.search(q.T, k=10)
        got = got.numpy()
        recalls[name] = np.mean([np.isin(gt[i], got[i]).mean()
                                 for i in range(24)])
    assert recalls["rerank"] >= recalls["base"] + 0.1, recalls
