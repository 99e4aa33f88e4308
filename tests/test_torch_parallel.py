"""Parity of the port's multi-rank surface (torchpq_tpu_torch.parallel, on
torch.distributed) with the JAX package's (torchpq_tpu.parallel, over the
virtual 8-device CPU mesh), mirroring tests/test_sharded.py case by case.

The port runs as 4 gloo ranks, each a process of tests/_torch_dist_worker.py
(torch and the port only), started once for every case: the JAX package
trains and fills each index here and saves it as .npz, which every rank
loads, so both packages start from the same state; the JAX side runs on
get_mesh(4). Each rank writes its outputs, and every test also checks that
the ranks agree (the result is replicated). Tolerances: values within 1e-3
(rtol and atol) of the JAX package's sharded search, ids agreeing on >= 0.95
of entries; k-means within 1e-4."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import jax.numpy as jnp
import pytest

from torchpq_tpu.index import IVFPQIndex as JaxIndex
from torchpq_tpu.parallel import ShardedIVFPQSearcher as JaxSearcher
from torchpq_tpu.parallel import get_mesh as jax_mesh
from torchpq_tpu.parallel.sharded_ivfpq import (
    data_parallel_kmeans_fit as jax_fit,
    data_parallel_lloyd_step as jax_lloyd,
    data_parallel_search as jax_dp_search)

WORLD = 4
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_dist_worker.py")
JOIN_TIMEOUT_S = 240
TOL = dict(rtol=1e-3, atol=1e-3)
KW = dict(d_vector=32, n_subvectors=8, n_cells=16)


def _filled(seed, n, cache="float32", initial_size=32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 32)).astype(np.float32)
    kw = dict(KW, scan_cache_dtype=cache, initial_size=initial_size)
    index = JaxIndex(**kw)
    index.train(jnp.asarray(x.T))
    ids = np.asarray(index.add(jnp.asarray(x.T)))
    return index, kw, x, ids


def _agree(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return int((a == b).sum()) / a.size


def _setup(tmp):
    """Every case's JAX-side objects and inputs; writes cases.json and the
    .npz files the ranks read."""
    rng = np.random.default_rng(5)
    cases, jax_side = [], {}

    def save_index(name, index, kw, settings):
        path = f"{name}.npz"
        index.save(os.path.join(tmp, path))
        return dict(file=path, kw=kw, settings=settings)

    def save_inputs(name, **arrays):
        np.savez(os.path.join(tmp, f"in.{name}.npz"), **arrays)
        return f"in.{name}.npz"

    probe = dict(n_probe=8, use_smart_probing=False, scan_mode="cell_major")
    a, a_kw, a_x, a_ids = _filled(0, 1600)
    b, b_kw, b_x, b_ids = _filled(1, 800)
    spec_a = save_index("a", a, a_kw, probe)
    spec_b = save_index("b", b, b_kw, probe)
    jax_side.update(a=(a, a_x, a_ids), b=(b, b_x, b_ids))

    def add(name, index_spec, k, q, searcher=None, steps=(), mesh=None,
            **arrays):
        c = dict(name=name, kind="search", index=index_spec, k=k,
                 queries=save_inputs(name, q=q, **arrays),
                 searcher=searcher or {}, steps=list(steps))
        if mesh:
            c["mesh"] = mesh
        cases.append(c)

    add("cell_major", spec_a, 5, a_x[:40])
    add("query_major", dict(spec_b, settings=dict(
        probe, n_probe=4, scan_mode="query_major")), 3, b_x[:10],
        searcher=dict(scan_mode="query_major"))
    y = rng.normal(size=(200, 32)).astype(np.float32)
    jax_side["y"] = y
    add("add_search", spec_b, 3, y, steps=[
        dict(op="add", x="y"), dict(op="search", x="q", k=3),
        dict(op="search", x="x0", k=3)], y=y, x0=b_x[:50])
    add("group", dict(spec_b, settings=dict(probe, n_probe=4)), 3, b_x[:50],
        searcher=dict(scan_group=2))
    add("flat", dict(spec_a, settings=dict(scan_mode="flat")), 5, a_x[:32],
        searcher=dict(scan_mode="flat"))
    add("partial_mesh", spec_b, 3, b_x[:20], mesh=2)
    add("empty_add", spec_b, 1, b_x[:4], steps=[dict(op="add", x="z")],
        z=np.zeros((0, 32), np.float32))

    # removal holes mid-cell before the searcher is built
    holes = JaxIndex(**b_kw)
    holes.load(os.path.join(tmp, spec_b["file"]))
    holes.remove(ids=jnp.asarray(b_ids[100:200]))
    x_new = rng.normal(size=(50, 32)).astype(np.float32)
    q_h = np.concatenate([b_x[:50], b_x[250:300], x_new])
    jax_side["holes"] = (holes, x_new, q_h)
    add("holes", save_index("holes", holes, b_kw, probe), 1, q_h, steps=[
        dict(op="add", x="x_new"), dict(op="set", on="index",
                                        name="n_probe", value=16),
        dict(op="search", x="q", k=1)], x_new=x_new)

    add("remove", spec_b, 1, b_x[:200], steps=[
        dict(op="remove", ids="rm"), dict(op="remove", ids="rm"),
        dict(op="set", on="index", name="n_probe", value=16),
        dict(op="search", x="q", k=1),
        dict(op="set", on="searcher", name="scan_mode", value="flat"),
        dict(op="search", x="q100", k=1)], rm=b_ids[:100], q100=b_x[:100])

    for tier in ("int8", "none"):
        idx, kw, x, ids = _filled(2 if tier == "int8" else 3, 1200,
                                  cache=tier, initial_size=128)
        settings = dict(probe, scan_impl="xla") if tier == "none" else probe
        if tier == "none":
            idx.scan_impl = "xla"
        x_new = rng.normal(size=(40, 32)).astype(np.float32)
        jax_side[tier] = (idx, x, ids, x_new)
        add(tier, save_index(tier, idx, kw, settings), 5, x[:32], steps=[
            dict(op="add", x="x_new"), dict(op="search", x="x_new", k=1),
            dict(op="set", on="searcher", name="scan_mode", value="flat"),
            dict(op="search", x="x_new", k=1)], x_new=x_new)

    d, k, n = 16, 8, 1024
    data = rng.normal(size=(n, d)).astype(np.float32)
    jax_side["lloyd"] = data
    cases.append(dict(name="lloyd", kind="lloyd", data=save_inputs(
        "lloyd", data_sh=data.reshape(WORLD, n // WORLD, d),
        cents=data[:k].copy())))
    x_fit = rng.normal(size=(1001, 16)).astype(np.float32)  # n % 4 != 0
    jax_side["fit"] = x_fit
    cases.append(dict(name="fit", kind="fit", k=8,
                      data=save_inputs("fit", x=x_fit),
                      kw=dict(max_iter=10, tol=0.0, seed=3)))
    cases.append(dict(name="dp_search", kind="dp_search", index=spec_b, k=5,
                      queries=save_inputs("dp_search", q=b_x[:41])))
    cases.append(dict(name="mesh", kind="mesh"))
    with open(os.path.join(tmp, "cases.json"), "w") as f:
        json.dump(cases, f)
    return jax_side


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Set up every case, run the 4 ranks once (each join under a timeout),
    and return (outputs by case and rank, the JAX-side objects)."""
    tmp = str(tmp_path_factory.mktemp("dist"))
    jax_side = _setup(tmp)
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(WORLD), tmp], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"

    def outputs(name):
        out = []
        for r in range(WORLD):
            path = os.path.join(tmp, f"out.{name}.r{r}.npz")
            if os.path.exists(path):
                with np.load(path) as f:
                    out.append({k: f[k] for k in f.files})
        return out
    return outputs, jax_side


def _replicated(outs):
    """Every rank's outputs are equal; returns rank 0's."""
    for o in outs[1:]:
        assert o.keys() == outs[0].keys()
        for k in o:
            np.testing.assert_array_equal(o[k], outs[0][k], err_msg=k)
    return outs[0]


def _close(v, i, v_ref, i_ref, min_agree=0.95):
    np.testing.assert_allclose(v, np.asarray(v_ref), **TOL)
    assert _agree(i, i_ref) >= min_agree, _agree(i, i_ref)


def _searcher(index, **kw):
    return JaxSearcher(index, mesh=jax_mesh(WORLD), **kw)


def test_mesh(run):
    outputs, _ = run
    o = _replicated(outputs("mesh"))
    assert len(outputs("mesh")) == WORLD
    assert int(o["device_count"]) == WORLD and int(o["size"]) == WORLD
    assert o["names"].tolist() == ["shard"]
    assert o["ranks"].tolist() == list(range(WORLD))


def test_sharded_search_matches(run):
    outputs, js = run
    o = _replicated(outputs("cell_major"))
    a, x, _ = js["a"]
    a.n_probe, a.use_smart_probing, a.scan_mode = 8, False, "cell_major"
    v, i = _searcher(a).search(jnp.asarray(x[:40].T), k=5)
    _close(o["v"], o["i"], v, i)
    # and the port's own single-device search (JAX: the same check)
    _close(o["v"], o["i"], o["single_v"], o["single_i"])
    assert int(o["n_shards"]) == WORLD


def test_sharded_search_query_major(run):
    outputs, js = run
    o = _replicated(outputs("query_major"))
    b, x, _ = js["b"]
    b.n_probe, b.use_smart_probing, b.scan_mode = 4, False, "query_major"
    v, i = _searcher(b, scan_mode="query_major").search(
        jnp.asarray(x[:10].T), k=3)
    _close(o["v"], o["i"], v, i)
    np.testing.assert_allclose(o["v"], o["single_v"], **TOL)


def test_lloyd_step(run):
    outputs, js = run
    o = _replicated(outputs("lloyd"))
    data = js["lloyd"]
    k = 8
    cents = data[:k].copy()
    ref = np.asarray(jax_lloyd(
        jax_mesh(WORLD), jnp.asarray(data.reshape(WORLD, -1, 16)),
        jnp.asarray(cents), "euclidean"))
    np.testing.assert_allclose(o["cents"], ref, rtol=1e-4, atol=1e-4)
    s = -((data[:, None] - cents[None]) ** 2).sum(-1)
    labels = s.argmax(1)
    want = np.stack([data[labels == j].mean(0) if (labels == j).any()
                     else cents[j] for j in range(k)])
    np.testing.assert_allclose(o["cents"], want, rtol=1e-4, atol=1e-4)


def test_sharded_add_then_search(run):
    outputs, js = run
    o = _replicated(outputs("add_search"))
    b, x, ids = js["b"]
    b.n_probe, b.use_smart_probing, b.scan_mode = 8, False, "cell_major"
    s = _searcher(b)
    new_ids = np.asarray(s.add(jnp.asarray(js["y"].T)))
    np.testing.assert_array_equal(o["0_ids"], new_ids)
    assert len(np.unique(o["0_ids"])) == 200
    v, got = s.search(jnp.asarray(js["y"].T), k=3)
    _close(o["1_v"], o["1_i"], v, got)
    assert (o["1_i"] == o["0_ids"][:, None]).any(1).mean() > 0.9
    v0, got0 = s.search(jnp.asarray(x[:50].T), k=3)
    _close(o["2_v"], o["2_i"], v0, got0)
    assert (o["2_i"] == ids[:50, None]).any(1).mean() > 0.9


def test_sharded_search_with_group(run):
    outputs, js = run
    o = _replicated(outputs("group"))
    b, x, ids = js["b"]
    b.n_probe, b.use_smart_probing, b.scan_mode = 4, False, "cell_major"
    v, got = _searcher(b, scan_group=2).search(jnp.asarray(x[:50].T), k=3)
    _close(o["v"], o["i"], v, got)
    assert (o["i"] == ids[:50, None]).any(1).mean() > 0.9


def test_sharded_flat_mode(run):
    outputs, js = run
    o = _replicated(outputs("flat"))
    a, x, _ = js["a"]
    v, i = _searcher(a, scan_mode="flat").search(jnp.asarray(x[:32].T), k=5)
    _close(o["v"], o["i"], v, i)
    # the single-device flat plan (JAX: agreement > 0.9)
    np.testing.assert_allclose(o["v"], o["single_v"], **TOL)
    assert _agree(o["i"], o["single_i"]) > 0.9


def test_sharded_add_after_removal_holes(run):
    outputs, js = run
    o = _replicated(outputs("holes"))
    holes, x_new, q = js["holes"]
    _, _, b_ids = js["b"]
    holes.n_probe, holes.use_smart_probing = 8, False
    holes.scan_mode = "cell_major"
    s = _searcher(holes)
    new_ids = np.asarray(s.add(jnp.asarray(x_new.T)))
    np.testing.assert_array_equal(o["0_ids"], new_ids)
    assert not set(new_ids.tolist()) & set(b_ids.tolist())
    holes.n_probe = 16
    v, got = s.search(jnp.asarray(q.T), k=1)
    _close(o["2_v"], o["2_i"], v, got)
    want = np.concatenate([b_ids[:50], b_ids[250:300], new_ids])
    assert (o["2_i"][:, 0] == want).mean() > 0.95


def test_sharded_add_empty_batch(run):
    outputs, _ = run
    o = _replicated(outputs("empty_add"))
    assert o["0_ids"].shape == (0,)


@pytest.mark.parametrize("tier", ["int8", "none"])
def test_sharded_tier_matches(run, tier):
    """int8 caches shard with their scales, the code domain its codes; the
    search, a sharded add and the flat mode against the JAX package's."""
    outputs, js = run
    o = _replicated(outputs(tier))
    idx, x, ids, x_new = js[tier]
    idx.n_probe, idx.use_smart_probing = 8, False
    idx.scan_mode = "cell_major"
    s = _searcher(idx)
    assert str(o["decoded_dtype"]) == ("torch.int8" if tier == "int8"
                                       else "torch.uint8")
    v, i = s.search(jnp.asarray(x[:32].T), k=5)
    _close(o["v"], o["i"], v, i)
    new_ids = np.asarray(s.add(jnp.asarray(x_new.T)))
    np.testing.assert_array_equal(o["0_ids"], new_ids)
    v, got = s.search(jnp.asarray(x_new.T), k=1)
    _close(o["1_v"], o["1_i"], v, got)
    assert (o["1_i"][:, 0] == new_ids).mean() > 0.9
    s.scan_mode = "flat"
    v, got = s.search(jnp.asarray(x_new.T), k=1)
    _close(o["3_v"], o["3_i"], v, got)
    assert (o["3_i"][:, 0] == new_ids).mean() > 0.9


def test_sharded_remove(run):
    outputs, js = run
    o = _replicated(outputs("remove"))
    b, x, ids = js["b"]
    b.n_probe, b.use_smart_probing, b.scan_mode = 8, False, "cell_major"
    s = _searcher(b)
    assert int(o["0_removed"]) == s.remove(ids[:100]) == 100
    assert int(o["1_removed"]) == s.remove(ids[:100]) == 0
    b.n_probe = 16
    v, got = s.search(jnp.asarray(x[:200].T), k=1)
    _close(o["3_v"], o["3_i"], v, got)
    got = o["3_i"][:, 0]
    assert not set(got[:100].tolist()) & set(ids[:100].tolist())
    assert (got[100:200] == ids[100:200]).mean() > 0.95
    s.scan_mode = "flat"
    v, got_f = s.search(jnp.asarray(x[:100].T), k=1)
    _close(o["5_v"], o["5_i"], v, got_f)
    assert not set(o["5_i"][:, 0].tolist()) & set(ids[:100].tolist())


def test_data_parallel_kmeans_fit(run):
    outputs, js = run
    o = _replicated(outputs("fit"))
    cents, iters = jax_fit(js["fit"], 8, mesh=jax_mesh(WORLD), max_iter=10,
                           tol=0.0, seed=3)
    assert int(o["iters"]) == iters == 10
    assert o["cents"].shape == (8, 16)
    np.testing.assert_allclose(o["cents"], np.asarray(cents), rtol=1e-4,
                               atol=1e-4)


def test_sharded_on_partial_mesh(run):
    """A 2-rank mesh in a world of 4: ranks 2 and 3 take no part."""
    outputs, js = run
    outs = outputs("partial_mesh")
    assert len(outs) == 2
    o = _replicated(outs)
    assert int(o["n_shards"]) == 2
    b, x, _ = js["b"]
    b.n_probe, b.use_smart_probing, b.scan_mode = 8, False, "cell_major"
    v, i = JaxSearcher(b, mesh=jax_mesh(2)).search(jnp.asarray(x[:20].T),
                                                    k=3)
    _close(o["v"], o["i"], v, i)
    np.testing.assert_allclose(o["v"], o["single_v"], **TOL)


def test_data_parallel_search(run):
    """41 queries (not a multiple of the mesh), against the JAX package's
    and the port's own single-device search; the index is left untouched
    (its state tensors the same objects with the same values, its derived
    caches kept)."""
    outputs, js = run
    o = _replicated(outputs("dp_search"))
    b, x, _ = js["b"]
    b.n_probe, b.use_smart_probing, b.scan_mode = 8, False, "cell_major"
    v, i = jax_dp_search(b, jnp.asarray(x[:41].T), k=5, mesh=jax_mesh(WORLD))
    assert o["v"].shape == (41, 5)
    _close(o["v"], o["i"], v, i)
    np.testing.assert_array_equal(o["i"], o["single_i"])
    np.testing.assert_array_equal(o["v"], o["single_v"])
    assert bool(o["untouched"])


def test_route_slots_vectorized_many_cells():
    """Slot routing is O(arrays), not O(distinct cells) Python iterations:
    65k cells / 200k items in well under a second, with arrival-order slots
    per cell and occupancy carried across calls (no process group needed:
    the routing is host arithmetic)."""
    from torchpq_tpu_torch.parallel.sharded_ivfpq import ShardedIVFPQSearcher

    n_shards, n_cells = 8, 65536
    lc = n_cells // n_shards
    sr = object.__new__(ShardedIVFPQSearcher)
    sr.n_shards = n_shards
    sr._next_free = np.zeros((n_shards, lc), np.int64)
    sr._lcap_np = np.full((n_shards, lc), 64, np.int64)
    sr._lstart_np = (np.arange(lc, dtype=np.int64) * 64)[None, :].repeat(
        n_shards, axis=0)

    def no_growth(need):
        raise AssertionError("no growth expected")
    sr._grow_local = no_growth

    cells = np.random.default_rng(11).integers(
        0, n_cells, size=200_000).astype(np.int64)
    t0 = time.perf_counter()
    shard_of, slots = sr._route_slots(cells)
    assert time.perf_counter() - t0 < 5.0
    ref = object.__new__(JaxSearcher)
    for name in ("n_shards", "_lstart_np", "_lcap_np"):
        setattr(ref, name, getattr(sr, name))
    ref._next_free = np.zeros((n_shards, lc), np.int64)
    ref._grow_local = no_growth
    ref_shard, ref_slots = ref._route_slots(cells)
    np.testing.assert_array_equal(shard_of, ref_shard)
    np.testing.assert_array_equal(slots, ref_slots)
    for c in [int(cells[0]), 7, 65535]:
        at = np.flatnonzero(cells == c)
        start = sr._lstart_np[c % n_shards, c // n_shards]
        np.testing.assert_array_equal(slots[at], start + np.arange(len(at)))
    cnt7 = int((cells == 7).sum())
    assert sr._next_free[7 % n_shards, 7 // n_shards] == cnt7
    _, slots2 = sr._route_slots(np.array([7], np.int64))
    assert slots2[0] == sr._lstart_np[7 % n_shards, 7 // n_shards] + cnt7


def test_mesh_needs_a_process_group():
    """Without an initialized default process group (this test process
    has none) the mesh helpers raise, naming the call that is missing."""
    import torch.distributed as dist
    from torchpq_tpu_torch import parallel
    assert not dist.is_initialized()
    for fn in (parallel.get_mesh, parallel.device_count):
        with pytest.raises(RuntimeError, match="init_process_group"):
            fn()


def test_dp_kmeans_device_follows_the_data_not_the_backend():
    """The data-parallel k-means computes where the caller's data lies, or
    where `device` says: a gloo mesh carries CUDA tensors too, so the
    collective backend never sends the work to the host. Numpy data with
    no `device` goes to the card, like every entry point of the port."""
    import torch
    from torchpq_tpu_torch.parallel.sharded_ivfpq import _compute_device
    cpu_t = torch.zeros(2)
    assert _compute_device(None, cpu_t) == torch.device("cpu")
    assert _compute_device(None, np.zeros(2), cpu_t) == torch.device("cpu")
    assert _compute_device("cpu", np.zeros(2)) == torch.device("cpu")
    assert _compute_device("cuda", cpu_t) == torch.device("cuda")
    assert _compute_device(None, np.zeros(2)) == torch.device("cuda")
