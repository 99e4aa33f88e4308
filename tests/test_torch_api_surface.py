"""Public API surface lock of the port, the twin of tests/test_api_surface.py
restricted to the modules the port has, and the parity of the surface's
smaller members with the JAX package on the same inputs (numpy draws from a
seed): codec exposure, similarity by id, the inert tunables and their
validation, KMeans / MultiKMeans predict and top-k, the PQ ADC table and
the batched top-k; the centroids setter and the static helpers of the
k-means classes, the cell container's address helpers, state_nbytes and
the save formats; and the JAX package's keyword arguments and defaults on
the port's public signatures."""

import importlib
import inspect

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torchpq_tpu.clustering import KMeans as JaxKMeans
from torchpq_tpu.clustering import MultiKMeans as JaxMultiKMeans
from torchpq_tpu.codec import PQCodec as JaxPQ
from torchpq_tpu.container import CellContainer as JaxCells
from torchpq_tpu.index import IVFPQIndex as JaxIndex
from torchpq_tpu.ops import max_sim as jms
import torchpq_tpu_torch as tp
from torchpq_tpu_torch.ops import max_sim as tms

from _torch_helpers import CPU, to_np

SURFACE = {
    "torchpq_tpu_torch": [
        "topk", "Topk", "CustomModule", "StateModule", "metric", "util",
        "config", "fn", "ops", "clustering", "codec", "container", "index",
        "transform", "parallel", "legacy", "native", "profiling",
    ],
    "torchpq_tpu_torch.parallel": [
        "get_mesh", "device_count", "ShardedIVFPQSearcher",
        "data_parallel_lloyd_step", "data_parallel_kmeans_fit",
        "data_parallel_search",
    ],
    "torchpq_tpu_torch.legacy": [
        "IVFPQ", "IVFPQR", "PQ", "SQ", "IVFPQTopk", "KMeansOld",
        "MultiKMeansOld",
    ],
    "torchpq_tpu_torch.native": [
        "read_fvecs", "read_bvecs", "read_ivecs", "stream_vecs",
        "spill_assign",
    ],
    "torchpq_tpu_torch.profiling": ["named_scope", "trace", "PhaseTimer"],
    "torchpq_tpu_torch.util": [
        "Timer", "block_until_ready", "to_numpy", "id_dtype", "as_n_d",
        "as_d_n", "pad_rows", "cdiv", "round_up", "next_pow2",
        "locality_order", "int8_quantize_rows", "normalize", "pad_cols",
    ],
    "torchpq_tpu_torch.index": ["FlatIndex", "IVFPQIndex", "IVFPQRIndex"],
    "torchpq_tpu_torch.clustering": ["KMeans", "MultiKMeans",
                                     "MinibatchKMeans"],
    "torchpq_tpu_torch.codec": ["BaseCodec", "VQCodec", "PQCodec",
                                "SQCodec"],
    "torchpq_tpu_torch.codec.pq": [
        "PQCodec", "pack_nibbles", "unpack_nibbles", "paired_codebook",
    ],
    "torchpq_tpu_torch.container": [
        "BaseContainer", "FlatContainer", "CellContainer",
        "FlatContainerGroup",
    ],
    "torchpq_tpu_torch.transform": ["PCA", "OPQ"],
    "torchpq_tpu_torch.fn": ["Topk", "topk", "IVFPQTopk"],
    "torchpq_tpu_torch.ops.bmm": ["bmm", "min_bmm", "topk_bmm",
                                  "masked_bmm"],
    "torchpq_tpu_torch.ops.adc": [
        "build_adc_table", "adc_lookup_scores", "scan_query_major",
        "scan_cell_major",
    ],
    "torchpq_tpu_torch.ops.flat_adc": ["flat_adc_scan", "flat_adc_auto"],
    "torchpq_tpu_torch.ops.onehot_adc": [
        "build_scan_lut", "scan_cell_major_codes", "flat_onehot_scan",
        "flat_decode_scan",
    ],
    "torchpq_tpu_torch.ops.spill": ["rank_in_group", "spill_assign_device"],
    "torchpq_tpu_torch.ops.max_sim": [
        "max_sim", "topk_sim", "batched_max_sim", "batched_topk_sim",
    ],
    "torchpq_tpu_torch.metric": [
        "similarity", "cosine_similarity", "negative_squared_l2_distance",
        "negative_manhattan_distance", "inner_similarity",
        "canonical_distance", "preprocess_query",
    ],
}

METHODS = {
    "torchpq_tpu_torch.index.IVFPQIndex": [
        "train", "add", "remove", "search", "search_cells", "encode",
        "decode", "save", "load", "state_dict", "load_state_dict",
        "similarity_at_address", "similarity_at_id", "get_id_by_address",
        "get_address_by_id",
    ],
    "torchpq_tpu_torch.clustering.KMeans": [
        "fit", "predict", "topk", "remaining_memory", "does_it_fit",
        "cos_sim", "euc_sim", "sim", "calculate_error", "calculate_inertia",
    ],
    "torchpq_tpu_torch.clustering.MultiKMeans": [
        "fit", "predict", "topk", "remaining_memory", "does_it_fit",
        "cos_sim", "euc_sim", "sim", "calculate_error", "calculate_inertia",
    ],
    "torchpq_tpu_torch.codec.PQCodec": [
        "train", "encode", "decode", "precompute_adc",
    ],
    "torchpq_tpu_torch.container.CellContainer": [
        "add", "remove", "expand", "get_cell_by_address",
        "get_data_by_address", "get_ioa", "get_write_address",
        "set_data_by_address", "get_data_by_id", "empty",
    ],
    "torchpq_tpu_torch.StateModule": [
        "state_dict", "load_state_dict", "state_nbytes", "save", "load",
    ],
    "torchpq_tpu_torch.index.IVFPQRIndex": [
        "train", "add", "remove", "search", "search_cells", "encode",
        "decode", "save", "load", "state_dict", "load_state_dict",
        "similarity_at_address", "similarity_at_id", "get_id_by_address",
        "get_address_by_id", "expand",
    ],
    "torchpq_tpu_torch.index.FlatIndex": [
        "add", "remove", "search", "expand", "get_data_by_address",
        "get_data_by_id", "set_data_by_address", "get_id_by_address",
        "get_address_by_id", "empty", "save", "load",
    ],
    "torchpq_tpu_torch.container.FlatContainer": [
        "add", "remove", "expand", "add_aux_store", "aux",
        "get_data_by_address", "set_data_by_address", "get_data_by_id",
        "empty", "create_inverse_id_mapping",
    ],
    "torchpq_tpu_torch.container.FlatContainerGroup": [
        "add", "remove", "get_data_by_address", "set_data_by_address",
        "__getitem__",
    ],
    "torchpq_tpu_torch.codec.SQCodec": ["train", "encode", "decode"],
    "torchpq_tpu_torch.transform.PCA": ["train", "encode", "decode",
                                        "covar"],
    "torchpq_tpu_torch.transform.OPQ": ["train", "encode", "decode",
                                        "rotate"],
    "torchpq_tpu_torch.clustering.MinibatchKMeans": [
        "fit_minibatch", "predict", "topk",
    ],
    "torchpq_tpu_torch.fn.Topk": ["__call__"],
    "torchpq_tpu_torch.parallel.ShardedIVFPQSearcher": ["search", "add",
                                                        "remove"],
    "torchpq_tpu_torch.legacy.IVFPQ": [
        "train", "add", "remove", "remove_address", "encode", "decode",
        "topk", "similarity_at_address", "similarity_at_id",
        "reconstruct_from_cpu_ram",
    ],
    "torchpq_tpu_torch.legacy.IVFPQTopk": ["topk", "scores"],
    "torchpq_tpu_torch.profiling.PhaseTimer": ["phase", "report"],
    "torchpq_tpu_torch.util.Timer": ["tick"],
}

# public callables whose JAX signatures' parameters the port's must all
# accept (ROADMAP C7: the tiling kwargs are accepted and ignored; C11: the
# precision kwargs are live), with the defaults of `DEFAULTS` equal in both
SIGNATURES = [
    "config.set_search_precision", "config.set_train_precision",
    "metric.inner_similarity", "metric.cosine_similarity",
    "metric.negative_squared_l2_distance", "metric.similarity",
    "metric.negative_manhattan_distance",
    "ops.max_sim.max_sim", "ops.max_sim.topk_sim",
    "ops.max_sim.batched_max_sim", "ops.max_sim.batched_topk_sim",
    "ops.adc.build_adc_table", "ops.adc.adc_lookup_scores",
    "ops.adc.scan_query_major", "ops.adc.scan_cell_major",
    "ops.flat_adc.flat_adc_scan", "ops.flat_adc.flat_adc_auto",
    "ops.onehot_adc.build_scan_lut", "ops.onehot_adc.scan_cell_major_codes",
    "ops.onehot_adc.flat_onehot_scan", "ops.onehot_adc.flat_decode_scan",
    "fn.ivfpq_topk.IVFPQTopk.topk", "clustering.kmeans.KMeans.__init__",
    "clustering.kmeans.MultiKMeans.__init__",
    "container.cell.CellContainer.__init__", "module.StateModule.save",
    "codec.pq.PQCodec.__init__", "index.ivfpq.IVFPQIndex.__init__",
    "fn.topk.topk", "fn.topk.Topk.__call__", "metric.preprocess_query",
    "container.flat.FlatContainer.__init__",
    "container.flat.FlatContainer.add", "container.flat.FlatContainer.remove",
    "container.group.FlatContainerGroup.__init__",
    "container.group.FlatContainerGroup.add",
    "container.group.FlatContainerGroup.get_data_by_address",
    "index.flat.FlatIndex.__init__", "index.flat.FlatIndex.add",
    "index.flat.FlatIndex.search", "index.ivfpqr.IVFPQRIndex.__init__",
    "index.ivfpqr.IVFPQRIndex.train", "index.ivfpqr.IVFPQRIndex.add",
    "index.ivfpqr.IVFPQRIndex.search", "codec.sq.SQCodec.__init__",
    "transform.pca.PCA.__init__", "transform.pca.PCA.covar",
    "transform.opq.OPQ.__init__",
    "clustering.minibatch_kmeans.MinibatchKMeans.__init__",
    "clustering.minibatch_kmeans.MinibatchKMeans.fit_minibatch",
    "clustering.minibatch_kmeans.MinibatchKMeans.topk",
    "ops.bmm.bmm", "ops.bmm.min_bmm", "ops.bmm.topk_bmm", "ops.bmm.masked_bmm",
    "container.cell.CellContainer.expand", "index.ivfpq.IVFPQIndex.expand",
    "native.read_fvecs", "native.read_bvecs", "native.read_ivecs",
    "native.stream_vecs", "native.spill_assign", "parallel.mesh.get_mesh",
    "parallel.sharded_ivfpq.ShardedIVFPQSearcher.__init__",
    "parallel.sharded_ivfpq.ShardedIVFPQSearcher.search",
    "parallel.sharded_ivfpq.ShardedIVFPQSearcher.add",
    "parallel.sharded_ivfpq.ShardedIVFPQSearcher.remove",
    "parallel.sharded_ivfpq.data_parallel_lloyd_step",
    "parallel.sharded_ivfpq.data_parallel_kmeans_fit",
    "parallel.sharded_ivfpq.data_parallel_search",
    "legacy.ivfpq.IVFPQ.__init__", "legacy.ivfpq.IVFPQ.add",
    "legacy.ivfpq.IVFPQ.topk", "legacy.ivfpq.IVFPQ.remove",
    "legacy.ivfpq.IVFPQR.__init__", "legacy.pq.PQ.__init__",
    "legacy.sq.SQ.__init__", "legacy.ivfpq_topk.IVFPQTopk.__init__",
    "legacy.ivfpq_topk.IVFPQTopk.topk", "legacy.ivfpq_topk.IVFPQTopk.scores",
    "profiling.PhaseTimer.phase", "util.Timer.tick", "util.as_n_d",
    "util.pad_rows", "util.cdiv", "util.round_up", "util.next_pow2",
    "util.locality_order", "util.str2dtype", "util.pad_cols",
    "util.normalize", "util.int8_quantize_rows", "util.id_dtype",
    "util.as_d_n", "util.block_until_ready", "util.to_numpy",
    "util.Timer.__init__",
]
DEFAULTS = ("impl", "dtype", "format", "n_bits", "anisotropic_iters",
            "pq_use_residual", "k", "dim", "distance", "approx",
            "recall_target", "expand_mode", "expand_step_size", "bits",
            "alpha", "mode", "n_subvectors_rerank", "rerank_multiplier",
            "n_iter", "pq_max_iter", "n_clusters", "init_mode", "meaned",
            "rowvar", "exact", "axis_name", "scan_mode", "p_tile",
            "scan_group", "max_iter", "tol", "seed", "chunk_rows", "kind",
            "n_cq_clusters", "n_pq_clusters", "blocksize", "n_subq",
            "n_cs", "offset", "n_max", "sync", "label")

TUNABLES = ["use_cublas", "use_tensor_core", "fp16_scale_mode",
            "use_precomputed", "pq_max_iter", "vq_max_iter",
            "use_smart_probing", "smart_probing_temperature",
            "use_approx_topk"]


# the deep-k surface and spill settings (plain attributes in both packages)
DEEPK = ["spill_cells", "spill_capacity", "spill_impl", "scan_group",
         "scan_probe_cap", "scan_k_pair", "scan_merge_taper",
         "scan_super_probe", "scan_split_taper"]


def _reference(name):
    """The JAX package's counterpart of a port module or class name."""
    return name.replace("torchpq_tpu_torch", "torchpq_tpu", 1)


@pytest.mark.parametrize("module", sorted(SURFACE))
def test_module_exports(module):
    """Each name exists in the port and in the reference module it
    mirrors (the twin never lists a name the reference lacks)."""
    mod = importlib.import_module(module)
    missing = [s for s in SURFACE[module] if not hasattr(mod, s)]
    assert not missing, f"{module} missing {missing}"
    ref = importlib.import_module(_reference(module))
    extra = [s for s in SURFACE[module] if not hasattr(ref, s)]
    assert not extra, f"{_reference(module)} lacks {extra}"


@pytest.mark.parametrize("qualname", sorted(METHODS) + ["tunables"])
def test_class_methods(qualname):
    if qualname == "tunables":
        qualname, names = "torchpq_tpu_torch.index.IVFPQIndex", TUNABLES
    else:
        names = METHODS[qualname]
    for name in (qualname, _reference(qualname)):
        mod_name, cls_name = name.rsplit(".", 1)
        cls = getattr(importlib.import_module(mod_name), cls_name)
        missing = [m for m in names if not hasattr(cls, m)]
        assert not missing, f"{name} missing {missing}"


def test_custom_module_alias():
    assert tp.CustomModule is tp.StateModule


@pytest.fixture(scope="module")
def index_pair():
    """A JAX-trained index, its state carried into the port, the same add
    (ids 0..n-1) in both."""
    rng = np.random.default_rng(21)
    centers = rng.normal(size=(20, 32)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 20, 2500)]
         + rng.normal(size=(2500, 32))).astype(np.float32)
    kw = dict(d_vector=32, n_subvectors=8, n_cells=8, initial_size=512)
    jidx = JaxIndex(**kw)
    port = tp.IVFPQIndex(**kw, device=CPU)
    assert (port.vq_max_iter, port.pq_max_iter) == \
        (jidx.vq_max_iter, jidx.pq_max_iter)
    for idx in (jidx, port):
        idx.vq_max_iter = idx.pq_max_iter = 5
    jidx.train(jnp.asarray(x[:1500].T))
    port.load_state_dict(jidx.state_dict())
    jidx.add(jnp.asarray(x.T))
    port.add(x.T)
    q = rng.normal(size=(32, 12)).astype(np.float32)
    return jidx, port, x, q


def test_encode_decode_matches(index_pair):
    jidx, port, x, _ = index_pair
    xs = x[:300].T
    c_ref = np.asarray(jidx.encode(jnp.asarray(xs)))
    codes = port.encode(xs)
    assert codes.dtype == torch.uint8 and tuple(codes.shape) == (8, 300)
    assert np.mean(codes.numpy() == c_ref) >= 0.999
    np.testing.assert_array_equal(
        port.decode(codes).numpy(),
        np.asarray(jidx.decode(jnp.asarray(codes.numpy()))))


def test_similarity_at_id_matches(index_pair):
    """Ids present, absent (-1, out of range) and removed-never: -inf where
    an id holds nothing."""
    jidx, port, _, q = index_pair
    ids = np.array([-1, 0, 7, 123, 2499, 2500, 99999])
    ref = np.asarray(jidx.similarity_at_id(jnp.asarray(q), jnp.asarray(ids)))
    got = port.similarity_at_id(q, ids).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    assert np.isinf(got[:, [0, 5, 6]]).all()
    np.testing.assert_array_equal(
        got, port.similarity_at_address(
            q, port.get_address_by_id(ids)).numpy())


@pytest.mark.parametrize("name,value", [
    ("use_cublas", 0), ("use_tensor_core", 0), ("use_precomputed", 1),
    ("fp16_scale_mode", "both"), ("pq_max_iter", 7.0), ("vq_max_iter", 3)])
def test_tunables_match(index_pair, name, value):
    """The reference's defaults, the same coercion on set, the codec
    pass-throughs; a search is unchanged by the inert ones."""
    jidx, port, _, q = index_pair
    assert getattr(port, name) == getattr(jidx, name)
    before = port.search(q, k=5)
    old = getattr(port, name)
    try:
        setattr(port, name, value)
        setattr(jidx, name, value)
        assert getattr(port, name) == getattr(jidx, name)
        assert type(getattr(port, name)) is type(getattr(jidx, name))
        if name.endswith("max_iter"):
            codec = port.pq_codec if name.startswith("pq") else port.vq_codec
            assert codec.kmeans.max_iter == int(value)
        after = port.search(q, k=5)
        assert all(torch.equal(a, b) for a, b in zip(before, after))
    finally:
        setattr(port, name, old)
        setattr(jidx, name, old)


@pytest.mark.parametrize("name", DEEPK)
def test_deepk_attributes_match(index_pair, name):
    """Each deep-k / spill attribute exists with the JAX package's default
    (and its type), on a fresh index as on a filled one."""
    jidx, port, _, _ = index_pair
    fresh = tp.IVFPQIndex(32, 8, 8, device=CPU)
    for idx in (port, fresh):
        assert getattr(idx, name) == getattr(jidx, name)
        assert type(getattr(idx, name)) is type(getattr(jidx, name))


def test_fp16_scale_mode_validates(index_pair):
    _, port, _, _ = index_pair
    with pytest.raises(AssertionError):
        port.fp16_scale_mode = "c"
    assert port.fp16_scale_mode == "a"


@pytest.mark.parametrize("distance", ["euclidean", "inner", "cosine"])
def test_kmeans_topk_matches(rng, distance):
    x = rng.normal(size=(16, 800)).astype(np.float32)
    init = x[:, :24].copy()
    kw = dict(n_clusters=24, max_iter=5, distance=distance)
    ref = JaxKMeans(**kw)
    ref.fit(jnp.asarray(x), centroids=jnp.asarray(init))
    port = tp.clustering.KMeans(**kw, device=CPU)
    port.load_state_dict(ref.state_dict())
    q = rng.normal(size=(16, 50)).astype(np.float32)
    v_ref, i_ref = ref.topk(jnp.asarray(q), k=6)
    v, i = port.topk(q, k=6)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))


@pytest.mark.parametrize("distance", ["euclidean", "cosine"])
def test_multikmeans_predict_topk_match(rng, distance):
    x = rng.normal(size=(4, 3, 600)).astype(np.float32)
    init = x[:, :, :20].copy()
    kw = dict(n_clusters=20, max_iter=5, distance=distance)
    ref = JaxMultiKMeans(**kw)
    ref.fit(jnp.asarray(x), centroids=jnp.asarray(init))
    port = tp.clustering.MultiKMeans(**kw, device=CPU)
    port.load_state_dict(ref.state_dict())
    q = rng.normal(size=(4, 3, 70)).astype(np.float32)
    np.testing.assert_array_equal(port.predict(q).numpy(),
                                  np.asarray(ref.predict(jnp.asarray(q))))
    v_ref, i_ref = ref.topk(jnp.asarray(q), k=5)
    v, i = port.topk(q, k=5)
    assert tuple(v.shape) == (4, 70, 5)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))


@pytest.mark.parametrize("distance", ["euclidean", "inner"])
def test_batched_topk_sim_matches(rng, distance):
    x = rng.normal(size=(3, 200, 8)).astype(np.float32)
    c = rng.normal(size=(3, 40, 8)).astype(np.float32)
    v_ref, i_ref = jms.batched_topk_sim(jnp.asarray(x), jnp.asarray(c), 7,
                                        distance)
    v, i = tms.batched_topk_sim(torch.from_numpy(x), torch.from_numpy(c), 7,
                                distance)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))


@pytest.mark.parametrize("distance", ["euclidean", "inner"])
def test_pq_precompute_adc_matches(rng, distance):
    x = rng.normal(size=(32, 2000)).astype(np.float32)
    ref = JaxPQ(d_vector=32, n_subvectors=8, max_iter=5, distance=distance)
    ref.train(jnp.asarray(x))
    port = tp.codec.PQCodec(d_vector=32, n_subvectors=8, distance=distance,
                            device=CPU)
    port.load_state_dict(ref.state_dict())
    q = rng.normal(size=(32, 9)).astype(np.float32)
    lut = port.precompute_adc(q)
    assert tuple(lut.shape) == (8, 9, 256)
    np.testing.assert_allclose(
        lut.numpy(), np.asarray(ref.precompute_adc(jnp.asarray(q))),
        rtol=1e-5, atol=1e-4)


def _resolve(pkg, path):
    """The object at `path` (modules, then attributes) under `pkg`."""
    parts = path.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join([pkg] + parts[:i]))
        except ImportError:
            continue
        for name in parts[i:]:
            obj = getattr(obj, name)
        return obj
    raise ImportError(path)


@pytest.mark.parametrize("path", SIGNATURES)
def test_signature_accepts_reference_kwargs(path):
    """Every parameter of the JAX signature exists in the port's (the
    tiling kwargs accepted and ignored, C7; precision live, C11), and the
    defaults that decide behaviour are the JAX package's (impl "xla", a
    float32 cell store, npz saves; C6)."""
    ref = inspect.signature(_resolve("torchpq_tpu", path)).parameters
    got = inspect.signature(_resolve("torchpq_tpu_torch", path)).parameters
    missing = [p for p in ref if p not in got]
    assert not missing, f"{path} lacks {missing}"
    for name in DEFAULTS:
        if name in ref:
            assert got[name].default == ref[name].default, (path, name)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_normalize_axis_matches(rng, axis):
    """util.normalize takes the reference's `axis` (ROADMAP C8): the JAX
    function's output on the same rows, positional and by keyword."""
    from torchpq_tpu import util as jutil
    x = rng.normal(size=(6, 9)).astype(np.float32)
    x[:, 2] = 0.0  # a zero column: the eps clamp
    ref = np.asarray(jutil.normalize(jnp.asarray(x), axis=axis))
    np.testing.assert_allclose(
        tp.util.normalize(torch.from_numpy(x), axis=axis).numpy(), ref,
        rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        tp.util.normalize(torch.from_numpy(x), axis).numpy(), ref,
        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("cls", ["KMeans", "MultiKMeans"])
def test_centroids_setter_matches(rng, cls):
    """Assigning centroids in the reference layout sets the same state and
    the same predictions in both packages (C5); None clears it."""
    if cls == "KMeans":
        x = rng.normal(size=(8, 300)).astype(np.float32)
        cents = rng.normal(size=(8, 12)).astype(np.float32)
        ref, port = JaxKMeans(n_clusters=12), tp.clustering.KMeans(
            n_clusters=12, sm_size=48 * 1024, device=CPU)
    else:
        x = rng.normal(size=(3, 4, 300)).astype(np.float32)
        cents = rng.normal(size=(3, 4, 12)).astype(np.float32)
        ref, port = JaxMultiKMeans(n_clusters=12), \
            tp.clustering.MultiKMeans(n_clusters=12, sm_size=48 * 1024,
                                      device=CPU)
    ref.centroids = jnp.asarray(cents)
    port.centroids = cents
    assert port.is_trained
    np.testing.assert_array_equal(port.centroids.numpy(), cents)
    np.testing.assert_array_equal(port._centroids.numpy(),
                                  np.asarray(ref._centroids))
    np.testing.assert_array_equal(port.predict(x).numpy(),
                                  np.asarray(ref.predict(jnp.asarray(x))))
    port.centroids = None
    assert not port.is_trained


def test_kmeans_static_helpers_match(rng):
    """cos_sim / euc_sim / sim take the reference's [d, n] operands;
    calculate_error / calculate_inertia; the memory probe's CPU answer is
    the JAX package's 8 GiB assumption (C5)."""
    a = rng.normal(size=(6, 20)).astype(np.float32)
    b = rng.normal(size=(6, 9)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    port = tp.clustering.KMeans(n_clusters=4, distance="inner", device=CPU)
    ref = JaxKMeans(n_clusters=4, distance="inner")
    for got, want in (
            (tp.clustering.KMeans.cos_sim(ta, tb), JaxKMeans.cos_sim(ja, jb)),
            (tp.clustering.KMeans.euc_sim(ta, tb), JaxKMeans.euc_sim(ja, jb)),
            (port.sim(ta, tb), ref.sim(ja, jb)),
            (tp.clustering.KMeans.calculate_error(ta[:, :9], tb),
             JaxKMeans.calculate_error(ja[:, :9], jb)),
            (tp.clustering.KMeans.calculate_inertia(ta),
             JaxKMeans.calculate_inertia(ja))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    assert tp.clustering.KMeans.remaining_memory("cpu") == 1 << 33
    assert tp.clustering.MultiKMeans.does_it_fit(1 << 20, "cpu")
    assert not tp.clustering.KMeans.does_it_fit(1 << 32, "cpu")


def test_cell_container_helpers_match(rng):
    """The float32 default store (C6), contiguous_size accepted (C7), and
    get_ioa / get_write_address / set_data_by_address / get_data_by_id /
    empty against the JAX container on the same adds (C5)."""
    kw = dict(code_size=3, n_cells=4, initial_size=16)
    jc = JaxCells(**kw, contiguous_size=4)
    tc = tp.container.CellContainer(**kw, contiguous_size=4, device=CPU)
    assert tc._storage.dtype == torch.float32
    data = rng.normal(size=(3, 30)).astype(np.float32)
    cells = rng.integers(0, 4, size=30).astype(np.int32)
    jc.add(jnp.asarray(data), jnp.asarray(cells))
    tc.add(data, cells)
    new = rng.integers(0, 4, size=11).astype(np.int32)
    np.testing.assert_array_equal(tc.get_ioa(new).numpy(),
                                  np.asarray(jc.get_ioa(jnp.asarray(new))))
    np.testing.assert_array_equal(
        tc.get_write_address(new).numpy(),
        np.asarray(jc.get_write_address(jnp.asarray(new))))
    addr = np.array([0, 5, 17, 40, -1, 9999])
    rows = rng.normal(size=(3, 6)).astype(np.float32)
    jc.set_data_by_address(jnp.asarray(rows), jnp.asarray(addr))
    tc.set_data_by_address(rows, addr)
    np.testing.assert_array_equal(tc._storage.numpy(),
                                  np.asarray(jc._storage))
    ids = np.array([0, 3, 29, 30, -1])
    np.testing.assert_array_equal(
        tc.get_data_by_id(ids).numpy(),
        np.asarray(jc.get_data_by_id(jnp.asarray(ids))))
    jc.empty()
    tc.empty()
    assert tc.n_items == 0 and tc.max_id == 0
    for k in ("_address2id", "_id2address", "_is_empty", "_cell_size"):
        np.testing.assert_array_equal(to_np(getattr(tc, k)),
                                      np.asarray(getattr(jc, k)), err_msg=k)
    assert tc.add(data[:, :2], cells[:2]).tolist() == [0, 1]


def test_state_nbytes_and_save_formats(index_pair, tmp_path):
    """state_nbytes counts the same registered state as the JAX package's
    (C5); save takes format="npz" and refuses "orbax", which imports jax
    (C7, a recorded divergence)."""
    jidx, port, _, q = index_pair
    assert port.state_nbytes() == jidx.state_nbytes()
    assert port.state_nbytes() == sum(
        np.asarray(v).nbytes for k, v in port.state_dict().items()
        if not k.endswith("::bfloat16") and np.ndim(v))
    path = str(tmp_path / "idx.npz")
    port.save(path, format="npz")
    fresh = tp.IVFPQIndex(d_vector=32, n_subvectors=8, n_cells=8,
                          device=CPU)
    fresh.load(path)
    assert all(torch.equal(a, b) for a, b in zip(port.search(q, k=5),
                                                  fresh.search(q, k=5)))
    with pytest.raises(NotImplementedError, match="jax"):
        port.save(str(tmp_path / "ckpt"), format="orbax")


# the modules the later slices of the port brought (A13, A14; A15-A17)
NEW_MODULES = [
    "torchpq_tpu_torch.fn.topk", "torchpq_tpu_torch.container.flat",
    "torchpq_tpu_torch.container.group", "torchpq_tpu_torch.index.flat",
    "torchpq_tpu_torch.index.ivfpqr", "torchpq_tpu_torch.codec.sq",
    "torchpq_tpu_torch.transform.pca", "torchpq_tpu_torch.transform.opq",
    "torchpq_tpu_torch.clustering.minibatch_kmeans",
    "torchpq_tpu_torch.ops.bmm", "torchpq_tpu_torch.native",
    "torchpq_tpu_torch.parallel", "torchpq_tpu_torch.parallel.mesh",
    "torchpq_tpu_torch.parallel.sharded_ivfpq", "torchpq_tpu_torch.legacy",
    "torchpq_tpu_torch.legacy.ivfpq", "torchpq_tpu_torch.legacy.ivfpq_topk",
    "torchpq_tpu_torch.legacy.pq", "torchpq_tpu_torch.legacy.sq",
    "torchpq_tpu_torch.profiling",
]


def _imports(path):
    """Top-level names of every module a source file imports."""
    import ast
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            out.add(node.module)
    return {name.split(".")[0] for name in out}


def test_port_sources_import_no_jax():
    """No source of the port, not chip_smoke.py, chip_variants.py or
    chip_matmul.py and not the multi-rank test worker
    (tests/_torch_dist_worker.py) names jax, orbax or the JAX package in an
    import."""
    import pathlib
    root = pathlib.Path(tp.__file__).parent
    files = sorted(root.rglob("*.py")) + [
        root.parent / "chip_smoke.py", root.parent / "chip_variants.py",
        root.parent / "chip_matmul.py",
        pathlib.Path(__file__).parent / "_torch_dist_worker.py"]
    for path in files:
        bad = _imports(path) & {"jax", "jaxlib", "orbax", "torchpq_tpu"}
        assert not bad, f"{path} imports {bad}"


def test_new_modules_load_without_jax():
    """A fresh interpreter imports every module of this slice and finds no
    jax, orbax or JAX-package module loaded."""
    import subprocess
    import sys
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in NEW_MODULES)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'orbax', 'torchpq_tpu')]\n"
              "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=str(__import__("pathlib").Path(tp.__file__)
                           .parent.parent))
