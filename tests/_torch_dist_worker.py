"""One rank of the port's multi-rank parity runs (tests/test_torch_parallel.py).

    python tests/_torch_dist_worker.py RANK WORLD CASE_DIR

Imports torch and the port only (never JAX): the rank joins a gloo world
through a FileStore in CASE_DIR, runs every case of CASE_DIR/cases.json in
order (each case's index loaded from the .npz the test saved, on the CPU),
and writes each case's outputs to CASE_DIR/out.<case>.r<RANK>.npz, so the
test can check that every rank returns the same replicated result.
"""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torchpq_tpu_torch as tp  # noqa: E402
from torchpq_tpu_torch.parallel import (  # noqa: E402
    ShardedIVFPQSearcher, data_parallel_kmeans_fit, data_parallel_lloyd_step,
    data_parallel_search, device_count, get_mesh)


def load_index(case_dir, spec):
    index = tp.IVFPQIndex(**spec["kw"], device="cpu")
    index.load(os.path.join(case_dir, spec["file"]))
    for name, value in spec.get("settings", {}).items():
        setattr(index, name, value)
    return index


def np_out(x):
    return tp.util.to_numpy(x)


def case_search(case_dir, c, index, mesh):
    """Single-device and sharded search of the same queries; then the
    case's steps (add, remove, mode switch, search) in order."""
    out = {}
    q = np.load(os.path.join(case_dir, c["queries"]))
    v1, i1 = index.search(q["q"].T, k=c["k"])
    out.update(single_v=np_out(v1), single_i=np_out(i1))
    searcher = ShardedIVFPQSearcher(index, mesh=mesh, **c.get("searcher", {}))
    out["n_shards"] = searcher.n_shards
    out["decoded_dtype"] = str(searcher.decoded.dtype)
    v2, i2 = searcher.search(q["q"].T, k=c["k"])
    out.update(v=np_out(v2), i=np_out(i2))
    for j, step in enumerate(c.get("steps", [])):
        op = step["op"]
        if op == "add":
            arr = q[step["x"]]
            out[f"{j}_ids"] = np_out(searcher.add(arr.T))
        elif op == "remove":
            out[f"{j}_removed"] = np.int64(searcher.remove(q[step["ids"]]))
        elif op == "set":
            target = index if step["on"] == "index" else searcher
            setattr(target, step["name"], step["value"])
        elif op == "search":
            v, i = searcher.search(q[step["x"]].T, k=step["k"])
            out[f"{j}_v"], out[f"{j}_i"] = np_out(v), np_out(i)
    return out


def case_lloyd(case_dir, c, mesh):
    f = np.load(os.path.join(case_dir, c["data"]))
    got = data_parallel_lloyd_step(mesh, torch.from_numpy(f["data_sh"]),
                                   torch.from_numpy(f["cents"]), "euclidean")
    return {"cents": np_out(got)}


def case_fit(case_dir, c, mesh):
    f = np.load(os.path.join(case_dir, c["data"]))
    cents, iters = data_parallel_kmeans_fit(f["x"], c["k"], mesh=mesh,
                                            device="cpu", **c["kw"])
    return {"cents": np_out(cents), "iters": np.int64(iters)}


def case_dp_search(case_dir, c, index, mesh):
    """data_parallel_search, and whether it left the index untouched."""
    q = np.load(os.path.join(case_dir, c["queries"]))["q"]
    index.scan_mode = "flat"  # populate a derived cache first
    index.search(q[:8].T, k=3)
    index.scan_mode = "cell_major"
    names = ("_storage", "_address2id", "_is_empty", "_cell_start",
             "_cell_capacity")
    before = {n: getattr(index, n) for n in names}
    copies = {n: t.clone() for n, t in before.items()}
    aux = {n: index.aux(n) for n in index._aux}
    flat = index._flat_cache
    v, i = data_parallel_search(index, q.T, k=c["k"], mesh=mesh)
    same = all(getattr(index, n) is t and torch.equal(t, copies[n])
               for n, t in before.items())
    same = same and all(index.aux(n) is t for n, t in aux.items())
    same = same and index._flat_cache is flat
    v1, i1 = index.search(q.T, k=c["k"])
    return {"v": np_out(v), "i": np_out(i), "single_v": np_out(v1),
            "single_i": np_out(i1), "untouched": np.bool_(same)}


def main():
    rank, world, case_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    store = dist.FileStore(os.path.join(case_dir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    with open(os.path.join(case_dir, "cases.json")) as f:
        cases = json.load(f)
    meshes = {}
    for c in cases:
        n = c.get("mesh", world)
        if n not in meshes:  # collective over the world: every rank builds
            meshes[n] = get_mesh(n)
        mesh = meshes[n]
        if mesh.get_coordinate() is None:
            continue  # ranks outside the mesh take no part
        kind = c["kind"]
        if kind == "search":
            out = case_search(case_dir, c, load_index(case_dir, c["index"]),
                              mesh)
        elif kind == "lloyd":
            out = case_lloyd(case_dir, c, mesh)
        elif kind == "fit":
            out = case_fit(case_dir, c, mesh)
        elif kind == "dp_search":
            out = case_dp_search(case_dir, c,
                                 load_index(case_dir, c["index"]), mesh)
        elif kind == "mesh":
            out = {"device_count": np.int64(device_count()),
                   "size": np.int64(mesh.size()),
                   "names": np.array(mesh.mesh_dim_names),
                   "ranks": np.array(mesh.mesh.tolist())}
        else:
            raise ValueError(kind)
        np.savez(os.path.join(case_dir, f"out.{c['name']}.r{rank}.npz"),
                 **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
