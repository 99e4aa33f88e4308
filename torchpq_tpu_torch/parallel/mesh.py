"""Meshes over the ranks of torch.distributed (counterpart of
torchpq_tpu/parallel/mesh.py).

JAX runs one controller over a mesh of devices. Here every rank is its own
process (one per card over NCCL, or CPU processes over gloo), started by the
caller, which also initializes the default process group
(`torch.distributed.init_process_group` with its address, world size and
rank). A mesh is a 1-D `DeviceMesh` over some of those ranks.
"""

import torch
import torch.distributed as dist


def _require_group():
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "torchpq_tpu_torch.parallel needs an initialized default process "
            "group: call torch.distributed.init_process_group (backend "
            "'nccl' for cards, 'gloo' for the CPU) in every rank first")


def device_count():
    """The world size of the default process group."""
    _require_group()
    return dist.get_world_size()


def get_mesh(n_devices=None, axis_name="shard", devices=None):
    """1-D mesh over the first n_devices ranks (default: all) of `devices`
    (a list of global ranks; default: the whole world), named
    (axis_name,). Its device type follows the default group's backend:
    "cuda" over NCCL, "cpu" over gloo.

    Every rank of the world calls this (a subgroup is created collectively);
    ranks outside the mesh take no further part (their mesh's
    get_coordinate() is None)."""
    _require_group()
    ranks = list(range(dist.get_world_size())) if devices is None \
        else [int(r) for r in devices]
    if n_devices is not None:
        if len(ranks) < n_devices:
            raise ValueError(f"need {n_devices} ranks, have {len(ranks)}")
        ranks = ranks[:n_devices]
    from torch.distributed.device_mesh import DeviceMesh
    device_type = "cuda" if "nccl" in str(dist.get_backend()) else "cpu"
    return DeviceMesh(device_type, torch.tensor(ranks),
                      mesh_dim_names=(axis_name,))


def mesh_rank(mesh):
    """This rank's index along the mesh (raises outside the mesh)."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError(
            f"rank {dist.get_rank()} is not in the mesh {mesh.mesh.tolist()}")
    return int(coord[0])
