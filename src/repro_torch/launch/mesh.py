"""Meshes: the reference's production pods and the card's layouts as
descriptions, and a ``DeviceMesh`` over the initialised process group
(twin of ``repro.launch.mesh``).

A description (``sharding.MeshDesc``) is what the logical-axis rules,
the specs and the dry run read; it touches no device. ``pod256`` and
``pod512`` are the reference's production meshes, so that the port's
specs are held against the reference's records; ``h100x1`` is one card
and ``h100x4`` four cards of one host over NVLink, all on the "model"
axis.
"""
from __future__ import annotations

from repro_torch.models.sharding import MeshDesc

MESHES = {
    "pod256": MeshDesc("pod256", ("data", "model"), (16, 16)),
    "pod512": MeshDesc("pod512", ("pod", "data", "model"), (2, 16, 16)),
    "h100x1": MeshDesc("h100x1", ("data", "model"), (1, 1)),
    "h100x4": MeshDesc("h100x4", ("data", "model"), (1, 4)),
}


def make_production_mesh(*, multi_pod: bool = False) -> MeshDesc:
    return MESHES["pod512" if multi_pod else "pod256"]


def make_test_mesh(shape=(2, 4), axes=("data", "model")):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the first ranks
    of the initialised process group, row-major, as ``jax.make_mesh``
    takes the first devices (gloo: CPU tensors; NCCL: each rank's card).
    Every rank of the group calls it."""
    import math

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(math.prod(shape)).reshape(tuple(shape))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes))
