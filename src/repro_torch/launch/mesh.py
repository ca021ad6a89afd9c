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


def rank_device(backend=None, rank=None):
    """The device a rank of the process group computes on: under NCCL its
    own card, ``cuda:<rank>`` (one rank a card, all on one host), under
    gloo the CPU. ``backend`` and ``rank`` default to the initialised
    group's; a rank that must pick its card before it joins the group
    (``init_process_group(..., device_id=)``) passes both."""
    import torch
    import torch.distributed as dist
    backend = backend or dist.get_backend()
    if backend != "nccl":
        return torch.device("cpu")
    return torch.device("cuda", dist.get_rank() if rank is None else rank)


def make_test_mesh(shape=(2, 4), axes=("data", "model")):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the first ranks
    of the initialised process group, row-major, as ``jax.make_mesh``
    takes the first devices, on each rank's ``rank_device`` (gloo: CPU
    tensors; NCCL: the rank's card, made the current device). Every rank
    of the group calls it."""
    import math

    import torch
    from torch.distributed.device_mesh import DeviceMesh
    dev = rank_device()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    ranks = torch.arange(math.prod(shape)).reshape(tuple(shape))
    return DeviceMesh(dev.type, ranks, mesh_dim_names=tuple(axes))
