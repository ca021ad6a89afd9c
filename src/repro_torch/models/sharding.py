"""Logical-axis sharding rules (twin of ``repro.models.sharding``).

Models annotate tensors with *logical* axis names; this module resolves
them to the axes of the current mesh. Rules are swappable through
``rules_override`` (thread-local, as the reference's).

Logical axes:
    batch    activation batch dim            -> ("pod","data")
    fsdp     weight d_model (ZeRO/FSDP) dim  -> ("pod","data")
    tensor   heads / mlp / vocab TP dim      -> ("model",)
    kv_seq   sharded KV-cache sequence dim   -> ("model",)   [decode]
    kv_seq_long  long-context KV sequence    -> ("data","model") [long_500k]
    expert   MoE expert dim                  -> ()  (replicated axis; ff uses tensor)

The current mesh is a *description* (``MeshDesc``: axis names and sizes)
set by ``use_mesh``, the counterpart of JAX's abstract mesh: enough for
the rules and specs of a 256-device pod without 256 processes. A spec
(``ax``) is a tuple with one entry a tensor dimension, each entry the
tuple of mesh axes that dimension is split over (``()``: replicated).
``placements`` turns a spec into DTensor placements on a ``DeviceMesh``.

``constrain`` and ``weight_gather`` return a plain tensor unchanged and
redistribute a DTensor on its own mesh, as ``with_sharding_constraint``
does under a mesh; ``replicated_like`` lifts a plain tensor built beside
a DTensor (a RoPE table, a mask) onto that DTensor's mesh, replicated.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Optional

import torch

DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "fsdp": ("pod", "data"),
    "tensor": ("model",),
    "kv_seq": ("model",),
    "kv_seq_long": ("data", "model"),
    "expert": (),
}

_local = threading.local()


@dataclass(frozen=True)
class MeshDesc:
    """A mesh's name, axis names and axis sizes (no devices)."""
    name: str
    axis_names: tuple
    axis_sizes: tuple

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def sizes(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))


def describe(mesh) -> MeshDesc:
    """A ``MeshDesc`` of a ``MeshDesc`` or a named ``DeviceMesh``."""
    if isinstance(mesh, MeshDesc):
        return mesh
    names = tuple(mesh.mesh_dim_names)
    return MeshDesc("x".join(map(str, mesh.shape)), names, tuple(mesh.shape))


def _rules() -> dict[str, tuple[str, ...]]:
    return getattr(_local, "rules", DEFAULT_RULES)


def current_mesh() -> Optional[MeshDesc]:
    return getattr(_local, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``MeshDesc`` or a named ``DeviceMesh``) the current
    mesh of this thread."""
    old = current_mesh()
    _local.mesh = describe(mesh)
    try:
        yield _local.mesh
    finally:
        _local.mesh = old


@contextlib.contextmanager
def rules_override(**kw):
    """Temporarily replace logical->mesh rules (hillclimbing)."""
    old = _rules()
    new = dict(old)
    for k, v in kw.items():
        new[k] = tuple(v) if v else ()
    _local.rules = new
    try:
        yield
    finally:
        _local.rules = old


def mesh_axis_names() -> tuple[str, ...]:
    mesh = current_mesh()
    return () if mesh is None else tuple(mesh.axis_names)


def resolve(logical: Optional[str], names=None) -> Optional[tuple[str, ...]]:
    """Resolve one logical name to the mesh axes present in the current
    mesh (or in ``names``); None when there are none."""
    if logical is None:
        return None
    present = set(mesh_axis_names() if names is None else names)
    axes = tuple(a for a in _rules().get(logical, ()) if a in present)
    return axes or None


def ax(*logicals: Optional[str], names=None) -> tuple:
    """The spec of a tensor whose dims carry ``logicals`` (None =
    replicated dim): a tuple of mesh-axis tuples."""
    return tuple(resolve(n, names) or () for n in logicals)


def axis_size(logical: str) -> int:
    mesh = current_mesh()
    if mesh is None:
        return 1
    sizes = mesh.sizes
    n = 1
    for a in _rules().get(logical, ()):
        n *= sizes.get(a, 1)
    return n


def shard_shape(shape, spec, mesh=None) -> tuple:
    """A device's block of a tensor of ``shape`` under ``spec``: each dim
    divided, rounded up, by the size of every mesh axis it is split over
    (the padded block XLA and DTensor give the first devices)."""
    sizes = describe(mesh).sizes if mesh is not None else \
        (current_mesh().sizes if current_mesh() else {})
    out = []
    for n, part in zip(shape, tuple(spec) + ((),) * (len(shape) - len(spec))):
        for a in part or ():
            n = -(-n // sizes.get(a, 1))
        out.append(n)
    return tuple(out)


def placements(spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh`` (a named DeviceMesh):
    ``Shard(d)`` on every mesh dim of more than one device that tensor
    dim d is split over (a dim split over two mesh axes is sharded on
    both), else ``Replicate()`` (a split over one device is a copy)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for i, name in enumerate(mesh.mesh_dim_names):
        dims = [d for d, part in enumerate(spec) if name in (part or ())]
        out.append(Shard(dims[0]) if dims and mesh.size(i) > 1
                   else Replicate())
    return out


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh`` (a leaf of a ``shardings`` tree)."""
    mesh: object
    spec: tuple

    def place(self, x):
        """``x`` (the same whole tensor on every rank) as a DTensor laid
        out by the spec; a rank outside the mesh holds an empty block."""
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(x.to(self.mesh.device_type), self.mesh,
                                 placements(self.spec, self.mesh))


def _is_dtensor(x) -> bool:
    if type(x) is torch.Tensor:       # the plain path pays one test
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _redistribute(x, logicals):
    mesh = x.device_mesh
    spec = ax(*logicals, names=mesh.mesh_dim_names)
    return x.redistribute(mesh, placements(spec, mesh))


def constrain(x, *logicals: Optional[str]):
    """``x`` laid out as ``logicals`` say, on its own mesh; a plain tensor
    is returned unchanged."""
    if not _is_dtensor(x):
        return x
    return _redistribute(x, logicals)


def weight_gather(cfg, w, axes):
    """A DTensor weight gathered over its fsdp dims (tensor dims kept)
    when ``cfg.gather_weights``; a plain tensor is returned unchanged."""
    if not getattr(cfg, "gather_weights", False) or not _is_dtensor(w):
        return w
    return _redistribute(w, [a if a == "tensor" else None for a in axes])


def whole_dim(x, dim, n):
    """``x`` with tensor dim ``dim`` gathered on every mesh dim that
    cannot split its ``n`` parts (heads) evenly; DTensor views refuse an
    uneven split where XLA pads one. A plain tensor is returned
    unchanged."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    pl = [Replicate() if p.is_shard(dim) and n % mesh.size(i) else p
          for i, p in enumerate(x.placements)]
    return x if pl == list(x.placements) else x.redistribute(mesh, pl)


def replicated_like(t, ref):
    """``t`` replicated on ``ref``'s mesh when ``ref`` is a DTensor, else
    ``t`` itself."""
    if not _is_dtensor(ref) or _is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def local(x):
    """The plain tensor of ``x``: a DTensor gathered whole, else ``x``."""
    return x.full_tensor() if _is_dtensor(x) else x
