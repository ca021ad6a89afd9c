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

Where DTensor refuses an op, the model code keeps the split instead of
gathering: ``blocks`` / ``from_blocks`` and ``local_rows`` run a
computation on each rank's block (a local map), ``index_copy_`` writes a
cache in place on each rank's block, and a dim is split only while it
splits evenly (XLA pads an uneven split; DTensor views refuse one).
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


def context():
    """This thread's mesh and rules, for model code that runs on another
    thread: a checkpoint's recompute runs on the autograd engine's
    device thread in a CUDA backward."""
    return current_mesh(), _rules()


@contextlib.contextmanager
def use_context(ctx):
    """Make ``ctx`` (from ``context()``) this thread's mesh and rules."""
    old = context()
    _local.mesh, _local.rules = ctx
    try:
        yield
    finally:
        _local.mesh, _local.rules = old


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
        out by the spec, each rank cutting its block from its own copy
        (no collective); a rank outside the mesh holds an empty block."""
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(x.to(self.mesh.device_type), self.mesh,
                                 placements(self.spec, self.mesh),
                                 src_data_rank=None)


def is_dtensor(x) -> bool:
    if type(x) is torch.Tensor:       # the plain path pays one test
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _even(pl, parts, mesh) -> list:
    """Placements ``pl`` with every ``Shard(d)`` that would split the
    ``parts[d]`` parts of dim d unevenly (mesh dims taken in order)
    turned into ``Replicate()``: DTensor views refuse an uneven split
    where XLA pads one."""
    from torch.distributed.tensor import Replicate
    pl, split = list(pl), {}
    for i, p in enumerate(pl):
        if p.is_shard() and p.dim in parts:
            n = split.get(p.dim, 1) * mesh.size(i)
            if parts[p.dim] % n:
                pl[i] = Replicate()
            else:
                split[p.dim] = n
    return pl


def _redistribute(x, logicals):
    """``x`` laid out as ``logicals`` say, a dim split over a mesh axis only
    while it splits evenly."""
    mesh = x.device_mesh
    spec = ax(*logicals, names=mesh.mesh_dim_names)
    return x.redistribute(mesh, _even(placements(spec, mesh),
                                      dict(enumerate(x.shape)), mesh))


def constrain(x, *logicals: Optional[str]):
    """``x`` laid out as ``logicals`` say, on its own mesh; a plain tensor
    is returned unchanged."""
    if not is_dtensor(x):
        return x
    return _redistribute(x, logicals)


def weight_gather(cfg, w, axes):
    """A DTensor weight gathered over its fsdp dims (tensor dims kept)
    when ``cfg.gather_weights``; a plain tensor is returned unchanged."""
    if not getattr(cfg, "gather_weights", False) or not is_dtensor(w):
        return w
    return _redistribute(w, [a if a == "tensor" else None for a in axes])


def whole_dim(x, dim, n):
    """``x`` with tensor dim ``dim`` gathered on every mesh dim, in mesh
    order, past which its ``n`` parts (heads, token groups) no longer
    split evenly. A plain tensor is returned unchanged."""
    if not is_dtensor(x):
        return x
    pl = _even(x.placements, {dim: n}, x.device_mesh)
    return x if pl == list(x.placements) else x.redistribute(x.device_mesh,
                                                             pl)


def blocks(xs, pls) -> list:
    """Each rank's blocks of DTensors ``xs`` (on one mesh), each laid out
    by its list of placements in ``pls``, for a computation on blocks (a
    local map). A block's gradient is Partial on every mesh dim that
    splits some input but not this one: each rank's part of the
    computation adds its share of that input's gradient."""
    from torch.distributed.tensor import Partial
    mesh = xs[0].device_mesh
    split = [any(pl[i].is_shard() for pl in pls) for i in range(mesh.ndim)]
    return [x.redistribute(mesh, pl).to_local(grad_placements=[
        Partial() if cut and not p.is_shard() else p
        for cut, p in zip(split, pl)]) for x, pl in zip(xs, pls)]


def from_blocks(t, mesh, pl, shape):
    """The DTensor of ``shape`` whose blocks, laid out by ``pl``, are each
    rank's ``t`` (contiguous)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t.contiguous(), mesh, pl, run_check=False,
                              shape=shape, stride=torch.empty(
                                  shape, device="meta").stride())


def local_rows(fn, *xs):
    """``fn(*xs)`` for a ``fn`` whose every row (dim 0) is computed from
    the same row of each input alone. On DTensors each rank runs ``fn``
    on its own rows: every input is laid out split on dim 0 as the first
    is and whole on every other dim, and each output (a tensor or a
    tuple) comes back split alike. Plain tensors: ``fn(*xs)``."""
    if not is_dtensor(xs[0]):
        return fn(*xs)
    from torch.distributed.tensor import Replicate
    mesh, rows = xs[0].device_mesh, xs[0].shape[0]
    pl = [p if p.is_shard(0) else Replicate() for p in xs[0].placements]
    xs = [replicated_like(x, xs[0]) for x in xs]
    out = fn(*blocks(xs, [pl] * len(xs)))

    def wrap(t):
        return from_blocks(t, mesh, pl, (rows,) + tuple(t.shape[1:]))
    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def laid_out_like(t, ref):
    """``t`` laid out as DTensor ``ref`` is (a gradient as its parameter:
    the reduce-scatter of a sharded weight's gradient), else ``t``."""
    if not is_dtensor(ref):
        return t
    return replicated_like(t, ref).redistribute(ref.device_mesh,
                                                ref.placements)


def replicated_like(t, ref):
    """``t`` replicated on ``ref``'s mesh when ``ref`` is a DTensor, else
    ``t`` itself."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _block(x, dim):
    """(offset, length) of this rank's block of DTensor ``x`` on ``dim``."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, offset = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    return offset[dim], shape[dim]


def index_copy_(dst, dim, index, src):
    """``dst.index_copy_(dim, index, src)`` (``index`` 1-D, no repeats).
    On a DTensor ``dst`` each rank writes into its own block the entries
    of ``index`` that fall in it: ``src`` is laid out as ``dst`` but
    whole on ``dim`` (a redistribution where it is split there), the
    index is read whole. One index is written without a host sync (off
    the block, the place keeps its value)."""
    if not is_dtensor(dst):
        return dst.index_copy_(dim, index, src)
    from torch.distributed.tensor import Replicate
    mesh = dst.device_mesh
    whole_on_dim = [Replicate() if p.is_shard(dim) else p
                    for p in dst.placements]
    src = replicated_like(src, dst).redistribute(mesh, whole_on_dim)
    src = src.to_local()
    if is_dtensor(index):
        index = index.redistribute(mesh, [Replicate()] * mesh.ndim)
        index = index.to_local()
    offset, n = _block(dst, dim)
    if n == 0:
        return dst
    local, at = dst.to_local(), index.long() - offset
    inside = (at >= 0) & (at < n)
    if at.numel() == 1:
        at = at.clamp(0, n - 1)
        local.index_copy_(dim, at, torch.where(
            inside, src, local.index_select(dim, at)))
    else:
        keep = inside.nonzero()[:, 0]
        local.index_copy_(dim, at[keep], src.index_select(dim, keep))
    return dst


def local(x):
    """The plain tensor of ``x``: a DTensor gathered whole, else ``x``."""
    return x.full_tensor() if is_dtensor(x) else x
